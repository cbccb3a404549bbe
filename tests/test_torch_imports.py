"""Import and tree hygiene of the port.

The port and ``chip_smoke.py`` must run where JAX and the JAX package's
other dependencies are absent.  A clean interpreter (this process already
imported JAX through conftest.py) imports every module of the port and
``chip_smoke``, then reports what ``sys.modules`` holds.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "decagon_tpu_torch"
FORBIDDEN = ("jax", "decagon_tpu", "networkx", "sklearn", "pandas", "ml_dtypes", "optax",
             "orbax")

_PROBE = """
import importlib, json, pkgutil, sys
import decagon_tpu_torch
names = [m.name for m in pkgutil.walk_packages(decagon_tpu_torch.__path__, "decagon_tpu_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
print(json.dumps({"modules": names, "loaded": sorted(sys.modules)}))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    for module in ("train.evaluate", "ops.sddmm_pallas", "train.step", "ops.optim",
                   "train.negatives", "models.losses", "train.sampler", "train.trainer",
                   "train.checkpoint", "train.logger", "bench",
                   "scripts.probe_adam_onepass", "scripts.quality_sweep", "graph.renumber",
                   "ops.tiling", "ops.spmm_pallas", "scripts.probing",
                   "scripts.probe_int8_bw", "scripts.probe_paired_parts",
                   "scripts.probe_paired_orient", "scripts.probe_paired_bwd_idioms",
                   "scripts.probe_paired_idioms", "scripts.probe_paired_sweep",
                   "scripts.probe_paired_cuts", "cli", "config", "registry", "native",
                   "data.public", "data.record", "data.repair", "predict.predictor",
                   "predict.export", "train.active", "train.layout", "graph.ids",
                   "scripts.np_predictor_example", "parallel", "parallel.mesh",
                   "parallel.collectives", "parallel.rowshard", "parallel.sharded",
                   "scripts.probe_mesh_step", "scripts.quality_full",
                   "scripts.bench_sparse_regime", "scripts.quality_sparse_regime",
                   "scripts.records", "scripts.quality_run", "scripts.profile_epoch",
                   "scripts.bench_scale", "scripts.probe_fullscale", "scripts.bench_paired",
                   "scripts.profile_fullscale_step", "scripts.profile_factored_ops",
                   "scripts.profile_sddmm", "scripts.worlds", "scripts.scaling_model",
                   "scripts.multihost_sim", "scripts.multihost_bench",
                   "scripts.multihost_overlap", "scripts.bench_sharded",
                   "scripts.diag_sharded", "scripts.hlo_collectives",
                   "scripts.hlo_overlap_schedule", "scripts.ingest_fullsize"):
        assert f"decagon_tpu_torch.{module}" in report["modules"]
    leaked = [
        m for m in report["loaded"]
        if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)
    ]
    assert leaked == []


def _port_files():
    """The port's files that git would commit (or, outside a git
    checkout, every file but build output and caches)."""
    try:
        out = subprocess.run(
            ["git", "ls-files", "--cached", "--others", "--exclude-standard",
             "decagon_tpu_torch"],
            cwd=ROOT, capture_output=True, text=True, timeout=60, check=True,
        ).stdout.split()
        return [ROOT / f for f in out]
    except (OSError, subprocess.SubprocessError):
        return [
            p for p in PORT.rglob("*")
            if p.is_file() and "_build" not in p.parts and "__pycache__" not in p.parts
        ]


def test_port_tree_holds_no_binaries_or_large_files():
    files = _port_files()
    assert any(f.name == "paired_fwd.cu" for f in files)
    for f in files:
        assert f.suffix not in (".so", ".npz", ".npy", ".pt", ".o"), f
        assert f.stat().st_size <= 1 << 20, f


@pytest.mark.parametrize(
    "name", ["optax", "networkx", "jax", "orbax", "decagon_tpu", "sklearn"]
)
def test_port_sources_name_no_forbidden_package(name):
    """No source line of the port or of ``chip_smoke.py`` imports the JAX
    package's dependencies, even behind a branch the probe above does not
    take."""
    import re

    pattern = re.compile(rf"^\s*(import|from)\s+{name}\b", re.M)
    files = [f for f in _port_files() if f.suffix == ".py"] + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        assert not pattern.search(f.read_text()), f


@pytest.mark.parametrize(
    "source", ["paired_fwd.cu", "paired_bwd.cu", "sddmm.cu", "adam.cu", "spmm_tiled.cu",
               "probe_int8_bw.cu", "probe_paired.cu", "probe_paired_sweep.cu"]
)
def test_cuda_sources_are_plain_c_interface(source):
    """The kernels build with nvcc into a ctypes library: no PyTorch
    headers (their build takes minutes) and every entry point extern C."""
    text = (PORT / "csrc" / source).read_text()
    assert "torch/extension.h" not in text and "ATen" not in text
    assert 'extern "C"' in text


@pytest.mark.parametrize("header", ["paired_core.cuh", "paired_fwd.cuh"])
def test_cuda_headers_are_built_and_plain(header):
    """A header the kernels include is part of the build's hash, and
    includes no PyTorch header either."""
    from decagon_tpu_torch.ops import cuda_build

    assert header in cuda_build.HEADERS
    text = (PORT / "csrc" / header).read_text()
    assert "torch/extension.h" not in text and "ATen" not in text
    assert any(f'#include "{header}"' in (PORT / "csrc" / src).read_text()
               for src in cuda_build.SOURCES)
