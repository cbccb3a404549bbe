"""The sparse regime on the card, beyond the paper's scale: K6 against the
COO gather and ``index_add_`` ("xla") in full training steps.

    python -m decagon_tpu_torch.scripts.bench_sparse_regime [--only NAME] [--device cpu]

Port of ``scripts/bench_sparse_regime.py``, config for config (``CONFIGS``:
the same names, drug and edge counts, implementations in the same order,
``share_state`` and ``renumber``).  Every config has the full 963-relation
schema with transposes and 19,081 proteins at hidden 64 -> 32:

* ``paper_cap`` (645 drugs, 4,651,131 drug-drug edges): the paper's graph
  with ``densify_max_cells=0``, so no dense or mask stack is built and every
  edge type aggregates over K6's CSR layouts; "xla" against K6 at both
  precisions;
* ``beyond_paper`` (1,600 drugs, 6M edges) and ``xla_infeasible`` (2,500
  drugs, 8M edges, with ``remat``): sizes whose drug-drug bf16 stacks
  (9.2 and 22.4 GiB) did not fit the chip the JAX package was built for.
  ``densify_max_cells=0`` stays their definition here too: the stacks are
  kept off the card, and ``workload`` states each stack beside the card's
  own memory;
* ``paper_cap_renumbered`` and ``beyond_paper_renumbered``: the same
  graphs relabelled by degree (``graph/renumber.py``) before the split.

Flow, as in the JAX script: the graph (``make_polypharmacy_like_graph``,
seed 7), optionally renumbered, split 5% / 5% (seed 1), the device graph
(CSR layouts on every edge type, no fused stream); every implementation of
a config starts from one state (the first ``Trainer``'s, copied; without
``share_state`` each ``Trainer`` draws it from the same seed) and is timed
in chunks of 10 steps: one warm-up chunk, then 4 timed ones (host clock,
synchronized after each), min and median ms a step.  ``edges_per_s`` is the
graph's adjacency nonzeros over the min step time, as in the JAX script,
not the batch's edges.  Each config runs in a subprocess of its own
(``--only``).

Besides the JAX fields (``workload``, ``host_build_s``, ``renumbered``,
``ms_per_step_min``, ``edges_per_s``, and the summary ``workload``, ``xla``,
``pallas_bf16``, ``pallas_vs_xla`` from ``paper_cap``), each config records
the host build's seconds by stage, each layout's ``tiling_stats`` (the JAX
tile occupancy has no meaning for the CSR), and per implementation the
median, the peak memory (``torch.cuda.max_memory_allocated`` after a reset,
the previous trainer freed), K6's and K7's launches a step, the launch
plans K6 took (``ops/spmm_pallas.PLANS``) and, on the card, one more chunk
of 8 steps under ``torch.profiler`` (``bench.device_profile``: device busy
ms a step, idle share, the top kernels, and K6's and K7's ms a step).  The record names the card
(``nvidia-smi`` name and power limit), its memory and the torch version.

Only a ``torch.cuda.OutOfMemoryError`` of the "xla" comparator is recorded
as a result (``{"failed": ..., "bytes_asked": ...}``); any other error, and
any subprocess that exits other than 0, ends the script with an error.
Writes ``artifacts/perf/torch_sparse_regime_bench.json`` (``--out``).  Runs
on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
from typing import Dict, Optional

import torch

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.bench import PROFILE_STEPS, device_profile, graph_nnz
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.ops import cuda_build, spmm_pallas
from decagon_tpu_torch.ops.optim import tree_map
from decagon_tpu_torch.ops.tiling import tiling_stats
from decagon_tpu_torch.timing import hard_sync
from decagon_tpu_torch.train.step import TrainConfig
from decagon_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "artifacts", "perf", "torch_sparse_regime_bench.json")
T0 = time.perf_counter()

# The kernels whose device time a profiled chunk sums (their CUDA kernels'
# names): K6's three passes and K7.
PROFILE_GROUPS = {"spmm_tiled": ("spmm_rows", "spmm_segments", "spmm_reduce"),
                  "adam": ("adam_multi_kernel",)}

# The graph, split and device graph of every config (the JAX script's
# ``run_config``).
GRAPH = dict(min_edges_per_relation=500, ppi_attachment=37, seed=7)
SPLIT = dict(val_frac=0.05, test_frac=0.05, seed=1)
DEVICE_GRAPH = dict(tile_for_pallas=True, densify_max_cells=0, build_fused=False)

CONFIGS = {
    "paper_cap": dict(
        n_drugs=645, dd_edges=4_651_131,
        impls=[("xla", "xla", "highest"),
               ("pallas_bf16", "pallas", "default"),
               ("pallas_f32", "pallas", "highest")],
    ),
    "beyond_paper": dict(
        n_drugs=1600, dd_edges=6_000_000,
        impls=[("pallas_bf16", "pallas", "default"),
               ("pallas_f32", "pallas", "highest"),
               ("xla", "xla", "highest")],
    ),
    "paper_cap_renumbered": dict(
        n_drugs=645, dd_edges=4_651_131,
        impls=[("pallas_bf16", "pallas", "default")],
        renumber=True,
    ),
    "beyond_paper_renumbered": dict(
        n_drugs=1600, dd_edges=6_000_000,
        impls=[("pallas_bf16", "pallas", "default")],
        renumber=True,
    ),
    "xla_infeasible": dict(
        n_drugs=2500, dd_edges=8_000_000,
        impls=[("xla", "xla", "highest"),
               ("pallas_bf16", "pallas", "default"),
               ("pallas_bf16_remat", "pallas", "default",
                {"remat": True})],
        share_state=False,
    ),
}


def log(msg: str) -> None:
    print(f"[sparse +{time.perf_counter() - T0:.0f}s] {msg}", file=sys.stderr, flush=True)


def host_graph(n_drugs: int, dd_edges: int, renumber: bool = False, n_proteins: int = 19081,
               n_side_effects: int = 963):
    """(graph, splits, seconds by stage) of a config: the polypharmacy-like
    graph, its degree renumbering when asked, the split."""
    stages = {}
    t = time.perf_counter()
    graph = make_polypharmacy_like_graph(
        n_proteins=n_proteins, n_drugs=n_drugs, n_side_effects=n_side_effects,
        total_drugdrug_edges=dd_edges, **GRAPH,
    )
    stages["graph_s"] = time.perf_counter() - t
    if renumber:
        # Degree-clustered relabelling: the hot source rows of K6's
        # gathers sit together at the front of the flat table.
        from decagon_tpu_torch.graph.renumber import renumber_by_degree

        t = time.perf_counter()
        graph, _ = renumber_by_degree(graph)
        stages["renumber_s"] = time.perf_counter() - t
    t = time.perf_counter()
    splits = split_graph(graph, **SPLIT)
    stages["split_s"] = time.perf_counter() - t
    return graph, splits, stages


def sparse_device_graph(graph, splits, device, stages: Optional[Dict] = None):
    """The device graph of every config: K6's CSR layouts on every edge
    type, no dense or mask stack, no fused stream."""
    t = time.perf_counter()
    dg = build_device_graph(graph, splits, device=device, **DEVICE_GRAPH)
    hard_sync(dg.neg_cdf)
    if stages is not None:
        stages["device_graph_s"] = time.perf_counter() - t
    return dg


def stack_gib(dg) -> float:
    """The drug-drug bf16 dense stack that ``densify_max_cells=0`` keeps
    off the card."""
    dd = dg.adj["1,1"]
    return dd.num_rel * dd.n_rows * dd.n_cols * 2 / 2**30


def layout_stats(dg) -> Dict:
    return {key: {d: tiling_stats(getattr(a, f"tiles_{d}")) for d in ("fwd", "bwd")}
            for key, a in sorted(dg.adj.items()) if a.tiles_fwd is not None}


def steady_ms(trainer, chunk: int = 10, windows: int = 4) -> Dict:
    """One warm-up chunk of ``chunk`` steps, then ``windows`` timed chunks:
    min and median ms a step and each window's."""
    batches = []
    need = chunk * (windows + 2)
    while len(batches) < need:
        batches.extend(trainer.scheduler.epoch())
    hard_sync(trainer.train_chunk(batches[:chunk], chunk))
    times = []
    for rep in range(windows):
        lo = chunk * (1 + rep)
        t0 = time.perf_counter()
        trainer.train_chunk(batches[lo:lo + chunk], chunk)
        hard_sync(trainer.params)
        times.append((time.perf_counter() - t0) / chunk)
    return {"min_ms": min(times) * 1e3, "median_ms": statistics.median(times) * 1e3,
            "window_ms": [t * 1e3 for t in times], "steps": chunk * (windows + 1)}


_ASKED = re.compile(r"Tried to allocate ([0-9.]+) (B|KiB|MiB|GiB|TiB)")
_UNITS = {"B": 1, "KiB": 2**10, "MiB": 2**20, "GiB": 2**30, "TiB": 2**40}


def oom_record(exc: BaseException) -> Dict:
    """An out-of-memory failure as a result: the message's first line and
    the bytes the failed allocation asked for (None if not stated)."""
    msg = str(exc)
    m = _ASKED.search(msg)
    return {"failed": msg.strip().splitlines()[0][:300] if msg.strip() else type(exc).__name__,
            "bytes_asked": None if m is None else int(float(m.group(1)) * _UNITS[m.group(2)])}


def _copy_state(state):
    return tree_map(lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x, state)


def _reset_memory(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def run_config(n_drugs, dd_edges, impls, chunk=10, share_state=True, renumber=False,
               n_proteins=19081, n_side_effects=963, device=None, windows=4):
    """One config's record (see the module docstring).  ``n_proteins`` and
    ``n_side_effects`` shrink the graph for the CPU tests; ``windows`` and
    ``chunk`` set the timing."""
    device = resolve_device(device)
    build_t0 = time.perf_counter()
    graph, splits, stages = host_graph(n_drugs, dd_edges, renumber, n_proteins, n_side_effects)
    dg = sparse_device_graph(graph, splits, device, stages)
    build_s = time.perf_counter() - build_t0
    nnz = graph_nnz(dg)
    stack = stack_gib(dg)
    card_gib = (torch.cuda.get_device_properties(device).total_memory / 2**30
                if device.type == "cuda" else None)
    beside = "no card (a CPU run)" if card_gib is None else f"the card's {card_gib:.1f} GiB"
    log(f"[{n_drugs} drugs] built in {build_s:.1f}s {json.dumps(stages)}; nnz={nnz}; dd dense "
        f"stack would be {stack:.1f} GiB bf16 against {beside}")
    out = {
        "workload": (
            f"{n_proteins} prot / {n_drugs} drugs / {n_side_effects} rels x2, nnz={nnz}; dd "
            f"dense stack would be {stack:.1f} GiB bf16 against {beside}; "
            "densify_max_cells=0 keeps every stack off the card"
        ),
        "host_build_s": build_s,
        "host_build_stages_s": stages,
        "renumbered": bool(renumber),
        "nnz": nnz,
        "dd_stack_gib": stack,
        "card_memory_gib": card_gib,
        "graph_memory_gib": (torch.cuda.memory_allocated(device) / 2**30
                             if device.type == "cuda" else None),
        "layouts": layout_stats(dg),
    }
    cfg = TrainConfig(batch_size=512, learning_rate=1e-3, scan_chunk=chunk)
    shared_state = None
    for spec in impls:
        tag, impl, precision = spec[:3]
        extra = spec[3] if len(spec) > 3 else {}
        _reset_memory(device)
        model = DecagonModel(ModelConfig(hidden1=64, hidden2=32, dropout=0.1, spmm_impl=impl,
                                         spmm_precision=precision, **extra), dg)
        trainer = None
        try:
            trainer = Trainer(model, graph, splits, dg, cfg, seed=0,
                              init_state=None if shared_state is None
                              else _copy_state(shared_state))
            if share_state and shared_state is None:
                shared_state = _copy_state(trainer.state_dict())
            cuda_build.reset_launches()
            spmm_pallas.PLANS.clear()
            t = steady_ms(trainer, chunk=chunk, windows=windows)
            out[tag] = {
                "ms_per_step_min": t["min_ms"],
                "ms_per_step_median": t["median_ms"],
                "window_ms": t["window_ms"],
                "edges_per_s": nnz / (t["min_ms"] / 1e3),
                "peak_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                             if device.type == "cuda" else None),
                "launches_per_step": {name: cuda_build.LAUNCHES[name] / t["steps"]
                                      for name in ("spmm_tiled", "adam")},
                "spmm_plans": [dict(zip(("n_dst", "n_src", "h", "table", "precision", "vec",
                                         "rows_vec", "staged"), key), launches=n)
                               for key, n in sorted(spmm_pallas.PLANS.items(), key=str)],
            }
            if device.type == "cuda":
                out[tag]["profile"] = device_profile(trainer, PROFILE_STEPS, t["median_ms"],
                                                     groups=PROFILE_GROUPS)
        except torch.cuda.OutOfMemoryError as exc:
            if impl != "xla":
                raise
            out[tag] = oom_record(exc)
        finally:
            # An out-of-memory attempt leaves its state referenced until
            # here: drop it before the next implementation.
            del trainer, model
            _reset_memory(device)
        log(f"{tag}: {json.dumps(out[tag])}")
    return out


def _device_name(device) -> str:
    if device.type != "cuda":
        return str(device)
    from decagon_tpu_torch.scripts.probing import card

    return card()


def summarize(out: Dict) -> Dict:
    """The summary fields the port's bench lifts (``paper_cap``'s), and
    ``pallas_vs_xla`` there."""
    head = out["paper_cap"]
    if "ms_per_step_min" in head.get("xla", {}) and "ms_per_step_min" in head.get(
            "pallas_bf16", {}):
        head["pallas_vs_xla"] = head["xla"]["ms_per_step_min"] / head["pallas_bf16"][
            "ms_per_step_min"]
    for key in ("workload", "xla", "pallas_bf16", "pallas_vs_xla"):
        out[key] = head.get(key)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None, choices=sorted(CONFIGS),
                    help="run one config in this process")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT, help="the record (with --only: that config's part)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.only:
        record = {args.only: run_config(**CONFIGS[args.only], device=device)}
        with open(args.out, "w") as f:
            json.dump(record, f)
        return 0
    # Each config in a process of its own: nothing one config leaves on
    # the card (a failed allocation's cache, the previous graph) can
    # starve the next.
    out = {}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for name in CONFIGS:
        part = f"{args.out}.{name}.part"
        cmd = [sys.executable, "-m", "decagon_tpu_torch.scripts.bench_sparse_regime",
               "--only", name, "--out", part] + (["--device", args.device] if args.device else [])
        rc = subprocess.run(cmd, cwd=ROOT, timeout=1800).returncode
        if rc != 0:
            raise RuntimeError(f"config {name}: its process exited with {rc}")
        with open(part) as f:
            out.update(json.load(f))
        os.remove(part)
    summarize(out)
    out["device"] = _device_name(device)
    out["torch"] = torch.__version__
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
