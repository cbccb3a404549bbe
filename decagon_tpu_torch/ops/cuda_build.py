"""Build and load the port's CUDA kernels: ``nvcc`` into one plain-C
shared library, bound with ``ctypes``.

The sources are ``decagon_tpu_torch/csrc/*.cu``.  They include no PyTorch
header, so each compiles in seconds; they are compiled in parallel (one
``nvcc`` per source) for ``sm_90a`` and linked into
``decagon_tpu_torch/_build/<hash>/libdecagon_kernels.so``, keyed by a hash
of the sources and flags.  The build runs at first use, never at import.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` turns a non-zero status into an error.
Wrappers count their launches in ``LAUNCHES`` (the scorer's f32 and bf16
variants apart; each probe of ``decagon_tpu_torch/scripts`` under its
script's name).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("paired_fwd.cu", "paired_bwd.cu", "sddmm.cu", "adam.cu", "spmm_tiled.cu",
           "probe_int8_bw.cu", "probe_paired.cu", "probe_paired_sweep.cu")
HEADERS = ("paired_core.cuh", "paired_fwd.cuh")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Kernel launches per wrapper since the last ``reset_launches``.
LAUNCHES: Dict[str, int] = {
    "paired_fwd": 0, "paired_bwd": 0, "sddmm": 0, "sddmm_bf16": 0, "adam": 0,
    "spmm_tiled": 0, "probe_int8_bw": 0, "probe_paired_parts": 0,
    "probe_paired_orient": 0, "probe_paired_bwd_idioms": 0, "probe_paired_idioms": 0,
    "probe_paired_sweep": 0, "probe_paired_cuts": 0,
}
# What the last build did: seconds, and ptxas' per-kernel report.
BUILD_INFO: Dict[str, object] = {}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, then ``$CUDA_HOME/bin``, then
    ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError(
        "nvcc not found on PATH, under $CUDA_HOME/bin or /usr/local/cuda/bin; "
        "the CUDA kernels cannot be built"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the library, unless a
    library with the same hash exists.  Returns its path."""
    out_dir = BUILD_DIR / _digest()
    lib_path = out_dir / "libdecagon_kernels.so"
    if lib_path.exists():
        BUILD_INFO.update(seconds=0.0, cached=True, ptxas="")
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs: List[subprocess.Popen] = []
    objects = []
    for name in SOURCES:
        obj = out_dir / (name + ".o")
        objects.append(str(obj))
        procs.append(subprocess.Popen(
            [nvcc, *CFLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    reports = []
    for name, proc in zip(SOURCES, procs):
        output, _ = proc.communicate()
        reports.append(output)
        if proc.returncode != 0:
            for other in procs:
                other.kill()
            raise RuntimeError(f"nvcc failed on {name}:\n{output}")
    tmp = str(lib_path) + f".tmp{os.getpid()}"
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", *objects, "-o", tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    BUILD_INFO.update(
        seconds=time.perf_counter() - t0, cached=False, ptxas="".join(reports)
    )
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.dt_paired_fwd.restype = _I
            lib.dt_paired_fwd.argtypes = [
                _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
            ]
            lib.dt_paired_bwd.restype = _I
            lib.dt_paired_bwd.argtypes = [
                _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
            ]
            for name in ("dt_paired_fwd_info", "dt_paired_bwd_info"):
                getattr(lib, name).restype = _I
                getattr(lib, name).argtypes = [_P]
            lib.dt_sddmm.restype = _I
            lib.dt_sddmm.argtypes = [
                _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P,
            ]
            lib.dt_adam.restype = _I
            lib.dt_adam.argtypes = [
                _P, _P, _P, _P, _L, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _P,
            ]
            lib.dt_spmm_tiled.restype = _I
            lib.dt_spmm_tiled.argtypes = [
                _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
            ]
            lib.dt_probe_column_sum.restype = _I
            lib.dt_probe_column_sum.argtypes = [_P, _I, _L, _I, _I, _I, _P, _P, _P]
            lib.dt_probe_paired.restype = _I
            lib.dt_probe_paired.argtypes = [
                _P, _I, _P, _P, _L, _P, _I, _I, _P, _P, _I, _I, _I, _I, _P,
            ]
            lib.dt_probe_paired_sweep.restype = _I
            lib.dt_probe_paired_sweep.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
            lib.dt_probe_paired_bwd.restype = _I
            lib.dt_probe_paired_bwd.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P]
            lib.dt_error_string.restype = ctypes.c_char_p
            lib.dt_error_string.argtypes = [_I]
            _lib = lib
    return _lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        msg = library().dt_error_string(status).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {msg} ({status})")
