"""ctypes bindings for the native host runtime (``graphcore.cpp``).

Port of ``decagon_tpu/native/__init__.py`` over the port's own copy of
``graphcore.cpp``.  The host-side hot loops (CSV parsing, negative
rejection sampling) dominate start-up on the full polypharmacy graph
(millions of rows and edges), so they run in C++; every entry point
returns ``None`` when the library is unavailable and the caller takes
its numpy path, which gives the same rows.

The shared library is compiled with ``g++ -O3 -std=c++17 -shared -fPIC``
at first use (never at import) into ``decagon_tpu_torch/_build/``, keyed
by a hash of the source and flags.  A failed build writes one line to
stderr and leaves the numpy paths in charge; ``chip_smoke.py`` fails on
it instead.  Setting ``DECAGON_TPU_TORCH_DISABLE_NATIVE`` turns the
library off for this package only (the JAX package has its own switch,
``DECAGON_TPU_DISABLE_NATIVE``, and its own library).  The switch is for
reproducing a split: above 4,096 negatives a relation's draws depend on
whether the library loaded, so a split made where ``g++`` was missing is
made again elsewhere with the switch set.

``build_tiles_arrays`` is not ported: it packs the JAX package's Pallas
edge tiles, and the port's sparse kernel K6 reads a CSR
(``ops/tiling.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "graphcore.cpp"
BUILD_DIR = SOURCE.parent.parent / "_build"
CFLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
DISABLE_ENV = "DECAGON_TPU_TORCH_DISABLE_NATIVE"
# The loaded library's path and the seconds from the start of its build
# to its load (the load alone when an earlier build was found).
BUILD_INFO: Dict[str, object] = {}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _build_library() -> Optional[ctypes.CDLL]:
    source = SOURCE.read_bytes()
    digest = hashlib.sha256(source + " ".join(CFLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libgraphcore-{digest}.so"
    start = time.perf_counter()
    if not lib_path.exists():
        tmp = f"{lib_path}.tmp{os.getpid()}"
        try:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            subprocess.run(
                ["g++", *CFLAGS, str(SOURCE), "-o", tmp],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, lib_path)
        except (subprocess.SubprocessError, OSError) as exc:
            sys.stderr.write(
                f"decagon_tpu_torch.native: build failed ({exc}); using numpy fallbacks\n"
            )
            return None
    lib = ctypes.CDLL(str(lib_path))
    BUILD_INFO.update(path=str(lib_path), seconds=time.perf_counter() - start)

    lib.dt_sample_false_edges.restype = ctypes.c_int64
    lib.dt_sample_false_edges.argtypes = [
        _I64P, _I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_uint64, _I64P, _I64P,
    ]
    lib.dt_parse_edge_csv.restype = ctypes.c_int64
    lib.dt_parse_edge_csv.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        _I64P, _I64P, ctypes.c_void_p, ctypes.c_int64,
    ]
    return lib


def get_library() -> Optional[ctypes.CDLL]:
    """The shared library, or None when it is off or failed to build."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if not _TRIED:
            _LIB = None if os.environ.get(DISABLE_ENV) else _build_library()
            _TRIED = True
    return _LIB


# ---------------------------------------------------------------------
# High-level wrappers (None return => caller should use its fallback).


def sample_false_edges(
    pos_rows: np.ndarray,
    pos_cols: np.ndarray,
    shape,
    count: int,
    seed: int,
) -> Optional[np.ndarray]:
    """``count`` distinct (row, col) pairs of a ``shape`` matrix outside
    the positives, drawn from a splitmix64 stream seeded with ``seed``:
    ``[count, 2]`` int32, or None."""
    lib = get_library()
    if lib is None:
        return None
    pos_rows = np.ascontiguousarray(pos_rows, np.int64)
    pos_cols = np.ascontiguousarray(pos_cols, np.int64)
    out_rows = np.empty(count, np.int64)
    out_cols = np.empty(count, np.int64)
    got = lib.dt_sample_false_edges(
        pos_rows, pos_cols, len(pos_rows), shape[0], shape[1],
        count, np.uint64(seed), out_rows, out_cols,
    )
    if got != count:
        return None
    return np.stack([out_rows, out_cols], axis=1).astype(np.int32)


def parse_edge_csv(path: str, n_fields: int) -> Optional[np.ndarray]:
    """Parse an edge CSV into an [N, n_fields] int64 array (digits-only
    field codec, headers skipped), or None."""
    lib = get_library()
    if lib is None:
        return None
    data = Path(path).read_bytes()
    max_rows = data.count(b"\n") + 1
    out_a = np.empty(max_rows, np.int64)
    out_b = np.empty(max_rows, np.int64)
    out_c = np.empty(max_rows, np.int64) if n_fields > 2 else None
    got = lib.dt_parse_edge_csv(
        data, len(data), n_fields, out_a, out_b,
        out_c.ctypes.data if out_c is not None else None, max_rows,
    )
    cols = [out_a[:got], out_b[:got]]
    if n_fields > 2:
        cols.append(out_c[:got])
    return np.stack(cols, axis=1)
