"""Sparse multi-relational aggregation over the CSR layout: the K6 kernel,
its plain version and its autograd.

Counterpart of ``decagon_tpu/ops/spmm_pallas.py`` (the module keeps its
name; the kernel here is CUDA, ``decagon_tpu_torch/csrc/spmm_tiled.cu``).
It computes ``out[dst] += val * P_flat[src]`` over the flattened
``[K * N_src, H]`` projected stack of one edge type (``spmm_pallas``) or of
the whole fused stream (``spmm_pallas_flat``), with f32 sums:

* ``precision="highest"``: f32 throughout;
* ``precision="default"``: ``P_flat`` and each edge value rounded to bf16
  (the kernel rounds an f32 table as it reads it); each product of two
  bf16 values is exact in f32.  On a TPU the reference's
  second MXU product would also round each message to bf16; its CPU path,
  which the tests hold the port to, does not, and neither does the port.

The backward is the same kernel over the transposed layout (``tiles_bwd``)
applied to the cotangent, rounded to bf16 at ``"default"`` as the
reference's is.  ``spmm_tiled`` launches the kernel for a CUDA tensor and
runs ``spmm_tiled_ref`` for a CPU tensor; ``ref=True`` takes the plain
version on any device (the ``"pallas_ref"`` / ``"fused_pallas_ref"``
impls, which ``chip_smoke.py`` compares the kernel with).
"""

from __future__ import annotations

import contextlib
import functools
from typing import TYPE_CHECKING, Dict, Tuple

import torch

from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.ops.tiling import CHUNK_EDGES, CHUNK_ROWS, INT32_MAX, CsrEdges

if TYPE_CHECKING:  # pragma: no cover
    from decagon_tpu_torch.graph.device import EdgeTypeAdj, FusedAdj

PRECISIONS = ("highest", "default")


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"spmm precision must be one of {PRECISIONS}, not {precision!r}")


def spmm_tiled_ref(p_flat: torch.Tensor, tiles: CsrEdges, precision: str = "highest") -> torch.Tensor:
    """Plain version: ``[tiles.n_dst, H]`` f32 by one gather and one f32
    ``index_add_``, with the kernel's roundings."""
    _check_precision(precision)
    p, val = _rounded(p_flat, tiles, precision)
    msgs = p[tiles.col.long()] * val[:, None]
    out = torch.zeros((tiles.n_dst, p.shape[1]), dtype=torch.float32, device=p.device)
    return out.index_add_(0, tiles.dst_index(), msgs)


def _rounded(p_flat: torch.Tensor, tiles: CsrEdges, precision: str):
    """The table as f32 and the edge values, rounded to bf16 at "default"."""
    p, val = p_flat.float(), tiles.val
    if precision == "default":
        p = p.to(torch.bfloat16).float()
        val = val.to(torch.bfloat16).float()
    return p, val


def _vec(h: int, ptr: int, itemsize: int) -> int:
    """Elements a lane loads at once: the widest of 16 bytes' worth (4 f32
    or 8 bf16), then halves, that divides ``h`` and matches ``ptr``'s
    alignment."""
    v = 16 // itemsize
    while v > 1 and (h % v or ptr % (v * itemsize)):
        v //= 2
    return v


# The row pass copies the table into shared memory when it takes at most
# this many bytes and its rows are gathered at least _STAGE_REUSE times for
# each SM's copy.  On the H100 (scripts/probe_sparse_kernels.py
# time_staging: rows of 7 edges from a [645, 64] or [645, 32] table),
# staging cost 3-23% at "highest" below 4 gathers a copy and saved 7-14%
# from 4 on; at "default" it saved 10-28% at every reuse from 0.25 to 32.
# At the drug-drug backward (~110 gathers a copy) it saves 24-31%.
_STAGE_BYTES = 180 * 1024
_STAGE_REUSE = 4
_LAYOUT_TENSORS = ("row_ptr", "col", "val", "row_chunks", "seg_edges", "seg_dst", "seg_order",
                   "multi_row", "multi_ptr")


# Lanes a row at most in the segment pass (a warp), whose thread index
# ``block * 256 + thread`` reaches num_segments * 32 + 255.
_SEGMENT_LANES = 32
# Launches by plan since the last ``PLANS.clear()``: (n_dst, n_src, h, the
# table's dtype, precision, vec, rows_vec, staged) -> count.
PLANS: Dict[Tuple, int] = {}


def check_index_range(tiles: CsrEdges, h: int) -> None:
    """Raises unless every index K6 computes in 32 bits stays below 2^31:
    sources, destinations, edges, partial-sum slots and the segment pass's
    thread index.  A table row's element offset ``row * h + column`` (up to
    ``n_src * h``, 308M elements of 1.23 GB in f32 at 2,500 drugs' drug-drug
    layer 1) is computed in 64 bits in every pass, so ``h`` only has to fit
    an int."""
    counts = {"n_src": tiles.n_src, "n_dst": tiles.n_dst, "nnz": tiles.nnz,
              "partial slots": tiles.num_slots, "h": h,
              "segment threads": tiles.num_segments * _SEGMENT_LANES + 255}
    for name, n in counts.items():
        if n > INT32_MAX:
            raise ValueError(f"spmm_tiled indexes with int32: {name} = {n} passes 2^31 - 1")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_plan(tiles: CsrEdges, h: int, ptr: int, b16: bool, rnd: bool, sms: int):
    """(vec, rows_vec, staged) of one call on a table of ``h`` columns (bf16
    when ``b16``) at address ``ptr``, rounded to bf16 when ``rnd``: the
    elements a lane loads at once from device memory; whether the row pass
    copies the table into shared memory (where it fits, as bf16 when
    ``b16`` or ``rnd``, and its rows are gathered often enough to repay
    ``sms`` copies); and the row pass's load width then (4 elements where
    ``h`` allows: 16 lanes a row at H = 64)."""
    item = 2 if b16 else 4
    vec = _vec(h, ptr, item)
    staged_bytes = tiles.n_src * h * (2 if b16 or rnd else 4)
    staged = (staged_bytes <= _STAGE_BYTES
              and tiles.n_src * h * item % 4 == 0 and ptr % 4 == 0  # copied in 4-byte words
              and tiles.nnz >= _STAGE_REUSE * sms * tiles.n_src)
    rows_vec = next(v for v in (4, 2, 1) if h % v == 0) if staged else vec
    return vec, rows_vec, staged


def _layout_args(tiles: CsrEdges, device: torch.device) -> tuple:
    """The layout's part of the kernel's arguments (its tensors' addresses,
    then its chunk, segment and long-row counts and ``n_src``); raises
    unless every tensor is contiguous on ``device``.  Kept on ``tiles``
    for the device it was last called on."""
    if tiles.launch_args is not None and tiles.launch_args[0] == device:
        return tiles.launch_args[1]
    for name in _LAYOUT_TENSORS:
        t = getattr(tiles, name)
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"tiles.{name} must be contiguous on {device}")
    args = tuple(getattr(tiles, name).data_ptr() for name in _LAYOUT_TENSORS) + (
        int(tiles.row_chunks.shape[0]), tiles.num_segments, int(tiles.multi_row.shape[0]),
        tiles.n_src,
    )
    tiles.launch_args = (device, args)
    return args


def spmm_tiled(p_flat: torch.Tensor, tiles: CsrEdges, precision: str = "highest") -> torch.Tensor:
    """``out [tiles.n_dst, H]`` f32 with ``out[d] = sum val * P[col]`` over
    row ``d``'s edges.  ``p_flat``: [tiles.n_src, H], f32 or bf16 (other
    types are read as f32).  A CUDA tensor goes through K6 (bitwise
    repeatable), a CPU tensor through ``spmm_tiled_ref``."""
    _check_precision(precision)
    if p_flat.device.type == "cpu":
        return spmm_tiled_ref(p_flat, tiles, precision)
    if p_flat.device.type != "cuda":
        raise ValueError(f"spmm_tiled runs on cuda or cpu, not {p_flat.device}")
    if p_flat.dim() != 2 or p_flat.shape[0] != tiles.n_src or p_flat.shape[1] < 1:
        raise ValueError(
            f"p_flat must be [{tiles.n_src}, H >= 1], got {tuple(p_flat.shape)}"
        )
    device = p_flat.device
    check_index_range(tiles, p_flat.shape[1])
    layout = _layout_args(tiles, device)
    src = p_flat if p_flat.dtype in (torch.float32, torch.bfloat16) else p_flat.float()
    src = src.contiguous()
    h = src.shape[1]
    b16, rnd = src.dtype == torch.bfloat16, precision == "default"
    index = device.index if device.index is not None else torch.cuda.current_device()
    vec, rows_vec, staged = launch_plan(tiles, h, src.data_ptr(), b16, rnd, _sm_count(index))
    lib = cuda_build.library()
    with contextlib.nullcontext() if index == torch.cuda.current_device() else torch.cuda.device(index):
        out = torch.empty((tiles.n_dst, h), dtype=torch.float32, device=device)
        partial = (
            torch.empty((tiles.num_slots, h), dtype=torch.float32, device=device)
            if tiles.num_slots else out
        )
        status = lib.dt_spmm_tiled(
            src.data_ptr(), int(b16), int(rnd), *layout[:9], partial.data_ptr(),
            out.data_ptr(), *layout[9:], h, vec, rows_vec, int(staged), CHUNK_ROWS, CHUNK_EDGES,
            torch.cuda.current_stream(index).cuda_stream,
        )
    cuda_build.check(status, "spmm_tiled")
    cuda_build.LAUNCHES["spmm_tiled"] += 1
    plan = (tiles.n_dst, tiles.n_src, h, "bf16" if b16 else "f32", precision, vec, rows_vec,
            staged)
    PLANS[plan] = PLANS.get(plan, 0) + 1
    return out


class _SpmmTiled(torch.autograd.Function):
    """``_spmm_pallas_op`` and ``_spmm_pallas_flat_op`` of the JAX package:
    the forward over ``tiles_fwd``, the backward the same function over
    ``tiles_bwd`` applied to the cotangent.  The gradient has the primal's
    dtype."""

    @staticmethod
    def forward(ctx, p_flat, tiles_fwd, tiles_bwd, precision, ref):
        ctx.tiles_bwd, ctx.precision, ctx.ref = tiles_bwd, precision, ref
        ctx.p_dtype = p_flat.dtype
        return (spmm_tiled_ref if ref else spmm_tiled)(p_flat, tiles_fwd, precision)

    @staticmethod
    def backward(ctx, ct):
        fn = spmm_tiled_ref if ctx.ref else spmm_tiled
        d = fn(ct.contiguous(), ctx.tiles_bwd, ctx.precision)
        return d.to(ctx.p_dtype), None, None, None, None


def spmm_pallas(
    p_stack: torch.Tensor, adj: "EdgeTypeAdj", precision: str = "highest", ref: bool = False
) -> torch.Tensor:
    """``sum_k A_k @ P_k`` [n_rows, H] for one edge type through K6;
    ``p_stack`` [K, N_src, H].  ``adj`` must carry the CSR layouts
    (``build_device_graph(..., tile_for_pallas=True)``)."""
    if adj.tiles_fwd is None or adj.tiles_bwd is None:
        raise ValueError(
            "adjacency has no tilings; build the device graph with "
            "tile_for_pallas=True to use the Pallas SpMM"
        )
    k, n, h = p_stack.shape
    return _SpmmTiled.apply(p_stack.reshape(k * n, h), adj.tiles_fwd, adj.tiles_bwd, precision, ref)


def spmm_pallas_flat(
    p_flat: torch.Tensor, fused: "FusedAdj", precision: str = "highest", ref: bool = False
) -> torch.Tensor:
    """The fused stream's aggregation through K6: the global projected
    table ``p_flat [n_p_rows, H]`` into the term space ``[n_t_rows, H]`` in
    one launch (``fused`` must carry the CSR layouts)."""
    if fused.tiles_fwd is None or fused.tiles_bwd is None:
        raise ValueError(
            "fused stream has no tilings; build the device graph with "
            "tile_for_pallas=True to use the fused Pallas SpMM"
        )
    return _SpmmTiled.apply(p_flat, fused.tiles_fwd, fused.tiles_bwd, precision, ref)
