"""Sparse multi-relational aggregation over the CSR layout: the K6 kernel,
its plain version and its autograd.

Counterpart of ``decagon_tpu/ops/spmm_pallas.py`` (the module keeps its
name; the kernel here is CUDA, ``decagon_tpu_torch/csrc/spmm_tiled.cu``).
It computes ``out[dst] += val * P_flat[src]`` over the flattened
``[K * N_src, H]`` projected stack of one edge type (``spmm_pallas``) or of
the whole fused stream (``spmm_pallas_flat``), with f32 sums:

* ``precision="highest"``: f32 throughout;
* ``precision="default"``: ``P_flat`` cast to bf16 once per call and each
  edge value rounded to bf16; each product of two bf16 values is exact in
  f32.  On a TPU the reference's second MXU product would also round each
  message to bf16; its CPU path, which the tests hold the port to, does
  not, and neither does the port.

The backward is the same kernel over the transposed layout (``tiles_bwd``)
applied to the cotangent, rounded to bf16 at ``"default"`` as the
reference's is.  ``spmm_tiled`` launches the kernel for a CUDA tensor and
runs ``spmm_tiled_ref`` for a CPU tensor; ``ref=True`` takes the plain
version on any device (the ``"pallas_ref"`` / ``"fused_pallas_ref"``
impls, which ``chip_smoke.py`` compares the kernel with).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.ops.tiling import CsrEdges

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
    p, val = p_flat.float(), tiles.val
    if precision == "default":
        p = p.to(torch.bfloat16).float()
        val = val.to(torch.bfloat16).float()
    msgs = p[tiles.col.long()] * val[:, None]
    out = torch.zeros((tiles.n_dst, p.shape[1]), dtype=torch.float32, device=p.device)
    return out.index_add_(0, tiles.dst_index(), msgs)


def _vec(h: int, ptr: int, itemsize: int) -> int:
    """Elements per lane: the widest of 4, 2, 1 that divides ``h``, keeps
    at least half the lanes of a slice busy and matches ``ptr``'s
    alignment."""
    for v in (4, 2):
        if h % v == 0 and h > 16 * v and ptr % (v * itemsize) == 0:
            return v
    return 1


def spmm_tiled(p_flat: torch.Tensor, tiles: CsrEdges, precision: str = "highest") -> torch.Tensor:
    """``out [tiles.n_dst, H]`` f32 with ``out[d] = sum val * P[col]`` over
    row ``d``'s edges.  ``p_flat``: [tiles.n_src, H], f32 or bf16.  A CUDA
    tensor goes through K6 (bitwise repeatable), a CPU tensor through
    ``spmm_tiled_ref``."""
    _check_precision(precision)
    if p_flat.device.type == "cpu":
        return spmm_tiled_ref(p_flat, tiles, precision)
    if p_flat.device.type != "cuda":
        raise ValueError(f"spmm_tiled runs on cuda or cpu, not {p_flat.device}")
    if p_flat.dim() != 2 or p_flat.shape[0] != tiles.n_src or p_flat.shape[1] < 1:
        raise ValueError(
            f"p_flat must be [{tiles.n_src}, H >= 1], got {tuple(p_flat.shape)}"
        )
    for name in ("col", "val", "seg_ptr", "seg_row", "seg_slot", "multi_row", "multi_ptr"):
        t = getattr(tiles, name)
        if t.device != p_flat.device or not t.is_contiguous():
            raise ValueError(f"tiles.{name} must be contiguous on {p_flat.device}")
    bf16 = precision == "default"
    src = (p_flat.to(torch.bfloat16) if bf16 else p_flat.float()).contiguous()
    h = src.shape[1]
    vec = _vec(h, src.data_ptr(), src.element_size())
    lib = cuda_build.library()
    with torch.cuda.device(src.device):
        out = torch.empty((tiles.n_dst, h), dtype=torch.float32, device=src.device)
        partial = (
            torch.empty((tiles.num_slots, h), dtype=torch.float32, device=src.device)
            if tiles.num_slots else out
        )
        status = lib.dt_spmm_tiled(
            src.data_ptr(), int(bf16), tiles.col.data_ptr(), tiles.val.data_ptr(),
            tiles.seg_ptr.data_ptr(), tiles.seg_row.data_ptr(), tiles.seg_slot.data_ptr(),
            tiles.multi_row.data_ptr(), tiles.multi_ptr.data_ptr(), partial.data_ptr(),
            out.data_ptr(), tiles.num_segments, int(tiles.multi_row.shape[0]),
            tiles.n_src, h, vec, torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(status, "spmm_tiled")
    cuda_build.LAUNCHES["spmm_tiled"] += 1
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
