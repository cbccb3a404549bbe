"""Multi-relational SpMM dispatch, row normalization and dropout (plain
PyTorch).

Port of ``decagon_tpu/ops/segment.py``.  ``spmm`` aggregates
``sum_k A_k @ P_k`` for one edge type from whichever form the device graph
holds: the padded COO stream (``"xla"``: one gather and one ``index_add_``),
the dense ``[K, N_i, N_j]`` stack (``"dense"``), the int8 factored stack
(``"dense_factored"``, with the JAX package's custom backward that reads
the pre-transposed mask), or the CSR layouts through the K6 kernel
(``"pallas"``, ``ops/spmm_pallas.py``; ``"pallas_ref"`` its plain version
on any device).  The first three are plain XLA in the JAX package and
plain PyTorch here.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import torch

from decagon_tpu_torch.ops.spmm_pallas import spmm_pallas

if TYPE_CHECKING:  # pragma: no cover
    from decagon_tpu_torch.graph.device import EdgeTypeAdj

SPMM_IMPLS = ("xla", "dense", "dense_factored", "pallas", "pallas_ref")


def spmm_segment(
    p_stack: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    rel: torch.Tensor,
    vals: torch.Tensor,
    n_out: int,
) -> torch.Tensor:
    """``out[r] = sum_e vals[e] * p_stack[rel[e], senders[e], :]``.

    ``p_stack``: [K, N_src, H] per-relation projected features.  Padding
    edges must carry ``vals == 0``."""
    k, n_src, h = p_stack.shape
    flat_idx = rel.long() * n_src + senders.long()
    msgs = p_stack.reshape(k * n_src, h)[flat_idx] * vals[:, None]
    out = torch.zeros((n_out, h), dtype=msgs.dtype, device=msgs.device)
    return out.index_add(0, receivers.long(), msgs)


# Cells of the dense stack upcast to f32 at once (2^27: 512 MB), so that no
# f32 copy of a whole stack (3.2 GB at the paper's drug-drug shape) is made
# or kept for the backward.
_DENSE_CHUNK_CELLS = 1 << 27


def _relation_chunks(dense_adj: torch.Tensor):
    """Slices of whole relations of at most ``_DENSE_CHUNK_CELLS`` cells
    (one relation if a single one is larger)."""
    k, n_i, n_j = dense_adj.shape
    step = max(1, _DENSE_CHUNK_CELLS // max(1, n_i * n_j))
    return [slice(lo, min(k, lo + step)) for lo in range(0, k, step)]


class _Dense(torch.autograd.Function):
    """``sum_k A_k @ P_k`` over the dense stack, a chunk of relations at a
    time: each chunk's stack upcast to f32, one batched product to
    ``[k, N_out, H]``, summed over its relations, the chunks' sums added in
    order.  A bf16 stack rounds ``P`` to bf16 first, and the backward
    rounds ``dP = A^T ct`` to bf16, as autograd of the cast does."""

    @staticmethod
    def forward(ctx, p_stack, dense_adj):
        ctx.save_for_backward(dense_adj)
        ctx.p_dtype = p_stack.dtype
        if dense_adj.dtype == torch.bfloat16:
            p_stack = p_stack.to(torch.bfloat16).float()
        out = None
        for part in _relation_chunks(dense_adj):
            acc = torch.bmm(dense_adj[part].float(), p_stack[part]).sum(0)
            out = acc if out is None else out + acc
        return out

    @staticmethod
    def backward(ctx, ct):
        (dense_adj,) = ctx.saved_tensors
        dp = torch.cat([torch.matmul(dense_adj[part].float().transpose(1, 2), ct)
                        for part in _relation_chunks(dense_adj)])
        if dense_adj.dtype == torch.bfloat16:
            dp = dp.to(torch.bfloat16)
        return dp.to(ctx.p_dtype), None


def spmm_dense(p_stack: torch.Tensor, dense_adj: torch.Tensor) -> torch.Tensor:
    """``sum_k A_k @ P_k`` over the dense stack ``[K, N_out, N_src]``.  A
    bf16 stack rounds the features to bf16 too, with f32 sums: the operands
    are upcast to f32 before the product (a bf16 x bf16 matmul in PyTorch
    would round its output to bf16, where XLA keeps f32), a chunk of
    relations at a time (``_Dense``)."""
    return _Dense.apply(p_stack, dense_adj)


class _DenseFactored(torch.autograd.Function):
    """``sum_k diag(a_k) B_k diag(b_k) P_k`` with the JAX package's custom
    VJP (``_factored_bwd``): the backward reads ``mask_t`` and rounds
    ``a * ct`` to bf16 before the product."""

    @staticmethod
    def forward(ctx, p_stack, mask, mask_t, row_scale, col_scale):
        ctx.save_for_backward(mask_t, row_scale, col_scale)
        pb = (p_stack * col_scale[:, :, None]).to(torch.bfloat16).float()
        kih = torch.bmm(mask.float(), pb)  # [K, N_i, H]
        return torch.einsum("ki,kih->ih", row_scale, kih)

    @staticmethod
    def backward(ctx, ct):
        mask_t, row_scale, col_scale = ctx.saved_tensors
        # d p_stack[k,j,h] = b_k[j] * sum_i B_k[j,i]^T a_k[i] ct[i,h]
        cta = (row_scale[:, :, None] * ct[None]).to(torch.bfloat16).float()
        kjh = torch.bmm(mask_t.float(), cta)  # [K, N_j, H]
        return kjh * col_scale[:, :, None], None, None, None, None


def spmm_dense_factored(
    p_stack: torch.Tensor,
    mask: torch.Tensor,
    mask_t: torch.Tensor,
    row_scale: torch.Tensor,
    col_scale: torch.Tensor,
) -> torch.Tensor:
    """``sum_k diag(a_k) B_k diag(b_k) P_k`` with an int8 mask stack.

    ``p_stack`` [K, N_j, H] f32; ``mask`` int8 [K, N_i, N_j] and its
    transpose ``mask_t`` [K, N_j, N_i]; returns [N_i, H] f32.  Same cast
    points as the JAX package: ``P * b`` (forward) and ``a * ct``
    (backward) round to bf16, the mask is exact, and the products run on
    the rounded operands upcast to f32."""
    return _DenseFactored.apply(p_stack, mask, mask_t, row_scale, col_scale)


def spmm(
    p_stack: torch.Tensor,
    adj: "EdgeTypeAdj",
    impl: str = "xla",
    precision: str = "highest",
) -> torch.Tensor:
    """Aggregate ``sum_k A_k @ P_k`` for one edge type: ``impl`` is
    "dense_factored", "dense", "xla" (the COO stream), "pallas" (K6 over
    the CSR layouts, at ``precision``) or "pallas_ref" (its plain
    version).  ``precision`` steers only the last two."""
    if impl in ("pallas", "pallas_ref"):
        return spmm_pallas(p_stack, adj, precision, ref=impl == "pallas_ref")
    if impl == "dense_factored":
        if adj.dense_mask is None:
            raise ValueError(
                "adjacency has no factored dense form; build the device "
                "graph with dense_factored=True"
            )
        return spmm_dense_factored(
            p_stack, adj.dense_mask, adj.dense_mask_t, adj.row_scale, adj.col_scale
        )
    if impl == "dense":
        if adj.dense is None:
            raise ValueError(
                "adjacency has no dense stack; build the device graph with a "
                "densify_max_cells above this relation's size"
            )
        return spmm_dense(p_stack, adj.dense)
    if impl == "xla":
        return spmm_segment(
            p_stack, adj.senders, adj.receivers, adj.rel, adj.vals, adj.n_rows
        )
    raise ValueError(f"unknown spmm impl: {impl!r}")


def l2_normalize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row L2 normalization with ``tf.nn.l2_normalize`` semantics:
    ``x * rsqrt(max(sum(x^2), eps))``."""
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps))


def _keep_mask(generator: torch.Generator, shape, keep: float, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device) < keep


def dropout(
    generator: Optional[torch.Generator],
    x: torch.Tensor,
    rate: float,
    deterministic: bool = False,
) -> torch.Tensor:
    """Inverted dropout (``tf.nn.dropout(x, keep_prob=1-rate)`` parity),
    drawn from ``generator`` (on ``x``'s device)."""
    if deterministic or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = _keep_mask(generator, x.shape, keep, x.device)
    return torch.where(mask, x / keep, 0.0)


def row_dropout(
    generator: Optional[torch.Generator],
    x: torch.Tensor,
    rate: float,
    deterministic: bool = False,
) -> torch.Tensor:
    """Drop whole last-axis rows together: sparse dropout over one-hot
    identity features (reference ``decagon/deep/layers.py:23-31,88``)."""
    if deterministic or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = _keep_mask(generator, x.shape[:-1] + (1,), keep, x.device)
    return torch.where(mask, x / keep, 0.0)
