"""Row normalization and the int8 factored aggregation (plain PyTorch).

Port of ``decagon_tpu/ops/segment.py`` for the serving slice: the forward
of ``spmm_dense_factored`` (the rectangular edge types' aggregation, plain
XLA in the JAX package and plain PyTorch here) and ``l2_normalize_rows``.
The ``spmm`` dispatch with the COO segment-sum, the bf16/f32 dense
stacks and the Pallas tiled path, and dropout, come with later slices.
"""

from __future__ import annotations

import torch


def spmm_dense_factored(
    p_stack: torch.Tensor,
    mask: torch.Tensor,
    mask_t: torch.Tensor,
    row_scale: torch.Tensor,
    col_scale: torch.Tensor,
) -> torch.Tensor:
    """``sum_k diag(a_k) B_k diag(b_k) P_k`` with an int8 mask stack.

    ``p_stack`` [K, N_j, H] f32; ``mask`` int8 [K, N_i, N_j]; returns
    [N_i, H] f32.  Same cast points as the JAX package: ``P * b`` rounds to
    bf16, the mask is exact, and the product runs on the bf16-rounded
    operands upcast to f32 (a bf16 x bf16 matmul in PyTorch would round
    its output to bf16, where XLA keeps f32).  ``mask_t`` serves the
    backward pass, which comes with the training slice.
    """
    del mask_t
    pb = (p_stack * col_scale[:, :, None]).to(torch.bfloat16).float()
    kih = torch.bmm(mask.float(), pb)  # [K, N_i, H]
    return torch.einsum("ki,kih->ih", row_scale, kih)


def l2_normalize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row L2 normalization with ``tf.nn.l2_normalize`` semantics:
    ``x * rsqrt(max(sum(x^2), eps))``."""
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps))
