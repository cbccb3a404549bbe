"""Paired factored SpMM forward: one int8 mask stack serves both halves.

Port of ``decagon_tpu/ops/spmm_paired.py`` (forward, no dropout).  A square
transpose-augmented edge type has relations ``[r_0..r_{K-1}, r_0^T..
r_{K-1}^T]``, so with the rank-1 normalization the aggregation is

    out = sum_k  a_e[k] * (B_k   @ (b_e[k] * p_e[k]))     (direct half)
        + sum_k  a_o[k] * (B_k^T @ (b_o[k] * p_o[k]))     (transposed half)

over ONE int8 mask stack ``B`` of K relations.  Operands ride transposed,
``p4 [2, K, H, N]`` (the encoder's paired weight layout), and the result
``outT [H, N]``.

``paired_fwd`` is the wrapper of the CUDA kernel
(``decagon_tpu_torch/csrc/paired_fwd.cu``): on a CUDA tensor it launches
the kernel or raises; on a CPU tensor it runs ``paired_ref``, the plain
version.  The backward kernels and the dropout keep-scale variant come
with the training slice.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import torch

from decagon_tpu_torch.ops import cuda_build

if TYPE_CHECKING:  # pragma: no cover
    from decagon_tpu_torch.graph.device import EdgeTypeAdj

# Output rows per kernel block (``TM`` in paired_fwd.cu).
_ROWS_PER_BLOCK = 64
_SUPPORTED_H = (32, 64)


def paired_ref(
    p4: torch.Tensor, mask: torch.Tensor, scales: torch.Tensor
) -> torch.Tensor:
    """Plain version: ``outT [H, N]`` f32 with the kernel's cast points
    (``p * b`` rounded to bf16, exact products, f32 sums).  Accepts masks
    and scales padded beyond ``[K, N]``, as the JAX package builds them."""
    k, n = p4.shape[1], p4.shape[3]
    b = mask[:k, :n, :n].float()
    ae = scales[:k, 0:1, :n]  # [K, 1, N]
    ao = scales[:k, 1:2, :n]
    be = scales[:k, 2:3, :n]
    bo = scales[:k, 3:4, :n]
    pe = (p4[0].float() * be).to(torch.bfloat16).float()  # [K, H, N]
    po = (p4[1].float() * bo).to(torch.bfloat16).float()
    xe = torch.matmul(pe, b.transpose(1, 2))  # [K, H, N_i]
    xo = torch.matmul(po, b)  # [K, H, N_j]
    return torch.sum(ae * xe + ao * xo, dim=0)


def _check_cuda_args(p4, mask, scales) -> None:
    dev = p4.device
    if p4.dim() != 4 or p4.shape[0] != 2:
        raise ValueError(f"p4 must be [2, K, H, N], got {tuple(p4.shape)}")
    _, k, h, n = p4.shape
    if p4.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"p4 must be float32 or bfloat16, got {p4.dtype}")
    if h not in _SUPPORTED_H:
        raise ValueError(f"hidden width {h} not in {_SUPPORTED_H}")
    if mask.dtype != torch.int8 or tuple(mask.shape) != (k, n, n):
        raise ValueError(
            f"mask must be int8 [{k}, {n}, {n}], got {mask.dtype} "
            f"{tuple(mask.shape)}"
        )
    if scales.dtype != torch.float32 or tuple(scales.shape) != (k, 4, n):
        raise ValueError(
            f"scales must be float32 [{k}, 4, {n}], got {scales.dtype} "
            f"{tuple(scales.shape)}"
        )
    for name, t in (("p4", p4), ("mask", mask), ("scales", scales)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, p4 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paired_fwd(
    p4: torch.Tensor, mask: torch.Tensor, scales: torch.Tensor
) -> torch.Tensor:
    """``outT [H, N]`` f32 of the paired aggregation.

    ``p4`` [2, K, H, N] f32 or bf16; ``mask`` int8 [K, N, N]; ``scales``
    f32 [K, 4, N].  CUDA tensors go through the kernel (relations split
    over enough blocks to fill the card, partial sums reduced in a fixed
    order, so the result is deterministic); CPU tensors through
    ``paired_ref``.
    """
    if p4.device.type == "cpu":
        return paired_ref(p4, mask, scales)
    if p4.device.type != "cuda":
        raise ValueError(f"paired_fwd runs on cuda or cpu, not {p4.device}")
    _check_cuda_args(p4, mask, scales)
    _, k, h, n = p4.shape
    lib = cuda_build.library()
    with torch.cuda.device(p4.device):
        sms = torch.cuda.get_device_properties(p4.device).multi_processor_count
        n_tiles = -(-n // _ROWS_PER_BLOCK)
        splits = max(1, min(k, -(-4 * sms // n_tiles)))
        out = torch.empty((n, h), dtype=torch.float32, device=p4.device)
        partial = out if splits == 1 else torch.empty(
            (splits, n, h), dtype=torch.float32, device=p4.device
        )
        status = lib.dt_paired_fwd(
            mask.data_ptr(), p4.data_ptr(), int(p4.dtype == torch.bfloat16),
            scales.data_ptr(), partial.data_ptr(), out.data_ptr(),
            k, n, h, splits, torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(status, "paired_fwd")
    cuda_build.LAUNCHES["paired_fwd"] += 1
    return out.t()


def _apply(p4, adj: "EdgeTypeAdj", impl: str) -> torch.Tensor:
    if adj.pair_mask is None:
        raise ValueError(
            "edge type has no paired mask stack; build the device graph "
            "with dense_paired=True"
        )
    if impl == "paired_ref":
        return paired_ref(p4, adj.pair_mask, adj.pair_scales)
    if impl in ("auto", "paired"):
        return paired_fwd(p4, adj.pair_mask, adj.pair_scales)
    raise ValueError(f"unknown paired impl: {impl!r}")


def spmm_paired_identity(
    weights: torch.Tensor,
    dropscale: Optional[torch.Tensor],
    adj: "EdgeTypeAdj",
    impl: str = "auto",
) -> torch.Tensor:
    """Identity-feature layer-1 aggregation for a paired edge type:
    ``weights`` is the raw [2, K, H, F] f32 encoder stack (with identity
    features the projection is the weights).  Returns [N, H] f32.
    ``impl``: "auto"/"paired" (the kernel wrapper) or "paired_ref" (the
    plain version on any device)."""
    if dropscale is not None:
        raise NotImplementedError(
            "dropout keep-scales come with the training slice"
        )
    return _apply(weights.contiguous(), adj, impl).t()


def spmm_paired(
    p_t: torch.Tensor, adj: "EdgeTypeAdj", impl: str = "auto"
) -> torch.Tensor:
    """Aggregate ``sum_k A_k @ P_k`` for a transpose-paired edge type.

    ``p_t``: [2, K, H, N] projected features, f32, unscaled; it is cast to
    bf16 here, as in the JAX package.  Returns [N, H] f32."""
    return _apply(p_t.to(torch.bfloat16).contiguous(), adj, impl).t()
