"""Sampled decoder scoring on gathered endpoint embeddings (plain PyTorch).

Port of ``decagon_tpu/ops/sddmm.py``: only the sampled (row, col) entries
of the decoder's ``Z R Z^T`` are computed,

    score[b] = (z_row[b] @ loc) @ glb @ (loc @ z_col[b])

with ``loc`` diagonal (DEDICOM) or identity and ``glb`` full (bilinear,
DEDICOM), diagonal (DistMult) or identity (inner product).  Products run
in full f32: the port turns TF32 off where it picks its device.
"""

from __future__ import annotations

from typing import Optional

import torch


def sddmm_pairs(
    z_rows: torch.Tensor,
    z_cols: torch.Tensor,
    glb: Optional[torch.Tensor] = None,
    loc_diag: Optional[torch.Tensor] = None,
    glb_diag: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batched bilinear edge scores.

    z_rows, z_cols: [B, d] gathered endpoint embeddings.
    glb: optional [d, d] full interaction matrix, or [B, d, d] per edge.
    glb_diag: optional [d] or per-edge [B, d] diagonal interaction.
    loc_diag: optional [d] or per-edge [B, d] local diagonal (DEDICOM).
    Returns [B] logits (no sigmoid).
    """
    left = z_rows
    right = z_cols
    if loc_diag is not None:
        ld = loc_diag if loc_diag.dim() == 2 else loc_diag[None, :]
        left = left * ld
        right = right * ld
    if glb is not None:
        if glb.dim() == 3:
            left = torch.bmm(left[:, None, :], glb)[:, 0, :]
        else:
            left = left @ glb
    elif glb_diag is not None:
        gd = glb_diag if glb_diag.dim() == 2 else glb_diag[None, :]
        left = left * gd
    return torch.sum(left * right, dim=-1)
