"""Tensor-factorization decoders as (glb, loc) factor pairs.

Port of ``decagon_tpu/models/decoders.py``.  Every decoder's score is the
bilinear chain ``z_r loc glb loc z_c^T`` with

    innerproduct: glb = I,         loc = I
    distmult:     glb = diag(r_k), loc = I
    bilinear:     glb = R_k,       loc = I
    dedicom:      glb = G (shared), loc = diag(d_k)

(reference ``decagon/deep/layers.py:121-213``, ``model.py:116-137``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from decagon_tpu_torch.models.init import glorot
from decagon_tpu_torch.ops.sddmm import sddmm_pairs

DECODER_NAMES = ("innerproduct", "distmult", "bilinear", "dedicom")

Params = Dict[str, torch.Tensor]


def init_decoder_params(
    generator: torch.Generator, name: str, num_rel: int, dim: int
) -> Params:
    if name == "innerproduct":
        return {}
    if name == "distmult":
        return {"relation_diag": glorot(generator, (num_rel, dim), fan=(dim, 1))}
    if name == "bilinear":
        return {"relation": glorot(generator, (num_rel, dim, dim), fan=(dim, dim))}
    if name == "dedicom":
        return {
            "global": glorot(generator, (dim, dim), fan=(dim, dim)),
            "local_diag": glorot(generator, (num_rel, dim), fan=(dim, 1)),
        }
    raise ValueError(f"unknown decoder: {name}")


def decoder_factors(
    params: Params, name: str, k
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(glb_full, glb_diag, loc_diag) for relation ``k`` (an int, or an
    index tensor giving per-edge factors)."""
    if name == "innerproduct":
        return None, None, None
    if name == "distmult":
        return None, params["relation_diag"][k], None
    if name == "bilinear":
        return params["relation"][k], None, None
    if name == "dedicom":
        return params["global"], None, params["local_diag"][k]
    raise ValueError(f"unknown decoder: {name}")


def score_edges(
    params: Params,
    name: str,
    k,
    z_rows: torch.Tensor,
    z_cols: torch.Tensor,
) -> torch.Tensor:
    """Logit scores for B sampled (row, col) pairs of relation ``k``."""
    glb, glb_diag, loc_diag = decoder_factors(params, name, k)
    return sddmm_pairs(
        z_rows, z_cols, glb=glb, loc_diag=loc_diag, glb_diag=glb_diag
    )


def score_matrix(
    params: Params,
    name: str,
    k,
    z_rows_all: torch.Tensor,
    z_cols_all: torch.Tensor,
) -> torch.Tensor:
    """Full [N_rows, N_cols] logit matrix for one relation (the reference
    evaluator's dense ``predictions``, ``decagon/deep/optimizer.py:87-106``)."""
    glb, glb_diag, loc_diag = decoder_factors(params, name, k)
    left = z_rows_all
    right = z_cols_all
    if loc_diag is not None:
        left = left * loc_diag[None, :]
        right = right * loc_diag[None, :]
    if glb is not None:
        left = left @ glb
    elif glb_diag is not None:
        left = left * glb_diag[None, :]
    return left @ right.T
