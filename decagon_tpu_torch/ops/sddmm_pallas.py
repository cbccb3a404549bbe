"""Edge scoring with a per-edge relation index: CUDA kernel and plain version.

Counterpart of ``decagon_tpu/ops/sddmm_pallas.py`` (the module keeps its
name so each port module sits where its reference does; the kernel here
is CUDA, ``decagon_tpu_torch/csrc/sddmm.cu``).  For B edges
``(ks[e], rows[e], cols[e])`` it returns the decoder logits

    innerproduct  z_r . z_c
    distmult      (z_r * d_k) . z_c
    dedicom       ((z_r * d_k) @ G) . (z_c * d_k)
    bilinear      z_r R_k z_c^T

in one of the reference's two precisions: ``"highest"`` (f32 throughout)
or ``"default"`` (every table rounded to bf16, f32 sums, and DEDICOM's
``z_r * d_k`` rounded to bf16 before the product with ``G``: the cast
points of ``sddmm_pallas_edges`` at ``precision="default"``; the kernel
reads bf16 tables, cast once per scoring pass).  ``sddmm_edges`` launches the
kernel for CUDA tensors and runs ``sddmm_plain`` for CPU tensors.  Edges
may come in any order and over any number of relations; the kernel is
fastest when a block's edges name few relations, as an evaluation sweep
staged relation by relation does.
"""

from __future__ import annotations

from typing import Optional

import torch

from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.ops.sddmm import sddmm_pairs

SUPPORTED_DECODERS = ("innerproduct", "distmult", "dedicom", "bilinear")
PRECISIONS = ("highest", "default")
_MODES = {"innerproduct": 0, "distmult": 1, "dedicom": 2, "bilinear": 3}
MAX_DIM = 128


def sddmm_plain(
    z_rows: torch.Tensor,
    z_cols: torch.Tensor,
    ks: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    *,
    name: str,
    glb: Optional[torch.Tensor] = None,
    rel_diag: Optional[torch.Tensor] = None,
    rel_full: Optional[torch.Tensor] = None,
    precision: str = "highest",
) -> torch.Tensor:
    """Plain version: gather the endpoint rows and each edge's relation
    factors (rounded to bf16 at ``"default"``), then ``sddmm_pairs``.  Same
    shape as ``ks``."""
    _check_precision(precision)
    bf16 = precision == "default"
    if bf16:
        z_rows, z_cols, glb, rel_diag, rel_full = (
            None if t is None else _bf16(t) for t in (z_rows, z_cols, glb, rel_diag, rel_full)
        )
    shape = ks.shape
    ks, rows, cols = (a.reshape(-1).long() for a in (ks, rows, cols))
    zr, zc = z_rows[rows], z_cols[cols]
    if name == "innerproduct":
        out = sddmm_pairs(zr, zc)
    elif name == "distmult":
        out = sddmm_pairs(zr, zc, glb_diag=rel_diag[ks])
    elif name == "dedicom" and bf16:
        dk = rel_diag[ks]
        out = torch.sum((_bf16(zr * dk) @ glb) * (zc * dk), dim=-1)
    elif name == "dedicom":
        out = sddmm_pairs(zr, zc, glb=glb, loc_diag=rel_diag[ks])
    elif name == "bilinear":
        out = sddmm_pairs(zr, zc, glb=rel_full[ks])
    else:
        raise ValueError(f"unknown decoder {name!r}")
    return out.reshape(shape)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even), as f32."""
    return t.to(torch.bfloat16).float()


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"sddmm precision must be one of {PRECISIONS}, not {precision!r}")


def _tables(name, glb, rel_diag, rel_full):
    """(rel, glb) operands of the kernel for ``name``, or raise."""
    if name == "innerproduct":
        return None, None
    if name == "distmult":
        return rel_diag, None
    if name == "dedicom":
        if glb is None or rel_diag is None:
            raise ValueError("dedicom needs glb and rel_diag")
        return rel_diag, glb
    if rel_full is None:
        raise ValueError("bilinear needs rel_full")
    return rel_full, None


def sddmm_edges(
    z_rows: torch.Tensor,
    z_cols: torch.Tensor,
    ks: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    *,
    name: str,
    glb: Optional[torch.Tensor] = None,
    rel_diag: Optional[torch.Tensor] = None,
    rel_full: Optional[torch.Tensor] = None,
    precision: str = "highest",
) -> torch.Tensor:
    """``[B]`` logits (same shape as ``ks``) for ``(ks, rows, cols)``.

    ``z_rows`` / ``z_cols``: [N_r, d] / [N_c, d] tables, d <= 128.
    ``rel_diag``: [K, d] (distmult's ``relation_diag``, dedicom's
    ``local_diag``); ``glb``: [d, d] (dedicom); ``rel_full``: [K, d, d]
    (bilinear).  Index tensors are int32.  ``precision``: ``"highest"``
    (K5, f32 tables) or ``"default"`` (K5-bf16, which reads bf16 tables:
    f32 ones are cast here, on every call; a caller that scores many
    chunks casts them once, as ``train/step.make_emb_scores`` does).  On
    CUDA an index outside its table gives a NaN score instead of an
    out-of-bounds read.
    """
    if name not in SUPPORTED_DECODERS:
        raise ValueError(f"sddmm supports {SUPPORTED_DECODERS}, not {name!r}")
    _check_precision(precision)
    if z_rows.device.type == "cpu":
        return sddmm_plain(
            z_rows, z_cols, ks, rows, cols, name=name, glb=glb,
            rel_diag=rel_diag, rel_full=rel_full, precision=precision,
        )
    if z_rows.device.type != "cuda":
        raise ValueError(f"sddmm runs on cuda or cpu, not {z_rows.device}")
    rel, g = _tables(name, glb, rel_diag, rel_full)
    d = z_rows.shape[1]
    if not 1 <= d <= MAX_DIM or z_cols.shape[1] != d:
        raise ValueError(f"embedding width must match and be <= {MAX_DIM}")
    bf16 = precision == "default"
    table_dtype = torch.bfloat16 if bf16 else torch.float32
    if bf16:
        same = z_cols is z_rows
        z_rows, rel, g = (None if t is None else t.to(table_dtype) for t in (z_rows, rel, g))
        z_cols = z_rows if same else z_cols.to(table_dtype)
    expect = {
        "z_rows": (z_rows, table_dtype, 2),
        "z_cols": (z_cols, table_dtype, 2),
        "ks": (ks, torch.int32, None),
        "rows": (rows, torch.int32, None),
        "cols": (cols, torch.int32, None),
    }
    if rel is not None:
        expect["rel"] = (rel, table_dtype, 3 if name == "bilinear" else 2)
    if g is not None:
        expect["glb"] = (g, table_dtype, 2)
    for key, (t, dtype, ndim) in expect.items():
        if t.dtype != dtype or t.device != z_rows.device or not t.is_contiguous():
            raise ValueError(
                f"{key} must be a contiguous {dtype} tensor on {z_rows.device}"
            )
        if ndim is not None and t.dim() != ndim:
            raise ValueError(f"{key} must have {ndim} dims")
    if rel is not None and tuple(rel.shape[1:]) != ((d, d) if name == "bilinear" else (d,)):
        raise ValueError(f"relation table shape {tuple(rel.shape)} does not fit d={d}")
    if g is not None and tuple(g.shape) != (d, d):
        raise ValueError(f"glb must be [{d}, {d}]")
    if not (ks.shape == rows.shape == cols.shape):
        raise ValueError("ks, rows and cols must have one shape")
    tables = [t for t in (z_rows, z_cols, rel, g) if t is not None]
    vl = 8 if bf16 else 4
    vl = vl if d % vl == 0 and all(t.data_ptr() % 16 == 0 for t in tables) else 1
    lib = cuda_build.library()
    with torch.cuda.device(z_rows.device):
        out = torch.empty(ks.shape, dtype=torch.float32, device=z_rows.device)
        status = lib.dt_sddmm(
            _MODES[name], int(bf16), z_rows.data_ptr(), z_cols.data_ptr(),
            None if rel is None else rel.data_ptr(),
            None if g is None else g.data_ptr(),
            ks.data_ptr(), rows.data_ptr(), cols.data_ptr(), out.data_ptr(),
            ks.numel(), d, z_rows.shape[0], z_cols.shape[0],
            0 if rel is None else rel.shape[0], vl,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(status, "sddmm")
    cuda_build.LAUNCHES["sddmm_bf16" if bf16 else "sddmm"] += 1
    return out
