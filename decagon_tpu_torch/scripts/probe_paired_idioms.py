"""The paired forward's contract on the card (port of the probe P1,
``scripts/probe_paired_idioms.py``).

    python -m decagon_tpu_torch.scripts.probe_paired_idioms

``paired(mask, pe_aug, po_aug)`` runs K1/K2's sweep (``csrc/paired_core.cuh``,
entry ``dt_paired_fwd_aug`` of ``csrc/paired_fwd.cu``) in the TPU probe's
node-major layout: for the int8 mask ``[K, N, N]`` and ``pe_aug``,
``po_aug [K, N, 128]`` bf16, whose columns ``:H`` hold the operands
``pe_k``, ``po_k [N, H]`` and column ``H`` the row scales ``a_e``, ``a_o``
(so the scales are bf16-rounded),

    out[:, :H] = sum_k a_e[k] * (B_k @ pe_k) + a_o[k] * (B_k^T @ po_k)

and ``out[:, H:] = 0``, ``[N, 128]`` f32: K1/K2's function with unit
column scales.  The sweep reads the operands' rows as they lie (no
operand pass) and applies the row scales in registers.  ``paired_ref`` is
the plain version.  Tolerance: the mask converts to bf16 exactly and the
products of bf16 values are exact in f32, so only the order of the f32
sums differs: max error <= 1e-5 of the largest output.

The cut (``cut``): ``kb=None`` takes ``spmm_paired.paired_schedule``'s, the
forward's own (relations and, where they leave waves unfilled, the
contraction split); an int ``kb`` splits the relations into ``ceil(K /
kb)`` ranges of at most ``kb`` each and leaves the contraction whole
(``kb = 1``: the TPU probe's grid, one relation a block).

``main`` does what the TPU probe's ``main`` does, on the card: K = 4,
N = 645, H = 64 from numpy draws (seed 0), the kernel against a float64
numpy oracle with f32 scales (max error < 2e-2 of the largest output, the
TPU probe's bound), then the kernel against its plain version and its
CUDA-event time at K = 963 (a ``[963, 645, 645]`` stack with 1% ones), at
one relation a block (the TPU probe's grid) and at the schedule's cut,
and K1/K2 (``spmm_paired.paired_fwd``, operand pass included) on the same
inputs (``as_forward``) with its largest difference from P1; last, one
JSON object naming the card.
"""

from __future__ import annotations

import json
import sys
from typing import Optional

import numpy as np
import torch

from decagon_tpu_torch.ops import cuda_build, spmm_paired
from decagon_tpu_torch.scripts import probing

N, H, K = 645, 64, 4
K_FULL = 963
DENSITY = 0.01
REPS = 10
AUG = 128  # the operands' and the output's row width


def paired_ref(mask: torch.Tensor, pe_aug: torch.Tensor, po_aug: torch.Tensor,
               h: int = H) -> torch.Tensor:
    """Plain version of ``paired``: ``[N, 128]`` f32."""
    b = mask.float()
    xe = torch.matmul(b, pe_aug[..., :h].float())
    xo = torch.matmul(b.transpose(1, 2), po_aug[..., :h].float())
    out = torch.zeros((mask.shape[1], AUG), dtype=torch.float32, device=mask.device)
    out[:, :h] = (pe_aug[..., h:h + 1].float() * xe + po_aug[..., h:h + 1].float() * xo).sum(0)
    return out


def as_forward(mask: torch.Tensor, pe_aug: torch.Tensor, po_aug: torch.Tensor,
               h: int = H):
    """K1/K2's operands for P1's inputs: ``p4 [2, K, h, N]`` bf16 (the
    columns ``:h``, transposed) and ``scales [K, 4, N]`` f32 (``a_e``,
    ``a_o`` from column ``h``, unit column scales), so that
    ``spmm_paired.paired_fwd(p4, mask, scales).t()`` is ``out[:, :h]``."""
    p4 = torch.stack([pe_aug[..., :h].transpose(1, 2), po_aug[..., :h].transpose(1, 2)])
    a_e, a_o = pe_aug[..., h].float(), po_aug[..., h].float()
    ones = torch.ones_like(a_e)
    return p4.contiguous(), torch.stack([a_e, a_o, ones, ones], dim=1).contiguous()


def cut(k: int, n: int, h: int, kb: Optional[int], sms: int,
        blocks_per_sm: int) -> spmm_paired.PairedSchedule:
    """The schedule of a call on ``sms`` SMs of ``blocks_per_sm`` blocks:
    ``paired_schedule``'s cut for ``kb=None``, else ``ceil(k / kb)``
    relation ranges (at most ``kb`` relations each) over the whole
    contraction."""
    if kb is None:
        return spmm_paired.paired_schedule(k, n, h, sms, blocks_per_sm)
    if kb < 1:
        raise ValueError(f"kb must be None or >= 1, got {kb}")
    return spmm_paired.schedule_at(k, n, h, sms, blocks_per_sm, -(-k // kb), 1)


def paired(mask: torch.Tensor, pe_aug: torch.Tensor, po_aug: torch.Tensor, h: int = H,
           kb: Optional[int] = None) -> torch.Tensor:
    """``[N, 128]`` f32 of ``paired_ref``: the sweep for CUDA tensors (mask
    int8 ``[K, N, N]``, ``pe_aug`` and ``po_aug`` bf16 ``[K, N, 128]``, all
    contiguous and 16-byte aligned, ``1 <= h <= 64``; the cut ``cut(kb)``
    at the occupancy the card reports for the forward's sweep), the plain
    version for CPU tensors."""
    if mask.device.type == "cpu":
        return paired_ref(mask, pe_aug, po_aug, h)
    if mask.device.type != "cuda":
        raise ValueError(f"paired runs on cuda or cpu, not {mask.device}")
    if mask.dtype != torch.int8 or mask.dim() != 3 or mask.shape[1] != mask.shape[2]:
        raise ValueError(f"mask must be int8 [K, N, N], got {mask.dtype} {tuple(mask.shape)}")
    k, n = mask.shape[0], mask.shape[1]
    for label, t in (("pe_aug", pe_aug), ("po_aug", po_aug)):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != (k, n, AUG):
            raise ValueError(f"{label} must be bf16 [{k}, {n}, {AUG}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if not 1 <= h <= probing.MAX_H:
        raise ValueError(f"h must be in 1..{probing.MAX_H}, got {h}")
    probing.check_on("paired", mask.device, mask=mask, pe_aug=pe_aug, po_aug=po_aug)
    if pe_aug.data_ptr() % 16 or po_aug.data_ptr() % 16:
        raise ValueError("paired: pe_aug and po_aug must be 16-byte aligned")
    with torch.cuda.device(mask.device):
        info = spmm_paired.kernel_info("fwd", mask.device.index)
        sched = cut(k, n, h, kb, info["sms"], max(1, info["blocks_per_sm"]))
        partial = torch.empty((sched.partials, n, h), dtype=torch.float32, device=mask.device)
        out = torch.empty((n, AUG), dtype=torch.float32, device=mask.device)
        status = cuda_build.library().dt_paired_fwd_aug(
            mask.data_ptr(), pe_aug.data_ptr(), po_aug.data_ptr(), partial.data_ptr(),
            out.data_ptr(), k, n, h, sched.rel_splits, sched.con_splits,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(status, "probe_paired_idioms")
    cuda_build.LAUNCHES["probe_paired_idioms"] += 1
    return out


def numpy_inputs(k: int = K, n: int = N, h: int = H, seed: int = 0,
                 density: float = DENSITY):
    """The TPU probe's draws: the mask ``[k, n, n]`` int8, ``pe``, ``po``
    ``[k, n, h]`` and ``ae``, ``ao`` ``[k, n]`` f32, and the augmented
    arrays ``pe_aug``, ``po_aug`` ``[k, n, 128]`` f32 (to be cast to bf16)."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((k, n, n)) < density).astype(np.int8)
    pe = rng.standard_normal((k, n, h)).astype(np.float32)
    po = rng.standard_normal((k, n, h)).astype(np.float32)
    ae = rng.random((k, n)).astype(np.float32)
    ao = rng.random((k, n)).astype(np.float32)
    pe_aug = np.zeros((k, n, AUG), np.float32)
    po_aug = np.zeros((k, n, AUG), np.float32)
    pe_aug[:, :, :h], po_aug[:, :, :h] = pe, po
    pe_aug[:, :, h], po_aug[:, :, h] = ae, ao
    return mask, pe, po, ae, ao, pe_aug, po_aug


def oracle_error(mask, pe, po, ae, ao, out: np.ndarray) -> float:
    """The TPU probe's check: ``out[:, :H]`` against float64 numpy with the
    f32 scales, as a share of the largest output."""
    want = np.zeros((mask.shape[1], pe.shape[2]))
    for k in range(mask.shape[0]):
        b = mask[k].astype(np.float64)
        want += ae[k][:, None] * (b @ pe[k]) + ao[k][:, None] * (b.T @ po[k])
    return float(np.abs(out[:, :pe.shape[2]] - want).max() / (np.abs(want).max() + 1e-9))


def device_inputs(device, k: int = K_FULL, n: int = N, h: int = H, seed: int = 0):
    """Mask ``[k, n, n]`` int8 (1% ones) and ``pe_aug``, ``po_aug [k, n,
    128]`` bf16 (standard normals in ``:h``, uniform scales in ``h``,
    zeros past it), from ``seed``, made on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    mask = (torch.rand((k, n, n), generator=g, device=device) < DENSITY).to(torch.int8)
    augs = []
    for _ in range(2):
        a = torch.zeros((k, n, AUG), device=device)
        a[..., :h] = torch.randn((k, n, h), generator=g, device=device)
        a[..., h] = torch.rand((k, n), generator=g, device=device)
        augs.append(a.to(torch.bfloat16))
    return mask, augs[0], augs[1]


def variant(mask: torch.Tensor, pe_aug: torch.Tensor, po_aug: torch.Tensor, h: int = H,
            kb: Optional[int] = None) -> probing.Variant:
    """Case ``paired_K<k>_kb<kb>`` (``_sched`` for the schedule's cut).
    Bytes: the mask read once, the ``h + 1`` used columns of both
    augmented arrays read once, the output written once; operations: two
    dense bf16 products of 2 h N^2 a relation."""
    k, n = mask.shape[0], mask.shape[1]
    return probing.Variant(
        key=f"paired_K{k}_" + ("sched" if kb is None else f"kb{kb}"),
        kernel=lambda: paired(mask, pe_aug, po_aug, h, kb),
        plain=lambda: paired_ref(mask, pe_aug, po_aug, h),
        nbytes=k * n * n + 2 * k * n * (h + 1) * 2 + n * AUG * 4,
        flops=2 * 2 * h * n * n * k,
    )


def main() -> int:
    device = probing.require_card("probe_paired_idioms")
    if device is None:
        return 1
    smi = probing.card()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    cuda_build.library()
    mask, pe, po, ae, ao, pe_aug, po_aug = numpy_inputs()
    args = (torch.from_numpy(mask).to(device),
            torch.from_numpy(pe_aug).to(device, torch.bfloat16),
            torch.from_numpy(po_aug).to(device, torch.bfloat16))
    out = paired(*args)
    err = oracle_error(mask, pe, po, ae, ao, out.cpu().numpy())
    print(f"max rel err: {err}", flush=True)
    assert err < 2e-2, err
    print("PAIRED IDIOMS OK", flush=True)
    small = probing.run([variant(*args)], REPS)
    full_inputs = device_inputs(device)
    full = probing.run([variant(*full_inputs, kb=kb) for kb in (1, None)], REPS, plain_reps=2)
    # K1/K2 on the same inputs: the main path's kernel, with its operand pass.
    mask = full_inputs[0]
    p4, scales = as_forward(*full_inputs)
    k1_diff = (paired(*full_inputs)[:, :H] - spmm_paired.paired_fwd(p4, mask, scales).t())
    k1 = dict(ms=probing.cuda_ms(lambda: spmm_paired.paired_fwd(p4, mask, scales), REPS),
              max_abs_diff=k1_diff.abs().max().item())
    print(json.dumps({"probe": "paired_idioms", "device": smi, "reps": REPS,
                      "oracle_rel_err": err, "rows": small + full, "k1_same_inputs": k1}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
