"""The paired forward's contract on the card (port of the probe P1,
``scripts/probe_paired_idioms.py``).

    python -m decagon_tpu_torch.scripts.probe_paired_idioms

``paired(mask, pe_aug, po_aug)`` is a kernel of ``csrc/probe_paired.cu``
(K1/K2's tiles in the node-major layout of the TPU probe): for the int8
mask ``[K, N, N]`` and ``pe_aug``, ``po_aug [K, N, 128]`` bf16, whose
columns ``:H`` hold the operands ``pe_k``, ``po_k [N, H]`` and column
``H`` the row scales ``a_e``, ``a_o`` (so the scales are bf16-rounded),

    out[:, :H] = sum_k a_e[k] * (B_k @ pe_k) + a_o[k] * (B_k^T @ po_k)

and ``out[:, H:] = 0``, ``[N, 128]`` f32.  ``paired_ref`` is the plain
version.  Tolerance: the mask converts to bf16 exactly and the products
of bf16 values are exact in f32, so only the order of the f32 sums
differs: max error <= 1e-5 of the largest output.

``main`` does what the TPU probe's ``main`` does, on the card: K = 4,
N = 645, H = 64 from numpy draws (seed 0), the kernel against a float64
numpy oracle with f32 scales (max error < 2e-2 of the largest output, the
TPU probe's bound), then the kernel against its plain version and its
CUDA-event time at K = 963 (a ``[963, 645, 645]`` stack with 1% ones), at
one relation a block (the TPU probe's grid) and at the relations a block
of K1's former WMMA design;
last, one JSON object naming the card.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts import probing
from decagon_tpu_torch.scripts.probe_paired_parts import k1_kb

N, H, K = 645, 64, 4
K_FULL = 963
DENSITY = 0.01
REPS = 10
AUG = probing.AUG


def paired_ref(mask: torch.Tensor, pe_aug: torch.Tensor, po_aug: torch.Tensor,
               h: int = H) -> torch.Tensor:
    """Plain version of ``paired``: ``[N, 128]`` f32."""
    b = mask.float()
    xe = torch.matmul(b, pe_aug[..., :h].float())
    xo = torch.matmul(b.transpose(1, 2), po_aug[..., :h].float())
    out = torch.zeros((mask.shape[1], AUG), dtype=torch.float32, device=mask.device)
    out[:, :h] = (pe_aug[..., h:h + 1].float() * xe + po_aug[..., h:h + 1].float() * xo).sum(0)
    return out


def paired(mask: torch.Tensor, pe_aug: torch.Tensor, po_aug: torch.Tensor, h: int = H,
           kb: int = 1) -> torch.Tensor:
    """``[N, 128]`` f32 of ``paired_ref``: the CUDA kernel for CUDA tensors
    (mask int8 ``[K, N, N]``, ``pe_aug`` and ``po_aug`` bf16 ``[K, N,
    128]``, all contiguous, ``1 <= h <= 64``; ``kb`` relations a block, one
    as in the TPU probe's grid), the plain version for CPU tensors."""
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
    if not 1 <= h <= probing.MAX_H or kb < 1:
        raise ValueError(f"h must be in 1..{probing.MAX_H} and kb >= 1, got {h}, {kb}")
    probing.check_on("paired", mask.device, mask=mask, pe_aug=pe_aug, po_aug=po_aug)
    return probing.launch_paired("probe_paired_idioms", mask, pe_aug, po_aug, n * AUG, None,
                                 probing.BOTH, probing.NAUG, (n, AUG), k, n, h, kb)


def numpy_inputs(k: int = K, n: int = N, h: int = H, seed: int = 0):
    """The TPU probe's draws: the mask ``[k, n, n]`` int8, ``pe``, ``po``
    ``[k, n, h]`` and ``ae``, ``ao`` ``[k, n]`` f32, and the augmented
    arrays ``pe_aug``, ``po_aug`` ``[k, n, 128]`` f32 (to be cast to bf16)."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((k, n, n)) < DENSITY).astype(np.int8)
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
            kb: int = 1) -> probing.Variant:
    """Bytes: the mask read once, the ``h + 1`` used columns of both
    augmented arrays read once, the output written once; operations: two
    dense bf16 products of 2 h N^2 a relation."""
    k, n = mask.shape[0], mask.shape[1]
    return probing.Variant(
        key=f"paired_K{k}_kb{kb}", kernel=lambda: paired(mask, pe_aug, po_aug, h, kb),
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
    kbs = (1, k1_kb(K_FULL, N, H, device))
    full = probing.run([variant(*full_inputs, kb=kb) for kb in kbs], REPS, plain_reps=2)
    print(json.dumps({"probe": "paired_idioms", "device": smi, "reps": REPS,
                      "oracle_rel_err": err, "rows": small + full}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
