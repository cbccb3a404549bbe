"""The paired backward's contract on the card (port of the probe P4,
``scripts/probe_paired_bwd_idioms.py``).

    python -m decagon_tpu_torch.scripts.probe_paired_bwd_idioms

``paired_bwd(mask, ctT, sc)`` runs K3/K4's kernel (``csrc/paired_bwd.cu``,
entry ``dt_paired_bwd_unscaled``: the sweep of ``csrc/paired_core.cuh``
with unit column scales and bf16 out, at the cut
``spmm_paired.launch_schedule("bwd", ...)``): per relation k of the int8
mask ``[K, N, N]``, from the cotangent ``ctT [H, N]`` f32 and the row
scales ``sc [K, 2, N]`` f32,

    de[k] = bf16(bf16(a_e[k] * ctT) @ B_k)      # [H, N], K3's d[0]
    do[k] = bf16(bf16(a_o[k] * ctT) @ B_k^T)    # K3's d[1]

bf16 rounding to nearest even, with the cast before the product.
``paired_bwd_ref`` is the plain version.  Tolerance: both round the same
operands and the products are exact, so only the f32 sums' order
differs, and that can flip a bf16 output to its neighbour: elementwise
``2^-7 |want| + 1e-4 max|want|``.

``main`` does what the TPU probe's ``main`` does, on the card: K = 4,
N = 645, H = 64 from numpy draws (seed 0), the kernel against a float64
numpy oracle (max error < 2e-2 of the largest output, the TPU probe's
bound), then the kernel against its plain version and its CUDA-event
time at K = 963 (a ``[963, 645, 645]`` stack with 1% ones), and K3/K4
(``spmm_paired.paired_bwd``) on the same inputs (``as_backward``), with
whether the two agree bit for bit; last, one JSON object naming the card.
"""

from __future__ import annotations

import json
import sys
from typing import Tuple

import numpy as np
import torch

from decagon_tpu_torch.ops import cuda_build, spmm_paired
from decagon_tpu_torch.scripts import probing

N, H, K = 645, 64, 4
K_FULL = 963
DENSITY = 0.01
REPS = 10


def paired_bwd_ref(mask: torch.Tensor, ctT: torch.Tensor,
                   sc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``paired_bwd``: ``(de, do)``, each ``[K, H, N]`` bf16."""
    b = mask.float()
    ct = ctT.float()[None]
    cta_e = (sc[:, 0:1, :] * ct).to(torch.bfloat16).float()
    cta_o = (sc[:, 1:2, :] * ct).to(torch.bfloat16).float()
    de = torch.matmul(cta_e, b).to(torch.bfloat16)
    do = torch.matmul(cta_o, b.transpose(1, 2)).to(torch.bfloat16)
    return de, do


def as_backward(sc: torch.Tensor) -> torch.Tensor:
    """K3/K4's scales for P4's row scales: ``[K, 4, N]`` f32 with rows
    ``a_e``, ``a_o`` and unit column scales, so that
    ``spmm_paired.paired_bwd(ctT, mask, as_backward(sc), None, torch.bfloat16)``
    is ``paired_bwd``'s ``(de, do)`` stacked."""
    ones = torch.ones_like(sc[:, 0])
    return torch.stack([sc[:, 0], sc[:, 1], ones, ones], dim=1).contiguous()


def paired_bwd(mask: torch.Tensor, ctT: torch.Tensor,
               sc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(de, do)`` of ``paired_bwd_ref``: the sweep for CUDA tensors
    (mask int8 ``[K, N, N]``, ``ctT`` f32 ``[H, N]``, ``sc`` f32 ``[K, 2,
    N]``, all contiguous), the plain version for CPU tensors.  The two are
    the halves of one ``[2, K, H, N]`` output."""
    if ctT.device.type == "cpu":
        return paired_bwd_ref(mask, ctT, sc)
    if ctT.device.type != "cuda":
        raise ValueError(f"paired_bwd runs on cuda or cpu, not {ctT.device}")
    if ctT.dim() != 2 or ctT.dtype != torch.float32:
        raise ValueError(f"ctT must be float32 [H, N], got {ctT.dtype} {tuple(ctT.shape)}")
    h, n = ctT.shape
    if mask.dtype != torch.int8 or mask.dim() != 3 or tuple(mask.shape[1:]) != (n, n):
        raise ValueError(f"mask must be int8 [K, {n}, {n}], got {mask.dtype} {tuple(mask.shape)}")
    k = mask.shape[0]
    if sc.dtype != torch.float32 or tuple(sc.shape) != (k, 2, n):
        raise ValueError(f"sc must be float32 [{k}, 2, {n}], got {sc.dtype} {tuple(sc.shape)}")
    if k < 1 or h < 1:
        raise ValueError(f"K and H must be >= 1, got {k}, {h}")
    probing.check_on("paired_bwd", ctT.device, mask=mask, ctT=ctT, sc=sc)
    dev = ctT.device
    with torch.cuda.device(dev):
        sched = spmm_paired.launch_schedule("bwd", k, n, h, dev)
        q = torch.empty((2, k, sched.hq, sched.npad), dtype=torch.bfloat16, device=dev)
        d = torch.empty((2, k, h, n), dtype=torch.bfloat16, device=dev)
        partial = d if sched.con_splits == 1 else torch.empty(
            (sched.con_splits, 2, k, h, n), dtype=torch.float32, device=dev)
        status = cuda_build.library().dt_paired_bwd_unscaled(
            mask.data_ptr(), ctT.data_ptr(), sc.data_ptr(), q.data_ptr(), partial.data_ptr(),
            d.data_ptr(), k, n, h, sched.rel_splits, sched.con_splits,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(status, "probe_paired_bwd_idioms")
    cuda_build.LAUNCHES["probe_paired_bwd_idioms"] += 1
    return d[0], d[1]


def numpy_inputs(k: int = K, n: int = N, h: int = H, seed: int = 0,
                 density: float = DENSITY):
    """The TPU probe's draws: mask ``[k, n, n]`` int8, ``ct [n, h]`` f32,
    ``sc [k, 2, n]`` f32."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((k, n, n)) < density).astype(np.int8)
    ct = rng.standard_normal((n, h)).astype(np.float32)
    sc = rng.random((k, 2, n)).astype(np.float32)
    return mask, ct, sc


def oracle_error(mask: np.ndarray, ct: np.ndarray, sc: np.ndarray, de, do) -> float:
    """The TPU probe's check: each relation and half against float64
    numpy, as a share of the largest output; the worst one."""
    worst = 0.0
    for k in range(mask.shape[0]):
        b = mask[k].astype(np.float64)
        we = (b.T @ (sc[k, 0][:, None] * ct)).T
        wo = (b @ (sc[k, 1][:, None] * ct)).T
        for got, want in ((de[k], we), (do[k], wo)):
            worst = max(worst, float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9)))
    return worst


def device_inputs(device, k: int = K_FULL, n: int = N, h: int = H, seed: int = 0):
    """Mask ``[k, n, n]`` int8 (1% ones), ``ctT [h, n]`` and ``sc [k, 2,
    n]`` f32, from ``seed``, made on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    mask = (torch.rand((k, n, n), generator=g, device=device) < DENSITY).to(torch.int8)
    ctT = torch.randn((h, n), generator=g, device=device)
    sc = torch.rand((k, 2, n), generator=g, device=device)
    return mask, ctT, sc


def variant(mask: torch.Tensor, ctT: torch.Tensor, sc: torch.Tensor) -> probing.Variant:
    """Bytes: the mask, ``ctT`` and ``sc`` read once, both outputs written
    once; operations: two dense bf16 products of 2 H N^2 a relation."""
    k, (h, n) = mask.shape[0], ctT.shape
    return probing.Variant(
        key=f"paired_bwd_K{k}", kernel=lambda: paired_bwd(mask, ctT, sc),
        plain=lambda: paired_bwd_ref(mask, ctT, sc),
        nbytes=k * n * n + h * n * 4 + k * 2 * n * 4 + 2 * k * h * n * 2,
        flops=2 * 2 * h * n * n * k, hold=probing.BF16,
    )


def main() -> int:
    device = probing.require_card("probe_paired_bwd_idioms")
    if device is None:
        return 1
    smi = probing.card()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    cuda_build.library()
    mask, ct, sc = numpy_inputs()
    de, do = paired_bwd(*(torch.from_numpy(a).to(device) for a in (mask, ct.T.copy(), sc)))
    err = oracle_error(mask, ct, sc, de.float().cpu().numpy(), do.float().cpu().numpy())
    print(f"max rel err against numpy at K={K}: {err}", flush=True)
    assert err < 2e-2, err
    print("PAIRED BWD IDIOMS OK", flush=True)
    small = probing.run([variant(*(torch.from_numpy(a).to(device)
                                   for a in (mask, ct.T.copy(), sc)))], REPS)
    mask, ctT, sc = device_inputs(device)
    full = probing.run([variant(mask, ctT, sc)], REPS, plain_reps=2)
    # K3/K4 on the same inputs: the main path's kernel at unit column scales.
    scales = as_backward(sc)
    k3 = spmm_paired.paired_bwd(ctT, mask, scales, None, torch.bfloat16)
    k3 = dict(ms=probing.cuda_ms(
        lambda: spmm_paired.paired_bwd(ctT, mask, scales, None, torch.bfloat16), REPS),
        equal=all(torch.equal(a, b) for a, b in zip(paired_bwd(mask, ctT, sc), k3)))
    print(json.dumps({"probe": "paired_bwd_idioms", "device": smi, "reps": REPS,
                      "oracle_rel_err": err, "rows": small + full, "k3_same_inputs": k3}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
