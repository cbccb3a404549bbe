"""The paired forward's two orientations on the card (port of the probe
P2, ``scripts/probe_paired_orient.py``).

    python -m decagon_tpu_torch.scripts.probe_paired_orient

``paired_orient(mask, p4, sc, mode, kb)`` runs a variant of K1/K2's
kernel (``csrc/probe_paired.cu``) for the mask ``[Km >= K, N, N]`` (int8,
or bf16), ``p4 [2, K, H, N]`` bf16 and the row scales ``sc [Km >= K, 2,
N]`` f32 (``a_e``, ``a_o``, broadcast over H), ``kb`` relations a block;
each returns ``[H, N]`` f32 (a bf16 mask goes with ``both`` and
``small_t`` only, the variants the TPU probe's sweep runs on it):

- ``both``: ``sum_k a_e[k] (pe_k B_k^T) + a_o[k] (po_k B_k)``;
- ``xe_only``: the direct half only; ``xo_only``: the transposed half only;
- ``small_t``: what ``both`` computes, with each mask tile staged once
  and read in both orientations from shared memory (a block owns a whole
  ``[N, 64]`` output strip, so N <= 768), where the other modes stage
  the two orientations of each tile apart, as K1's former WMMA design did.

``paired_orient_ref`` is the plain version.  Tolerance: the mask converts
to bf16 exactly, products of bf16 values are exact in f32 and the scales
multiply f32 sums, so only the order of the f32 sums differs: max error
<= 1e-5 of the largest output.

``main`` runs the TPU probe's sweep at its shapes (K = 963 relations of a
``[964, 645, 645]`` stack with 1% ones, H = 64, from a seed): ``both``
with the int8 and the bf16 mask at ``kb`` 2, 4 and 8, then ``xe_only``,
``xo_only`` and ``small_t`` at ``kb`` 4 and 8.  It checks each variant
against its plain version, times it with CUDA events, and prints the TPU
probe's keys (``<mode>_<i8|bf16>_kb<kb>``, ms) with each GB/s over the
bytes the variant must read, then one JSON object naming the card.
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional, Sequence

import torch

from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts import probing
from decagon_tpu_torch.scripts.probe_paired_parts import DENSITY, H, K, KPAD, N, make_inputs

MODES = ("both", "xe_only", "xo_only", "small_t")
_CODES = {"both": probing.BOTH, "xe_only": probing.DIRECT, "xo_only": probing.TRANS,
          "small_t": probing.SMALL_T}
BF16_MODES = ("both", "small_t")
KBS = (2, 4, 8)
REPS = 10


def paired_orient_ref(mask: torch.Tensor, p4: torch.Tensor, sc: torch.Tensor,
                      mode: str) -> torch.Tensor:
    """Plain version of ``paired_orient``: ``[H, N]`` f32."""
    if mode not in _CODES:
        raise ValueError(f"unknown mode {mode!r}")
    k = p4.shape[1]
    b = mask[:k].float()
    out = 0.0
    if mode != "xo_only":
        out = out + sc[:k, 0:1, :] * torch.matmul(p4[0].float(), b.transpose(1, 2))
    if mode != "xe_only":
        out = out + sc[:k, 1:2, :] * torch.matmul(p4[1].float(), b)
    return out.sum(0)


def paired_orient(mask: torch.Tensor, p4: torch.Tensor, sc: torch.Tensor, mode: str = "both",
                  kb: int = 4) -> torch.Tensor:
    """``[H, N]`` f32 of ``mode``: the CUDA kernel for CUDA tensors (mask
    int8 or bf16 ``[Km >= K, N, N]``, ``p4`` bf16 ``[2, K, H <= 64, N]``,
    ``sc`` f32 ``[Km >= K, 2, N]``, all contiguous; ``small_t`` needs
    N <= 768), ``paired_orient_ref`` for CPU tensors."""
    if mode not in _CODES:
        raise ValueError(f"unknown mode {mode!r}")
    if mask.dtype == torch.bfloat16 and mode not in BF16_MODES:
        raise ValueError(f"a bf16 mask takes the modes {BF16_MODES}, not {mode!r}")
    if p4.device.type == "cpu":
        return paired_orient_ref(mask, p4, sc, mode)
    if p4.device.type != "cuda":
        raise ValueError(f"paired_orient runs on cuda or cpu, not {p4.device}")
    if p4.dim() != 4 or p4.shape[0] != 2 or p4.dtype != torch.bfloat16:
        raise ValueError(f"p4 must be bf16 [2, K, H, N], got {p4.dtype} {tuple(p4.shape)}")
    _, k, h, n = p4.shape
    if mask.dtype not in (torch.int8, torch.bfloat16) or mask.dim() != 3 or \
            mask.shape[0] < k or tuple(mask.shape[1:]) != (n, n):
        raise ValueError(f"mask must be int8 or bf16 [>= {k}, {n}, {n}], got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if sc.dtype != torch.float32 or sc.dim() != 3 or sc.shape[0] < k or \
            tuple(sc.shape[1:]) != (2, n):
        raise ValueError(f"sc must be float32 [>= {k}, 2, {n}], got {sc.dtype} "
                         f"{tuple(sc.shape)}")
    if not 1 <= h <= probing.MAX_H or kb < 1:
        raise ValueError(f"H must be in 1..{probing.MAX_H} and kb >= 1, got {h}, {kb}")
    if mode == "small_t" and n > probing.STRIP_MAX_N:
        raise ValueError(f"small_t keeps an [N, 64] strip in shared memory: N <= "
                         f"{probing.STRIP_MAX_N}, got {n}")
    probing.check_on("paired_orient", p4.device, mask=mask, p4=p4, sc=sc)
    return probing.launch_paired("probe_paired_orient", mask, p4[0], p4[1], h * n, sc,
                                 _CODES[mode], probing.HN, (h, n), k, n, h, kb)


def make_scales(device, seed: int = 0, kpad: int = KPAD, n: int = N) -> torch.Tensor:
    """``sc [kpad, 2, n]`` f32 uniforms in [0, 1) from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed + 1)
    return torch.rand((kpad, 2, n), generator=g, device=device)


def orient_bytes_flops(mask: torch.Tensor, p4: torch.Tensor, mode: str):
    """Bytes a variant must move (the mask's K relations, the halves of
    ``p4`` and the scale rows it uses, read once; the output written once)
    and its dense bf16 operations (2 H N^2 a relation and product)."""
    _, k, h, n = p4.shape
    halves = 2 if mode in ("both", "small_t") else 1
    nbytes = k * n * n * mask.element_size() + halves * (k * h * n * 2 + k * n * 4) + h * n * 4
    return nbytes, halves * 2 * h * n * n * k


def variants(mask8: torch.Tensor, p4: torch.Tensor, sc: torch.Tensor,
             mask16: Optional[torch.Tensor] = None,
             sweep: Sequence = (("both", KBS), ("xe_only", (4, 8)), ("xo_only", (4, 8)),
                                ("small_t", (4, 8)))) -> List[probing.Variant]:
    """``sweep``: (mode, kbs) pairs; ``both`` and ``small_t`` also run on
    ``mask16`` where it is given."""
    out = []
    for mode, kbs in sweep:
        masks = [("i8", mask8)]
        if mask16 is not None and mode in BF16_MODES:
            masks.append(("bf16", mask16))
        for tag, m in masks:
            nbytes, flops = orient_bytes_flops(m, p4, mode)
            for kb in kbs:
                out.append(probing.Variant(
                    key=f"{mode}_{tag}_kb{kb}",
                    kernel=lambda m=m, mode=mode, kb=kb: paired_orient(m, p4, sc, mode, kb),
                    plain=lambda m=m, mode=mode: paired_orient_ref(m, p4, sc, mode),
                    nbytes=nbytes, flops=flops,
                ))
    return out


def main() -> int:
    device = probing.require_card("probe_paired_orient")
    if device is None:
        return 1
    smi = probing.card()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    cuda_build.library()
    mask, p4 = make_inputs(device)
    sc = make_scales(device)
    rows = probing.run(variants(mask, p4, sc, mask.to(torch.bfloat16)), REPS, plain_reps=2)
    out = {}
    for r in rows:
        out[r["case"]] = r["ms"]
        out[f"{r['case']}_gbps"] = r["gbps"]
    print(json.dumps({"probe": "paired_orient", "device": smi, "reps": REPS, "density": DENSITY,
                      "shape": [K, N, H], **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
