"""Where the paired forward's time goes, part by part, on the card (port of
the probe P3, ``scripts/probe_paired_parts.py``).

    python -m decagon_tpu_torch.scripts.probe_paired_parts

``paired_parts(mask, p4, mode, kb)`` runs a variant of K1/K2's former
kernel, the WMMA design (``csrc/probe_paired.cu``, on that design's tiles,
byte-wide staging and accumulation; the sweep ``csrc/paired_core.cuh``
has since replaced it) that does only part of the work, for the mask ``[Km >= K, N, N]`` int8 and
``p4 [2, K, H, N]`` bf16, ``kb`` relations a block; each returns
``[H, N]`` f32:

- ``dma_only``: stages every operand as ``two_dots`` does and skips the
  products; the output is zeros;
- ``one_dot``: ``sum_k po_k B_k`` (stages the transposed mask tile and
  ``po`` only);
- ``two_dots``: ``sum_k pe_k B_k^T + po_k B_k`` (K1's work without its
  scales);
- ``m128_dot``: ``sum_k (pe_k B_k) + (po_k B_k)``: one mask orientation
  against both operands, the TPU probe's single 128-row product.

``paired_parts_ref`` is the plain version.  Tolerance: the mask converts
to bf16 exactly and products of bf16 values are exact in f32, so only the
order of the f32 sums differs: max error <= 1e-5 of the largest output
(``dma_only``: zeros, exactly).

``main`` runs the TPU probe's sweep at its shapes (K = 963 relations of a
``[964, 645, 645]`` int8 stack with 1% ones, H = 64, from a seed): every
mode at ``kb`` 4 and 8, and at the relations per block that the WMMA
design took at the same shape (``k1_kb``), so the parts add up against
that design's time.  It
checks each variant against its plain version, times it with CUDA
events, and prints the TPU probe's keys (``<mode>_kb<kb>``, ms) with each
GB/s over the bytes the variant must read, then one JSON object naming
the card.
"""

from __future__ import annotations

import json
import sys
from typing import List, Sequence

import torch

from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts import probing

K, N, H = 963, 645, 64
KPAD = 964
DENSITY = 0.01
MODES = ("dma_only", "one_dot", "two_dots", "m128_dot")
_CODES = {"dma_only": probing.DMA, "one_dot": probing.TRANS, "two_dots": probing.BOTH,
          "m128_dot": probing.M128}
KBS = (4, 8)
REPS = 10


def paired_parts_ref(mask: torch.Tensor, p4: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain version of ``paired_parts``: ``[H, N]`` f32."""
    if mode not in _CODES:
        raise ValueError(f"unknown mode {mode!r}")
    k, h, n = p4.shape[1:]
    if mode == "dma_only":
        return torch.zeros((h, n), dtype=torch.float32, device=p4.device)
    b = mask[:k].float()
    pe, po = p4[0].float(), p4[1].float()
    xo = torch.matmul(po, b)
    if mode == "one_dot":
        return xo.sum(0)
    xe = torch.matmul(pe, b.transpose(1, 2) if mode == "two_dots" else b)
    return (xe + xo).sum(0)


def paired_parts(mask: torch.Tensor, p4: torch.Tensor, mode: str, kb: int = 4) -> torch.Tensor:
    """``[H, N]`` f32 of ``mode``: the CUDA kernel for CUDA tensors (mask
    int8 ``[Km >= K, N, N]``, ``p4`` bf16 ``[2, K, H <= 64, N]``, both
    contiguous), ``paired_parts_ref`` for CPU tensors."""
    if mode not in _CODES:
        raise ValueError(f"unknown mode {mode!r}")
    if p4.device.type == "cpu":
        return paired_parts_ref(mask, p4, mode)
    if p4.device.type != "cuda":
        raise ValueError(f"paired_parts runs on cuda or cpu, not {p4.device}")
    if p4.dim() != 4 or p4.shape[0] != 2 or p4.dtype != torch.bfloat16:
        raise ValueError(f"p4 must be bf16 [2, K, H, N], got {p4.dtype} {tuple(p4.shape)}")
    _, k, h, n = p4.shape
    if mask.dtype != torch.int8 or mask.dim() != 3 or mask.shape[0] < k or \
            tuple(mask.shape[1:]) != (n, n):
        raise ValueError(f"mask must be int8 [>= {k}, {n}, {n}], got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if not 1 <= h <= probing.MAX_H or kb < 1:
        raise ValueError(f"H must be in 1..{probing.MAX_H} and kb >= 1, got {h}, {kb}")
    probing.check_on("paired_parts", p4.device, mask=mask, p4=p4)
    return probing.launch_paired("probe_paired_parts", mask, p4[0], p4[1], h * n, None,
                                 _CODES[mode], probing.HN, (h, n), k, n, h, kb)


def make_inputs(device, seed: int = 0, k: int = K, n: int = N, h: int = H, kpad: int = KPAD):
    """The mask ``[kpad, n, n]`` int8 (ones with probability ``DENSITY``)
    and ``p4 [2, k, h, n]`` bf16 standard normals, from ``seed``, made on
    ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    mask = (torch.rand((kpad, n, n), generator=g, device=device) < DENSITY).to(torch.int8)
    p4 = torch.randn((2, k, h, n), generator=g, device=device).to(torch.bfloat16)
    return mask, p4


def k1_kb(k: int, n: int, h: int, device) -> int:
    """The relations a block of K1's former WMMA design took at this shape
    on this card (``probing.wmma_relations_per_block``): the design this probe
    copies, not the sweep ``ops/spmm_paired.paired_fwd`` runs now."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return probing.wmma_relations_per_block(k, n, h, sms)


def part_bytes_flops(mask: torch.Tensor, p4: torch.Tensor, mode: str):
    """Bytes a variant must move (the mask's K relations and the operands
    it stages read once, the output written once) and its dense bf16
    operations (2 H N^2 a relation and product)."""
    _, k, h, n = p4.shape
    halves = 1 if mode == "one_dot" else 2
    nbytes = k * n * n * mask.element_size() + halves * k * h * n * 2 + h * n * 4
    products = {"dma_only": 0, "one_dot": 1}.get(mode, 2)
    return nbytes, products * 2 * h * n * n * k


def variants(mask: torch.Tensor, p4: torch.Tensor,
             kbs: Sequence[int] = KBS) -> List[probing.Variant]:
    """Every mode at each of ``kbs``."""
    out = []
    for mode in MODES:
        nbytes, flops = part_bytes_flops(mask, p4, mode)
        for kb in kbs:
            out.append(probing.Variant(
                key=f"{mode}_kb{kb}",
                kernel=lambda mode=mode, kb=kb: paired_parts(mask, p4, mode, kb),
                plain=lambda mode=mode: paired_parts_ref(mask, p4, mode),
                nbytes=nbytes, flops=flops,
            ))
    return out


def main() -> int:
    device = probing.require_card("probe_paired_parts")
    if device is None:
        return 1
    smi = probing.card()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    cuda_build.library()
    mask, p4 = make_inputs(device)
    kbs = tuple(sorted({*KBS, k1_kb(K, N, H, device)}))
    rows = probing.run(variants(mask, p4, kbs=kbs), REPS, plain_reps=2)
    out = {}
    for r in rows:
        out[r["case"]] = r["ms"]
        out[f"{r['case']}_gbps"] = r["gbps"]
    print(json.dumps({"probe": "paired_parts", "device": smi, "reps": REPS,
                      "k1_kb": k1_kb(K, N, H, device), **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
