"""The paired forward's two orientations on the card (port of the probe
P2, ``scripts/probe_paired_orient.py``).

    python -m decagon_tpu_torch.scripts.probe_paired_orient

``paired_orient(mask, p4, sc, mode, kb)`` runs K1/K2's sweep
(``csrc/paired_core.cuh``, entry ``dt_probe_parts`` of
``csrc/probe_paired.cu``) on a parts policy, for the mask ``[Km >= K, N,
N]`` (int8, or bf16), ``p4 [2, K, H, N]`` bf16 and the row scales ``sc
[Km >= K, 2, N]`` f32 (``a_e``, ``a_o``, broadcast over H), after K1/K2's
operand pass at unit column scales; each returns ``[H, N]`` f32 (a bf16
mask goes with ``both`` and ``small_t`` only, the variants the TPU probe's
sweep runs on it):

- ``both``: ``sum_k a_e[k] (pe_k B_k^T) + a_o[k] (po_k B_k)``: K1/K2 on
  ``as_forward_scales(sc)`` (unit column scales), bit for bit at the same
  cut;
- ``xe_only``: the direct half only; ``xo_only``: the transposed half only;
- ``small_t``: what ``both`` computes, with each mask tile staged once and
  read in both orientations (a block owns a pair of node tiles; each half
  writes a partial of its 64 nodes, and a last pass adds them in a fixed
  order, ``probe_paired_parts.small_t_terms``), where the other modes
  stage the two orientations of each tile apart, as the sweep does.

A bf16 mask is staged at two bytes a cell; ``stages`` (3 or 2, a bf16
``both`` only) is the ring's depth: three stages fit one block an SM, two
fit two.  The cut: ``probe_paired_parts.launch``'s (``kb=None`` the
schedule's at the instantiation's occupancy, an int ``kb`` ``ceil(K /
kb)`` relation ranges; small_t cuts only the relations).

``paired_orient_ref`` is the plain version.  Tolerance: the mask converts
to bf16 exactly, products of bf16 values are exact in f32 and the scales
multiply f32 sums, so only the order of the f32 sums differs: max error
<= 1e-5 of the largest output.

``main`` runs the TPU probe's sweep at its shapes (K = 963 relations of a
``[964, 645, 645]`` stack with 1% ones, H = 64, from a seed): ``both``
with the int8 and the bf16 mask at ``kb`` 2, 4 and 8 and the schedule's
cut (the bf16 mask at both ring depths), then ``xe_only``, ``xo_only``
and ``small_t`` at ``kb`` 4 and 8 and the schedule's cut.  It checks each
variant against its plain version, times it with CUDA events, and prints
the TPU probe's keys (``<mode>_<i8|bf16>_kb<kb>``, ``..._sched``; ms) with
each GB/s over the bytes the variant must move, then one JSON object
naming the card.
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional, Sequence

import torch

from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts import probing
from decagon_tpu_torch.scripts import probe_paired_parts as parts
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


def as_forward_scales(sc: torch.Tensor, k: int) -> torch.Tensor:
    """K1/K2's ``scales [k, 4, N]`` for P2's row scales: ``sc``'s rows
    ``a_e``, ``a_o`` and unit column scales, so that ``both`` is
    ``spmm_paired.paired_fwd(p4, mask[:k], as_forward_scales(sc, k))``."""
    rows = sc[:k]
    return torch.cat([rows, torch.ones_like(rows)], dim=1).contiguous()


def paired_orient(mask: torch.Tensor, p4: torch.Tensor, sc: torch.Tensor, mode: str = "both",
                  kb: Optional[int] = None, stages: int = 3) -> torch.Tensor:
    """``[H, N]`` f32 of ``mode``: the sweep for CUDA tensors (mask int8 or
    bf16 ``[Km >= K, N, N]``, ``p4`` bf16 ``[2, K, H <= 64, N]``, ``sc``
    f32 ``[Km >= K, 2, N]``, all contiguous), ``paired_orient_ref`` for CPU
    tensors."""
    if mode not in _CODES:
        raise ValueError(f"unknown mode {mode!r}")
    if mask.dtype == torch.bfloat16 and mode not in BF16_MODES:
        raise ValueError(f"a bf16 mask takes the modes {BF16_MODES}, not {mode!r}")
    if kb is not None and kb < 1:
        raise ValueError(f"kb must be None or >= 1, got {kb}")
    if stages not in (2, 3) or (stages == 2 and not (mode == "both" and
                                                     mask.dtype == torch.bfloat16)):
        raise ValueError(f"stages is 3, or 2 for a bf16 mask's both; got {stages} for {mode!r}")
    if p4.device.type == "cpu":
        return paired_orient_ref(mask, p4, sc, mode)
    if p4.device.type != "cuda":
        raise ValueError(f"paired_orient runs on cuda or cpu, not {p4.device}")
    parts.check_operands("paired_orient", mask, p4, (torch.int8, torch.bfloat16))
    _, k, _, n = p4.shape
    if sc.dtype != torch.float32 or sc.dim() != 3 or sc.shape[0] < k or \
            tuple(sc.shape[1:]) != (2, n):
        raise ValueError(f"sc must be float32 [>= {k}, 2, {n}], got {sc.dtype} "
                         f"{tuple(sc.shape)}")
    probing.check_on("paired_orient", p4.device, sc=sc)
    return parts.launch("probe_paired_orient", mask, p4, sc, _CODES[mode], kb, stages)


def make_scales(device, seed: int = 0, kpad: int = KPAD, n: int = N) -> torch.Tensor:
    """``sc [kpad, 2, n]`` f32 uniforms in [0, 1) from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed + 1)
    return torch.rand((kpad, 2, n), generator=g, device=device)


def orient_bytes_flops(mask: torch.Tensor, p4: torch.Tensor, mode: str,
                       small_t_splits: int = 0):
    """Bytes a variant must move (the mask's K relations, the halves of
    ``p4`` and the scale rows it uses, read once; the output written once;
    small_t's partials, ``small_t_splits`` x pairs x 2 x 64 x H f32, written
    and read once) and its dense bf16 operations (2 H N^2 a relation and
    product)."""
    _, k, h, n = p4.shape
    halves = 2 if mode in ("both", "small_t") else 1
    nbytes = k * n * n * mask.element_size() + halves * (k * h * n * 2 + k * n * 4) + h * n * 4
    if mode == "small_t":
        nbytes += 2 * small_t_splits * (-(-n // parts.TILE)) ** 2 * 2 * parts.TILE * h * 4
    return nbytes, halves * 2 * h * n * n * k


def _small_t_splits(mask: torch.Tensor, p4: torch.Tensor, kb: Optional[int]) -> int:
    """small_t's relation splits for a call on ``p4``'s device (0 off the
    card: the plain version has no partials)."""
    _, k, h, n = p4.shape
    if p4.device.type != "cuda":
        return 0
    info = parts.probe_info(probing.SMALL_T, mask.dtype == torch.bfloat16, 3,
                            p4.device.index or 0)
    return parts.small_t_splits(k, n, h, kb, info["sms"], max(1, info["blocks_per_sm"]))


def variants(mask8: torch.Tensor, p4: torch.Tensor, sc: torch.Tensor,
             mask16: Optional[torch.Tensor] = None,
             sweep: Sequence = (("both", KBS + (None,)), ("xe_only", (4, 8, None)),
                                ("xo_only", (4, 8, None)), ("small_t", (4, 8, None))),
             bf16_stages: Sequence[int] = (3, 2)) -> List[probing.Variant]:
    """``sweep``: (mode, kbs) pairs (``None``: the schedule's cut, case
    ``..._sched``); ``both`` and ``small_t`` also run on ``mask16`` where it
    is given, ``both`` there at each of ``bf16_stages`` (cases ``..._s2``
    for two stages)."""
    out = []
    for mode, kbs in sweep:
        masks = [("i8", mask8, (3,))]
        if mask16 is not None and mode in BF16_MODES:
            masks.append(("bf16", mask16, bf16_stages if mode == "both" else (3,)))
        for tag, m, stage_set in masks:
            for kb in kbs:
                splits = _small_t_splits(m, p4, kb) if mode == "small_t" else 0
                nbytes, flops = orient_bytes_flops(m, p4, mode, splits)
                for stages in stage_set:
                    out.append(probing.Variant(
                        key=f"{mode}_{tag}_" + ("sched" if kb is None else f"kb{kb}")
                        + ("" if stages == 3 else f"_s{stages}"),
                        kernel=lambda m=m, mode=mode, kb=kb, stages=stages: paired_orient(
                            m, p4, sc, mode, kb, stages),
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
