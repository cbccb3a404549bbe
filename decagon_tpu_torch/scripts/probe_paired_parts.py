"""Where the paired forward's time goes, part by part, on the card (port of
the probe P3, ``scripts/probe_paired_parts.py``).

    python -m decagon_tpu_torch.scripts.probe_paired_parts

``paired_parts(mask, p4, mode, kb)`` runs K1/K2's sweep
(``csrc/paired_core.cuh``, entry ``dt_probe_parts`` of
``csrc/probe_paired.cu``) on a parts policy that does only part of the
work, for the mask ``[Km >= K, N, N]`` int8 and ``p4 [2, K, H, N]`` bf16,
after K1/K2's operand pass at unit column scales; each returns ``[H, N]``
f32:

- ``dma_only``: the sweep's copies (the ``cp.async`` ring) of every tile
  ``two_dots`` stages, without conversion or products; the output is
  zeros;
- ``one_dot``: ``sum_k po_k B_k`` (stages, converts and multiplies the
  transposed tile and ``po`` only);
- ``two_dots``: ``sum_k pe_k B_k^T + po_k B_k``: K1/K2 at unit scales, bit
  for bit;
- ``m128_dot``: ``sum_k (pe_k B_k) + (po_k B_k)``: one mask orientation
  (the transposed tile, staged alone) against both operands, the TPU
  probe's single 128-row product.

``paired_parts_ref`` is the plain version.  Tolerance: the mask converts
to bf16 exactly and products of bf16 values are exact in f32, so only the
order of the f32 sums differs: max error <= 1e-5 of the largest output
(``dma_only``: zeros, exactly).

The cut (``probe_paired_idioms.cut``): ``kb=None`` takes
``spmm_paired.paired_schedule``'s at the occupancy the card reports for
the mode's instantiation (``probe_info``); an int ``kb`` gives ``ceil(K /
kb)`` relation ranges over the whole contraction.

``main`` runs the TPU probe's sweep at its shapes (K = 963 relations of a
``[964, 645, 645]`` int8 stack with 1% ones, H = 64, from a seed): every
mode at ``kb`` 4 and 8 and at the schedule's cut.  It checks each variant
against its plain version, times it with CUDA events, and prints the TPU
probe's keys (``<mode>_kb<kb>``, ``<mode>_sched``; ms) with each GB/s over
the bytes the variant must read, then one JSON object naming the card.
"""

from __future__ import annotations

import ctypes
import functools
import json
import sys
import types
from typing import List, Mapping, Optional, Sequence

import torch

from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts import probing
from decagon_tpu_torch.scripts.probe_paired_idioms import cut

K, N, H = 963, 645, 64
KPAD = 964
DENSITY = 0.01
MODES = ("dma_only", "one_dot", "two_dots", "m128_dot")
_CODES = {"dma_only": probing.DMA, "one_dot": probing.TRANS, "two_dots": probing.BOTH,
          "m128_dot": probing.M128}
KBS = (4, 8)
REPS = 10
TILE = 64  # nodes of a node tile (``TM`` in ``csrc/paired_core.cuh``)


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


def paired_parts(mask: torch.Tensor, p4: torch.Tensor, mode: str,
                 kb: Optional[int] = None) -> torch.Tensor:
    """``[H, N]`` f32 of ``mode``: the sweep for CUDA tensors (mask int8
    ``[Km >= K, N, N]``, ``p4`` bf16 ``[2, K, H <= 64, N]``, both
    contiguous; the cut ``cut(kb)``), ``paired_parts_ref`` for CPU
    tensors."""
    if mode not in _CODES:
        raise ValueError(f"unknown mode {mode!r}")
    if kb is not None and kb < 1:
        raise ValueError(f"kb must be None or >= 1, got {kb}")
    if p4.device.type == "cpu":
        return paired_parts_ref(mask, p4, mode)
    if p4.device.type != "cuda":
        raise ValueError(f"paired_parts runs on cuda or cpu, not {p4.device}")
    check_operands("paired_parts", mask, p4, (torch.int8,))
    return launch("probe_paired_parts", mask, p4, None, _CODES[mode], kb)


def check_operands(name: str, mask: torch.Tensor, p4: torch.Tensor, mask_dtypes) -> None:
    """Raise unless ``p4`` is bf16 ``[2, K, 1..64, N]`` and the mask one of
    ``mask_dtypes`` ``[>= K, N, N]``, both contiguous on ``p4``'s device."""
    if p4.dim() != 4 or p4.shape[0] != 2 or p4.dtype != torch.bfloat16:
        raise ValueError(f"p4 must be bf16 [2, K, H, N], got {p4.dtype} {tuple(p4.shape)}")
    _, k, h, n = p4.shape
    if mask.dtype not in mask_dtypes or mask.dim() != 3 or mask.shape[0] < k or \
            tuple(mask.shape[1:]) != (n, n):
        kinds = " or ".join(str(d).replace("torch.", "") for d in mask_dtypes)
        raise ValueError(f"mask must be {kinds} [>= {k}, {n}, {n}], got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if not 1 <= h <= probing.MAX_H:
        raise ValueError(f"H must be in 1..{probing.MAX_H}, got {h}")
    probing.check_on(name, p4.device, mask=mask, p4=p4)


@functools.lru_cache(maxsize=None)
def probe_info(mode: int, mask_bf16: bool, stages: int, device_index: int) -> Mapping[str, int]:
    """What the card gives the instantiation of ``dt_probe_parts`` for
    (mode code, mask type, ring depth): registers a thread, blocks an SM,
    shared and local bytes, and the SMs (``spmm_paired.kernel_info``'s
    fields); queried once a device."""
    info = (ctypes.c_int * 4)()
    lib = cuda_build.library()
    with torch.cuda.device(device_index):
        status = lib.dt_probe_parts_info(mode, int(mask_bf16), stages, ctypes.addressof(info))
    cuda_build.check(status, "probe_paired info")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return types.MappingProxyType(dict(
        registers=info[0], blocks_per_sm=info[1], smem_bytes=info[2], local_bytes=info[3],
        sms=sms))


def small_t_splits(k: int, n: int, h: int, kb: Optional[int], sms: int,
                   blocks_per_sm: int) -> int:
    """small_t's relation splits: ``ceil(k / kb)`` for an int ``kb``; for
    ``kb=None`` the count of least ``spmm_paired``'s cost (whole waves of
    its grid of node-tile pairs times the longest block's steps, each a
    one-chunk relation with its epilogue, plus a block's fill), ties to
    fewer splits."""
    from decagon_tpu_torch.ops import spmm_paired as sp

    if kb is not None:
        if kb < 1:
            raise ValueError(f"kb must be None or >= 1, got {kb}")
        return -(-k // kb)
    pairs = (-(-n // TILE)) ** 2 * -(-h // TILE)
    wave = sms * blocks_per_sm
    cap = max(sp._MAX_WAVES * wave, pairs)
    best = None
    for rs in range(1, k + 1):
        if pairs * rs > cap:
            break
        cost = -(-pairs * rs // wave) * (-(-k // rs) * (1 + sp._EPILOGUE_STEPS) + sp._BLOCK_STEPS)
        if best is None or cost < best[0]:
            best = (cost, rs)
    return best[1]


def probe_cut(mode: int, k: int, n: int, h: int, kb: Optional[int], sms: int,
              blocks_per_sm: int):
    """``(rel_splits, con_splits)`` of a ``dt_probe_parts`` call: small_t's
    ``small_t_splits`` over a whole contraction, every other mode
    ``cut(kb)`` (``kb=None``: ``paired_schedule``'s)."""
    if mode == probing.SMALL_T:
        return small_t_splits(k, n, h, kb, sms, blocks_per_sm), 1
    sched = cut(k, n, h, kb, sms, blocks_per_sm)
    return sched.rel_splits, sched.con_splits


def small_t_blocks(k: int, n: int, h: int, rel_splits: int):
    """Each small_t block's work in launch order (``blockIdx`` x fastest,
    then y, then z), with the kernel's integer arithmetic: ``(R, C,
    hslice, k0, k1, split)``; the block stages ``B_k[R, C]`` for ``k0 <= k
    < k1``."""
    tiles = -(-n // TILE)
    for z in range(-(-h // TILE)):
        for y in range(rel_splits):
            k0, k1 = k * y // rel_splits, k * (y + 1) // rel_splits
            for x in range(tiles * tiles):
                r, c = divmod(x, tiles)
                yield r, c, z, k0, k1, y


def small_t_terms(n: int, rel_splits: int, t: int):
    """The partials small_t's last pass adds for node tile ``t``, in its
    order: ``(split, R, C, half)`` with the direct partials of (t, C), C =
    0.., then the transposed ones of (R, t), R = 0.., split by split."""
    tiles = -(-n // TILE)
    out = []
    for s in range(rel_splits):
        out.extend((s, t, c, 0) for c in range(tiles))
        out.extend((s, r, t, 1) for r in range(tiles))
    return out


def launch(name: str, mask: torch.Tensor, p4: torch.Tensor, sc: Optional[torch.Tensor],
           mode: int, kb: Optional[int], stages: int = 3) -> torch.Tensor:
    """One call of ``dt_probe_parts`` (P2's and P3's sweep, its operand
    pass and its last pass): ``[H, N]`` f32, counted under ``name``; the
    wrapper has checked the operands.  The cut is ``probe_cut``'s at the
    instantiation's occupancy."""
    _, k, h, n = p4.shape
    dev = p4.device
    mask_bf16 = mask.dtype == torch.bfloat16
    info = probe_info(mode, mask_bf16, stages, dev.index or 0)
    bps = max(1, info["blocks_per_sm"])
    rs, cs = probe_cut(mode, k, n, h, kb, info["sms"], bps)
    tiles = -(-n // TILE)
    shape = (rs, tiles * tiles, 2, TILE, h) if mode == probing.SMALL_T else (rs * cs, n, h)
    with torch.cuda.device(dev):
        partial = torch.empty(shape, dtype=torch.float32, device=dev)
        q = torch.empty((2, k, -(-h // 16) * 16, tiles * TILE), dtype=torch.bfloat16, device=dev)
        out = torch.empty((h, n), dtype=torch.float32, device=dev)
        status = cuda_build.library().dt_probe_parts(
            mask.data_ptr(), int(mask_bf16), p4.data_ptr(), 0 if sc is None else sc.data_ptr(),
            mode, stages, q.data_ptr(), partial.data_ptr(), out.data_ptr(), k, n, h, rs, cs,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(status, name)
    cuda_build.LAUNCHES[name] += 1
    return out


def make_inputs(device, seed: int = 0, k: int = K, n: int = N, h: int = H, kpad: int = KPAD):
    """The mask ``[kpad, n, n]`` int8 (ones with probability ``DENSITY``)
    and ``p4 [2, k, h, n]`` bf16 standard normals, from ``seed``, made on
    ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    mask = (torch.rand((kpad, n, n), generator=g, device=device) < DENSITY).to(torch.int8)
    p4 = torch.randn((2, k, h, n), generator=g, device=device).to(torch.bfloat16)
    return mask, p4


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
             kbs: Sequence[Optional[int]] = KBS + (None,)) -> List[probing.Variant]:
    """Every mode at each of ``kbs`` (``None``: the schedule's cut, case
    ``<mode>_sched``)."""
    out = []
    for mode in MODES:
        nbytes, flops = part_bytes_flops(mask, p4, mode)
        for kb in kbs:
            out.append(probing.Variant(
                key=f"{mode}_" + ("sched" if kb is None else f"kb{kb}"),
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
    rows = probing.run(variants(mask, p4), REPS, plain_reps=2)
    out = {}
    for r in rows:
        out[r["case"]] = r["ms"]
        out[f"{r['case']}_gbps"] = r["gbps"]
    print(json.dumps({"probe": "paired_parts", "device": smi, "reps": REPS, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
