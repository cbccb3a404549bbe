"""Where the paired forward's time goes on the card, part by part, in the
sweep design (``csrc/paired_core.cuh``, ``csrc/paired_fwd.cu``).

    python -m decagon_tpu_torch.scripts.probe_paired_sweep

``sweep_variant(p4, mask, scales, ds, variant)`` runs the forward's sweep
kernel alone (``dt_probe_paired_sweep``, ``csrc/probe_paired_sweep.cu``:
the same sweep kernel, on parts policies of ``paired_core.cuh`` that
switch a part off), cut by the same
``paired_schedule`` as ``ops/spmm_paired.paired_fwd``, and sums its
partials; each returns ``outT [H, N]`` f32:

- ``sweep``: the main path's sweep on operand planes written beforehand
  (the result of ``paired_fwd``);
- ``staging``: its 16-byte copies and the mask's conversion, without the
  products (zeros);
- ``products``: its products on zeroed shared memory, without copies or
  conversion (zeros).

``sweep_variant_ref`` is the plain version: ``paired_ref`` /
``paired_ref_ds`` for ``sweep``, zeros for the parts.  Tolerance: the same roundings and exact products, f32 sums in
another order, so 1e-5 of the largest output (``probing.REL``); the
parts' zeros exactly.

``main`` runs the main path's four forward shapes (drug-drug K = 963,
N = 645 and PPI K = 1, N = 19,081; layer 1 f32 H = 64 with keep-scales,
layer 2 bf16 H = 32; masks with 1% ones, operands and scales from a
seed): each variant and the whole ``paired_fwd`` call, checked against
the plain versions and timed with CUDA events, with each part's share of
the sweep; last, one JSON object naming the card.
"""

from __future__ import annotations

import json
import sys

import torch

from decagon_tpu_torch.ops import cuda_build, spmm_paired
from decagon_tpu_torch.scripts import probing

VARIANTS = {"sweep": 0, "staging": 1, "products": 2}
SHAPES = (("(1,1) layer 1 f32", 963, 645, 64, True), ("(1,1) layer 2 bf16", 963, 645, 32, False),
          ("(0,0) layer 1 f32", 1, 19081, 64, True), ("(0,0) layer 2 bf16", 1, 19081, 32, False))
DENSITY = 0.01
REPS = 10


def sweep_variant_ref(p4, mask, scales, ds, variant: str) -> torch.Tensor:
    """Plain version of ``sweep_variant``."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if variant in ("staging", "products"):
        return torch.zeros((p4.shape[2], p4.shape[3]), dtype=torch.float32, device=p4.device)
    if ds is None:
        return spmm_paired.paired_ref(p4, mask, scales)
    return spmm_paired.paired_ref_ds(p4, mask, scales, ds)


def _planes(p4, scales, ds, sched) -> torch.Tensor:
    """The operand pass's planes ``[2, K, Hq, Npad]`` bf16, from the plain
    ``paired_operands``, zero-padded."""
    q = spmm_paired.paired_operands(p4, scales, ds)
    return torch.nn.functional.pad(
        q, (0, sched.npad - q.shape[3], 0, sched.hq - q.shape[2])).contiguous()


def sweep_variant(p4, mask, scales, ds, variant: str, planes=None) -> torch.Tensor:
    """``outT [H, N]`` f32 of ``variant``: the CUDA kernel for CUDA tensors
    (``paired_fwd``'s operands; ``planes`` from ``_planes`` may be passed
    in, else they are made here, outside the kernel), the plain version
    for CPU tensors."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if p4.device.type == "cpu":
        return sweep_variant_ref(p4, mask, scales, ds, variant)
    spmm_paired._check_fwd_args(p4, mask, scales, ds)
    _, k, h, n = p4.shape
    lib = cuda_build.library()
    with torch.cuda.device(p4.device):
        sched = spmm_paired.launch_schedule("fwd", k, n, h, p4.device)
        if planes is None:
            planes = _planes(p4, scales, ds, sched)
        if (planes.dtype != torch.bfloat16 or not planes.is_contiguous()
                or tuple(planes.shape) != (2, k, sched.hq, sched.npad)):
            raise ValueError(f"planes must be contiguous bf16 [2, {k}, {sched.hq}, "
                             f"{sched.npad}], got {planes.dtype} {tuple(planes.shape)}")
        partial = torch.empty((sched.partials, n, h), dtype=torch.float32, device=p4.device)
        status = lib.dt_probe_paired_sweep(
            mask.data_ptr(), scales.data_ptr(), planes.data_ptr(), partial.data_ptr(),
            k, n, h, sched.rel_splits, sched.con_splits, VARIANTS[variant],
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(status, "probe_paired_sweep")
    cuda_build.LAUNCHES["probe_paired_sweep"] += 1
    return partial.sum(0).t()


def make_inputs(device, k: int, n: int, h: int, f32: bool, seed: int = 0):
    """Mask (1% ones), scales, keep-scales (with f32 operands) and p4 (f32
    or bf16) from ``seed``, made on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    mask = (torch.rand((k, n, n), generator=g, device=device) < DENSITY).to(torch.int8)
    scales = torch.rand((k, 4, n), generator=g, device=device)
    p4 = torch.randn((2, k, h, n), generator=g, device=device)
    ds = None
    if f32:
        keep = torch.rand((k, 2, n), generator=g, device=device) < 0.9
        ds = torch.where(keep, 1 / 0.9, 0.0).float()
    else:
        p4 = p4.to(torch.bfloat16)
    return mask, scales, ds, p4


def variants(label, mask, scales, ds, p4):
    """``probing.Variant``s of each sweep variant and of the whole call."""
    _, k, h, n = p4.shape
    nbytes = mask.numel() + p4.numel() * p4.element_size() + scales.numel() * 4 + n * h * 4
    flops = 4 * h * int(torch.count_nonzero(mask))
    sched = spmm_paired.launch_schedule("fwd", k, n, h, p4.device)
    planes = _planes(p4, scales, ds, sched)
    out = [probing.Variant(
        key=f"{label} call", kernel=lambda: spmm_paired.paired_fwd(p4, mask, scales, ds),
        plain=lambda: sweep_variant_ref(p4, mask, scales, ds, "sweep"),
        nbytes=nbytes, flops=flops)]
    for name in VARIANTS:
        out.append(probing.Variant(
            key=f"{label} {name}",
            kernel=lambda name=name: sweep_variant(p4, mask, scales, ds, name, planes),
            plain=lambda name=name: sweep_variant_ref(p4, mask, scales, ds, name),
            nbytes=nbytes, flops=flops,
            hold=probing.EQUAL if name in ("staging", "products") else probing.REL))
    return out


def main() -> int:
    device = probing.require_card("probe_paired_sweep")
    if device is None:
        return 1
    smi = probing.card()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    cuda_build.library()
    out = {}
    for label, k, n, h, f32 in SHAPES:
        mask, scales, ds, p4 = make_inputs(device, k, n, h, f32)
        rows = probing.run(variants(label, mask, scales, ds, p4), REPS, plain_reps=1)
        ms = {r["case"][len(label) + 1:]: r["ms"] for r in rows}
        ms["staging_share"] = ms["staging"] / ms["sweep"]
        ms["products_share"] = ms["products"] / ms["sweep"]
        out[label] = ms
        print(json.dumps({label: ms}), flush=True)
        del mask, scales, ds, p4
        torch.cuda.empty_cache()
    print(json.dumps({"probe": "paired_sweep", "device": smi, "reps": REPS, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
