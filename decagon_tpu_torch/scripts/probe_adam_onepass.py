"""One-pass Adam kernel against the eager chain on the card (port of the
probe P6, ``scripts/probe_adam_onepass.py``).

    python -m decagon_tpu_torch.scripts.probe_adam_onepass

At P6's leaf shape ``[1926, 64, 645]`` it runs two cases: bf16 g, m, v
with f32 p (P6's), and f32 throughout (``pallas_adam``'s in-place leaves),
each through the one-leaf entry ``adam_onepass`` of the multi-tensor
kernel K7.  Each case first checks one
kernel call against ``adam_onepass_ref`` (bit for bit, in place), then
times 20 calls on the device alone (``probing.device_ms``: one CUDA graph
of the calls, replayed between CUDA events, each call on operands that
are not in the L2 cache): the eager chain
(``adam_onepass_ref``), the kernel at each block size of the sweep (P6
swept its TPU block ``lb`` instead), and, for f32,
``torch.optim.Adam(fused=True).step()``, the library call that computes
the same update (a yardstick only).  Each time comes with its GB/s over the
bytes one pass must move and the bytes bound at 3.35 TB/s (H100 SXM).
Prints one JSON object as its last line.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional

import torch

from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.ops.optim import adam_onepass, adam_onepass_ref
from decagon_tpu_torch.scripts import probing

SHAPE = (1926, 64, 645)
ITERS = 20  # timed calls per variant
HBM_BYTES_S = 3.35e12  # H100 SXM
L2_BYTES = 50 * 2**20  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, outside the tensor cores
# P6's scalars: s1, s2 fixed, lr 1e-3, TF1 Adam's b1, b2, eps.
SCALARS = dict(s1=1.1, s2=1.05, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
# The kernel rounds each operation on its own in the chain's order, so it
# should equal the plain version bit for bit; the fallback bound, 1e-6 of
# each output's largest magnitude, admits a last-bit difference in sqrt
# or division and nothing beyond.
REL_TOL = 1e-6


def onepass_bytes(n: int, moments_dtype: torch.dtype) -> int:
    """Least bytes one Adam pass over ``n`` elements moves: g, m, v, p read
    once, m, v, p written once (p f32; g, m, v in ``moments_dtype``)."""
    item = torch.empty((), dtype=moments_dtype).element_size()
    return n * (5 * item + 2 * 4)


def onepass_flops(n: int) -> int:
    """f32 operations of one Adam element: 12 multiplies and adds, a square
    root and a division."""
    return n * 14


def make_case(shape, dtype, device, seed: int = 0, offset: int = 0) -> List[torch.Tensor]:
    """g, m, v in ``dtype`` and f32 p of ``shape`` (standard normals, v
    made positive), each a view ``offset`` elements into its storage."""
    n = 1
    for d in shape:
        n *= d
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(dt, positive=False):
        x = torch.randn(n + offset, generator=g, device=device)
        x = x.abs() if positive else x
        return x.to(dt)[offset:].view(shape)

    return [draw(dtype), draw(dtype), draw(dtype, positive=True), draw(torch.float32)]


def copy_at_offset(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` in a storage of its own, at ``x``'s storage offset
    (so with ``x``'s alignment)."""
    off = x.storage_offset()
    out = torch.empty(off + x.numel(), dtype=x.dtype, device=x.device)[off:].view(x.shape)
    return out.copy_(x)


def rotation(n: int, dtype: torch.dtype) -> int:
    """How many copies of a case of ``n`` elements ``probing.device_ms`` takes in
    turn so that at least 4x the L2 cache of other operands passes between
    two uses of one copy (1 where the case alone is that large)."""
    footprint = n * (3 * torch.empty((), dtype=dtype).element_size() + 4)
    return 1 if footprint >= 4 * L2_BYTES else 1 + -(-4 * L2_BYTES // footprint)


def library_ms(sets, iters: int) -> Optional[float]:
    """``torch.optim.Adam(fused=True).step()``, one optimizer for each case
    ``(g, m, v, p)`` of ``sets``, taken in turn (the same update up to the
    order of its operations; ``capturable`` so that ``probing.device_ms`` can
    capture it), or None where it does not take the dtypes (bf16 moments
    beside f32 parameters)."""
    if sets[0][0].dtype != torch.float32:
        return None
    steps = []
    for g, m, v, p in sets:
        q = p.detach().clone().requires_grad_(True)
        q.grad = g.clone()
        opt = torch.optim.Adam([q], lr=SCALARS["lr"], betas=(SCALARS["b1"], SCALARS["b2"]),
                               eps=SCALARS["eps"], fused=True, capturable=True)
        opt.step()
        state = opt.state[q]
        state["exp_avg"].copy_(m)
        state["exp_avg_sq"].copy_(v)
        steps.append(opt.step)
    return probing.device_ms(steps, iters)


def run_case(label: str, case: List[torch.Tensor], iters: int,
             block_sizes=(256,), time_it: bool = True) -> Dict:
    """One kernel call against ``adam_onepass_ref`` on copies of the same
    inputs, then the times.  The kernel must update in place and match
    the plain version bit for bit, or, failing that, within ``REL_TOL`` of
    each output's largest magnitude (``bitwise`` says which); raises
    otherwise."""
    g, m, v, p = case
    got = [copy_at_offset(x) for x in (m, v, p)]
    want = [copy_at_offset(x) for x in (m, v, p)]
    ptrs = [x.data_ptr() for x in got]
    adam_onepass(g, *got, **SCALARS, block_threads=block_sizes[-1])
    adam_onepass_ref(g, *want, **SCALARS)
    torch.cuda.synchronize()
    in_place = [x.data_ptr() for x in got] == ptrs
    bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
    errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
    rel = max(e / max(b.float().abs().max().item(), 1e-30) for e, b in zip(errs, want))
    n = p.numel()
    nbytes = onepass_bytes(n, g.dtype)
    row = dict(
        case=label, shape=list(p.shape), dtype=str(g.dtype).replace("torch.", ""),
        aligned=all(x.data_ptr() % 16 == 0 for x in (g, m, v, p)),
        max_abs_err=max(errs), rel_err=rel, bitwise=bitwise, in_place=in_place,
        bytes_ms=nbytes / HBM_BYTES_S * 1e3, ops_ms=onepass_flops(n) / F32_FLOPS * 1e3,
    )
    if not (in_place and (bitwise or rel <= REL_TOL)):
        raise AssertionError(f"adam {label}: kernel differs from its plain version "
                             f"(relative error {rel:.3g}, in place {in_place})")
    if time_it:
        time_case(row, case, iters, block_sizes)
    return row


def time_case(row: Dict, case: List[torch.Tensor], iters: int, block_sizes=(256,)) -> Dict:
    """Adds to ``row`` the device times of the plain chain, the kernel at
    each block size and the library call, each over ``rotation`` copies
    of ``case``, and their GB/s."""
    g, p = case[0], case[3]
    n = p.numel()
    nbytes = onepass_bytes(n, g.dtype)
    sets = [[copy_at_offset(x) for x in case] for _ in range(rotation(n, g.dtype))]
    row["copies"] = len(sets)
    row["plain_ms"] = probing.device_ms(
        [lambda c=c: adam_onepass_ref(*c, **SCALARS) for c in sets], iters)
    row["block_ms"] = {
        b: probing.device_ms([lambda c=c, b=b: adam_onepass(*c, **SCALARS, block_threads=b)
                      for c in sets], iters)
        for b in block_sizes
    }
    row["ms"] = min(row["block_ms"].values())
    row["library_ms"] = library_ms(sets, iters)
    row["gb_s"] = nbytes / row["ms"] / 1e6
    row["plain_gb_s"] = nbytes / row["plain_ms"] / 1e6
    return row


def main() -> int:
    device = probing.require_card("probe_adam_onepass")
    if device is None:
        return 1
    smi = probing.card()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    cuda_build.library()
    rows = []
    for label, dtype in (("P6: bf16 g/m/v, f32 p", torch.bfloat16),
                         ("K7 contract: f32 throughout", torch.float32)):
        row = run_case(label, make_case(SHAPE, dtype, device), ITERS,
                       block_sizes=(64, 128, 256))
        print(json.dumps(row), flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    print(json.dumps({"probe": "adam_onepass", "device": smi, "iters": ITERS,
                      "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
