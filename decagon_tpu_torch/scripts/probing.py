"""What the paired-kernel probes share (``probe_int8_bw``,
``probe_paired_parts``, ``probe_paired_orient``, ``probe_paired_bwd_idioms``,
``probe_paired_idioms``).

A probe is a list of ``Variant``s: a kernel call, its plain PyTorch version
on the same inputs, optionally the one PyTorch call that computes the same
function (a yardstick only), and the bytes and operations the function
needs.  ``check`` holds two kernel calls against each other (equal bits)
and against the plain version; ``time_variant`` times the three with CUDA
events after a warm-up (every probe's operands exceed the card's 50 MB L2
cache, so back-to-back calls read device memory) and sets each time beside
its bound on an H100 SXM.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from typing import Callable, Dict, List, Optional, Sequence

import torch

# Published peaks of one H100 SXM (NVIDIA data sheet, dense).
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12

# How a kernel is held to its plain version (each probe's docstring says
# why): equal bits; max error <= REL_TOL of the largest output; or bf16
# outputs elementwise within one bf16 ulp of the value plus BF16_FLOOR of
# the largest output.
EQUAL, REL, BF16 = "equal", "rel", "bf16"
REL_TOL = 1e-5
BF16_ULP = 2.0 ** -7
BF16_FLOOR = 1e-4


@dataclasses.dataclass
class Variant:
    key: str
    kernel: Callable[[], object]
    plain: Callable[[], object]
    nbytes: int
    flops: int = 0
    library: Optional[Callable[[], object]] = None
    hold: str = REL


def _tensors(out) -> List[torch.Tensor]:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def hold(got, want, rule: str) -> Dict[str, float]:
    """Max absolute and relative error of ``got`` against ``want`` (tensors
    or tuples of tensors); raises ``AssertionError`` beyond ``rule``."""
    worst_abs, worst_rel = 0.0, 0.0
    for g, w in zip(_tensors(got), _tensors(want)):
        if tuple(g.shape) != tuple(w.shape):
            raise AssertionError(f"shape {tuple(g.shape)} against {tuple(w.shape)}")
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        err = diff.max().item() if diff.numel() else 0.0
        scale = w.abs().max().item() if w.numel() else 0.0
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / scale if scale > 0 else (0.0 if err == 0 else float("inf")))
        if rule == EQUAL:
            ok = torch.equal(g, w)
        elif rule == REL:
            ok = err <= REL_TOL * scale
        elif rule == BF16:
            ok = bool((diff <= BF16_ULP * w.abs() + BF16_FLOOR * scale).all())
        else:
            raise ValueError(f"unknown rule {rule!r}")
        if not ok:
            raise AssertionError(
                f"kernel differs from its plain version: max error {err:.4g}, "
                f"{err / scale if scale else err:.4g} of the largest output (rule {rule})")
    return dict(max_abs_err=worst_abs, rel_err=worst_rel)


def check(v: Variant) -> Dict[str, object]:
    """Two kernel calls (equal bits) against the plain version (``v.hold``)."""
    got = v.kernel()
    again = v.kernel()
    want = v.plain()
    torch.cuda.synchronize()
    repeat = all(torch.equal(a, b) for a, b in zip(_tensors(got), _tensors(again)))
    if not repeat:
        raise AssertionError(f"{v.key}: two kernel calls differ")
    return dict(case=v.key, bitwise_repeat=repeat, **hold(got, want, v.hold))


def cuda_ms(fn: Callable[[], object], reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` in ms from CUDA events over ``reps``
    calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_variant(v: Variant, reps: int, plain_reps: Optional[int] = None) -> Dict[str, object]:
    """CUDA-event ms of the kernel, the plain version and the library call
    (None where there is none), the bytes and operations bounds, and the
    kernel's and the plain version's GB/s (10^9 bytes a second) over the
    bytes the function needs."""
    ms = cuda_ms(v.kernel, reps)
    plain_ms = cuda_ms(v.plain, plain_reps or reps)
    library_ms = None if v.library is None else cuda_ms(v.library, reps)
    bytes_ms = v.nbytes / HBM_BYTES_S * 1e3
    ops_ms = v.flops / BF16_FLOPS * 1e3
    return dict(
        case=v.key, ms=ms, gbps=v.nbytes / ms / 1e6, plain_ms=plain_ms,
        plain_gbps=v.nbytes / plain_ms / 1e6, library_ms=library_ms,
        bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        x_bound=ms / max(bytes_ms, ops_ms),
    )


def run(variants: Sequence[Variant], reps: int, plain_reps: Optional[int] = None) -> List[Dict]:
    """``check`` and ``time_variant`` of each variant, one JSON line each."""
    rows = []
    for v in variants:
        row = {**check(v), **time_variant(v, reps, plain_reps)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def card() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def require_card(name: str) -> Optional[torch.device]:
    """The CUDA device, or None (with a message) where there is none: a
    probe measures the card and has nothing to say on the CPU."""
    if not torch.cuda.is_available():
        print(f"{name}: no CUDA device; the probe measures the card only", file=sys.stderr)
        return None
    from decagon_tpu_torch import resolve_device

    return resolve_device("cuda")



# Codes of ``dt_probe_paired``'s forward variants (``Mode`` in
# ``csrc/probe_paired.cu``) and its two layouts.
DIRECT, TRANS, BOTH, M128, DMA, SMALL_T = 1, 2, 3, 4, 5, 6
HN, NAUG = 0, 1
AUG = 128  # P1's operand and output row width
MAX_H = 64  # one hidden slice
STRIP_MAX_N = 768  # small_t keeps a [N, 64] f32 strip in shared memory


def wmma_relations_per_block(k: int, n: int, h: int, sms: int) -> int:
    """The relations a block of K1's former WMMA design took (its split
    rule, frozen here): enough (64-node tile, 64-column slice, split)
    blocks to give every SM four, at most one split a relation.
    ``csrc/probe_paired.cu`` copies that design, so P1-P3 keep measuring
    it at its own shapes."""
    tiles = -(-n // 64) * -(-h // 64)
    splits = max(1, min(k, -(-4 * sms // tiles)))
    return -(-k // splits)


def check_on(name: str, device: torch.device, **tensors) -> None:
    """Raise unless every tensor is contiguous and on ``device``."""
    for label, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {label} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def launch_paired(name: str, mask: torch.Tensor, pe: torch.Tensor, po: torch.Tensor,
                  p_rel: int, sc: Optional[torch.Tensor], mode: int, layout: int,
                  out_shape, k: int, n: int, h: int, kb: int) -> torch.Tensor:
    """One call of ``dt_probe_paired`` (the forward probes' kernels, with
    the pass that adds the per-block partials in order), counted under
    ``name``; the wrapper has checked the operands."""
    from decagon_tpu_torch.ops import cuda_build

    lib = cuda_build.library()
    splits = -(-k // kb)
    with torch.cuda.device(mask.device):
        count = out_shape[0] * out_shape[1]
        partial = torch.empty((splits, count), dtype=torch.float32, device=mask.device)
        out = torch.empty(out_shape, dtype=torch.float32, device=mask.device)
        status = lib.dt_probe_paired(
            mask.data_ptr(), int(mask.dtype == torch.bfloat16), pe.data_ptr(), po.data_ptr(),
            p_rel, 0 if sc is None else sc.data_ptr(), mode, layout, partial.data_ptr(),
            out.data_ptr(), k, n, h, kb, torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(status, name)
    cuda_build.LAUNCHES[name] += 1
    return out
