"""What the kernel probes share (``probe_int8_bw``, ``probe_paired_parts``,
``probe_paired_orient``, ``probe_paired_bwd_idioms``, ``probe_paired_idioms``,
``probe_adam_onepass``, ``probe_sparse_kernels``) and ``chip_smoke.py``
uses: the timers (``cuda_ms``, ``device_ms``), the card's name, and the
paper-scale cases of the sparse kernels (``spmm_cases``, ``sddmm_cases``).

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


def device_ms(fns, iters: int) -> float:
    """Mean device ms of one call over ``iters`` calls that take ``fns`` in
    turn: each called once to warm up, then the ``iters`` calls captured
    in one CUDA graph, whose second replay is timed with CUDA events.
    What the host spends issuing a call (Python, ctypes, the launch) stays
    out of the replay, so a leaf of a few MB reads its kernels' time and
    not its wrapper's; with ``fns`` over ``rotation`` copies of a case, a
    call finds its operands in HBM, as the update of a step does, and not
    in the L2 where the previous call left them."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


# Codes of ``dt_probe_parts``'s modes (``Mode`` in ``csrc/probe_paired.cu``).
DIRECT, TRANS, BOTH, M128, DMA, SMALL_T = 1, 2, 3, 4, 5, 6
MAX_H = 64  # one hidden slice


def check_on(name: str, device: torch.device, **tensors) -> None:
    """Raise unless every tensor is contiguous and on ``device``."""
    for label, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {label} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def spmm_cases(dg, params):
    """K6's cases on a sparse-regime device graph: (label, P_flat, forward?,
    layout) for every edge type and both layers, the forward over the
    projected stack and the backward over a seeded cotangent on the
    transposed layout, with the sparse path's own operands."""
    from decagon_tpu_torch.models.encoder import _project, encode_layer

    h1 = encode_layer(params, dg, "enc1", dg.features, True, "pallas")
    gen = torch.Generator(device=dg.device).manual_seed(11)
    cases = []
    for key, adj in sorted(dg.adj.items()):
        src = key.split(",")[1]
        for layer, level, feat in (("layer 1", "enc1", dg.features[src]),
                                   ("layer 2", "enc2", h1[src])):
            p = _project(feat, params[level][key])
            h = p.shape[-1]
            cases.append((f"({key}) {layer} forward", p.reshape(-1, h).contiguous(), True,
                          adj.tiles_fwd))
            ct = torch.randn((adj.n_rows, h), generator=gen, device=dg.device)
            cases.append((f"({key}) {layer} backward", ct, False, adj.tiles_bwd))
    return cases


def sddmm_cases(dg, params, emb, splits, seed, shuffled=False):
    """K5's cases: (label, z_rows, z_cols, ks, rows, cols, decoder kwargs).
    DEDICOM over the pooled drug-drug validation sweep (positives and
    negatives of every (1,1) relation, relation by relation, as
    ``evaluate_all_drug_drug`` scores them); with ``shuffled``, the same
    sweep in a seeded random order; bilinear over as many random PPI
    pairs, on relations 0 and 1 of (0,0)."""
    import numpy as np

    parts = [
        (k, e) for (i, j, k), sp in sorted(splits.items()) if (i, j) == (1, 1)
        for e in (sp.val, sp.val_false)
    ]
    ks = np.concatenate([np.full(e.shape[0], k, np.int32) for k, e in parts])
    edges = np.concatenate([e for _, e in parts]).astype(np.int32)
    dev = emb["1"].device
    ks, rows, cols = (
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in (ks, edges[:, 0], edges[:, 1])
    )
    b = ks.numel()
    dd = params["dec"]["1,1"]
    g = torch.Generator(device=dev).manual_seed(seed)
    n_p = dg.num_nodes[0]
    pk = torch.randint(0, 2, (b,), generator=g, device=dev, dtype=torch.int32)
    pr = torch.randint(0, n_p, (b,), generator=g, device=dev, dtype=torch.int32)
    pc = torch.randint(0, n_p, (b,), generator=g, device=dev, dtype=torch.int32)
    z1, z0 = emb["1"].contiguous(), emb["0"].contiguous()
    ded = dict(name="dedicom", glb=dd["global"], rel_diag=dd["local_diag"])
    cases = [("dedicom (1,1) validation sweep", z1, z1, ks, rows, cols, ded)]
    if shuffled:
        perm = torch.randperm(b, generator=torch.Generator().manual_seed(seed)).to(dev)
        cases.append(("dedicom (1,1) validation sweep, shuffled", z1, z1,
                      *(a[perm].contiguous() for a in (ks, rows, cols)), ded))
    cases.append(("bilinear (0,0) random pairs", z0, z0, pk, pr, pc,
                  dict(name="bilinear", rel_full=params["dec"]["0,0"]["relation"])))
    return cases
