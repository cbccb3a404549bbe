"""How the paired kernels' time depends on the cut of their work, on the
card: the calibration of ``ops/spmm_paired.paired_schedule``'s cost model.

    python -m decagon_tpu_torch.scripts.probe_paired_cuts [--out RECORD.json]
    python -m decagon_tpu_torch.scripts.probe_paired_cuts --fit RECORD.json

On the card, at each case of ``CASES`` (the shapes of ``chip_smoke.py``
phases 4 and 8: drug-drug K = 963, N = 645 and PPI K = 1, N = 19,081 at
layer 1, H = 64 f32 with keep-scales, and layer 2, H = 32 bf16; the
backward's synthetic K = 3, N = 5000, H = 64), it runs the forward
(``spmm_paired.run_fwd``) or the backward (``run_bwd``) at every cut that
``spmm_paired.schedule_cuts`` offers, holds each cut's result against
that of the cut ``paired_schedule`` picks (the sums' order differs: 1e-5
of the largest output, or the bf16 rule for bf16 outputs), and times it
with CUDA events (masks with 1% ones, operands and scales from a seed).
It writes the record (the card, its SMs and blocks an SM, each case's
cuts and their ms) to ``--out``, and prints one JSON line a case and,
last, the card and ``fit``'s result.

``fit(record)`` picks the cost model's two constants, a relation's
epilogue and a block's fixed cost in chunk steps: over a grid, the pair
whose cheapest cuts (``spmm_paired.cheapest_cut``) lose the least time
against each case's fastest measured cut, summed over the cases; ties go
to the pair whose costs best follow the measured times near the fastest
cut.  ``--fit`` runs it on a record, on any machine.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

from decagon_tpu_torch.ops import cuda_build, spmm_paired
from decagon_tpu_torch.scripts import probing

# (label, kernel, K, N, H, operand dtype (forward) or output dtype (backward), keep-scales)
CASES = (
    ("fwd (1,1) layer 1 f32 ds", "fwd", 963, 645, 64, "float32", True),
    ("fwd (1,1) layer 2 bf16", "fwd", 963, 645, 32, "bfloat16", False),
    ("fwd (0,0) layer 1 f32 ds", "fwd", 1, 19081, 64, "float32", True),
    ("fwd (0,0) layer 2 bf16", "fwd", 1, 19081, 32, "bfloat16", False),
    ("bwd (1,1) layer 1 ds f32", "bwd", 963, 645, 64, "float32", True),
    ("bwd (1,1) layer 2 bf16", "bwd", 963, 645, 32, "bfloat16", False),
    ("bwd (0,0) layer 1 ds f32", "bwd", 1, 19081, 64, "float32", True),
    ("bwd (0,0) layer 2 bf16", "bwd", 1, 19081, 32, "bfloat16", False),
    ("bwd K=3 N=5000 ds f32", "bwd", 3, 5000, 64, "float32", True),
    ("bwd K=3 N=5000 bf16", "bwd", 3, 5000, 64, "bfloat16", False),
)
DENSITY = 0.01
TARGET_MS = 30.0  # timed device ms a cut, within [MIN_REPS, MAX_REPS] calls
MIN_REPS, MAX_REPS = 3, 10
# The fit's grid: a relation's epilogue and a block's fixed cost, in chunk steps.
EPILOGUE_GRID = np.arange(0.0, 8.0 + 1e-9, 0.125)
BLOCK_GRID = np.arange(0.0, 32.0 + 1e-9, 0.5)
NEAR = 1.5  # cuts within this factor of the fastest take part in the tie-break


def make_inputs(device, which, k, n, h, dtype, with_ds, seed=0):
    """(mask, scales, ds, operand): ``p4 [2, K, H, N]`` in ``dtype`` for the
    forward, ``ct [H, N]`` f32 for the backward; from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    mask = (torch.rand((k, n, n), generator=g, device=device) < DENSITY).to(torch.int8)
    scales = torch.rand((k, 4, n), generator=g, device=device)
    ds = None
    if with_ds:
        keep = torch.rand((k, 2, n), generator=g, device=device) < 0.9
        ds = torch.where(keep, 1 / 0.9, 0.0).float()
    if which == "fwd":
        operand = torch.randn((2, k, h, n), generator=g, device=device).to(getattr(torch, dtype))
    else:
        operand = torch.randn((h, n), generator=g, device=device)
    return mask, scales, ds, operand


def _call(which, inputs, dtype, sched):
    mask, scales, ds, operand = inputs
    if which == "fwd":
        return spmm_paired.run_fwd(operand, mask, scales, ds, sched)
    return spmm_paired.run_bwd(operand, mask, scales, ds, getattr(torch, dtype), sched)


def measure_case(device, label, which, k, n, h, dtype, with_ds, sms, bps):
    """The case's record: the cut ``paired_schedule`` picks and every
    ``schedule_cuts`` cut's ms, each held to the picked cut's result."""
    inputs = make_inputs(device, which, k, n, h, dtype, with_ds)
    picked = spmm_paired.paired_schedule(k, n, h, sms, bps)
    want = _call(which, inputs, dtype, picked)
    rule = probing.BF16 if which == "bwd" and dtype == "bfloat16" else probing.REL
    cuts = []
    for rs, cs in spmm_paired.schedule_cuts(k, n, h, sms, bps):
        sched = spmm_paired.schedule_at(k, n, h, sms, bps, rs, cs)
        probing.hold(_call(which, inputs, dtype, sched), want, rule)
        fn = lambda sched=sched: _call(which, inputs, dtype, sched)  # noqa: E731
        first = probing.cuda_ms(fn, reps=1, warmup=0)
        reps = max(MIN_REPS, min(MAX_REPS, math.ceil(TARGET_MS / max(first, 1e-3))))
        cuts.append([rs, cs, probing.cuda_ms(fn, reps=reps, warmup=0)])
        cuda_build.LAUNCHES["probe_paired_cuts"] += 2 + reps
    del inputs, want
    torch.cuda.empty_cache()
    return dict(label=label, which=which, k=k, n=n, h=h, dtype=dtype, ds=with_ds,
                picked=[picked.rel_splits, picked.con_splits], cuts=cuts)


def _case_arrays(case, sms, bps):
    """Per measured cut: ms, waves, longest relation and chunk ranges, and
    the tie-break rank (fewer splits, then fewer relation splits)."""
    k, n, h = case["k"], case["n"], case["h"]
    base, chunks, wave = spmm_paired._grid(k, n, h, sms, bps)
    cuts = sorted(case["cuts"], key=lambda c: (c[0] * c[1], c[0]))
    rs = np.array([c[0] for c in cuts])
    cs = np.array([c[1] for c in cuts])
    ms = np.array([c[2] for c in cuts], dtype=float)
    waves = -(-base * rs * cs // wave)
    kb, cb = -(-k // rs), -(-chunks // cs)
    return cuts, ms, waves.astype(float), kb.astype(float), cb.astype(float)


def fit(record):
    """The cost model's constants that lose the least time on ``record``'s
    cases (see the module docstring), with each case's fastest cut, the
    cut and time at the fitted constants and at the module's."""
    sms = record["sms"]
    arrays = [(case, *_case_arrays(case, sms, record["blocks_per_sm"][case["which"]]))
              for case in record["cases"]]
    best = None
    for e in EPILOGUE_GRID:
        for b in BLOCK_GRID:
            loss, spread = 0.0, 0.0
            for case, cuts, ms, waves, kb, cb in arrays:
                cost = waves * (kb * (cb + e) + b)
                loss += ms[int(np.argmin(cost))] / ms.min() - 1.0
                near = ms <= NEAR * ms.min()
                r = np.log(ms[near]) - np.log(cost[near])
                spread += float(np.mean((r - r.mean()) ** 2))
            key = (round(loss, 9), spread)
            if best is None or key < best[0]:
                best = (key, float(e), float(b))
    (loss, spread), e, b = best
    rows = []
    for case, cuts, ms, waves, kb, cb in arrays:
        bps = record["blocks_per_sm"][case["which"]]
        row = dict(label=case["label"], fastest=list(cuts[int(np.argmin(ms))]))
        for name, (ee, bb) in (("fitted", (e, b)),
                               ("module", (spmm_paired._EPILOGUE_STEPS, spmm_paired._BLOCK_STEPS))):
            cut = spmm_paired.cheapest_cut(case["k"], case["n"], case["h"], sms, bps, ee, bb)
            t = next(c[2] for c in cuts if (c[0], c[1]) == cut)
            row[name] = [cut[0], cut[1], t, t / ms.min()]
        rows.append(row)
    return dict(epilogue_steps=e, block_steps=b, loss=loss, spread=spread, cases=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="write the record here")
    ap.add_argument("--fit", type=Path, help="fit the cost model to this record and stop")
    args = ap.parse_args(argv)
    if args.fit is not None:
        print(json.dumps(fit(json.loads(args.fit.read_text())), indent=1))
        return 0
    device = probing.require_card("probe_paired_cuts")
    if device is None:
        return 1
    smi = probing.card()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    cuda_build.library()
    info = {w: spmm_paired.kernel_info(w, device.index or 0) for w in ("fwd", "bwd")}
    sms = info["fwd"]["sms"]
    bps = {w: max(1, info[w]["blocks_per_sm"]) for w in info}
    cases = []
    for label, which, k, n, h, dtype, with_ds in CASES:
        case = measure_case(device, label, which, k, n, h, dtype, with_ds, sms, bps[which])
        ms = [c[2] for c in case["cuts"]]
        fastest = case["cuts"][int(np.argmin(ms))]
        picked = next(c for c in case["cuts"] if c[:2] == case["picked"])
        print(json.dumps(dict(case=label, cuts=len(ms), fastest=fastest, picked=picked)),
              flush=True)
        cases.append(case)
    record = dict(probe="paired_cuts", device=smi, torch=torch.__version__, sms=sms,
                  blocks_per_sm=bps, registers={w: info[w]["registers"] for w in info},
                  cases=cases)
    record["fit"] = fit(record)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record))
    print(json.dumps(dict(probe="paired_cuts", device=smi, fit=record["fit"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
