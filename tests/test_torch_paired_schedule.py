"""The paired kernels' schedule and split-and-reduce, on the CPU.

``paired_schedule`` cuts a paired call into (node tile, hidden slice,
relation range, contraction range) blocks for the CUDA sweep
(``csrc/paired_core.cuh``); ``PairedSchedule.ranges`` repeats the kernel's
integer arithmetic.  These tests hold that the cut covers every
(relation, node tile, chunk, slice) once, fills whole waves at the paper's
shapes, and, emulated in plain PyTorch (the kernel's operand pass, its
per-block sums and its fixed-order reduction), gives ``paired_ref`` and
``paired_bwd_ref``.  Tolerance of the emulation: both sides round the same
operands to bf16 and the products are exact, so only the order of the f32
sums differs: 1e-6 of the largest output.  The ``torch.bmm`` yardstick
rounds each relation's product to bf16 before the scales and the sum, so
it is held elementwise to 2^-8 of the sum of its terms' magnitudes (one
bf16 rounding each) plus 1e-6 of the largest output.
"""

import collections
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from decagon_tpu_torch.ops import spmm_paired as sp
from decagon_tpu_torch.scripts import probe_paired_cuts

# Every cut's time at the paper's shapes on an H100 (``probe_paired_cuts``).
RECORD = json.loads(
    (Path(sp.__file__).resolve().parents[1] / "scripts" / "paired_cuts_h100.json").read_text())
# How much longer than the fastest measured cut the picked one may take.
MEASURED_LIMIT = 1.035

H100 = dict(sms=132, blocks_per_sm=2)
PAPER = [(963, 645, 64), (963, 645, 32), (1, 19081, 64), (1, 19081, 32)]
NAMED = PAPER + [(3, 5000, 64)]
SMALL = [(2, 100, 16), (5, 130, 96), (4, 50, 24), (7, 645, 64), (1, 4500, 64)]


def _covered(sched):
    """(relation, tile, chunk, slice) -> times covered, and (tile, slice)
    -> the partial indices of its blocks, from ``ranges``."""
    cover = collections.Counter()
    partials = collections.defaultdict(list)
    for tile, hs, k0, k1, ch0, ch1, y in sched.ranges():
        partials[(tile, hs)].append(y)
        for k in range(k0, k1):
            for c in range(ch0, ch1):
                cover[(k, tile, c, hs)] += 1
    return cover, partials


@pytest.mark.parametrize("k,n,h", NAMED + SMALL)
def test_schedule_covers_each_piece_once(k, n, h):
    sched = sp.paired_schedule(k, n, h, **H100)
    cover, partials = _covered(sched)
    assert len(cover) == k * sched.tiles * sched.chunks * sched.hslices
    assert set(cover.values()) == {1}
    assert sched.tiles == -(-n // 64) and sched.chunks == -(-n // 64)
    assert sched.hslices == -(-h // 64)
    assert sched.hq % 16 == 0 and sched.hq >= h and sched.npad == 64 * sched.chunks
    for ys in partials.values():
        assert ys == list(range(sched.partials))
    assert sched.blocks == sum(1 for _ in sched.ranges())


@pytest.mark.parametrize("blocks_per_sm", [1, 2, 3])
@pytest.mark.parametrize("k,n,h", NAMED)
def test_schedule_fills_whole_waves(k, n, h, blocks_per_sm):
    """At the paper's shapes the last wave is at least 90% full (85% at
    K = 3, N = 5000, whose 79 tiles do not divide a wave; its 237 blocks
    are the fastest cut measured there), and the grid runs at least one
    wave."""
    sched = sp.paired_schedule(k, n, h, sms=132, blocks_per_sm=blocks_per_sm)
    fill = sched.blocks / (math.ceil(sched.waves) * sched.wave)
    assert sched.waves >= 0.85
    assert fill >= (0.9 if (k, n, h) in PAPER else 0.85), (sched, fill)


@pytest.mark.parametrize("k,n,h", NAMED + SMALL)
def test_schedule_is_the_cheapest_cut(k, n, h):
    """No relation and contraction split within the wave cap finishes
    sooner under the schedule's cost model: the pruned search misses
    nothing."""
    sched = sp.paired_schedule(k, n, h, **H100)

    def cost(rs, cs):
        return sp.cut_cost(k, n, h, H100["sms"], H100["blocks_per_sm"], rs, cs)

    best = cost(sched.rel_splits, sched.con_splits)
    cap = max(sp._MAX_WAVES * sched.wave, sched.tiles * sched.hslices)
    for rs in range(1, k + 1):
        for cs in range(1, sched.chunks + 1):
            if sched.tiles * sched.hslices * rs * cs <= cap:
                assert cost(rs, cs) >= best


def test_cost_model_constants_are_fitted_to_the_measured_cuts():
    fit = probe_paired_cuts.fit(RECORD)
    assert (fit["epilogue_steps"], fit["block_steps"]) == (sp._EPILOGUE_STEPS, sp._BLOCK_STEPS)


@pytest.mark.parametrize("case", RECORD["cases"], ids=lambda c: c["label"])
def test_schedule_is_near_the_fastest_measured_cut(case):
    """On the H100 record, which times every cut the search weighs, the
    picked cut takes at most 3.5% longer than the fastest.  The largest
    gap is the (1,1) backward's 3.3%: its fastest cut (3 relations a
    block, 13.4 waves) costs 14 whole waves in the model, which no pair of
    constants ranks below one wave of 41 relations a block."""
    k, n, h = case["k"], case["n"], case["h"]
    sms, bps = RECORD["sms"], RECORD["blocks_per_sm"][case["which"]]
    times = {(rs, cs): ms for rs, cs, ms in case["cuts"]}
    assert set(times) == set(sp.schedule_cuts(k, n, h, sms, bps))
    sched = sp.paired_schedule(k, n, h, sms, bps)
    assert times[(sched.rel_splits, sched.con_splits)] <= MEASURED_LIMIT * min(times.values())


def test_cost_model_fit_recovers_known_constants():
    """``fit`` on times that follow the model at known constants returns
    them."""
    cases = []
    for label, which, k, n, h, _, _ in probe_paired_cuts.CASES[::3]:
        cuts = [[rs, cs, 1e-3 * sp.cut_cost(k, n, h, 132, 2, rs, cs, 1.25, 6.0)]
                for rs, cs in sp.schedule_cuts(k, n, h, 132, 2)]
        cases.append(dict(label=label, which=which, k=k, n=n, h=h, cuts=cuts))
    fit = probe_paired_cuts.fit(dict(sms=132, blocks_per_sm=dict(fwd=2, bwd=2), cases=cases))
    assert (fit["epilogue_steps"], fit["block_steps"], fit["loss"]) == (1.25, 6.0, 0.0)


def test_probe_paired_cuts_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe_paired_cuts.main([]) == 1


def test_schedule_splits_the_contraction_when_k_is_small():
    for n in (4500, 19081):
        assert sp.paired_schedule(1, n, 64, **H100).con_splits > 1
    paper = sp.paired_schedule(963, 645, 64, **H100)
    assert paper.con_splits == 1 and paper.rel_splits > 1


def test_schedule_is_a_fixed_function():
    a = sp.paired_schedule(963, 645, 64, **H100)
    sp.paired_schedule.cache_clear()
    b = sp.paired_schedule(963, 645, 64, **H100)
    assert a == b and list(a.ranges()) == list(b.ranges())


def _world(k, n, h, seed):
    rng = np.random.default_rng(seed)
    mask = (rng.random((k, n, n)) < 0.08).astype(np.int8)
    mask[0, 0, 0] = 3
    mask[-1, n - 1, 0] = -2
    scales = rng.random((k, 4, n)).astype(np.float32)
    ds = np.where(rng.random((k, 2, n)) < 0.9, 1 / 0.9, 0.0).astype(np.float32)
    p4 = rng.standard_normal((2, k, h, n)).astype(np.float32)
    ct = rng.standard_normal((h, n)).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (mask, scales, ds, p4, ct))


def _pieces(sched, tile, hs, ch0, ch1):
    n, h = sched.n, sched.h
    rows = slice(64 * tile, min(n, 64 * tile + 64))
    cols = slice(64 * ch0, min(n, 64 * ch1))
    hcols = slice(64 * hs, min(h, 64 * hs + 64))
    return rows, cols, hcols


def emulate_fwd(p4, mask, scales, ds, sched):
    """The forward kernel in plain PyTorch: the operand pass, each block's
    totals of the direct and the transposed half (row scales applied at
    each relation's end), their sum, then the partials in index order."""
    q = sp.paired_operands(p4, scales, ds).float()
    b = mask.float()
    parts = torch.zeros(sched.partials, sched.n, sched.h)
    for tile, hs, k0, k1, ch0, ch1, y in sched.ranges():
        rows, cols, hcols = _pieces(sched, tile, hs, ch0, ch1)
        tot_d = torch.zeros(rows.stop - rows.start, hcols.stop - hcols.start)
        tot_t = torch.zeros_like(tot_d)
        for k in range(k0, k1):
            tot_d += scales[k, 0, rows, None] * (b[k, rows, cols] @ q[0, k, hcols, cols].T)
            tot_t += scales[k, 1, rows, None] * (b[k, cols, rows].T @ q[1, k, hcols, cols].T)
        parts[y, rows, hcols] = tot_d + tot_t
    out = parts[0].clone()
    for y in range(1, sched.partials):
        out += parts[y]
    return out.t()


def emulate_bwd(ct, mask, scales, ds, sched):
    """The backward kernel in plain PyTorch: the operand pass, each block's
    per-relation sums (the direct tile gives d[1], the transposed d[0]),
    the contraction splits' partials in order, then the column scales."""
    k = mask.shape[0]
    q = sp.paired_bwd_operands(ct, scales, k).float()
    b = mask.float()
    parts = torch.zeros(sched.con_splits, 2, k, sched.h, sched.n)
    for tile, hs, k0, k1, ch0, ch1, y in sched.ranges():
        rows, cols, hcols = _pieces(sched, tile, hs, ch0, ch1)
        c = y % sched.con_splits
        for kk in range(k0, k1):
            parts[c, 1, kk, hcols, rows] = (b[kk, rows, cols] @ q[1, kk, hcols, cols].T).T
            parts[c, 0, kk, hcols, rows] = (b[kk, cols, rows].T @ q[0, kk, hcols, cols].T).T
    total = parts[0].clone()
    for c in range(1, sched.con_splits):
        total += parts[c]
    s = scales[:, 2:4]
    if ds is not None:
        s = s * ds
    return s.transpose(0, 1)[:, :, None, :] * total


# (K, N, H, sms, blocks_per_sm): small cards force relation and contraction
# splits at small sizes; N not a multiple of 16, H not one of 64.
EMULATED = [(5, 150, 24, 2, 2), (1, 300, 16, 3, 2), (3, 200, 80, 4, 1), (6, 70, 32, 132, 2)]


@pytest.mark.parametrize("with_ds", [False, True], ids=["no_ds", "ds"])
@pytest.mark.parametrize("k,n,h,sms,bps", EMULATED)
def test_emulated_split_forward_matches_paired_ref(k, n, h, sms, bps, with_ds):
    mask, scales, ds, p4, _ = _world(k, n, h, seed=k * n + h)
    sched = sp.paired_schedule(k, n, h, sms, bps)
    got = emulate_fwd(p4, mask, scales, ds if with_ds else None, sched)
    want = sp.paired_ref_ds(p4, mask, scales, ds) if with_ds else sp.paired_ref(p4, mask, scales)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


@pytest.mark.parametrize("with_ds", [False, True], ids=["no_ds", "ds"])
@pytest.mark.parametrize("k,n,h,sms,bps", EMULATED)
def test_emulated_split_backward_matches_paired_bwd_ref(k, n, h, sms, bps, with_ds):
    mask, scales, ds, _, ct = _world(k, n, h, seed=k * n + h + 1)
    ds = ds if with_ds else None
    sched = sp.paired_schedule(k, n, h, sms, bps)
    got = emulate_bwd(ct, mask, scales, ds, sched)
    want = sp.paired_bwd_ref(ct, mask, scales, ds, torch.float32)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def test_emulated_cases_split_both_ways():
    """The emulated cases exercise relation splits and contraction splits."""
    scheds = [sp.paired_schedule(k, n, h, sms, bps) for k, n, h, sms, bps in EMULATED]
    assert any(s.rel_splits > 1 for s in scheds)
    assert any(s.con_splits > 1 for s in scheds)
    assert any(s.rel_splits > 1 and s.con_splits > 1 for s in scheds)


def _bmm_hold(got, terms, want):
    bound = 2.0 ** -8 * terms + 1e-6 * want.abs().max()
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("with_ds", [False, True], ids=["no_ds", "ds"])
def test_bmm_yardstick_gives_paired_ref(with_ds):
    mask, scales, ds, p4, _ = _world(4, 90, 16, seed=3)
    ds = ds if with_ds else None
    q = sp.paired_operands(p4, scales, ds)
    m16, qd, qt = sp.paired_bmm_inputs(mask, q[0], q[1])
    assert m16.dtype == torch.bfloat16 and tuple(qd.shape) == (4, 90, 16)
    xd, xt = sp.paired_bmm(m16, qd, qt)
    ae, ao = scales[:, 0, :, None], scales[:, 1, :, None]
    got = (ae * xd.float() + ao * xt.float()).sum(0).t()
    terms = (ae * xd.float().abs() + ao * xt.float().abs()).sum(0).t()
    want = sp.paired_ref_ds(p4, mask, scales, ds) if ds is not None else sp.paired_ref(
        p4, mask, scales)
    _bmm_hold(got, terms, want)


@pytest.mark.parametrize("with_ds", [False, True], ids=["no_ds", "ds"])
def test_bmm_yardstick_gives_paired_bwd_ref(with_ds):
    mask, scales, ds, _, ct = _world(3, 70, 24, seed=4)
    ds = ds if with_ds else None
    q = sp.paired_bwd_operands(ct, scales, 3)
    xd, xt = sp.paired_bmm(*sp.paired_bmm_inputs(mask, q[1], q[0]))
    s = scales[:, 2:4] if ds is None else scales[:, 2:4] * ds
    got = torch.stack([s[:, 0, None, :] * xt.float().transpose(1, 2),
                       s[:, 1, None, :] * xd.float().transpose(1, 2)])
    terms = torch.stack([s[:, 0, None, :] * xt.float().abs().transpose(1, 2),
                         s[:, 1, None, :] * xd.float().abs().transpose(1, 2)])
    _bmm_hold(got, terms, sp.paired_bwd_ref(ct, mask, scales, ds, torch.float32))


def test_sweep_probe_plain_versions():
    """On the CPU the sweep probe runs its plain versions: the sweep is
    ``paired_ref`` / ``paired_ref_ds``, the parts zeros."""
    from decagon_tpu_torch.scripts import probe_paired_sweep as probe

    mask, scales, ds, p4, _ = _world(3, 40, 16, seed=5)
    for d, want in ((None, sp.paired_ref(p4, mask, scales)),
                    (ds, sp.paired_ref_ds(p4, mask, scales, ds))):
        assert torch.equal(probe.sweep_variant(p4, mask, scales, d, "sweep"), want)
        for name in ("staging", "products"):
            assert not probe.sweep_variant(p4, mask, scales, d, name).any()
    with pytest.raises(ValueError):
        probe.sweep_variant(p4, mask, scales, None, "dma_only")
