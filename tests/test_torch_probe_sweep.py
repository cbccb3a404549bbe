"""The probes P1-P4 against the paired kernels' plain versions, on the CPU.

P1 (``probe_paired_idioms``), P2 (``probe_paired_orient``), P3
(``probe_paired_parts``) and P4 (``probe_paired_bwd_idioms``) run the
paired sweep (``csrc/paired_core.cuh``) on the card: P1 is K1/K2's
function in the TPU probe's node-major layout, P4 is K3's, both with unit
column scales; P2's ``both`` and P3's ``two_dots`` are K1/K2 at unit
column scales, the other modes parts of it.  These tests show that each
probe's contract is the live kernel's at unit column scales, over ragged
shapes, that the probes' cuts cover every relation once, and that small_t's
blocks and last pass (each mask tile staged once, partials summed in a
fixed order), emulated in plain PyTorch, compute ``both``.  The JAX probes'
own comparisons are in ``test_torch_probes.py``; the kernels against these
plain versions, on the card, in ``test_torch_cuda.py``.

Tolerances.  P4's plain version rounds the same operands at the same
points as ``spmm_paired.paired_bwd_ref`` and runs the same products, so
the two are equal bit for bit; so are P2's ``both`` on its ``sc [K, 2, N]``
and K1/K2's on ``[K, 4, N]`` with unit column scales, and P3's
``two_dots`` and K1/K2's on all-ones scales (the same products, sums and
scalings in the same order).  P1's multiplies the same exact products
(bf16 operands, an exactly converted mask) but as ``B @ p`` where the
forward's is ``p @ B^T``, so the f32 sums may be taken in another order:
max error <= 1e-6 of the largest output; small_t's emulation sums tile by
tile: max error <= 1e-5 of the largest output (the card tests' rule).
"""

import collections
import itertools

import pytest
import torch

from decagon_tpu_torch.ops import spmm_paired
from decagon_tpu_torch.scripts import probe_paired_bwd_idioms as p4
from decagon_tpu_torch.scripts import probe_paired_idioms as p1
from decagon_tpu_torch.scripts import probe_paired_orient as p2
from decagon_tpu_torch.scripts import probe_paired_parts as p3
from decagon_tpu_torch.scripts import probing

SHAPES = list(itertools.product((1, 3, 4), (20, 70, 645), (16, 40, 64)))
# Denser than the probes' 1%, so that N = 20 has edges in every relation.
DENSITY = 0.1
P1_TOL = 1e-6
H100 = dict(sms=132, blocks_per_sm=2)


@pytest.mark.parametrize("k,n,h", SHAPES)
def test_p1_is_the_forward_at_unit_column_scales(k, n, h):
    mask, *_, pe_aug, po_aug = p1.numpy_inputs(k, n, h, seed=k * n + h, density=DENSITY)
    mask[0, 0, :2] = (2, 3)
    mask = torch.from_numpy(mask)
    pe_aug = torch.from_numpy(pe_aug).to(torch.bfloat16)
    po_aug = torch.from_numpy(po_aug).to(torch.bfloat16)
    got = p1.paired_ref(mask, pe_aug, po_aug, h)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, p1.AUG)
    assert not got[:, h:].any()
    p4_, scales = p1.as_forward(mask, pe_aug, po_aug, h)
    assert torch.equal(scales[:, 2:], torch.ones_like(scales[:, 2:]))
    want = spmm_paired.paired_ref(p4_, mask, scales).t()
    assert want.abs().max() > 0
    assert (got[:, :h] - want).abs().max() <= P1_TOL * want.abs().max()


@pytest.mark.parametrize("k,n,h", SHAPES)
def test_p4_is_the_backward_at_unit_column_scales(k, n, h):
    mask, ct, sc = p4.numpy_inputs(k, n, h, seed=k * n + h, density=DENSITY)
    mask[0, 0, :2] = (2, 3)
    mask, ct_t, sc = torch.from_numpy(mask), torch.from_numpy(ct.T.copy()), torch.from_numpy(sc)
    de, do = p4.paired_bwd_ref(mask, ct_t, sc)
    d = spmm_paired.paired_bwd_ref(ct_t, mask, p4.as_backward(sc), None, torch.bfloat16)
    assert de.dtype == do.dtype == torch.bfloat16 and tuple(de.shape) == (k, h, n)
    assert torch.equal(de, d[0]) and torch.equal(do, d[1])


@pytest.mark.parametrize("kb", [None, 1, 3, "K"])
@pytest.mark.parametrize("k,n,h", [(1, 20, 16), (3, 70, 40), (4, 645, 64), (963, 645, 64)])
def test_p1_cut_covers_every_relation_once(k, n, h, kb):
    kb = k if kb == "K" else kb
    sched = p1.cut(k, n, h, kb, **H100)
    if kb is None:
        assert sched == spmm_paired.paired_schedule(k, n, h, **H100)
    else:
        assert (sched.rel_splits, sched.con_splits) == (-(-k // kb), 1)
    seen = collections.Counter()
    for x, z, k0, k1, ch0, ch1, _ in sched.ranges():
        if kb is not None:
            assert 1 <= k1 - k0 <= kb and (ch0, ch1) == (0, sched.chunks)
        seen.update((x, z, r, c) for r in range(k0, k1) for c in range(ch0, ch1))
    every = itertools.product(range(sched.tiles), range(sched.hslices), range(k),
                              range(sched.chunks))
    assert seen == collections.Counter(every)


def test_p1_cut_rejects_kb_below_one():
    with pytest.raises(ValueError, match="kb"):
        p1.cut(4, 645, 64, 0, **H100)


def _p2_inputs(k, n, h, seed):
    """A mask [k + 1, n, n] int8 with a few counts above 1, ``p4 [2, k, h,
    n]`` bf16 and ``sc [k + 1, 2, n]``, from ``seed``."""
    mask, p4_ = p3.make_inputs("cpu", seed=seed, k=k, n=n, h=h, kpad=k + 1)
    g = torch.Generator().manual_seed(seed)
    mask += (torch.rand(mask.shape, generator=g) < DENSITY).to(torch.int8)
    mask[0, 0, :2] = torch.tensor([2, 3], dtype=torch.int8)
    return mask, p4_, p2.make_scales("cpu", seed, kpad=k + 1, n=n)


@pytest.mark.parametrize("k,n,h", SHAPES)
def test_p2_both_and_p3_two_dots_are_the_forward_at_unit_column_scales(k, n, h):
    mask, p4_, sc = _p2_inputs(k, n, h, seed=k * n + h)
    m = mask[:k].contiguous()
    want = spmm_paired.paired_ref(p4_, m, p2.as_forward_scales(sc, k))
    assert want.abs().max() > 0
    assert torch.equal(p2.paired_orient_ref(mask, p4_, sc, "both"), want)
    ones = torch.ones((k, 4, n))
    assert torch.equal(p3.paired_parts_ref(mask, p4_, "two_dots"),
                       spmm_paired.paired_ref(p4_, m, ones))


def test_p2_forward_scales_are_sc_and_ones():
    sc = p2.make_scales("cpu", 0, kpad=5, n=30)
    got = p2.as_forward_scales(sc, 4)
    assert tuple(got.shape) == (4, 4, 30) and got.is_contiguous()
    assert torch.equal(got[:, :2], sc[:4]) and torch.equal(got[:, 2:], torch.ones(4, 2, 30))


MODE_CODES = [probing.BOTH, probing.DIRECT, probing.TRANS, probing.M128, probing.DMA,
              probing.SMALL_T]


@pytest.mark.parametrize("kb", [None, 1, 3, "K"])
@pytest.mark.parametrize("mode", MODE_CODES)
@pytest.mark.parametrize("k,n,h", [(1, 20, 16), (3, 70, 40), (4, 645, 64), (963, 645, 64)])
def test_probe_cut_covers_every_relation_once(k, n, h, kb, mode):
    kb = k if kb == "K" else kb
    rs, cs = p3.probe_cut(mode, k, n, h, kb, **H100)
    if mode == probing.SMALL_T:
        assert cs == 1
        if kb is not None:
            assert rs == -(-k // kb)
        tiles = -(-n // 64)
        seen = collections.Counter()
        for r, c, z, k0, k1, _ in p3.small_t_blocks(k, n, h, rs):
            if kb is not None:
                assert 1 <= k1 - k0 <= kb
            seen.update((r, c, z, rel) for rel in range(k0, k1))
        every = itertools.product(range(tiles), range(tiles), range(-(-h // 64)), range(k))
        assert seen == collections.Counter(every)
        return
    want = (p1.cut(k, n, h, kb, **H100) if kb is not None
            else spmm_paired.paired_schedule(k, n, h, **H100))
    assert (rs, cs) == (want.rel_splits, want.con_splits)
    sched = spmm_paired.schedule_at(k, n, h, H100["sms"], H100["blocks_per_sm"], rs, cs)
    seen = collections.Counter()
    for x, z, k0, k1, ch0, ch1, _ in sched.ranges():
        seen.update((x, z, r, c) for r in range(k0, k1) for c in range(ch0, ch1))
    every = itertools.product(range(sched.tiles), range(sched.hslices), range(k),
                              range(sched.chunks))
    assert seen == collections.Counter(every)


@pytest.mark.parametrize("k", [1, 4, 963])
def test_small_t_schedule_fills_waves(k):
    """``kb=None`` picks the relation splits of least cost: at most 16 waves
    of the T * T pairs, and no fewer splits cost less."""
    rs = p3.small_t_splits(k, 645, 64, None, **H100)
    assert 1 <= rs <= k and 121 * rs <= 16 * 264
    if k == 963:
        assert rs > 1


@pytest.mark.parametrize("n,rs", [(20, 1), (70, 3), (645, 2)])
def test_small_t_terms_cover_each_partial_once_in_a_fixed_order(n, rs):
    tiles = -(-n // 64)
    for t in range(tiles):
        terms = p3.small_t_terms(n, rs, t)
        assert terms == p3.small_t_terms(n, rs, t)
        want = [(s, t, c, 0) for s in range(rs) for c in range(tiles)] + \
            [(s, r, t, 1) for s in range(rs) for r in range(tiles)]
        assert sorted(terms) == sorted(want)
        assert len(set(terms)) == len(terms) == 2 * tiles * rs
        # Split by split, the direct partials before the transposed ones.
        for s in range(rs):
            chunk = terms[s * 2 * tiles:(s + 1) * 2 * tiles]
            assert [x[3] for x in chunk] == [0] * tiles + [1] * tiles


def _pad64(x, rows, cols):
    out = torch.zeros((rows, cols), dtype=x.dtype)
    out[:x.shape[0], :x.shape[1]] = x
    return out


def small_t_emulated(mask, p4_, sc, rs):
    """small_t in plain PyTorch: each block's tile ``B_k[R, C]`` read as
    rows (against ``pe`` at C, scaled by ``a_e`` of R's nodes) and as
    columns (against ``po`` at R, scaled by ``a_o`` of C's nodes) into its
    two partials, then the last pass in ``small_t_terms``' order."""
    _, k, h, n = p4_.shape
    tiles, t64 = -(-n // 64), 64
    npad = tiles * t64
    b = torch.zeros((k, npad, npad))
    b[:, :n, :n] = mask[:k].float()
    pe = torch.zeros((k, h, npad))
    po = torch.zeros((k, h, npad))
    pe[..., :n], po[..., :n] = p4_[0].float(), p4_[1].float()
    ae = torch.zeros((k, npad))
    ao = torch.zeros((k, npad))
    ae[:, :n], ao[:, :n] = sc[:k, 0], sc[:k, 1]
    part = torch.zeros((rs, tiles, tiles, 2, t64, h))
    for r, c, _, k0, k1, y in p3.small_t_blocks(k, n, h, rs):
        rows, cols = slice(r * t64, (r + 1) * t64), slice(c * t64, (c + 1) * t64)
        for rel in range(k0, k1):
            tile = b[rel, rows, cols]
            part[y, r, c, 0] += ae[rel, rows, None] * (tile @ pe[rel, :, cols].T)
            part[y, r, c, 1] += ao[rel, cols, None] * (tile.T @ po[rel, :, rows].T)
    out = torch.zeros((h, n))
    for t in range(tiles):
        acc = torch.zeros((t64, h))
        for s, r, c, half in p3.small_t_terms(n, rs, t):
            acc = acc + part[s, r, c, half]
        width = min(t64, n - t * t64)
        out[:, t * t64:t * t64 + width] = acc[:width].T
    return out


@pytest.mark.parametrize("k,n,h,rs", [(1, 20, 16, 1), (3, 70, 40, 2), (4, 130, 64, 3)])
def test_small_t_blocks_and_last_pass_compute_both(k, n, h, rs):
    mask, p4_, sc = _p2_inputs(k, n, h, seed=k + n)
    want = p2.paired_orient_ref(mask, p4_, sc, "both")
    got = small_t_emulated(mask, p4_, sc, rs)
    assert (got - want).abs().max() <= probing.REL_TOL * want.abs().max()
    assert torch.equal(p2.paired_orient_ref(mask, p4_, sc, "small_t"), want)
