"""The probes P1 and P4 against the paired kernels' plain versions, on the CPU.

P1 (``probe_paired_idioms``) and P4 (``probe_paired_bwd_idioms``) run the
paired sweep (``csrc/paired_core.cuh``) on the card: P1 is K1/K2's
function in the TPU probe's node-major layout, P4 is K3's, both with unit
column scales.  These tests show that each probe's contract is the live
kernel's at unit column scales, over ragged shapes, and that P1's cuts
cover every relation once.  The JAX probes' own comparisons are in
``test_torch_probes.py``; the kernels against these plain versions, on
the card, in ``test_torch_cuda.py``.

Tolerances.  P4's plain version rounds the same operands at the same
points as ``spmm_paired.paired_bwd_ref`` and runs the same products, so
the two are equal bit for bit.  P1's multiplies the same exact products
(bf16 operands, an exactly converted mask) but as ``B @ p`` where the
forward's is ``p @ B^T``, so the f32 sums may be taken in another order:
max error <= 1e-6 of the largest output.
"""

import collections
import itertools

import pytest
import torch

from decagon_tpu_torch.ops import spmm_paired
from decagon_tpu_torch.scripts import probe_paired_bwd_idioms as p4
from decagon_tpu_torch.scripts import probe_paired_idioms as p1

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
