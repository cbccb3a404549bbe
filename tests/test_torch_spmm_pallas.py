"""The tiled SpMM (K6) of the port against the JAX package on the CPU: the
port's plain version (what ``spmm_tiled`` runs for a CPU tensor) against
the JAX kernel in interpret mode, forward and backward, per edge type and
over the fused stream, at both precisions and at the JAX tests' shapes
(the CUDA kernel is held against the plain version on the card in
``test_torch_cuda.py``).

Tolerance: the error is held to 1e-5 of the output's largest magnitude.
Both sides sum in f32 in different orders; at ``"default"`` they round the
same values (the source table, the edge values, the backward's cotangent)
to bf16 and every product of two bf16 values is exact, so a larger gap
would mean the contract was misread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decagon_tpu.ops.spmm_pallas import _spmm_pallas_flat_op, _spmm_pallas_op
from decagon_tpu.ops.spmm_pallas import spmm_tiled as jax_spmm_tiled
from decagon_tpu.ops.tiling import build_tiles as jax_build_tiles
from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.ops.spmm_pallas import (
    _SpmmTiled,
    launch_plan,
    spmm_pallas,
    spmm_tiled,
    spmm_tiled_ref,
)
from decagon_tpu_torch.ops.tiling import SEGMENT, build_tiles
from tests.torch_k6_order import spmm_tiled_ordered

PRECISIONS = {"highest": jax.lax.Precision.HIGHEST, "default": jax.lax.Precision.DEFAULT}


def _hold(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err / np.abs(want).max()


def _edges(k, n_src, n_dst, e, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, k * n_src, e)
    dst = rng.integers(0, n_dst, e)
    vals = rng.normal(size=e).astype(np.float32)
    return src, dst, vals


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("shape", [(2, 100, 80, 5000), (5, 37, 61, 900)])
def test_spmm_tiled_matches_interpret_kernel(shape, precision):
    k, n_src, n_dst, e = shape
    src, dst, vals = _edges(k, n_src, n_dst, e, seed=0)
    pf = np.random.default_rng(1).normal(size=(k * n_src, 32)).astype(np.float32)
    tiles_ref = jax_build_tiles(src, dst, vals, k * n_src, n_dst, 64, 64, 64)
    want = np.asarray(jax_spmm_tiled(
        jnp.asarray(pf), tiles_ref, interpret=True, precision=PRECISIONS[precision]
    ))[:n_dst, :32]
    before = dict(cuda_build.LAUNCHES)
    got = spmm_tiled(torch.from_numpy(pf), build_tiles(src, dst, vals, k * n_src, n_dst), precision)
    assert cuda_build.LAUNCHES == before  # a CPU tensor runs the plain version
    _hold(got.numpy(), want)


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_spmm_tiled_backward_matches_reference_vjp(precision):
    """The gradient of ``sum(tanh(out))`` through the JAX custom VJP (the
    kernel over the transposed tiling) and through the port's autograd."""
    k, n_src, n_dst, e, h = 3, 50, 40, 700, 16
    src, dst, vals = _edges(k, n_src, n_dst, e, seed=1)
    p = np.random.default_rng(2).normal(size=(k, n_src, h)).astype(np.float32)
    tf = jax_build_tiles(src, dst, vals, k * n_src, n_dst, 64, 64, 64)
    tb = jax_build_tiles(dst, src, vals, n_dst, k * n_src, 64, 64, 64)

    def f(p_stack):
        return jnp.sum(jnp.tanh(_spmm_pallas_op(p_stack, tf, tb, n_dst, True, precision)))

    want_loss, want = jax.value_and_grad(f)(jnp.asarray(p))
    adj = type("Adj", (), dict(
        tiles_fwd=build_tiles(src, dst, vals, k * n_src, n_dst),
        tiles_bwd=build_tiles(dst, src, vals, n_dst, k * n_src),
    ))()
    q = torch.from_numpy(p).requires_grad_(True)
    loss = torch.tanh(spmm_pallas(q, adj, precision)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _hold(q.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_flat_op_matches_reference(precision):
    """``_spmm_pallas_flat_op`` (the fused stream's op): forward and the
    gradient of a weighted sum."""
    n_p, n_t, e, h = 300, 90, 2000, 24
    src, dst, vals = _edges(1, n_p, n_t, e, seed=3)
    rng = np.random.default_rng(4)
    p = rng.normal(size=(n_p, h)).astype(np.float32)
    w = rng.normal(size=(n_t, h)).astype(np.float32)
    tf = jax_build_tiles(src, dst, vals, n_p, n_t, 64, 64, 64)
    tb = jax_build_tiles(dst, src, vals, n_t, n_p, 64, 64, 64)
    out_ref, vjp = jax.vjp(
        lambda x: _spmm_pallas_flat_op(x, tf, tb, n_t, True, precision), jnp.asarray(p)
    )
    (grad_ref,) = vjp(jnp.asarray(w))
    q = torch.from_numpy(p).requires_grad_(True)
    out = _SpmmTiled.apply(
        q, build_tiles(src, dst, vals, n_p, n_t), build_tiles(dst, src, vals, n_t, n_p),
        precision, False,
    )
    out.backward(torch.from_numpy(w))
    _hold(out.detach().numpy(), np.asarray(out_ref))
    _hold(q.grad.numpy(), np.asarray(grad_ref))


def test_empty_relation_gives_zeros():
    tiles = build_tiles(np.empty(0), np.empty(0), np.empty(0, np.float32), 64, 64)
    out = spmm_tiled(torch.ones((64, 16)), tiles)
    assert torch.equal(out, torch.zeros((64, 16)))
    tiles_ref = jax_build_tiles(
        np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.float32), 64, 64, 64, 64, 64
    )
    assert not np.asarray(jax_spmm_tiled(jnp.ones((64, 16)), tiles_ref, interpret=True)).any()


def test_spmm_pallas_raises_without_layouts():
    adj = type("Adj", (), dict(tiles_fwd=None, tiles_bwd=None))()
    with pytest.raises(ValueError):
        spmm_pallas(torch.zeros((1, 4, 2)), adj)
    tiles = build_tiles(np.array([0]), np.array([0]), np.array([1.0]), 4, 4)
    with pytest.raises(ValueError):
        spmm_tiled(torch.zeros((4, 2)), tiles, "fast")


@pytest.mark.parametrize("window", [0, 150])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_kernel_summation_order_matches_plain(precision, window):
    """``spmm_tiled_ordered`` (K6's order: short rows in edge order, a long
    row's segments, then its slots in order) against ``spmm_tiled_ref``
    (one ``index_add_``), on rows short and long (``SEGMENT`` edges and
    past it, cut at source windows or not), and against the JAX kernel in
    interpret mode.  Both sum the same rounded messages in f32 in other
    orders, so each element is held to 1e-6 of the sum of its messages'
    magnitudes (the scale a reordered f32 sum's error is proportional to;
    a misplaced or missing edge would move it by a whole message)."""
    n_src, n_dst, h = 2000, 120, 32
    rng = np.random.default_rng(7)
    dst = np.concatenate([rng.integers(0, 100, 4000), np.full(3 * SEGMENT + 5, 101),
                          np.full(SEGMENT + 1, 102), np.full(SEGMENT, 103)])
    src = rng.integers(0, n_src, dst.size)
    vals = rng.normal(size=dst.size).astype(np.float32)
    tiles = build_tiles(src, dst, vals, n_src, n_dst, window=window)
    assert {101, 102} <= set(tiles.multi_row.tolist()) and tiles.num_segments >= 6
    assert window or tiles.multi_row.tolist() == [101, 102]
    p = torch.from_numpy(rng.normal(size=(n_src, h)).astype(np.float32))
    got = spmm_tiled_ordered(p, tiles, precision)
    want = spmm_tiled_ref(p, tiles, precision)
    mags = spmm_tiled_ref(p.abs(), dataclasses.replace(tiles, val=tiles.val.abs()), precision)
    assert bool(((got - want).abs() <= 1e-6 * mags).all())
    jax_tiles = jax_build_tiles(src, dst, vals, n_src, n_dst, 64, 64, 64)
    jax_out = np.asarray(jax_spmm_tiled(
        jnp.asarray(p.numpy()), jax_tiles, interpret=True, precision=PRECISIONS[precision]
    ))[:n_dst, :h]
    _hold(got.numpy(), jax_out)


def test_launch_plan_stages_small_tables_that_are_gathered_often():
    """The row pass copies the table into shared memory only where it fits
    (as bf16 at "default": the drug-drug backward's [645, 64] cotangent
    fits either way, a [1000, 64] table only in bf16, PPI's [19081, 64]
    not at all) and where its rows are gathered at least 4 times for each
    of the card's copies; loads from device memory are 16 bytes wherever
    the width and the alignment allow, from shared memory 4 elements."""
    def tiles(n_src, nnz):
        src = np.arange(nnz) % n_src
        return build_tiles(src, np.arange(nnz) // 7, np.ones(nnz, np.float32), n_src, nnz // 7 + 1)

    small = tiles(645, 4 * 132 * 645)
    assert launch_plan(small, 64, 0, False, False, 132) == (4, 4, True)
    assert launch_plan(small, 64, 0, False, True, 132) == (4, 4, True)
    assert launch_plan(small, 64, 8, False, False, 132) == (2, 4, True)
    assert launch_plan(small, 64, 0, True, False, 132) == (8, 4, True)
    assert launch_plan(small, 96, 4, True, True, 132) == (2, 4, True)
    assert launch_plan(small, 36, 0, False, False, 132) == (4, 4, True)
    assert launch_plan(small, 64, 2, True, False, 132) == (1, 1, False)
    assert not launch_plan(tiles(645, 4 * 132 * 645 - 1), 64, 0, False, False, 132)[2]
    wider = tiles(1000, 4 * 132 * 1000)
    assert not launch_plan(wider, 64, 0, False, False, 132)[2]
    assert launch_plan(wider, 64, 0, False, True, 132)[2]
    assert not launch_plan(tiles(19081, 4 * 132 * 19081), 64, 0, True, True, 132)[2]
    assert launch_plan(tiles(645, 340_000), 1, 2, True, False, 132) == (1, 1, False)
