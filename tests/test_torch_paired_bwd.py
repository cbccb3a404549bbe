"""The port's paired and factored VJPs against the JAX package on the CPU.

The paired backward (K3/K4 on the card) runs here through its plain
versions, inside the autograd Functions: without keep-scales the JAX
package's non-kernel ``_paired_bwd`` formula, with them autograd of
``paired_ref_ds``.  Both are held against ``jax.vjp`` of the JAX custom-VJP
functions with ``use_kernel=False``, and ``paired_bwd_ref`` (the kernel's
plain version) against the JAX kernel run in interpret mode.  Cases: f32
and bf16 primals, with and without keep-scales, the small-N drug-drug type
(K > 1) and the PPI type (K = 1), and K > 1 with the JAX package's big-N
form forced by shrinking its threshold (its interpret-mode kernel refuses
K > 1 there, so the non-kernel backward is the reference).

Tolerance: 1e-4 of each output's largest magnitude.  Both sides round the
same operands to bf16 at the same points, and sum in f32 in other orders.
Where a bf16 rounding comes after such a sum (a bf16 output, or the ds
backward, which rounds the product to bf16 as the JAX transpose rule does),
the two sums may round to neighbouring bf16 values: one bf16 ulp, at most
2^-7 of the element.  There the bound is ``2^-7 |want| + 1e-4 max|want|``
elementwise, and at most 0.1% of the elements may exceed 1e-4 of the max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decagon_tpu.graph.device import build_device_graph as jax_build
from decagon_tpu.graph.split import split_graph as jax_split
from decagon_tpu.graph.synthetic import make_polypharmacy_like_graph as jax_graph
from decagon_tpu.ops import segment as jax_segment
from decagon_tpu.ops import spmm_paired as jax_sp
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.ops import segment
from decagon_tpu_torch.ops import spmm_paired as sp

SMALL = dict(
    n_proteins=300, n_drugs=60, n_side_effects=6, min_edges_per_relation=20,
    ppi_attachment=5, seed=7,
)
TOL = 1e-4


def _graphs():
    g_ref = jax_graph(**SMALL)
    ref = jax_build(
        g_ref, jax_split(g_ref, val_frac=0.05, test_frac=0.05, seed=1),
        dense_factored=True, dense_paired=True, build_fused=False,
    )
    g = make_polypharmacy_like_graph(**SMALL)
    dg = build_device_graph(
        g, split_graph(g, val_frac=0.05, test_frac=0.05, seed=1),
        dense_factored=True, dense_paired=True, device="cpu",
    )
    return ref, dg


@pytest.fixture(scope="module")
def graphs():
    return _graphs()


@pytest.fixture
def big_graphs(monkeypatch):
    """The JAX side builds the drug-drug type (K = 6 pairs, N = 60) in its
    big-N form: masks and scales padded to the 32-wide block."""
    monkeypatch.setattr(jax_sp, "BIG_N_THRESHOLD", 40)
    monkeypatch.setattr(jax_sp, "BIG_BLOCK", 32)
    ref, dg = _graphs()
    assert ref.adj["1,1"].pair_mask.shape[1] > jax_sp.BIG_N_THRESHOLD
    return ref, dg


def _world(adj, h, seed):
    k, n = adj.num_rel // 2, adj.n_rows
    rng = np.random.default_rng(seed)
    p4 = rng.standard_normal((2, k, h, n)).astype(np.float32)
    ct = rng.standard_normal((h, n)).astype(np.float32)
    ds = np.where(rng.random((k, 2, n)) < 0.9, 1.0 / 0.9, 0.0).astype(np.float32)
    return p4, ct, ds


def _jax_ds(ds, adj_ref):
    """The port's unpadded [K, 2, N] keep-scales in the JAX package's
    padded [K8, 2, Np] layout."""
    k8, _, n_pad = adj_ref.pair_scales.shape
    out = np.zeros((k8, 2, n_pad), np.float32)
    out[: ds.shape[0], :, : ds.shape[2]] = ds
    return jnp.asarray(out)


def _hold(got, want, bf16_rounded=False):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    tight = TOL * np.abs(want).max()
    if not bf16_rounded:
        assert err.max() <= tight, err.max() / np.abs(want).max()
        return
    assert (err <= tight + 2.0 ** -7 * np.abs(want)).all()
    assert (err > tight).sum() <= max(1, 1e-3 * err.size)


def _vjps(ref, dg, key, h, dtype, with_ds, seed):
    """(port gradient, JAX gradient) of the paired aggregation with
    respect to p4, for the cotangent ct of outT."""
    a_ref, a = ref.adj[key], dg.adj[key]
    p4, ct, ds = _world(a, h, seed)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    pj = jnp.asarray(p4).astype(jdt)
    k, n = p4.shape[1], p4.shape[3]
    kb = jax_sp.default_kb(k, n)
    if with_ds:
        fn = lambda q: jax_sp._paired_apply_ds(  # noqa: E731
            q, a_ref.pair_mask, a_ref.pair_scales, _jax_ds(ds, a_ref), kb, False
        )
    else:
        fn = lambda q: jax_sp._paired_apply(  # noqa: E731
            q, a_ref.pair_mask, a_ref.pair_scales, kb, False
        )
    out_j, vjp = jax.vjp(fn, pj)
    (want,) = vjp(jnp.asarray(ct))

    pt = torch.from_numpy(p4).to(tdt).requires_grad_(True)
    if with_ds:
        out_t = sp._PairedApplyDs.apply(
            pt, a.pair_mask, a.pair_scales, torch.from_numpy(ds), False
        )
    else:
        out_t = sp._PairedApply.apply(pt, a.pair_mask, a.pair_scales, False)
    _hold(out_t.detach().numpy(), np.asarray(out_j)[:, :n])
    out_t.backward(torch.from_numpy(ct))
    assert pt.grad.dtype == tdt and want.dtype == jdt
    return pt.grad.float().numpy(), np.asarray(want.astype(jnp.float32))


def _bf16_rounded(dtype, with_ds):
    return dtype == "bf16" or with_ds


VJP_CASES = [
    pytest.param("1,1", "f32", False, id="small_n-f32"),
    pytest.param("1,1", "bf16", False, id="small_n-bf16"),
    pytest.param("1,1", "f32", True, id="small_n-f32-ds"),
    pytest.param("0,0", "f32", False, id="ppi-f32"),
    pytest.param("0,0", "bf16", False, id="ppi-bf16"),
    pytest.param("0,0", "f32", True, id="ppi-f32-ds"),
]


@pytest.mark.parametrize("key,dtype,with_ds", VJP_CASES)
def test_paired_vjp_matches_reference(graphs, key, dtype, with_ds):
    ref, dg = graphs
    got, want = _vjps(ref, dg, key, 16, dtype, with_ds, seed=1)
    _hold(got, want, _bf16_rounded(dtype, with_ds))


@pytest.mark.parametrize("dtype,with_ds", [("f32", True), ("bf16", False)])
def test_paired_vjp_matches_reference_big_n_k_above_one(big_graphs, dtype, with_ds):
    ref, dg = big_graphs
    got, want = _vjps(ref, dg, "1,1", 8, dtype, with_ds, seed=2)
    _hold(got, want, _bf16_rounded(dtype, with_ds))


@pytest.mark.parametrize("with_ds", [False, True], ids=["no_ds", "ds"])
@pytest.mark.parametrize("out_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("key", ["1,1", "0,0"])
def test_paired_bwd_plain_matches_interpret_kernel(graphs, key, out_dtype, with_ds):
    """The kernel's plain version against the JAX backward kernel itself
    (``_bwd_call`` in interpret mode, K3 on drug-drug and K3's whole-N
    form on the PPI type at this size)."""
    ref, dg = graphs
    a_ref, a = ref.adj[key], dg.adj[key]
    p4, ct, ds = _world(a, 16, seed=3)
    _, k, h, n = p4.shape
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if out_dtype == "bf16" else (jnp.float32, torch.float32)
    want = jax_sp._bwd_call(
        jnp.asarray(ct), a_ref.pair_mask, a_ref.pair_scales, k, h, n,
        kb=jax_sp.default_kb(k, n), ds=_jax_ds(ds, a_ref) if with_ds else None,
        out_dtype=jdt, interpret=True,
    )
    got = sp.paired_bwd(
        torch.from_numpy(ct), a.pair_mask, a.pair_scales,
        torch.from_numpy(ds) if with_ds else None, tdt,
    )
    assert got.dtype == tdt
    _hold(got.float().numpy(), np.asarray(want.astype(jnp.float32)), out_dtype == "bf16")


@pytest.mark.parametrize("key", ["0,1", "1,0"])
def test_factored_vjp_matches_reference(graphs, key):
    ref, dg = graphs
    a_ref, a = ref.adj[key], dg.adj[key]
    rng = np.random.default_rng(4)
    p = rng.standard_normal((a.num_rel, a.n_cols, 16)).astype(np.float32)
    ct = rng.standard_normal((a.n_rows, 16)).astype(np.float32)
    out_j, vjp = jax.vjp(
        lambda q: jax_segment.spmm_dense_factored(
            q, a_ref.dense_mask, a_ref.dense_mask_t, a_ref.row_scale, a_ref.col_scale
        ),
        jnp.asarray(p),
    )
    (want,) = vjp(jnp.asarray(ct))
    pt = torch.from_numpy(p).requires_grad_(True)
    out = segment.spmm_dense_factored(
        pt, a.dense_mask, a.dense_mask_t, a.row_scale, a.col_scale
    )
    _hold(out.detach().numpy(), out_j)
    out.backward(torch.from_numpy(ct))
    _hold(pt.grad.numpy(), want)


@pytest.mark.parametrize("impl", ["xla", "dense"])
def test_spmm_vjp_matches_reference(impl):
    """The COO and dense forms on a graph built with the defaults."""
    g_ref = jax_graph(**SMALL)
    ref = jax_build(g_ref, jax_split(g_ref, val_frac=0.05, test_frac=0.05, seed=1),
                    build_fused=False)
    g = make_polypharmacy_like_graph(**SMALL)
    dg = build_device_graph(g, split_graph(g, val_frac=0.05, test_frac=0.05, seed=1),
                            device="cpu")
    rng = np.random.default_rng(5)
    for key in ("0,1", "1,1"):
        a_ref, a = ref.adj[key], dg.adj[key]
        p = rng.standard_normal((a.num_rel, a.n_cols, 8)).astype(np.float32)
        ct = rng.standard_normal((a.n_rows, 8)).astype(np.float32)
        out_j, vjp = jax.vjp(lambda q: jax_segment.spmm(q, a_ref, impl=impl), jnp.asarray(p))
        (want,) = vjp(jnp.asarray(ct))
        pt = torch.from_numpy(p).requires_grad_(True)
        out = segment.spmm(pt, a, impl=impl)
        _hold(out.detach().numpy(), out_j)
        out.backward(torch.from_numpy(ct))
        _hold(pt.grad.numpy(), want)
