"""Paired forward and factored aggregation of the port against the JAX
package, through the plain versions on the CPU (the CUDA kernel is held
against them on the card in ``test_torch_cuda.py``).

The paired cases cover the kernel's two TPU forms (the small-N whole-block
form on drug-drug, and the big-N 2D-blocked form, forced on the PPI type
by shrinking the JAX threshold) with f32 (layer 1) and bf16 (layer 2)
inputs.  Tolerances: the port's plain version has the reference's cast
points and sums in f32 in another order, so its relative error against
``paired_ref`` is held to 1e-4; the JAX interpret-mode kernel is held to
the 2e-2 its own tests use.
"""

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
from decagon_tpu_torch.ops import segment, spmm_paired as sp

SMALL = dict(
    n_proteins=300, n_drugs=60, n_side_effects=6, min_edges_per_relation=20,
    ppi_attachment=5, seed=7,
)


def _graphs(monkeypatch=None):
    """JAX and port device graphs from the same seeds.  With
    ``monkeypatch``, the JAX side builds the PPI type in its big-N form."""
    if monkeypatch is not None:
        monkeypatch.setattr(jax_sp, "BIG_N_THRESHOLD", 100)
        monkeypatch.setattr(jax_sp, "BIG_BLOCK", 64)
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


def _p4(adj, h, seed):
    k, n = adj.num_rel // 2, adj.n_rows
    return np.random.default_rng(seed).standard_normal((2, k, h, n)).astype(np.float32)


def _as_pair(p4, dtype):
    """The same p4 in both packages, in f32 or rounded to bf16 (both
    round to nearest even from the same f32 values)."""
    j = jnp.asarray(p4)
    t = torch.from_numpy(p4)
    if dtype == "bf16":
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


CASES = [
    pytest.param("1,1", "f32", id="small_n-f32"),
    pytest.param("1,1", "bf16", id="small_n-bf16"),
    pytest.param("0,0", "f32", id="big_n-f32"),
    pytest.param("0,0", "bf16", id="big_n-bf16"),
]


@pytest.mark.parametrize("key,dtype", CASES)
def test_paired_plain_matches_paired_ref(graphs, key, dtype):
    ref, dg = graphs
    p4 = _p4(dg.adj[key], 16, seed=1)
    pj, pt = _as_pair(p4, dtype)
    want = jax_sp.paired_ref(pj, ref.adj[key].pair_mask, ref.adj[key].pair_scales)
    got = sp.paired_fwd(pt, dg.adj[key].pair_mask, dg.adj[key].pair_scales)
    assert got.shape == want.shape
    assert _rel_err(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("key,dtype", CASES)
def test_paired_plain_matches_interpret_kernel(monkeypatch, key, dtype):
    ref, dg = _graphs(monkeypatch)
    adj_ref = ref.adj[key]
    big = adj_ref.pair_mask.shape[1] > jax_sp.BIG_N_THRESHOLD
    assert big == (key == "0,0")
    p4 = _p4(dg.adj[key], 8, seed=2)
    pj, pt = _as_pair(p4, dtype)
    k, n = p4.shape[1], p4.shape[3]
    want = jax_sp._fwd_call(
        pj, adj_ref.pair_mask, adj_ref.pair_scales,
        kb=jax_sp.default_kb(k, n), interpret=True,
    )[:, :n]
    got = sp.paired_fwd(pt, dg.adj[key].pair_mask, dg.adj[key].pair_scales)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("key", ["0,0", "1,1"])
@pytest.mark.parametrize("identity", [False, True], ids=["projected", "identity"])
def test_spmm_paired_matches_reference(graphs, key, identity):
    """The [N, H] entry points: layer 1 takes the raw f32 weights, layer 2
    casts the projection to bf16 first."""
    ref, dg = graphs
    p4 = _p4(dg.adj[key], 16, seed=3)
    if identity:
        want = jax_sp.spmm_paired_identity(
            jnp.asarray(p4), None, ref.adj[key], impl="paired_ref"
        )
        got = sp.spmm_paired_identity(torch.from_numpy(p4), None, dg.adj[key])
    else:
        want = jax_sp.spmm_paired(jnp.asarray(p4), ref.adj[key], impl="paired_ref")
        got = sp.spmm_paired(torch.from_numpy(p4), dg.adj[key])
    assert got.shape == want.shape
    assert _rel_err(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("key", ["0,1", "1,0"])
def test_dense_factored_matches_reference(graphs, key):
    ref, dg = graphs
    a_ref, a = ref.adj[key], dg.adj[key]
    p = np.random.default_rng(4).standard_normal(
        (a.num_rel, a.n_cols, 16)
    ).astype(np.float32)
    want = jax_segment.spmm_dense_factored(
        jnp.asarray(p), a_ref.dense_mask, a_ref.dense_mask_t,
        a_ref.row_scale, a_ref.col_scale,
    )
    got = segment.spmm_dense_factored(
        torch.from_numpy(p), a.dense_mask, a.dense_mask_t, a.row_scale, a.col_scale
    )
    assert _rel_err(got.numpy(), want) <= 1e-5


def test_l2_normalize_rows_matches_reference():
    x = np.random.default_rng(5).standard_normal((7, 5)).astype(np.float32)
    x[3] = 0.0
    x[4] = 1e-8  # below eps: scaled by rsqrt(eps), as tf.nn.l2_normalize
    want = jax_segment.l2_normalize_rows(jnp.asarray(x))
    got = segment.l2_normalize_rows(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


def test_paired_wrapper_rejects_bad_impl(graphs):
    _, dg = graphs
    p4 = torch.from_numpy(_p4(dg.adj["1,1"], 16, seed=6))
    with pytest.raises(ValueError):
        sp.spmm_paired(p4, dg.adj["1,1"], impl="dense")
    with pytest.raises(ValueError):
        sp.spmm_paired(p4, dg.adj["0,1"])
