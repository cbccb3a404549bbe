"""Graph layer of the port against the JAX package: the Barabasi-Albert
replica, the polypharmacy-like graph, the split and the device graph.

Inputs are made from seeds; the host layers must agree exactly, and the
device graphs over the region the port does not pad.
"""

import networkx as nx
import numpy as np
import pytest

from decagon_tpu.graph.device import build_device_graph as jax_build
from decagon_tpu.graph.split import split_graph as jax_split
from decagon_tpu.graph.synthetic import make_polypharmacy_like_graph as jax_graph
from decagon_tpu_torch.graph.container import Relation
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import (
    barabasi_albert_adjacency,
    make_polypharmacy_like_graph,
)

SMALL = dict(
    n_proteins=300, n_drugs=60, n_side_effects=6, min_edges_per_relation=20,
    ppi_attachment=5, seed=7,
)


@pytest.fixture(scope="module")
def both():
    g_ref = jax_graph(**SMALL)
    g = make_polypharmacy_like_graph(**SMALL)
    s_ref = jax_split(g_ref, val_frac=0.05, test_frac=0.05, seed=1)
    s = split_graph(g, val_frac=0.05, test_frac=0.05, seed=1)
    return g_ref, g, s_ref, s


@pytest.mark.parametrize(
    "n,m,seed", [(50, 3, 0), (300, 5, 7), (1000, 1, 3), (800, 37, 7)]
)
def test_barabasi_albert_matches_networkx(n, m, seed):
    want = Relation.from_scipy(
        nx.adjacency_matrix(nx.barabasi_albert_graph(n, m, seed=seed))
    )
    got = Relation.from_scipy(barabasi_albert_adjacency(n, m, seed))
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.cols, want.cols)


def test_polypharmacy_graph_matches_reference(both):
    g_ref, g, _, _ = both
    assert g.num_nodes == g_ref.num_nodes
    assert g.decoders == g_ref.decoders
    assert sorted(g.relations) == sorted(g_ref.relations)
    for et, rels in g_ref.relations.items():
        assert len(g.relations[et]) == len(rels)
        for want, got in zip(rels, g.relations[et]):
            np.testing.assert_array_equal(got.rows, want.rows)
            np.testing.assert_array_equal(got.cols, want.cols)
            assert (got.shape, got.name, got.transpose_of) == (
                want.shape, want.name, want.transpose_of
            )


def test_split_matches_reference(both):
    _, _, s_ref, s = both
    assert sorted(s) == sorted(s_ref)
    for key, want in s_ref.items():
        got = s[key]
        for field in (
            "train", "val", "test", "val_false", "test_false",
            "adj_rows", "adj_cols", "adj_vals",
        ):
            np.testing.assert_array_equal(
                getattr(got, field), getattr(want, field), err_msg=f"{key} {field}"
            )


def test_device_graph_matches_reference(both):
    g_ref, g, s_ref, s = both
    ref = jax_build(
        g_ref, s_ref, dense_factored=True, dense_paired=True, build_fused=False
    )
    dg = build_device_graph(
        g, s, dense_factored=True, dense_paired=True, device="cpu"
    )
    assert sorted(dg.adj) == sorted(ref.adj)
    assert dg.decoders == ref.decoders
    for key, want in ref.adj.items():
        got = dg.adj[key]
        for field in ("senders", "receivers", "rel", "vals"):
            np.testing.assert_array_equal(
                getattr(got, field).numpy(), np.asarray(getattr(want, field))
            )
        assert (got.pair_mask is None) == (want.pair_mask is None), key
        for field in ("dense_mask", "dense_mask_t", "row_scale", "col_scale"):
            if want.pair_mask is not None:
                # the paired form replaces the factored one in the port
                assert getattr(got, field) is None, f"{key} {field}"
                continue
            np.testing.assert_array_equal(
                getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                err_msg=f"{key} {field}",
            )
        if want.pair_mask is not None:
            k, n = got.num_rel // 2, got.n_rows
            assert tuple(got.pair_mask.shape) == (k, n, n)
            np.testing.assert_array_equal(
                got.pair_mask.numpy(), np.asarray(want.pair_mask)[:k, :n, :n]
            )
            np.testing.assert_array_equal(
                got.pair_scales.numpy(), np.asarray(want.pair_scales)[:k, :, :n]
            )
    assert {k for k, a in dg.adj.items() if a.pair_mask is not None} == {
        "0,0", "1,1"
    }


def test_pair_form_needs_transposed_halves(both):
    """The port builds the paired form only when relation K+k's stored
    adjacency is relation k's transpose (the JAX package trusts the
    ``transpose_of`` link alone)."""
    _, g, _, s = both
    broken = dict(s)
    k_half = len(g.relations[(1, 1)]) // 2
    direct, victim = s[(1, 1, 0)], s[(1, 1, k_half)]
    # Relation K's adjacency replaced by relation 0's own (not transposed):
    # still rank-1 normalized, but no longer the transpose.
    broken[(1, 1, k_half)] = type(victim)(
        train=victim.train, val=victim.val, test=victim.test,
        val_false=victim.val_false, test_false=victim.test_false,
        adj_rows=direct.adj_rows, adj_cols=direct.adj_cols,
        adj_vals=direct.adj_vals,
    )
    dg = build_device_graph(
        g, broken, dense_factored=True, dense_paired=True, device="cpu"
    )
    assert dg.adj["1,1"].dense_mask is not None
    assert dg.adj["1,1"].pair_mask is None
    assert dg.adj["0,0"].pair_mask is not None


def test_count_mask_adds_duplicate_edges():
    """Duplicate cells count every edge (scatter-add, not set)."""
    import torch

    from decagon_tpu_torch.graph.device import _count_mask

    idx = (torch.tensor([0, 0, 1]), torch.tensor([2, 2, 0]), torch.tensor([1, 1, 1]))
    mask = _count_mask((2, 3, 2), idx, torch.ones(3, dtype=torch.int8), "cpu")
    assert mask[0, 2, 1] == 2 and mask[1, 0, 1] == 1 and int(mask.sum()) == 3
