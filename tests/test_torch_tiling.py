"""Host layouts of the sparse regime against the JAX package: degree
renumbering and the CSR edge layout of the K6 kernel.

Both are exact host computations: ``renumber_by_degree`` and
``restore_external_rows`` must equal the JAX ones bit for bit, and the
port's CSR must hold the same ``(dst, src, val)`` multiset, bitwise, as
the JAX package's packed tiles (decoded here), with zero-valued edges
dropped and duplicate pairs kept.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decagon_tpu.graph.container import NodeFeatures as JaxNodeFeatures
from decagon_tpu.graph.device import build_device_graph as jax_build
from decagon_tpu.graph.renumber import renumber_by_degree as jax_renumber
from decagon_tpu.graph.renumber import restore_external_rows as jax_restore
from decagon_tpu.graph.split import split_graph as jax_split
from decagon_tpu.graph.synthetic import make_polypharmacy_like_graph as jax_graph
from decagon_tpu.ops.tiling import build_tiles as jax_build_tiles
from decagon_tpu.train.checkpoint import export_ndarrays as jax_export
from decagon_tpu_torch.graph.container import NodeFeatures
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.renumber import renumber_by_degree, restore_external_rows
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.ops.tiling import (
    CHUNK_EDGES,
    CHUNK_ROWS,
    SEGMENT,
    SHORT,
    WINDOW,
    build_tiles,
    tiling_stats,
)
from decagon_tpu_torch.train.checkpoint import export_ndarrays

SMALL = dict(
    n_proteins=300, n_drugs=60, n_side_effects=6, min_edges_per_relation=20,
    ppi_attachment=5, seed=7,
)


def _with_dense_features(g, features_cls):
    """The graph with dense drug features (node type 1), so renumbering
    has a feature table to permute."""
    feats = np.random.default_rng(0).normal(size=(g.num_nodes[1], 5)).astype(np.float32)
    return dataclasses.replace(g, features={**g.features, 1: features_cls.from_dense(feats)})


@pytest.mark.parametrize("dense", [False, True], ids=["identity", "dense-features"])
def test_renumber_matches_reference_bitwise(dense):
    g_ref, g = jax_graph(**SMALL), make_polypharmacy_like_graph(**SMALL)
    if dense:
        g_ref, g = _with_dense_features(g_ref, JaxNodeFeatures), _with_dense_features(g, NodeFeatures)
    want, want_perms = jax_renumber(g_ref)
    got, perms = renumber_by_degree(g)
    assert sorted(perms) == sorted(want_perms)
    for t in perms:
        assert perms[t].dtype == want_perms[t].dtype
        np.testing.assert_array_equal(perms[t], want_perms[t])
    for et, rels in want.relations.items():
        for r_want, r_got in zip(rels, got.relations[et]):
            assert r_got.rows.dtype == r_want.rows.dtype
            np.testing.assert_array_equal(r_got.rows, r_want.rows)
            np.testing.assert_array_equal(r_got.cols, r_want.cols)
            assert r_got.transpose_of == r_want.transpose_of and r_got.shape == r_want.shape
    for t, f_want in want.features.items():
        assert got.features[t].kind == f_want.kind
        if f_want.kind == "dense":
            np.testing.assert_array_equal(got.features[t].dense, f_want.dense)
    table = np.random.default_rng(1).normal(size=(g.num_nodes[0], 3)).astype(np.float32)
    np.testing.assert_array_equal(
        restore_external_rows(table, perms[0]), jax_restore(table, want_perms[0])
    )
    # The permutation puts node degrees in descending order.
    deg = np.zeros(g.num_nodes[0], np.int64)
    for (i, j), rels in g.relations.items():
        for rel in rels:
            if i == 0:
                deg += np.bincount(rel.rows, minlength=g.num_nodes[0])
            if j == 0:
                deg += np.bincount(rel.cols, minlength=g.num_nodes[0])
    assert (np.diff(deg[perms[0]]) <= 0).all()


def test_export_restores_external_rows_as_reference(tmp_path):
    """``export_ndarrays(node_perms=...)``: the drug embeddings written in
    external row order, equal to the JAX export bit for bit."""
    g = make_polypharmacy_like_graph(**SMALL)
    _, perms = renumber_by_degree(g)
    s = split_graph(g, val_frac=0.05, test_frac=0.05, seed=1)
    dg = build_device_graph(g, s, device="cpu", build_fused=False)
    emb = np.random.default_rng(3).normal(size=(g.num_nodes[1], 4)).astype(np.float32)
    k = dg.adj["1,1"].num_rel
    rng = np.random.default_rng(4)
    params = {"dec": {"1,1": {"global": rng.normal(size=(4, 4)).astype(np.float32),
                              "local_diag": rng.normal(size=(k, 4)).astype(np.float32)}}}
    dg_ref = type("G", (), {"decoders": dg.decoders, "adj": dg.adj})()
    jax_export(params, {"1": jnp.asarray(emb)}, dg_ref, str(tmp_path / "jax"), node_perms=perms)
    export_ndarrays({"dec": {"1,1": {n: torch.from_numpy(v) for n, v in params["dec"]["1,1"].items()}}},
                    {"1": torch.from_numpy(emb)}, dg, str(tmp_path / "port"), node_perms=perms)
    got = np.load(tmp_path / "port" / "embeddings.npy")
    np.testing.assert_array_equal(got, np.load(tmp_path / "jax" / "embeddings.npy"))
    np.testing.assert_array_equal(got[perms[1]], emb)


def _decode(tiles):
    """The (dst, src, val bits) triples of a JAX ``TiledEdges``."""
    packed = np.asarray(tiles.packed)
    row_ptr = np.asarray(tiles.row_ptr)
    block_of_tile = np.searchsorted(row_ptr, np.arange(packed.shape[0]), side="right") - 1
    both = packed[:, 0, :].astype(np.int64) & 0xFFFFFFFF
    vals = packed[:, 1, :].view(np.float32)
    t, c = np.nonzero(vals != 0)
    dst = block_of_tile[t] * tiles.block_r + (both[t, c] >> 16)
    src = np.asarray(tiles.src_start).astype(np.int64)[t] + (both[t, c] & 0xFFFF)
    return _sorted_triples(dst, src, vals[t, c])


def _triples(csr):
    return _sorted_triples(csr.dst_index().numpy(), csr.col.numpy(), csr.val.numpy())


def _sorted_triples(dst, src, vals):
    bits = np.ascontiguousarray(vals, np.float32).view(np.int32).astype(np.int64)
    out = np.stack([np.asarray(dst, np.int64), np.asarray(src, np.int64), bits])
    return out[:, np.lexsort(out[::-1])]


def _edges(seed, n_src, n_dst, e):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_src, e)
    dst = rng.integers(0, n_dst, e)
    vals = rng.normal(size=e).astype(np.float32)
    vals[::13] = 0.0  # padding-like edges: dropped
    src[:40], dst[:40] = src[40:80], dst[40:80]  # duplicate pairs: kept
    return src, dst, vals


@pytest.mark.parametrize("geometry", [(64, 64, 64), (0, 0, 0)], ids=["64-blocks", "auto"])
@pytest.mark.parametrize("shape", [(200, 80, 5000), (2220, 61, 900), (61, 2220, 900)])
def test_csr_holds_the_reference_tiles_edges(shape, geometry):
    n_src, n_dst, e = shape
    src, dst, vals = _edges(sum(shape), n_src, n_dst, e)
    want = _decode(jax_build_tiles(src, dst, vals, n_src, n_dst, *geometry))
    csr = build_tiles(src, dst, vals, n_src, n_dst)
    np.testing.assert_array_equal(_triples(csr), want)
    assert csr.nnz == int((vals != 0).sum()) == want.shape[1]


def test_csr_layout_order_and_segments():
    """Rows by ascending source, duplicates in input order; short rows (at
    most ``SHORT`` edges, the empty one included) sit in row chunks; a
    medium row is one segment that writes its row; a long row splits into
    ``SEGMENT``-edge segments whose partial slots are contiguous and
    follow its edges."""
    n_src, n_dst = 3000, 7
    rng = np.random.default_rng(2)
    dst = np.concatenate([rng.integers(0, 5, 900), np.full(2 * SEGMENT + 3, 6)])
    src = rng.integers(0, n_src, dst.size)
    vals = (np.arange(dst.size) + 1).astype(np.float32)
    csr = build_tiles(src, dst, vals, n_src, n_dst)
    row_ptr, col, val = csr.row_ptr.numpy(), csr.col.numpy(), csr.val.numpy()
    for d in range(n_dst):
        seg = slice(row_ptr[d], row_ptr[d + 1])
        keys = np.stack([col[seg], val[seg]])
        assert (np.diff(col[seg]) >= 0).all()
        # ties (duplicate sources) keep the input order, i.e. rising vals
        assert (np.lexsort(keys[::-1]) == np.arange(keys.shape[1])).all()
    assert row_ptr[6] - row_ptr[5] == 0  # node 5 has no edges
    assert all(SHORT < row_ptr[d + 1] - row_ptr[d] <= SEGMENT for d in range(5))
    assert csr.row_chunks.numpy().tolist() == [[5, 6, row_ptr[5], row_ptr[6]]]
    long_segments = [[row_ptr[6] + i * SEGMENT, min(row_ptr[6] + (i + 1) * SEGMENT, row_ptr[7])]
                     for i in range(3)]
    assert csr.seg_edges.numpy().tolist() == [[row_ptr[d], row_ptr[d + 1]] for d in range(5)] + long_segments
    assert csr.seg_dst.numpy().tolist() == [0, 1, 2, 3, 4, ~0, ~1, ~2]
    assert csr.multi_row.numpy().tolist() == [6] and csr.multi_ptr.numpy().tolist() == [0, 3]
    # n_src lies inside one source window: the cuts are every SEGMENT edges
    assert csr.seg_order.numpy().tolist() == list(range(8)) and csr.window == WINDOW > n_src
    stats = tiling_stats(csr)
    assert stats["nnz"] == dst.size and stats["rows"] == n_dst
    assert stats["max_row"] == 2 * SEGMENT + 3
    assert (stats["short_rows"], stats["row_chunks"], stats["long_rows"]) == (1, 1, 1)
    assert (stats["segments"], stats["partial_slots"]) == (8, 3) == (csr.num_segments, csr.num_slots)


def _schedule_cover(csr):
    """Each edge's owner in the schedule, asserting the invariants on the
    way: the row chunks hold the short rows, each once, in order, within
    their limits; every other row's segments tile its edges in order, a
    medium row's one segment naming the row, a long row's segments naming
    its contiguous partial slots."""
    row_ptr = csr.row_ptr.numpy().astype(np.int64)
    counts = np.diff(row_ptr)
    owner = np.full(csr.nnz, -1, np.int64)
    chunks = csr.row_chunks.numpy().astype(np.int64)
    rows = np.concatenate([np.arange(a, b) for a, b, _, _ in chunks] + [np.zeros(0, np.int64)])
    assert rows.tolist() == np.flatnonzero(counts <= SHORT).tolist()
    assert (chunks[:, 2] == row_ptr[chunks[:, 0]]).all() and (chunks[:, 3] == row_ptr[chunks[:, 1]]).all()
    assert (chunks[:, 1] - chunks[:, 0] >= 1).all() and (chunks[:, 1] - chunks[:, 0] <= CHUNK_ROWS).all()
    assert (chunks[:, 3] - chunks[:, 2] <= CHUNK_EDGES).all()
    for d in rows:
        owner[row_ptr[d]:row_ptr[d + 1]] = -2  # a short row's edge
    edges = csr.seg_edges.numpy().astype(np.int64)
    seg_dst, order = csr.seg_dst.numpy(), csr.seg_order.numpy()
    assert (edges[:, 1] - edges[:, 0] >= 1).all() and (edges[:, 1] - edges[:, 0] <= SEGMENT).all()
    assert (edges[1:, 0] >= edges[:-1, 1]).all()  # segments in edge order
    seg_row = np.searchsorted(row_ptr, edges[:, 0], side="right") - 1
    per_row = np.bincount(seg_row, minlength=csr.n_dst)
    assert (per_row[counts > SHORT] >= 1).all() and (per_row[counts <= SHORT] == 0).all()
    for s, (lo, hi) in enumerate(edges):
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = s
        assert (seg_dst[s] == seg_row[s]) == (per_row[seg_row[s]] == 1)
    multi_row, multi_ptr = csr.multi_row.numpy(), csr.multi_ptr.numpy()
    assert multi_row.tolist() == np.flatnonzero(per_row > 1).tolist()
    slots = ~seg_dst[seg_dst < 0]
    assert slots.tolist() == list(range(csr.num_slots)) and multi_ptr[-1] == csr.num_slots
    for m, d in enumerate(multi_row):
        mine = seg_row[seg_dst < 0][multi_ptr[m]:multi_ptr[m + 1]]
        assert (mine == d).all() and mine.size == per_row[d]
    assert (owner != -1).all()  # every edge lies in one short row or one segment
    assert sorted(order.tolist()) == list(range(edges.shape[0]))
    return owner, edges, order


@pytest.mark.parametrize("lengths", [(0,), (7,), (SHORT,), (0, 1, 300, 7, 100)],
                         ids=["empty", "seven", "short-limit", "mixed"])
def test_row_chunks_respect_their_limits(lengths):
    """Thousands of rows of one length (or a mix with medium and long rows
    between the runs): chunks cut at ``CHUNK_ROWS`` rows and
    ``CHUNK_EDGES`` edges, broken by every row that is not short, covering
    every short row once."""
    counts = np.resize(np.asarray(lengths), 3000)
    dst = np.repeat(np.arange(counts.size), counts)
    src = np.random.default_rng(1).integers(0, 500, dst.size)
    csr = build_tiles(src, dst, np.ones(dst.size, np.float32), 500, counts.size)
    _schedule_cover(csr)
    assert tiling_stats(csr)["row_chunks"] == csr.row_chunks.shape[0] > 0


@pytest.mark.parametrize("window", [0, 1, 37, 400, 5000])
def test_schedule_covers_every_edge_once_in_a_fixed_order(window):
    """Short rows and segments cover every edge exactly once; a segment
    spans at most ``window`` source rows' window and ``SEGMENT`` edges; the
    launch order runs window by window, then row, then slot; the layout
    still holds the reference tiles' edges bit for bit."""
    n_src, n_dst = 4000, 90
    rng = np.random.default_rng(window)
    others = np.setdiff1d(np.arange(n_dst), [40, 41])
    dst = np.concatenate([rng.choice(others, 6000), np.full(5 * SEGMENT + 11, 3),
                          np.full(SEGMENT + 1, 40), np.full(SEGMENT, 41)])
    src = rng.integers(0, n_src, dst.size)
    vals = rng.normal(size=dst.size).astype(np.float32)
    vals[:-SEGMENT:31] = 0.0
    csr = build_tiles(src, dst, vals, n_src, n_dst, window=window)
    _, edges, order = _schedule_cover(csr)
    col = csr.col.numpy().astype(np.int64)
    assert 3 in csr.multi_row.numpy()
    if not window:  # exactly SEGMENT edges: one segment
        assert 41 not in csr.multi_row.numpy() and 41 in csr.seg_dst.numpy()
    if window:
        first_win = col[edges[:, 0]] // window
        assert (col[edges[:, 1] - 1] // window == first_win).all()
        rows = np.searchsorted(csr.row_ptr.numpy(), edges[:, 0], side="right") - 1
        keys = np.stack([first_win, rows, np.arange(edges.shape[0])])[:, order]
        assert (np.lexsort(keys[::-1]) == np.arange(order.size)).all()
    else:
        assert order.tolist() == list(range(edges.shape[0]))
    assert build_tiles(src, dst, vals, n_src, n_dst, window=window).seg_order.equal(csr.seg_order)
    want = _decode(jax_build_tiles(src, dst, vals, n_src, n_dst, 64, 64, 64))
    np.testing.assert_array_equal(_triples(csr), want)


def test_empty_relation():
    """No edges: every row is short (zeros from the row pass), no segment."""
    csr = build_tiles(np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.float32), 64, 50)
    assert csr.nnz == 0 and csr.num_segments == 0 and csr.multi_row.numel() == 0
    assert (csr.row_ptr.numpy() == 0).all() and tiling_stats(csr)["max_row"] == 0
    assert tiling_stats(csr)["short_rows"] == 50
    assert csr.row_chunks.numpy().tolist() == [[0, 50, 0, 0]]
    with pytest.raises(ValueError):
        build_tiles(np.array([64]), np.array([0]), np.array([1.0]), 64, 50)
    with pytest.raises(ValueError):
        build_tiles(np.array([0]), np.array([0]), np.array([1.0]), 64, 50, window=-1)


def test_device_graph_layouts_match_reference():
    """``tile_for_pallas`` on both packages: the same edge types tiled (by
    the dense-size gate), each direction's CSR holding the reference
    tiles' edges, and the fused stream equal array for array."""
    g_ref, g = jax_graph(**SMALL), make_polypharmacy_like_graph(**SMALL)
    s_ref = jax_split(g_ref, val_frac=0.05, test_frac=0.05, seed=1)
    s = split_graph(g, val_frac=0.05, test_frac=0.05, seed=1)
    kw = dict(tile_for_pallas=True, densify_max_cells=20_000, edge_pad_multiple=256)
    dg_ref = jax_build(g_ref, s_ref, tile_block=64, **kw)
    dg = build_device_graph(g, s, device="cpu", **kw)
    tiled = [k for k, a in dg_ref.adj.items() if a.tiles_fwd is not None]
    assert 0 < len(tiled) < len(dg_ref.adj)
    assert tiled == [k for k, a in dg.adj.items() if a.tiles_fwd is not None]
    for key in tiled:
        for direction in ("tiles_fwd", "tiles_bwd"):
            want = getattr(dg_ref.adj[key], direction)
            got = getattr(dg.adj[key], direction)
            np.testing.assert_array_equal(_triples(got), _decode(want))
    fa_ref, fa = dg_ref.fused, dg.fused
    assert fa.layout == fa_ref.layout and fa.terms == fa_ref.terms
    assert (fa.n_p_rows, fa.n_t_rows) == (fa_ref.n_p_rows, fa_ref.n_t_rows)
    for name in ("src", "dst", "vals"):
        np.testing.assert_array_equal(getattr(fa, name).numpy(), np.asarray(getattr(fa_ref, name)))
    np.testing.assert_array_equal(_triples(fa.tiles_fwd), _decode(fa_ref.tiles_fwd))
    np.testing.assert_array_equal(_triples(fa.tiles_bwd), _decode(fa_ref.tiles_bwd))
    untiled = build_device_graph(g, s, device="cpu", build_fused=False)
    assert untiled.fused is None and all(a.tiles_fwd is None for a in untiled.adj.values())
