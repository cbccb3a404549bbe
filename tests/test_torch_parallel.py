"""The port's mesh parallelism (``decagon_tpu_torch/parallel``) against the
JAX package's, on the CPU.

The JAX side runs in this process on the 8 virtual CPU devices of
``tests/conftest.py`` (meshes of the first 4); the port runs in one
spawned world of 4 gloo ranks (``tests/torch_mesh_ranks.parity_world``),
which computes every check that needs ranks and returns its results.
The world is the JAX mesh tests' (``tests/test_parallel.py``): 80 genes,
48 drugs, 2 drug-drug types, hidden 16 -> 8, dropout 0, the JAX package's
initial weights carried across with ``models/convert.py``, and 64 random
(1, 1, 0) pairs scored by ``sum(tanh(scores))``.

Tolerances, as ``tests/test_parallel.py`` holds the JAX mesh: the loss to
``rtol=1e-5``, gradients to ``rtol=2e-4, atol=1e-5``, embeddings to
``rtol=2e-5, atol=1e-6``; the sharded layout bit for bit; a port run
against itself (overlap on and off, chunk against single steps, a
checkpoint round trip) bit for bit.  Where the mesh's Adam steps are held
against the single process's, parameters to ``rtol=1e-4, atol=1e-6`` and
losses to ``rtol=1e-5``, as the JAX test holds weight sharding against
whole stacks; the bf16 row reduce to ``rtol=2e-2`` of the f32 losses.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from decagon_tpu.graph.device import build_device_graph as jax_build
from decagon_tpu.graph.split import split_graph as jax_split
from decagon_tpu.graph.synthetic import make_synthetic_graph as jax_synthetic
from decagon_tpu.models.model import DecagonModel as JaxModel
from decagon_tpu.models.model import ModelConfig as JaxConfig
from decagon_tpu.ops.tiling import TiledEdges
from decagon_tpu.parallel.mesh import make_mesh as jax_make_mesh
from decagon_tpu.parallel.rowshard import build_sharded_device_graph as jax_build_sharded
from decagon_tpu.parallel.rowshard import sharded_pspecs
from decagon_tpu.parallel.sharded import encode_sharded as jax_encode_sharded
from decagon_tpu.train.step import TrainConfig as JaxTrainConfig
from decagon_tpu.train.trainer import Trainer as JaxTrainer
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.models.convert import adam_state_from_numpy, params_from_numpy
from decagon_tpu_torch.ops.optim import tree_map
from decagon_tpu_torch.parallel.rowshard import build_sharded_device_graph
from decagon_tpu_torch.train.checkpoint import Checkpointer
from decagon_tpu_torch.train.step import (
    TrainConfig,
    make_grouped_chunked_train_step,
    make_optimizer,
    value_and_grad,
)
from decagon_tpu_torch.train.trainer import Trainer
from tests import torch_mesh_ranks as ranks

W = ranks.World()
JAX_IMPL = {"xla": "xla", "dense": "dense", "pallas": "pallas_interpret", "paired": "paired",
            "fused_pallas": "fused_pallas"}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, dtype=np.float64) if not np.isscalar(tree) else tree}


def _close(got, want, rtol, atol):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for name in w:
        np.testing.assert_allclose(g[name], w[name], rtol=rtol, atol=atol, err_msg=name)


def _equal(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for name in w:
        np.testing.assert_array_equal(g[name], w[name], err_msg=name)


@pytest.fixture(scope="module")
def jax_world():
    graph = jax_synthetic(n_genes=W.n_genes, n_drugs=W.n_drugs, n_drugdrug_types=W.n_types,
                          seed=0)
    splits = jax_split(graph, val_frac=0.15, test_frac=0.1, seed=3)
    dg = jax_build(graph, splits, edge_pad_multiple=256)
    model = JaxModel(JaxConfig(hidden1=W.hidden1, hidden2=W.hidden2, dropout=0.0), dg)
    params = model.init_params(jax.random.PRNGKey(0), dg)
    rng = np.random.default_rng(0)
    rows = rng.integers(0, W.n_drugs, size=W.batch).astype(np.int32)
    cols = rng.integers(0, W.n_drugs, size=W.batch).astype(np.int32)
    return graph, splits, dg, model, params, rows, cols


@pytest.fixture(scope="module")
def port_single(jax_world):
    """The port's single process on the same graph, weights and pairs."""
    params_np = jax.device_get(jax_world[4])
    graph, splits = ranks.make_graph(W)
    dg = build_device_graph(graph, splits, edge_pad_multiple=256, device="cpu")
    model = ranks._model(W, dg)
    params = params_from_numpy(params_np, "cpu")
    rows, cols = (torch.from_numpy(a) for a in jax_world[5:7])

    def loss_fn(p):
        emb = model.embeddings(p, dg)
        return torch.sum(torch.tanh(model.score_edges(p, dg, emb, (1, 1), 0, rows, cols)))

    loss, grads = value_and_grad(loss_fn, params)
    emb = model.embeddings(params, dg)
    return dict(graph=graph, splits=splits, dg=dg, model=model, params=params,
                loss=float(loss), grads=ranks.to_numpy(grads), emb=ranks.to_numpy(emb))


@pytest.fixture(scope="module")
def jax_trained_state(jax_world):
    """A JAX mesh trainer's (2, 2) state after 2 batches, weight-sharded."""
    graph, splits, dg, model, _, _, _ = jax_world
    t = JaxTrainer(model, graph, splits, dg, JaxTrainConfig(batch_size=W.batch), seed=0,
                   mesh=jax_make_mesh(shape=(2, 2)))
    assert t.shard_weights
    for b in list(t.scheduler.epoch())[:2]:
        t.train_batch(b)
    state = jax.device_get(t.state_dict())
    emb = jax.device_get(t.eval_embeddings())
    return state, emb


@pytest.fixture(scope="module")
def world(jax_world, jax_trained_state, tmp_path_factory):
    """The port's 4-rank world: {rank: results}."""
    params_np = jax.device_get(jax_world[4])
    state = jax_trained_state[0]
    port_state = {"params": params_from_numpy(state["params"], "cpu"),
                  "opt_state": adam_state_from_numpy(state["opt_state"], "cpu"),
                  "global_step": int(state["global_step"]), "opt_step": int(state["opt_step"])}
    ckpt = str(tmp_path_factory.mktemp("mesh_ckpt"))
    out = ranks.run_world(ranks.parity_world, 4, W, params_np, jax_world[5], jax_world[6], ckpt,
                          port_state)
    out["ckpt_dir"] = ckpt
    return out


def _jax_loss_grads_emb(jax_world, shape, impl):
    graph, splits, dg, model, params, rows, cols = jax_world
    mesh = jax_make_mesh(shape=shape)
    tiled = impl == "pallas"
    sg = jax_build_sharded(graph, splits, mesh, tile_for_pallas=tiled, tile_block=64 if tiled else 0,
                           tile_even_if_dense=tiled)
    k = jnp.int32(0)

    def local(params, g, r, c):
        def loss(p):
            emb = jax_encode_sharded(p, g, None, deterministic=True, spmm_impl=JAX_IMPL[impl])
            s = model.score_edges(p, g, emb, (1, 1), k, r, c, deterministic=True)
            return jnp.sum(jnp.tanh(s)), emb

        (value, emb), grads = jax.value_and_grad(loss, has_aux=True)(params)
        return (jax.lax.psum(value, ("row", "edge")), jax.lax.psum(grads, ("row", "edge")), emb)

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), sharded_pspecs(sg), P(("row", "edge")), P(("row", "edge"))),
        out_specs=(P(), P(), P()), check_vma=False,
    ))
    loss, grads, emb = jax.device_get(fn(params, sg, jnp.asarray(rows), jnp.asarray(cols)))
    return float(loss), grads, emb


# ---- the layout, with no processes -------------------------------------------


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


def _sorted_triples(dst, src, vals):
    bits = np.ascontiguousarray(vals, np.float32).view(np.int32).astype(np.int64)
    out = np.stack([np.asarray(dst, np.int64), np.asarray(src, np.int64), bits])
    return out[:, np.lexsort(out[::-1])]


def _slot_tiles(stacked, s):
    return TiledEdges(
        packed=np.asarray(stacked.packed)[s], src_start=np.asarray(stacked.src_start)[s],
        row_ptr=np.asarray(stacked.row_ptr)[s], n_dst=stacked.n_dst, n_src=stacked.n_src,
        block_r=stacked.block_r, block_s=stacked.block_s, tile_c=stacked.tile_c,
    )


@pytest.mark.parametrize("shape", ranks.SHAPES)
def test_sharded_layout_matches_jax_slot_by_slot(jax_world, port_single, shape):
    graph, splits = jax_world[:2]
    mesh = jax_make_mesh(shape=shape)
    want = jax_build_sharded(graph, splits, mesh, tile_for_pallas=True, tile_block=64,
                             tile_even_if_dense=True)
    assert any(a.dense is not None for a in want.adj.values())
    for slot in range(4):
        got = build_sharded_device_graph(port_single["graph"], port_single["splits"], shape, slot,
                                         device="cpu", tile_for_pallas=True,
                                         tile_even_if_dense=True)
        assert got.mesh_shape == want.mesh_shape and got.num_nodes == want.num_nodes
        assert got.decoders == want.decoders and got.edge_types == want.edge_types
        for key, w in want.adj.items():
            g = got.adj[key]
            for name in ("senders", "receivers", "rel", "vals"):
                np.testing.assert_array_equal(getattr(g, name).numpy(),
                                              np.asarray(getattr(w, name))[slot], err_msg=name)
            assert (g.num_rel, g.n_rows, g.n_cols, g.n_rows_block, g.k_loc) == (
                w.num_rel, w.n_rows, w.n_cols, w.n_rows_block, w.k_loc)
            if w.dense is None:
                assert g.dense is None
            else:
                np.testing.assert_array_equal(g.dense.numpy(), np.asarray(w.dense)[slot])
            # The JAX tiles pad their spaces to TPU blocks; the CSR does not.
            space = (g.n_rows_block, g.num_rel * g.n_cols)
            for direction, dims in (("fwd", space), ("bwd", space[::-1])):
                csr = getattr(g, f"tiles_{direction}")
                jt = _slot_tiles(getattr(w, f"tiles_{direction}"), slot)
                assert (csr.n_dst, csr.n_src) == dims
                np.testing.assert_array_equal(
                    _sorted_triples(csr.dst_index().numpy(), csr.col.numpy(), csr.val.numpy()),
                    _decode(jt))
            np.testing.assert_array_equal(got.neg_cdf[key].numpy(), np.asarray(want.neg_cdf[key]))


def test_sharded_graph_rejects_a_slot_outside_the_mesh(port_single):
    with pytest.raises(ValueError, match="outside"):
        build_sharded_device_graph(port_single["graph"], port_single["splits"], (2, 2), 4,
                                   device="cpu")


# ---- the sharded encoder and its gradients --------------------------------


@pytest.mark.parametrize("impl", ranks.IMPLS)
@pytest.mark.parametrize("shape", ranks.SHAPES)
def test_sharded_encoder_matches_jax_and_single_process(jax_world, port_single, world, shape,
                                                        impl):
    got = world[0][f"enc/{shape}/{impl}"]
    loss, grads, emb = _jax_loss_grads_emb(jax_world, shape, impl)
    for want_loss, want_grads, want_emb in (
        (loss, grads, emb), (port_single["loss"], port_single["grads"], port_single["emb"])
    ):
        np.testing.assert_allclose(float(got["loss"]), want_loss, rtol=1e-5)
        _close(got["grads"], want_grads, rtol=2e-4, atol=1e-5)
        _close(got["emb"], want_emb, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("shape", ranks.SHAPES)
def test_weight_sharded_grads_match_single_process(port_single, world, shape):
    got = world[0][f"wsharded/{shape}"]
    assert got["keys"], "the world must densify at least one edge type"
    ne = shape[1]
    for key, local in got["local_shape"].items():
        k = port_single["params"]["enc1"][key].shape[0]
        assert local[0] == -(-k // ne)
    np.testing.assert_allclose(float(got["loss"]), port_single["loss"], rtol=1e-5)
    _close(got["grads"], port_single["grads"], rtol=2e-4, atol=1e-5)


def test_comm_overlap_on_and_off_equal_bit_for_bit(world):
    assert world[0]["overlap_equal"]


def test_sharded_pallas_ref_equals_pallas_on_the_cpu(world):
    assert world[0]["pallas_ref_equal"]


def test_sharded_encoder_refuses_what_it_does_not_run(port_single, world):
    """The interpret names raise ``NotImplementedError`` and an unknown name
    ``ValueError``, as in the single-process encoder, before any
    collective; the names without a sharded form of their own ("paired",
    "fused") take the COO stream, as the JAX mesh routes them: on the
    (2, 2) mesh, the "xla" loss, gradients and embeddings bit for bit."""
    from decagon_tpu_torch.parallel.sharded import encode_sharded

    sg = build_sharded_device_graph(port_single["graph"], port_single["splits"], (1, 1), 0,
                                    device="cpu")
    for impl, err in (("pallas_interpret", NotImplementedError),
                      ("paired_interpret", NotImplementedError),
                      ("fused_pallas_interpret", NotImplementedError),
                      ("no_such_impl", ValueError)):
        with pytest.raises(err):
            encode_sharded(port_single["params"], sg, None, spmm_impl=impl)
    assert world[0]["coo_equal"] == {"paired": True, "fused_pallas": True, "fused": True}


def test_mesh_trainer_trains_the_coo_stream_impls(jax_world, port_single, world):
    """``Trainer(mesh=...)`` with "paired" or "fused_pallas" trains (it
    raised before): the sharded graph has no pair masks, so the stacks
    keep the [K, F, H] layout, as the JAX mesh's do, weight sharding is
    off, and two batches give the "xla" trainer's losses and parameters
    bit for bit."""
    from decagon_tpu.models.encoder import paired_edge_types as jax_paired_edge_types
    from decagon_tpu_torch.models.encoder import paired_edge_types

    sg_jax = jax_build_sharded(jax_world[0], jax_world[1], jax_make_mesh(shape=(2, 2)))
    sg = build_sharded_device_graph(port_single["graph"], port_single["splits"], (2, 2), 0,
                                    device="cpu")
    assert jax_paired_edge_types(sg_jax, "paired") == paired_edge_types(sg, "paired") == set()
    got = world[0]["coo_trainer"]
    want_shapes = {k: tuple(v.shape) for k, v in port_single["params"]["enc1"].items()}
    for impl in ("paired", "fused_pallas"):
        assert got[impl]["equal"], impl
        assert not got[impl]["shard_weights"]
        assert got[impl]["enc1_shapes"] == want_shapes


def test_group_reduction_matches_single_process(port_single, world):
    """The encoder's process-group sum (the JAX ``axis_name``): ranks
    holding every fourth edge give the single process's embeddings and,
    summed, its gradients."""
    got = world[0]["group"]
    np.testing.assert_allclose(float(got["loss"]), port_single["loss"], rtol=1e-5)
    _close(got["grads"], port_single["grads"], rtol=2e-4, atol=1e-5)
    _close(got["emb"], port_single["emb"], rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["all_reduce_sum", "edge_accum", "gather_rows"])
def test_collective_adjoints(world, name):
    res = {r: world[r][f"coll/{name}"] for r in range(4)}
    xs = {r: res[r]["x"] for r in res}
    cts = {r: res[r]["ct"] for r in res}
    for r in range(4):
        if name == "gather_rows":
            # (2, 2) mesh: rank r * 2 + e; its row group is {e, 2 + e}.
            e, row = r % 2, r // 2
            want_y = np.concatenate([xs[e], xs[2 + e]])[:5]
            padded = sum(np.concatenate([cts[q], np.zeros((1, 4))]) for q in range(4))
            want_gx = padded[row * 3 : (row + 1) * 3]
        else:
            want_y = sum(xs.values())
            want_gx = sum(cts.values()) if name == "all_reduce_sum" else cts[r]
        np.testing.assert_allclose(res[r]["y"], want_y, rtol=1e-12)
        np.testing.assert_allclose(res[r]["gx"], want_gx, rtol=1e-12)


# ---- the mesh Trainer -------------------------------------------------------


def test_mesh_train_step_learns(world):
    losses = world[0]["learns"]
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def test_weight_sharded_trainer_matches_replicated_trainer(world):
    rep, sh = world[0]["trainer/replicated"], world[0]["trainer/sharded"]
    assert (rep["shard_weights"], sh["shard_weights"]) == (False, True)
    np.testing.assert_allclose(sh["losses"], rep["losses"], rtol=1e-5)
    _close(sh["state"]["params"], rep["state"]["params"], rtol=1e-4, atol=1e-6)


def test_bf16_row_reduce_tracks_f32(world):
    np.testing.assert_allclose(world[0]["trainer/bf16"]["losses"],
                               world[0]["trainer/sharded"]["losses"], rtol=2e-2)


def test_mesh_chunk_equals_single_steps(world):
    assert world[0]["chunk_equal"]


def test_mesh_grouped_chunk_matches_single_process(port_single, world):
    """The sharded grouped chunk against the single process's grouped
    chunk from the same state, batches and negative uniforms."""
    got = world[0]["grouped"]
    cfg = TrainConfig(batch_size=W.batch, scan_chunk=3, schedule="balanced", relation_group=2)
    model = port_single["model"]
    start = ranks.from_numpy(got["start"])
    opt = make_optimizer(cfg)
    # The moments travelled as f32 (exact for bf16 values).
    state = {"m": tree_map(lambda t: t.to(torch.bfloat16), start["opt_state"]["m"]),
             "v": tree_map(lambda t: t.to(torch.bfloat16), start["opt_state"]["v"]),
             "t": int(start["opt_state"]["t"])}
    chunk = make_grouped_chunked_train_step(model, port_single["dg"], cfg, opt)
    branch, ks, rows, cols, step_no, valid = got["args"]
    neg_u = [[torch.from_numpy(u) for u in slot] for slot in got["neg_u"]]
    params, _, losses = chunk(start["params"], state, port_single["dg"], 3, branch, ks,
                              torch.from_numpy(rows), torch.from_numpy(cols), step_no, valid,
                              neg_u=neg_u)
    np.testing.assert_allclose(got["losses"], losses.numpy(), rtol=1e-5)
    _close(got["end"]["params"], ranks.to_numpy(params), rtol=1e-4, atol=1e-6)


def test_mesh_checkpoint_restores_into_other_topologies(port_single, world):
    """A (2, 2) checkpoint restores into (1, 4) and into the single-process
    trainer with equal state."""
    ck = world[0]["ckpt"]
    assert ck["resumed"] and np.isfinite(ck["next_loss"])
    _equal(ck["restored"], ck["saved"])
    single = Trainer(port_single["model"], port_single["graph"], port_single["splits"],
                     port_single["dg"], TrainConfig(batch_size=W.batch, learning_rate=1e-2),
                     seed=0)
    assert single.try_resume(Checkpointer(world["ckpt_dir"]))
    _equal(ranks.to_numpy(single.state_dict()), ck["saved"])


def test_mesh_trainer_takes_the_jax_mesh_state(jax_trained_state, world):
    """A JAX mesh trainer's state, carried across with ``models/convert.py``,
    starts the port's (2, 2) mesh trainer: its gathered state equals the
    JAX state and its sharded embeddings the JAX mesh's."""
    state, emb = jax_trained_state
    got = world[0]["fromjax"]
    assert got["shard_weights"]
    want = {"params": state["params"],
            "opt_state": {k: state["opt_state"][k] for k in ("m", "v", "t")},
            "global_step": state["global_step"], "opt_step": state["opt_step"]}
    want = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), want)
    _equal(got["state"], want)
    _close(got["emb"], emb, rtol=2e-5, atol=1e-6)
