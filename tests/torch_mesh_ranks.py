"""Spawned ``torch.distributed`` worlds for the mesh tests.

``run_world(target, n_ranks, *args)`` starts ``n_ranks`` processes (the
``spawn`` method), each joins a gloo group over localhost with one CPU
thread and runs ``target(rank, *args)``; the parent collects every rank's
return value through a queue, within a time limit, and kills the ranks
when it runs out or one fails: a hang fails the test that started the
world instead of eating the run's clock.  The targets here import neither
JAX nor the JAX package: the test files compute the JAX side in their own
process and compare.

Each world target runs several checks and returns numpy arrays, so that
one world serves many tests.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import queue as queue_mod
import time
import traceback
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from decagon_tpu_torch.scripts.worlds import free_port

WORLD_TIMEOUT_S = 240


def _rank_main(target, rank, n_ranks, port, results, env, init, args):
    torch.set_num_threads(1)
    os.environ.update(env)
    try:
        if init:
            dist.init_process_group(
                "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=n_ranks, rank=rank,
                timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S),
            )
            out = target(rank, *args)
        else:
            out = target(rank, n_ranks, port, *args)
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the test
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(target, n_ranks: int, *args, timeout: float = WORLD_TIMEOUT_S,
              env: Dict[str, str] = None, init: bool = True) -> Dict[int, Any]:
    """``{rank: target(rank, *args)}`` from ``n_ranks`` spawned gloo ranks
    (with ``init=False`` the ranks join no group and run ``target(rank,
    n_ranks, port, *args)``).  Raises with the rank's traceback if one
    fails, and ``TimeoutError`` when the world has not answered within
    ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [
        ctx.Process(target=_rank_main,
                    args=(target, rank, n_ranks, port, results, dict(env or {}), init, args),
                    daemon=True)
        for rank in range(n_ranks)
    ]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < n_ranks:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"world of {n_ranks} ranks: no answer within {timeout} s "
                                   f"(answered: {sorted(out)})")
            try:
                rank, ok, payload = results.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank died with exit code {dead[0]}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            out[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return out


# ---- shared set-up -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class World:
    """The JAX mesh tests' graph (``tests/test_parallel.py``): 80 genes, 48
    drugs, 2 drug-drug types, split seed 3; hidden 16 -> 8, dropout 0."""

    n_genes: int = 80
    n_drugs: int = 48
    n_types: int = 2
    hidden1: int = 16
    hidden2: int = 8
    batch: int = 64


def make_graph(w: World):
    from decagon_tpu_torch.graph.split import split_graph
    from decagon_tpu_torch.graph.synthetic import make_synthetic_graph

    graph = make_synthetic_graph(n_genes=w.n_genes, n_drugs=w.n_drugs,
                                 n_drugdrug_types=w.n_types, seed=0)
    splits = split_graph(graph, val_frac=0.15, test_frac=0.1, seed=3)
    return graph, splits


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


def from_numpy(tree):
    if isinstance(tree, dict):
        return {k: from_numpy(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree, copy=True))
    return tree


def _model(w: World, dg, **kw):
    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig

    return DecagonModel(ModelConfig(hidden1=w.hidden1, hidden2=w.hidden2, dropout=0.0, **kw), dg)


def _tanh_loss_grads(model, params, sg, mesh, rows, cols, impl, keys=frozenset(), overlap=True):
    """The JAX tests' ``sum(tanh(scores))`` on relation (1, 1, 0) over this
    rank's batch slice, summed over the mesh, and the embeddings."""
    from decagon_tpu_torch.parallel.mesh import mesh_shape
    from decagon_tpu_torch.parallel.sharded import encode_sharded, reduce_gradients
    from decagon_tpu_torch.train.step import value_and_grad

    nr, ne = mesh_shape(mesh)
    lb = rows.shape[0] // (nr * ne)
    sl = slice(sg.slot * lb, (sg.slot + 1) * lb)
    out = {}

    def loss_fn(p):
        emb = encode_sharded(p, sg, mesh, spmm_impl=impl, sharded_keys=keys, overlap=overlap)
        out["emb"] = emb
        scores = model.score_edges(p, sg, emb, (1, 1), 0, rows[sl], cols[sl])
        return torch.sum(torch.tanh(scores))

    loss, grads = value_and_grad(loss_fn, params)
    loss, grads = reduce_gradients(loss, grads, keys, mesh)
    return loss, grads, out["emb"]


# ---- the parity world (tests/test_torch_parallel.py) -----------------------

SHAPES = ((1, 4), (2, 2), (4, 1))
# "paired" and "fused_pallas" take the COO stream on the mesh, as in the
# JAX package.
IMPLS = ("xla", "dense", "pallas", "paired", "fused_pallas")


def parity_world(rank: int, w: World, params_np, rows_np, cols_np, ckpt_dir: str,
                 jax_state=None):
    """Every mesh check of ``tests/test_torch_parallel.py`` that needs
    ranks.  Returns numpy results (rank 0's in full; every rank's where the
    test compares ranks)."""
    from decagon_tpu_torch.graph.device import build_device_graph
    from decagon_tpu_torch.parallel import collectives as coll
    from decagon_tpu_torch.parallel.mesh import make_mesh, mesh_groups
    from decagon_tpu_torch.parallel.rowshard import build_sharded_device_graph
    from decagon_tpu_torch.parallel.sharded import (
        gather_relation_blocks,
        local_relation_block,
        shardable_weight_keys,
    )

    graph, splits = make_graph(w)
    params = from_numpy(params_np)
    rows, cols = torch.from_numpy(rows_np), torch.from_numpy(cols_np)
    dg = build_device_graph(graph, splits, edge_pad_multiple=256, device="cpu")
    model = _model(w, dg)
    res: Dict[str, Any] = {}

    for shape in SHAPES:
        mesh = make_mesh(shape=shape, backend="gloo")
        sg = build_sharded_device_graph(graph, splits, shape, rank, device="cpu")
        sg_tiled = build_sharded_device_graph(graph, splits, shape, rank, device="cpu",
                                              tile_for_pallas=True, tile_even_if_dense=True)
        outs = {}
        for impl in IMPLS:
            g = sg_tiled if impl == "pallas" else sg
            outs[impl] = _tanh_loss_grads(model, params, g, mesh, rows, cols, impl)
            loss, grads, emb = outs[impl]
            res[f"enc/{shape}/{impl}"] = to_numpy({"loss": loss, "grads": grads, "emb": emb})
        if shape == (2, 2):
            # The names without a sharded form of their own take the COO
            # stream: "xla"'s bits.
            outs["fused"] = _tanh_loss_grads(model, params, sg, mesh, rows, cols, "fused")
            res["coo_equal"] = {impl: _tree_equal(outs[impl], outs["xla"])
                                for impl in ("paired", "fused_pallas", "fused")}
        # Weight-sharded: local relation blocks in, gathered gradients out.
        keys = shardable_weight_keys(sg)
        local = local_relation_block(params, sg)
        loss, grads, emb = _tanh_loss_grads(model, local, sg, mesh, rows, cols, "auto", keys)
        res[f"wsharded/{shape}"] = to_numpy({
            "loss": loss, "grads": gather_relation_blocks(grads, sg, mesh), "keys": sorted(keys),
            "local_shape": {k: tuple(local["enc1"][k].shape) for k in keys}})
        if shape == (2, 2):
            outs = {}
            for overlap in (True, False):
                for impl, g, kk, p in (("auto", sg, keys, local), ("pallas", sg_tiled,
                                                                   frozenset(), params)):
                    outs[(overlap, impl)] = _tanh_loss_grads(model, p, g, mesh, rows, cols,
                                                             impl, kk, overlap=overlap)
            res["overlap_equal"] = all(
                _tree_equal(outs[(True, impl)], outs[(False, impl)]) for impl in ("auto", "pallas"))
            # "pallas_ref" is K6's plain version on any device: on the CPU,
            # "pallas" runs the same.
            res["pallas_ref_equal"] = _tree_equal(
                outs[(True, "pallas")],
                _tanh_loss_grads(model, params, sg_tiled, mesh, rows, cols, "pallas_ref"))

            # The three collectives' adjoints.
            row_g, edge_g = mesh_groups(mesh)
            gen = torch.Generator().manual_seed(100 + rank)
            x = torch.randn(3, 5, generator=gen, dtype=torch.float64)
            ct = torch.randn(3, 5, generator=gen, dtype=torch.float64)
            for name, fn in (("all_reduce_sum", coll.all_reduce_sum(None)),
                             ("edge_accum", coll.edge_accum(None))):
                xi = x.clone().requires_grad_(True)
                y = fn(xi)
                (gx,) = torch.autograd.grad(y, xi, ct)
                res[f"coll/{name}"] = to_numpy({"x": x, "ct": ct, "y": y, "gx": gx})
            block = torch.randn(3, 4, generator=gen, dtype=torch.float64)
            ctg = torch.randn(5, 4, generator=gen, dtype=torch.float64)
            bi = block.clone().requires_grad_(True)
            y = coll.gather_rows(row_g, (row_g, edge_g), 5, 3, 2)(bi)
            (gb,) = torch.autograd.grad(y, bi, ctg)
            res["coll/gather_rows"] = to_numpy({"x": block, "ct": ctg, "y": y, "gx": gb})

    # The encoder's process-group reduction (the JAX ``axis_name``): each
    # rank holds every fourth edge, the aggregations are summed over the
    # world.
    part = {key: dataclasses.replace(s, adj_rows=s.adj_rows[rank::4], adj_cols=s.adj_cols[rank::4],
                                     adj_vals=s.adj_vals[rank::4])
            for key, s in splits.items()}
    dg_part = build_device_graph(graph, part, edge_pad_multiple=256, device="cpu")
    from decagon_tpu_torch.parallel.sharded import reduce_gradients
    from decagon_tpu_torch.train.step import value_and_grad

    mesh = make_mesh(shape=(1, 4), backend="gloo")
    lb = rows.shape[0] // 4
    sl = slice(rank * lb, (rank + 1) * lb)
    holder = {}

    def group_loss(p):
        emb = model.embeddings(p, dg_part, group=dist.group.WORLD)
        holder["emb"] = emb
        return torch.sum(torch.tanh(model.score_edges(p, dg_part, emb, (1, 1), 0, rows[sl],
                                                      cols[sl])))

    loss, grads = value_and_grad(group_loss, params)
    loss, grads = reduce_gradients(loss, grads, frozenset(), mesh)
    res["group"] = to_numpy({"loss": loss, "grads": grads, "emb": holder["emb"]})

    res.update(trainer_checks(rank, w, graph, splits, dg, model, ckpt_dir))
    if jax_state is not None:
        from decagon_tpu_torch.train.step import TrainConfig
        from decagon_tpu_torch.train.trainer import Trainer

        t = Trainer(model, graph, splits, dg, TrainConfig(batch_size=w.batch), seed=0,
                    mesh=make_mesh(shape=(2, 2), backend="gloo"), init_state=jax_state)
        res["fromjax"] = {"state": to_numpy(t.state_dict()), "emb": to_numpy(t.eval_embeddings()),
                          "shard_weights": t.shard_weights}
    return res if rank == 0 else {k: v for k, v in res.items() if k.startswith("coll/")}


def _tree_equal(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return all(_tree_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return set(a) == set(b) and all(_tree_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def _draws(w: World, n: int, seed: int):
    """Per step, the negative uniforms of a whole batch, the same on every
    rank."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.random(w.batch).astype(np.float32)) for _ in range(n)]


def trainer_checks(rank, w: World, graph, splits, dg, model, ckpt_dir: str):
    """The mesh ``Trainer``: learning, weight sharding against whole
    stacks, the bf16 row reduce, chunks against single steps, the grouped
    chunk against the single-process one, and a checkpoint across
    topologies."""
    from decagon_tpu_torch.parallel.mesh import make_mesh
    from decagon_tpu_torch.parallel.sharded import (
        make_sharded_grouped_chunked_train_step,
        make_sharded_train_step,
    )
    from decagon_tpu_torch.train.checkpoint import Checkpointer
    from decagon_tpu_torch.train.step import TrainConfig, step_generator
    from decagon_tpu_torch.train.trainer import Trainer

    res: Dict[str, Any] = {}
    mesh22 = make_mesh(shape=(2, 2), backend="gloo")

    # It learns: 12 sharded steps on relation (1, 1, 0).
    t = Trainer(model, graph, splits, dg, TrainConfig(batch_size=w.batch, learning_rate=1e-2),
                seed=0, mesh=mesh22)
    step = make_sharded_train_step(model, (1, 1), t.config, t.optimizer, mesh22, t.device_graph,
                                   shard_weights=t.shard_weights)
    train = splits[(1, 1, 0)].train
    p, s, losses = t.params, t.opt_state, []
    for it in range(12):
        idx = np.random.default_rng(it).integers(0, len(train), size=w.batch)
        p, s, loss = step(p, s, t.device_graph, 0, torch.from_numpy(train[idx, 0]),
                          torch.from_numpy(train[idx, 1]), step_generator(0, it, "cpu"))
        losses.append(float(loss))
    res["learns"] = np.asarray(losses)

    # shard_weights on and off, and the bf16 row reduce: 6 batches each.
    batches = None
    for name, kw in (("replicated", dict(shard_weights=False)), ("sharded", {}),
                     ("bf16", dict(grad_reduce_dtype="bfloat16"))):
        tr = Trainer(model, graph, splits, dg, TrainConfig(batch_size=w.batch, **kw), seed=0,
                     mesh=mesh22)
        if batches is None:
            batches = list(tr.scheduler.epoch())[:6]
        trace = [float(tr.train_batch(b)) for b in batches]
        res[f"trainer/{name}"] = {"losses": np.asarray(trace), "shard_weights": tr.shard_weights,
                                  "state": to_numpy(tr.state_dict())}

    # Chunks against single steps (bitwise), and the grouped chunk against
    # the single-process grouped chunk on the same negatives.
    per_step = Trainer(model, graph, splits, dg, TrainConfig(batch_size=w.batch), seed=0,
                       mesh=mesh22)
    chunked = Trainer(model, graph, splits, dg, TrainConfig(batch_size=w.batch, scan_chunk=4),
                      seed=0, mesh=mesh22)
    batches = list(per_step.scheduler.epoch())[:6]
    single = torch.stack([per_step.train_batch(b) for b in batches])
    chunk = torch.cat([chunked.train_chunk(batches[:4], 4), chunked.train_chunk(batches[4:], 4)])
    res["chunk_equal"] = bool(torch.equal(single, chunk)) and _tree_equal(
        per_step.state_dict()["params"], chunked.state_dict()["params"])

    cfg = TrainConfig(batch_size=w.batch, scan_chunk=3, schedule="balanced", relation_group=2)
    grouped = Trainer(model, graph, splits, dg, cfg, seed=0, mesh=mesh22)
    start = to_numpy(grouped.state_dict())
    batches = list(grouped.scheduler.epoch())[:6]
    neg_u = [[u, v] for u, v in zip(_draws(w, 3, 5), _draws(w, 3, 6))]
    args = grouped_args(grouped, batches, 3)
    chunk = make_sharded_grouped_chunked_train_step(
        model, cfg, grouped.optimizer, mesh22, grouped.device_graph,
        shard_weights=grouped.shard_weights)
    grouped.params, grouped.opt_state, g_losses = chunk(
        grouped.params, grouped.opt_state, grouped.device_graph, grouped.step_seed, *args,
        neg_u=neg_u)
    res["grouped"] = {"losses": to_numpy(g_losses), "start": start, "args": [
        np.asarray(a) if not isinstance(a, torch.Tensor) else a.numpy() for a in args],
        "neg_u": [[u.numpy() for u in slot] for slot in neg_u],
        "end": to_numpy(grouped.state_dict())}

    # spmm_impl values without a sharded form of their own train through
    # the COO stream: the same bits as "xla", whole [K, F, H] stacks.
    coo = {}
    for impl in ("xla", "paired", "fused_pallas"):
        tr = Trainer(_model(w, dg, spmm_impl=impl), graph, splits, dg,
                     TrainConfig(batch_size=w.batch), seed=0, mesh=mesh22)
        losses = [tr.train_batch(b) for b in list(tr.scheduler.epoch())[:2]]
        coo[impl] = (torch.stack(losses), tr.state_dict()["params"], tr.shard_weights)
    res["coo_trainer"] = {
        impl: {"equal": _tree_equal(coo[impl][:2], coo["xla"][:2]),
               "shard_weights": coo[impl][2],
               "enc1_shapes": {k: tuple(v.shape) for k, v in coo[impl][1]["enc1"].items()}}
        for impl in coo}

    # A checkpoint of a (2, 2) trainer restores into (1, 4).
    cfg = TrainConfig(batch_size=w.batch, learning_rate=1e-2)
    t1 = Trainer(model, graph, splits, dg, cfg, seed=0, mesh=mesh22)
    for b in list(t1.scheduler.epoch())[:4]:
        t1.train_batch(b)
    ck = Checkpointer(ckpt_dir, max_to_keep=1)
    ck.save(t1.global_step, t1.state_dict())
    t2 = Trainer(model, graph, splits, dg, cfg, seed=0, mesh=make_mesh(shape=(1, 4),
                                                                         backend="gloo"))
    res["ckpt"] = {"saved": to_numpy(t1.state_dict()), "resumed": bool(t2.try_resume(ck)),
                   "restored": to_numpy(t2.state_dict())}
    loss = None
    for b in list(t2.scheduler.epoch())[:2]:
        loss = t2.train_batch(b)
    res["ckpt"]["next_loss"] = float(loss)
    return res


def grouped_args(trainer, batches, chunk_size):
    """The grouped chunk's host arguments for ``batches``, as
    ``Trainer.train_chunk`` builds them."""
    g, b = trainer.group, trainer.config.batch_size
    branch = np.zeros((chunk_size, g), np.int32)
    ks = np.zeros((chunk_size, g), np.int32)
    rows = np.zeros((chunk_size, g, b), np.int32)
    cols = np.zeros((chunk_size, g, b), np.int32)
    valid = np.zeros((chunk_size, g), bool)
    for j, batch in enumerate(batches):
        s, gg = divmod(j, g)
        branch[s, gg] = trainer._branch_idx[batch.edge_type]
        ks[s, gg] = batch.k
        rows[s, gg] = batch.rows
        cols[s, gg] = batch.cols
        valid[s, gg] = True
    step_no = trainer.opt_step + np.arange(chunk_size)
    return branch, ks, torch.from_numpy(rows), torch.from_numpy(cols), step_no, valid


# ---- the multi-host world (tests/test_torch_parallel_cli.py) --------------


def multihost_world(rank: int, n_ranks: int, port: int):
    """The port's ``scripts/multihost_sim.py`` (``simulate``: each rank a
    host, ``LOCAL_WORLD_SIZE=1``, the ``row`` axis across them; one
    sharded train step and the sharded embedding); then the meshes that
    must be refused."""
    from decagon_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from decagon_tpu_torch.scripts.multihost_sim import simulate

    initialize_distributed(f"127.0.0.1:{port}", n_ranks, rank, backend="gloo")
    initialize_distributed(f"127.0.0.1:{port}", n_ranks, rank, backend="gloo")  # idempotent
    res = simulate(rank, n_ranks, torch.device("cpu"))
    refused = {}
    for name, kw in (("size", dict(shape=(2, 2))), ("edge_across_hosts",
                                                     dict(shape=(1, n_ranks), multihost=True)),
                     ("backend", dict(shape=(n_ranks, 1), backend="nccl"))):
        try:
            make_mesh(**kw)
            refused[name] = None
        except ValueError as exc:
            refused[name] = str(exc)
    return {"loss": res["loss"], "emb": res["emb"], "single_emb": res["single_emb"],
            "refused": refused}


# ---- the mesh scripts' worlds (tests/test_torch_scripts_mesh.py) ----------


def mesh_scripts_world2(rank: int, params_np, graph_kw, steps: int, batch: int):
    """Two ranks: ``multihost_sim``'s rank (its line and loss) and its
    sharded embedding from ``params_np``, then ``multihost_overlap``'s
    weight-sharded steps with ``comm_overlap`` on and off."""
    from decagon_tpu_torch.scripts import multihost_overlap, multihost_sim

    res = {"sim": multihost_sim.rank_main(rank, 2, 0, device="cpu")}
    res["sim_carried"] = multihost_sim.simulate(rank, 2, torch.device("cpu"),
                                                params=from_numpy(params_np))["emb"]
    for overlap in (True, False):
        res[f"overlap_{overlap}"] = multihost_overlap.rank_main(
            rank, 2, 0, overlap=overlap, steps=steps, device="cpu", graph_kw=graph_kw,
            batch_size=batch)
    return res


# The rank whose gradient reduction the faults below break.
FAULT_RANK = 1


def _drop_replicated_partial(orig):
    """``sharded._reduce_gradients`` with ``FAULT_RANK``'s partial of the
    leaves summed across the edge axis (the replicated ones, summed over the
    whole mesh) left out: that rank hands zeros to the reduction."""
    from decagon_tpu_torch.parallel import sharded

    def reduce(loss, grads, sharded_keys, mesh, row_dtype):
        if dist.get_rank() == FAULT_RANK:
            values = {path: t if sharded._is_sharded_path(path, sharded_keys)
                      else torch.zeros_like(t) for path, t in sharded._leaves(grads)}
            grads = sharded._rebuild(grads, values)
        return orig(loss, grads, sharded_keys, mesh, row_dtype)

    return reduce


def _skip_row_scatter(orig):
    """``collectives._reduce_scatter`` (the row-axis reduction of
    ``gather_rows``' backward) skipped on ``FAULT_RANK``: the rank still
    takes part, so that the others are not left waiting, but keeps its own
    block of the cotangent unsummed."""
    def reduce_scatter(full, group):
        out = orig(full, group)
        if dist.get_rank() == FAULT_RANK:
            return full.contiguous().chunk(dist.get_world_size(group))[
                dist.get_rank(group)].clone()
        return out

    return reduce_scatter


# name: (module, attribute, wrapper) of each injected reduction fault.
FAULTS = {
    "edge_partial_dropped": ("decagon_tpu_torch.parallel.sharded", "_reduce_gradients",
                             _drop_replicated_partial),
    "row_scatter_skipped": ("decagon_tpu_torch.parallel.collectives", "_reduce_scatter",
                            _skip_row_scatter),
}


@contextlib.contextmanager
def injected(fault: str):
    """The package with ``FAULTS[fault]`` patched in, in this rank only."""
    import importlib

    module_name, attr, wrap = FAULTS[fault]
    module = importlib.import_module(module_name)
    orig = getattr(module, attr)
    setattr(module, attr, wrap(orig))
    try:
        yield
    finally:
        setattr(module, attr, orig)


def mesh_scripts_world4(rank: int, graph_kw, steps: int, batch: int, teacher_dir: str):
    """Four ranks: ``multihost_bench``'s (2, 2) traces with f32 and bf16
    row reductions and its losses at the single process's saved points
    (``teacher_dir``): the f32 mesh, the bf16 control and the f32 mesh with
    each injected fault; then ``hlo_collectives``' inventory of one step on
    the (2, 2) mesh and ``hlo_overlap_schedule``'s schedule of one step with
    ``comm_overlap`` on and off."""
    from decagon_tpu_torch.scripts import hlo_collectives, hlo_overlap_schedule, multihost_bench

    kw = dict(steps=steps, device="cpu", graph_kw=graph_kw, batch_size=batch)
    res = {dtype: multihost_bench.rank_main(rank, 4, 0, 2, 2, dtype, **kw)
           for dtype in ("float32", "bfloat16")}
    for tag, dtype in (("teacher", "float32"), ("teacher_bf16", "bfloat16")):
        res[tag] = multihost_bench.rank_main(rank, 4, 0, 2, 2, dtype, teacher_dir=teacher_dir,
                                             **kw)
    for fault in FAULTS:
        with injected(fault):
            res[f"teacher_{fault}"] = multihost_bench.rank_main(
                rank, 4, 0, 2, 2, "float32", teacher_dir=teacher_dir, **kw)
    res["inventory"] = hlo_collectives.rank_main(rank, 4, 0, 2, 2, device="cpu",
                                                 graph_kw=graph_kw, batch_size=batch)
    res["schedule"] = {overlap: hlo_overlap_schedule.rank_main(
        rank, 4, 0, 2, 2, overlap, device="cpu", graph_kw=graph_kw, batch_size=batch)
        for overlap in (True, False)}
    return res
