"""Sharded encoder, train steps and embedding over the (row, edge) mesh.

Port of ``decagon_tpu/parallel/sharded.py``.  The JAX package runs the
loss and gradients inside one ``shard_map``; here every rank runs the same
program on its own slot (``parallel/rowshard.py``):

1. projects per-relation features (replicated compute from replicated
   parameters; free for identity features),
2. aggregates its edge shard into its destination-row block (the dense
   ``[k_loc, nb, n_j]`` product, the COO stream's ``index_add_``, or K6
   over the slot's CSR: density dispatch survives sharding),
3. sums the block over the ``edge`` group,
4. all-gathers the blocks over the ``row`` group into the full node table,
5. scores its slice of the batch with its own negatives, and the loss and
   gradients are all-reduced per leaf kind (``reduce_gradients``),

so the update equals the single-process step with the same total batch.
With ``shard_weights`` the enc1/enc2 stacks of edge types with a dense
stack (and their Adam moments) hold only this rank's ``[k_loc, ...]``
relation block: a rank's forward reads only those relations, so their
gradients have disjoint support over the ``edge`` axis and need no
all-reduce there.  The collectives then take the explicit-adjoint pair
(``edge_accum`` / ``gather_rows``), whose backward hands every rank the
whole mesh's cotangent of its block.

Randomness.  The step's generator splits into the encoder's and the
sampler's as in ``train/step.py``; an edge type's dropout mask is drawn
from ``fold_generator(enc_gen, tag * 1009 + i * 31 + j)``, folded once more
with the edge index for weight-sharded types (each shard masks its own
relations), and rank ``s``'s negatives from ``fold_generator(sample_gen,
s)``.  ``layer_bits`` / ``neg_u`` replace the draws in the single-process
format (``models/encoder.layer_mask_spans`` order, ``[batch *
neg_sample_size]`` uniforms): each rank cuts its relations and its batch
slice out of them, so a test can feed the single process and the mesh the
same draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from decagon_tpu_torch.graph.device import etkey
from decagon_tpu_torch.models.encoder import _project, check_spmm_impl
from decagon_tpu_torch.models.model import DecagonModel
from decagon_tpu_torch.ops.segment import l2_normalize_rows, spmm_dense, spmm_segment
from decagon_tpu_torch.ops.spmm_pallas import _SpmmTiled
from decagon_tpu_torch.parallel.collectives import (
    Pending,
    _all_gather,
    _all_reduce_,
    all_reduce_sum,
    edge_accum,
    gather_rows,
    site,
)
from decagon_tpu_torch.parallel.mesh import mesh_groups, mesh_shape, mesh_slot
from decagon_tpu_torch.parallel.rowshard import ShardedGraph
from decagon_tpu_torch.train.step import (
    GradientTransformation,
    TrainConfig,
    apply_optimizer,
    chunk_loop,
    fold_generator,
    grouped_chunk_loop,
    make_scoring_loss,
    split_generator,
    value_and_grad,
)

_LEVELS = ("enc1", "enc2")


# ---- relation-sharded leaves ----------------------------------------------


def shardable_weight_keys(graph: ShardedGraph) -> frozenset:
    """Edge types whose enc1/enc2 stacks can shard over the edge axis:
    those with dense relation blocks (the COO stream and K6's layouts
    address the whole ``[K * n_j]`` space and need whole stacks)."""
    return frozenset(key for key, a in graph.adj.items() if a.dense is not None)


def _is_sharded_path(path, keys: frozenset) -> bool:
    """Whether a tree path addresses a relation-sharded leaf: enc1/enc2,
    then a sharded key, anywhere in the path (params and Adam states)."""
    return any(a in _LEVELS and b in keys for a, b in zip(path, path[1:]))


def _map_sharded(tree, keys: frozenset, fn: Callable, path=()):
    """``tree`` with ``fn(key, leaf)`` applied to its relation-sharded
    leaves; other leaves (and non-tensors) as they are."""
    if isinstance(tree, dict):
        return {k: _map_sharded(v, keys, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and _is_sharded_path(path, keys):
        return fn(path[-1], tree)
    return tree


def pad_relation_stacks(tree, graph: ShardedGraph, pad_value: float = 0.0):
    """The relation axis of every relation-sharded leaf padded to ``ne *
    k_loc`` (params, or an Adam state ``{"m", "v", "t"}``)."""
    ne = graph.mesh_shape[1]

    def pad(key, w):
        k_pad = graph.adj[key].k_loc * ne
        if w.shape[0] >= k_pad:
            return w
        fill = w.new_full((k_pad - w.shape[0],) + tuple(w.shape[1:]), pad_value)
        return torch.cat([w, fill])

    return _map_sharded(tree, shardable_weight_keys(graph), pad)


def unpad_relation_stacks(tree, graph: ShardedGraph):
    """Inverse of ``pad_relation_stacks``: back to ``num_rel`` relations."""
    return _map_sharded(
        tree, shardable_weight_keys(graph), lambda key, w: w[: graph.adj[key].num_rel]
    )


def local_relation_block(tree, graph: ShardedGraph):
    """This rank's ``[k_loc, ...]`` relation block of every relation-sharded
    leaf of a whole (unpadded) tree: the counterpart of ``shard_state_tree``
    for one rank.  Other leaves stay whole."""
    e = graph.edge_index

    def block(key, w):
        k_loc = graph.adj[key].k_loc
        return w[e * k_loc : (e + 1) * k_loc].clone()

    return _map_sharded(pad_relation_stacks(tree, graph), shardable_weight_keys(graph), block)


def gather_relation_blocks(tree, graph: ShardedGraph, mesh: DeviceMesh):
    """Inverse of ``local_relation_block``: every relation-sharded leaf's
    blocks all-gathered over the ``edge`` group and unpadded, so the tree
    does not depend on the mesh.  A collective: every rank calls it."""
    _, edge_g = mesh_groups(mesh)
    with torch.no_grad():
        full = _map_sharded(tree, shardable_weight_keys(graph),
                            lambda key, w: _all_gather(w, edge_g))
    return unpad_relation_stacks(full, graph)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out.extend(_leaves(v, path + (k,)))
        return out
    return [(path, tree)]


def _rebuild(tree, values, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (k,)) for k, v in tree.items()}
    return values[path]


# Leaves of at least this many elements are all-reduced on their own;
# smaller ones travel together in one flat buffer a dtype.
_ALONE = 1 << 20


def _reduce_flat(tensors: List[torch.Tensor], group, wire_dtype=None) -> List[torch.Tensor]:
    """``tensors`` summed over ``group``: each large one in its own
    all-reduce (in place: they are the step's fresh gradients), the small
    ones in one (a dtype); in ``wire_dtype`` when given."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)

    def reduce(t: torch.Tensor) -> torch.Tensor:
        if wire_dtype is not None and wire_dtype != t.dtype:
            return _all_reduce_(t.to(wire_dtype), group).to(t.dtype)
        return _all_reduce_(t.contiguous(), group)

    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        if t.numel() >= _ALONE:
            out[i] = reduce(t)
        else:
            by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = reduce(torch.cat([tensors[i].reshape(-1) for i in idx]))
        at = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[at : at + n].view(tensors[i].shape)
            at += n
    return out


def reduce_gradients(loss: torch.Tensor, grads, sharded_keys: frozenset, mesh: DeviceMesh,
                     row_dtype: Optional[torch.dtype] = None):
    """``(loss, grads)`` summed over the mesh, per leaf kind (the JAX
    package's ``_psum_replicated_leaves`` and loss ``psum``).

    The loss and replicated leaves (decoders, whole enc stacks): summed
    over both axes, since each rank's gradient covers only its edges and
    its batch slice.  Relation-sharded enc leaves: summed over the ``row``
    group only.  Over ``edge`` they are already exact (the cotangents of
    the whole mesh arrive through ``gather_rows``' backward), but each row
    block's rank backpropagates through its own block's edges only; with
    ``row_dtype`` (``TrainConfig.grad_reduce_dtype``) they travel in that
    type and are summed in it."""
    with site("gradients"):
        return _reduce_gradients(loss, grads, sharded_keys, mesh, row_dtype)


def _reduce_gradients(loss, grads, sharded_keys, mesh, row_dtype):
    row_g, _ = mesh_groups(mesh)
    leaves = _leaves(grads)
    sharded = [i for i, (p, _) in enumerate(leaves) if _is_sharded_path(p, sharded_keys)]
    replicated = [i for i in range(len(leaves)) if i not in set(sharded)]
    values = {}
    reduced = _reduce_flat([loss.reshape(1)] + [leaves[i][1] for i in replicated], None)
    loss = reduced[0].reshape(())
    for i, t in zip(replicated, reduced[1:]):
        values[leaves[i][0]] = t
    if sharded:
        for i, t in zip(sharded, _reduce_flat([leaves[i][1] for i in sharded], row_g,
                                              wire_dtype=row_dtype)):
            values[leaves[i][0]] = t
    return loss, _rebuild(grads, values)


# ---- the sharded encoder -------------------------------------------------


def _mask_shape(k: int, feat: Optional[torch.Tensor], rows: int, per_relation_dropout_max: int):
    """An edge type's keep-mask shape (``layer_mask_spans``' rule): identity
    features [k, rows, 1]; dense ones a mask per relation [k, N, F] up to
    ``per_relation_dropout_max`` relations, else one shared [N, F]."""
    if feat is None:
        return (k, rows, 1)
    if k <= per_relation_dropout_max:
        return (k,) + tuple(feat.shape)
    return tuple(feat.shape)


def _relation_block(mask: torch.Tensor, e: int, k_loc: int) -> torch.Tensor:
    """Relations ``[e * k_loc, (e + 1) * k_loc)`` of a whole relation mask,
    padded with kept entries past the last relation (their weights are
    zero)."""
    block = mask[e * k_loc : (e + 1) * k_loc]
    if block.shape[0] < k_loc:
        fill = block.new_ones((k_loc - block.shape[0],) + tuple(block.shape[1:]))
        block = torch.cat([block, fill])
    return block


def _check_mesh(graph: ShardedGraph, mesh: DeviceMesh) -> None:
    if tuple(graph.mesh_shape) != mesh_shape(mesh) or graph.slot != mesh_slot(mesh):
        raise ValueError(
            f"sharded graph of slot {graph.slot} on a {graph.mesh_shape} mesh does not belong "
            f"to this rank (slot {mesh_slot(mesh)} of {mesh_shape(mesh)})"
        )


def encode_sharded(
    params,
    graph: ShardedGraph,
    mesh: DeviceMesh,
    generator: Optional[torch.Generator] = None,
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    spmm_impl: str = "auto",
    per_relation_dropout_max: int = 64,
    spmm_precision: str = "highest",
    sharded_keys: frozenset = frozenset(),
    overlap: bool = True,
    layer_bits: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """The two-layer encoder on this rank's slot: full per-type node tables
    ``{"0": [N_0, H2], ...}``, equal on every rank.  Same math as
    ``models/encoder.encode``.

    ``spmm_impl``, routed as the JAX mesh routes it: "auto" (the dense
    block where built, else K6 on CUDA where the slot has its CSR, else the
    COO stream), "dense" (the dense block where built, else the COO
    stream), "pallas" (K6 where the slot has its CSR: the kernel for CUDA
    tensors, its plain version for CPU ones), "pallas_ref" (K6's plain
    version on any device); every other name of the port ("xla", "paired",
    "paired_ref", "dense_factored", "fused", "fused_pallas",
    "fused_pallas_ref") takes the COO stream, since the slot has no pair
    masks, factored stacks or fused layout.  The interpret names raise
    ``NotImplementedError`` and unknown ones ``ValueError``
    (``check_spmm_impl``).  ``sharded_keys``: edge types whose enc stacks
    arrive as this rank's ``[k_loc, ...]`` relation blocks; they need the
    dense block (``ValueError`` otherwise).  ``overlap``: issue every edge
    type's aggregation and ``edge`` reduction before waiting for any, then
    every ``row`` gather before reading any; without it each edge type's
    exchange completes before the next one's projection (the control).
    Dropout as the module docstring says."""
    check_spmm_impl(spmm_impl)
    _check_mesh(graph, mesh)
    row_g, edge_g = mesh_groups(mesh)
    nr, ne = graph.mesh_shape
    e_idx = graph.edge_index
    shard_w = bool(sharded_keys)
    keep = 1.0 - dropout_rate
    drop = not deterministic and dropout_rate > 0.0

    def masks_for(level, inputs, tag):
        """{etkey: this rank's keep-mask} of the layer, or {}."""
        if not drop:
            return {}
        out = {}
        if layer_bits is not None:
            bits = layer_bits[level].to(graph.device)
            start = 0
            for et in graph.edge_types:
                key = etkey(et)
                adj, w = graph.adj[key], params[level][key]
                shape = _mask_shape(adj.num_rel, inputs[str(et[1])], w.shape[1],
                                    per_relation_dropout_max)
                size = int(np.prod(shape))
                mask = bits[start : start + size].reshape(shape)
                start += size
                if key in sharded_keys and len(shape) == 3:
                    mask = _relation_block(mask, e_idx, adj.k_loc)
                out[key] = mask
            if start != bits.numel():
                raise ValueError(f"{level}: expected {start} dropout bits, got {bits.numel()}")
            return out
        if generator is None:
            return {}
        for et in graph.edge_types:
            key = etkey(et)
            w = params[level][key]
            gen = fold_generator(generator, tag * 1009 + et[0] * 31 + et[1])
            if key in sharded_keys:
                gen = fold_generator(gen, e_idx)
            shape = _mask_shape(w.shape[0], inputs[str(et[1])], w.shape[1],
                                per_relation_dropout_max)
            u = torch.rand(shape, generator=gen, device=gen.device)
            out[key] = (u < keep).to(graph.device)
        return out

    def aggregate(p_stack: torch.Tensor, adj, local_k: bool) -> torch.Tensor:
        """This rank's partial ``[nb, H]`` block of ``sum_k A_k @ P_k``."""
        k, n_j, h = p_stack.shape
        use_dense = adj.dense is not None and spmm_impl in ("auto", "dense")
        use_k6 = adj.tiles_fwd is not None and (
            spmm_impl in ("pallas", "pallas_ref")
            or (spmm_impl == "auto" and not use_dense and p_stack.is_cuda)
        )
        if local_k and not use_dense:
            raise ValueError(
                "weight-sharded edge types require the dense relation blocks (the COO "
                "stream and K6's layouts address the whole relation space)"
            )
        if use_k6:
            return _SpmmTiled.apply(
                p_stack.reshape(k * n_j, h), adj.tiles_fwd, adj.tiles_bwd, spmm_precision,
                spmm_impl == "pallas_ref",
            )
        if use_dense:
            if not local_k:
                # Relations are split over the edge axis: this rank's
                # window of the (padded) stack.
                k_pad = adj.k_loc * ne
                if k_pad != k:
                    p_stack = torch.cat([p_stack, p_stack.new_zeros((k_pad - k, n_j, h))])
                p_stack = p_stack[e_idx * adj.k_loc : (e_idx + 1) * adj.k_loc]
            return spmm_dense(p_stack, adj.dense)
        return spmm_segment(p_stack, adj.senders, adj.receivers, adj.rel, adj.vals,
                            adj.n_rows_block)

    groups = (row_g, edge_g) if shard_w else (row_g,)
    edge_sum = (edge_accum if shard_w else all_reduce_sum)(edge_g)
    gathers = {
        key: gather_rows(row_g, groups, adj.n_rows, adj.n_rows_block, nr)
        for key, adj in graph.adj.items()
    }

    def layer(level, inputs, relu, tag):
        masks = masks_for(level, inputs, tag)
        pending = Pending()
        tables: Dict[str, torch.Tensor] = {}
        for et in graph.edge_types:
            key = etkey(et)
            adj = graph.adj[key]
            p_stack = _project(inputs[str(et[1])], params[level][key], masks.get(key), keep)
            part = aggregate(p_stack, adj, key in sharded_keys)
            if overlap:
                tables[key] = edge_sum.start(part, pending)
            else:
                tables[key] = gathers[key](edge_sum(part))
        if overlap:
            pending.wait()
            issued = {key: gathers[key].start(done(), pending) for key, done in tables.items()}
            pending.wait()
            tables = {key: done() for key, done in issued.items()}
        out: Dict[str, torch.Tensor] = {}
        for i in range(len(graph.num_nodes)):
            acc = None
            for et in graph.edge_types:
                if et[0] != i:
                    continue
                term = l2_normalize_rows(tables[etkey(et)])
                acc = term if acc is None else acc + term
            if acc is None:
                raise ValueError(f"node type {i} has no incoming edge types")
            out[str(i)] = torch.relu(acc) if relu else acc
        return out

    h1 = layer("enc1", graph.features, True, 1)
    return layer("enc2", h1, False, 2)


# ---- steps ------------------------------------------------------------------


@dataclasses.dataclass
class _MeshRun:
    """What every sharded step shares: the mesh, this rank's shard of the
    batch, the sharded keys and the gradient reduction."""

    model: DecagonModel
    cfg: TrainConfig
    mesh: DeviceMesh
    sharded_keys: frozenset
    row_dtype: Optional[torch.dtype]
    shard: int
    local_batch: int

    @staticmethod
    def make(model, cfg: TrainConfig, mesh: DeviceMesh, graph: ShardedGraph,
             shard_weights: bool, chunked: bool = False) -> "_MeshRun":
        _check_mesh(graph, mesh)
        nr, ne = mesh_shape(mesh)
        n_shards = nr * ne
        if cfg.batch_size % n_shards != 0:
            raise ValueError(f"batch_size {cfg.batch_size} must divide over {n_shards} shards")
        keys = shardable_weight_keys(graph) if shard_weights else frozenset()
        if keys and chunked and cfg.lazy_decoder_adam:
            raise ValueError("shard_weights requires the fused Adam state {'m', 'v', 't'}, "
                             "not lazy_decoder_adam's")
        row_dtype = (
            torch.bfloat16
            if cfg.grad_reduce_dtype in ("bfloat16", "bf16")
            # A row axis of one rank has no traffic to save: its gradients
            # are not rounded.
            and nr > 1
            else None
        )
        return _MeshRun(model, cfg, mesh, keys, row_dtype, graph.slot,
                        cfg.batch_size // n_shards)

    def encode(self, params, graph, generator, layer_bits=None, deterministic=False):
        mc = self.model.config
        return encode_sharded(
            params, graph, self.mesh, generator, dropout_rate=mc.dropout,
            deterministic=deterministic, spmm_impl=mc.spmm_impl,
            per_relation_dropout_max=mc.per_relation_dropout_max,
            spmm_precision=mc.spmm_precision, sharded_keys=self.sharded_keys,
            overlap=bool(self.cfg.comm_overlap), layer_bits=layer_bits,
        )

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole batch."""
        return x[self.shard * self.local_batch : (self.shard + 1) * self.local_batch]

    def local_u(self, u: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's negative uniforms out of the whole batch's ``[batch
        * ns]`` (negative ``c * batch + b`` pairs with column ``b``)."""
        if u is None:
            return None
        ns = max(1, self.cfg.neg_sample_size)
        return self.local(u.reshape(ns, self.cfg.batch_size).T).T.reshape(-1)

    def scorers(self, edge_types):
        local_cfg = dataclasses.replace(self.cfg, batch_size=self.local_batch)
        return [make_scoring_loss(self.model, et, local_cfg) for et in edge_types]

    def value_and_grad(self, loss_fn, params, *args, **kwargs):
        """``(loss, grads)`` of this rank's ``loss_fn``, summed over the mesh
        (``reduce_gradients``)."""
        loss, grads = value_and_grad(loss_fn, params, *args, **kwargs)
        return reduce_gradients(loss, grads, self.sharded_keys, self.mesh, self.row_dtype)

    def update(self, optimizer, loss_fn, params, opt_state, *args, **kwargs):
        loss, grads = self.value_and_grad(loss_fn, params, *args, **kwargs)
        with torch.no_grad():
            params, opt_state = apply_optimizer(optimizer, self.cfg, grads, opt_state, params)
        return params, opt_state, loss


def _edge_loss_fn(run: _MeshRun, scoring: Callable) -> Callable:
    def loss_fn(params, graph, k, rows, cols, enc_gen, sample_gen, layer_bits=None, neg_u=None):
        emb = run.encode(params, graph, enc_gen, layer_bits)
        return scoring(params, graph, emb, k, run.local(rows), run.local(cols),
                       fold_generator(sample_gen, run.shard), neg_u=run.local_u(neg_u))

    return loss_fn


def make_sharded_grads_fn(
    model: DecagonModel,
    edge_type,
    cfg: TrainConfig,
    mesh: DeviceMesh,
    graph_template: ShardedGraph,
    shard_weights: bool = False,
) -> Callable:
    """``grads(params, graph, k, rows, cols, generator, layer_bits=None,
    neg_u=None) -> (loss, grads)``: one step's loss and gradients summed
    over the mesh (``reduce_gradients``), before the optimizer; ``rows`` /
    ``cols`` the whole batch."""
    run = _MeshRun.make(model, cfg, mesh, graph_template, shard_weights)
    (scoring,) = run.scorers([edge_type])
    loss_fn = _edge_loss_fn(run, scoring)

    def grads(params, graph, k, rows, cols, generator, layer_bits=None, neg_u=None):
        enc_gen, sample_gen = split_generator(generator)
        return run.value_and_grad(loss_fn, params, graph, k, rows, cols, enc_gen, sample_gen,
                                  layer_bits=layer_bits, neg_u=neg_u)

    return grads


def make_sharded_train_step(
    model: DecagonModel,
    edge_type,
    cfg: TrainConfig,
    optimizer: GradientTransformation,
    mesh: DeviceMesh,
    graph_template: ShardedGraph,
    shard_weights: bool = False,
) -> Callable:
    """``step(params, opt_state, graph, k, rows, cols, generator,
    layer_bits=None, neg_u=None) -> (params, opt_state, loss)`` for one
    edge type on this rank.  ``rows`` / ``cols`` are the whole
    ``[batch_size]`` batch (``batch_size`` must divide over the mesh's
    ranks), of which the rank scores its slice; the generator is the step's
    (``step_generator(base_seed, step_no)``), the same on every rank.  The
    loss returned is the mesh's sum.  With ``shard_weights`` the enc
    stacks of the dense edge types (and their moments in ``opt_state``)
    are this rank's relation blocks (``local_relation_block``), and
    their update stays local."""
    run = _MeshRun.make(model, cfg, mesh, graph_template, shard_weights)
    (scoring,) = run.scorers([edge_type])
    loss_fn = _edge_loss_fn(run, scoring)

    def step(params, opt_state, graph, k, rows, cols, generator, layer_bits=None, neg_u=None):
        enc_gen, sample_gen = split_generator(generator)
        return run.update(optimizer, loss_fn, params, opt_state, graph, k, rows, cols,
                          enc_gen, sample_gen, layer_bits=layer_bits, neg_u=neg_u)

    return step


def make_sharded_chunked_train_step(
    model: DecagonModel,
    cfg: TrainConfig,
    optimizer: GradientTransformation,
    mesh: DeviceMesh,
    graph_template: ShardedGraph,
    shard_weights: bool = False,
) -> Callable:
    """The mesh counterpart of ``train/step.make_chunked_train_step``:
    ``chunk(params, opt_state, graph, base_seed, branch[C], k[C], rows[C,
    B], cols[C, B], step_no[C], valid[C], layer_bits=None, neg_u=None) ->
    (params, opt_state, losses[C])``; step ``c`` is
    ``make_sharded_train_step``'s on ``step_generator(base_seed,
    step_no[c])``, a padding step (``valid[c]`` False) is skipped and
    reports NaN.  ``shard_weights`` needs the fused Adam state."""
    run = _MeshRun.make(model, cfg, mesh, graph_template, shard_weights, chunked=True)
    loss_fns = [_edge_loss_fn(run, s) for s in run.scorers(graph_template.edge_types)]
    return chunk_loop(loss_fns, lambda *a, **kw: run.update(optimizer, *a, **kw))


def make_sharded_grouped_chunked_train_step(
    model: DecagonModel,
    cfg: TrainConfig,
    optimizer: GradientTransformation,
    mesh: DeviceMesh,
    graph_template: ShardedGraph,
    shard_weights: bool = False,
) -> Callable:
    """The mesh counterpart of ``train/step.make_grouped_chunked_train_step``:
    per optimization step ``G = cfg.relation_group`` relation-batches share
    one sharded encoder forward (one boundary exchange per G batches).
    ``chunk(params, opt_state, graph, base_seed, branch[C, G], k[C, G],
    rows[C, G, B], cols[C, G, B], step_no[C], valid[C, G], layer_bits=None,
    neg_u=None) -> (params, opt_state, losses[C])``; sub-batch ``g`` draws
    its negatives from ``fold_generator(fold_generator(sample_gen, g),
    shard)``."""
    run = _MeshRun.make(model, cfg, mesh, graph_template, shard_weights, chunked=True)
    scorers = run.scorers(graph_template.edge_types)

    def slot_loss(params, graph, branch, k, rows, cols, valid, enc_gen, sample_gen,
                  layer_bits=None, neg_u=None):
        emb = run.encode(params, graph, enc_gen, layer_bits)
        total = None
        for g, ok in enumerate(valid):
            if not ok:
                continue
            sub = scorers[branch[g]](
                params, graph, emb, k[g], run.local(rows[g]), run.local(cols[g]),
                fold_generator(fold_generator(sample_gen, g), run.shard),
                neg_u=None if neg_u is None else run.local_u(neg_u[g]),
            )
            total = sub if total is None else total + sub
        return total

    return grouped_chunk_loop(slot_loss, lambda *a, **kw: run.update(optimizer, *a, **kw))


def make_sharded_embed_fn(
    model: DecagonModel,
    mesh: DeviceMesh,
    graph_template: ShardedGraph,
    shard_weights: bool = False,
) -> Callable:
    """``embed(params, graph) -> {"0": [N_0, H2], ...}``: the deterministic
    sharded forward, whole tables on every rank (for ``make_emb_scores``
    and the ``AccuracyEvaluator``).  A collective: every rank calls it."""
    _check_mesh(graph_template, mesh)
    keys = shardable_weight_keys(graph_template) if shard_weights else frozenset()
    mc = model.config

    @torch.no_grad()
    def embed(params, graph):
        return encode_sharded(
            params, graph, mesh, None, deterministic=True, spmm_impl=mc.spmm_impl,
            per_relation_dropout_max=mc.per_relation_dropout_max,
            spmm_precision=mc.spmm_precision, sharded_keys=keys, overlap=True,
        )

    return embed
