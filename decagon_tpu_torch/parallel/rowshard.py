"""Row x edge sharded graph: one rank's slot of the multi-relational
adjacency partitioned over the (row, edge) mesh.

Port of ``decagon_tpu/parallel/rowshard.py``, with one difference of form:
the JAX package lays out every slot on a leading ``[S, ...]`` axis and
shards it with ``sharded_pspecs``; here each rank builds and holds only
its own slot, so ``ShardedGraph`` has no leading axis and there are no
partition specs.  The layout is the JAX package's, slot for slot:

* rows of edge type ``(i, j)`` go to row blocks of ``nb = ceil(n_i / nr)``;
* the edges, stably sorted by block, are dealt round-robin to the edge
  shards: the ``p``-th edge of a block goes to shard ``p % ne`` at position
  ``p // ne``; each slot's stream is padded to a multiple of
  ``edge_pad_multiple`` with ``vals == 0``, and its receivers are local to
  the block (``row - r * nb``);
* the dense ``[k_loc, nb, n_j]`` stack (``k_loc = ceil(K / ne)``), where
  ``k_loc * nb * n_j`` is at most ``densify_max_cells_per_device``, is split
  by RELATION, not by the round-robin shard: edge shard ``e`` holds
  relations ``[e * k_loc, (e + 1) * k_loc)`` of all of its block's edges,
  so a weight-sharded rank's forward reads only its own relations'
  weights.  Each rank fills its stack on its own device (the JAX package
  scatters the stacked one on the device; the result is the same);
* with ``tile_for_pallas``, where the type has no dense stack (or always,
  with ``tile_even_if_dense``), K6's layouts of the slot's edges
  (``ops/tiling.build_tiles``): forward from the flat source
  ``rel * n_j + sender`` into the ``nb`` block rows, backward its
  transpose into the ``K * n_j`` projected space;
* the negative-sampling CDFs and the features are whole on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from decagon_tpu_torch import DeviceLike, resolve_device
from decagon_tpu_torch.graph.container import EdgeType, RelationGraph, RelationKey
from decagon_tpu_torch.graph.device import _neg_cdf, _round_up, etkey, parse_etkey
from decagon_tpu_torch.graph.split import EdgeSplit
from decagon_tpu_torch.ops.tiling import CsrEdges, build_tiles


@dataclasses.dataclass
class ShardedEdgeTypeAdj:
    """One edge type's adjacency in this rank's slot (row block ``r``,
    edge shard ``e``).  ``receivers`` are local to the row block; padding
    entries carry ``vals == 0``."""

    senders: torch.Tensor  # int32 [E_loc] (global column index)
    receivers: torch.Tensor  # int32 [E_loc] (row-block-local row index)
    rel: torch.Tensor  # int32 [E_loc]
    vals: torch.Tensor  # float32 [E_loc]
    num_rel: int
    n_rows: int
    n_cols: int
    n_rows_block: int
    k_loc: int
    dense: Optional[torch.Tensor] = None  # [k_loc, nb, n_cols]: relations e*k_loc.. of block r
    tiles_fwd: Optional[CsrEdges] = None  # into [nb] from [K * n_cols]
    tiles_bwd: Optional[CsrEdges] = None  # its transpose
    pair_mask: None = None  # a mesh has no paired stacks (``paired_edge_types``)


@dataclasses.dataclass
class ShardedGraph:
    """This rank's slot of the sharded graph: the counterpart of
    ``DeviceGraph`` for the mesh path, with its ``edge_types`` /
    ``num_relations`` / ``decoder_name`` surface."""

    adj: Dict[str, ShardedEdgeTypeAdj]
    features: Dict[str, Optional[torch.Tensor]]
    neg_cdf: Dict[str, torch.Tensor]
    num_nodes: Tuple[int, ...]
    feature_dims: Tuple[int, ...]
    decoders: Tuple[Tuple[str, str], ...]
    mesh_shape: Tuple[int, int]
    slot: int
    device: torch.device

    @property
    def edge_types(self) -> List[EdgeType]:
        return sorted(parse_etkey(k) for k in self.adj)

    @property
    def row_index(self) -> int:
        return self.slot // self.mesh_shape[1]

    @property
    def edge_index(self) -> int:
        return self.slot % self.mesh_shape[1]

    def num_relations(self, edge_type: EdgeType) -> int:
        return self.adj[etkey(edge_type)].num_rel

    def decoder_name(self, edge_type: EdgeType) -> str:
        return dict(self.decoders)[etkey(edge_type)]


def slot_layout(receivers: np.ndarray, nb: int, nr: int, ne: int):
    """The round-robin layout of one edge type's edges: ``order`` (the
    stable sort by row block), and per sorted edge its block, edge shard
    and position in the shard's stream."""
    blk = receivers // nb
    order = np.argsort(blk, kind="stable")
    blk = blk[order]
    block_starts = np.searchsorted(blk, np.arange(nr))
    pos_in_block = np.arange(len(blk)) - block_starts[blk]
    return order, blk, pos_in_block % ne, pos_in_block // ne


def build_sharded_device_graph(
    graph: RelationGraph,
    splits: Dict[RelationKey, EdgeSplit],
    mesh_shape: Tuple[int, int],
    rank: int,
    device: DeviceLike = None,
    edge_pad_multiple: int = 256,
    densify_max_cells_per_device: int = 8_000_000,
    dense_dtype: torch.dtype = torch.float32,
    tile_for_pallas: bool = False,
    tile_even_if_dense: bool = False,
) -> ShardedGraph:
    """Slot ``rank`` (``r * ne + e``) of the normalized train adjacencies
    partitioned over a ``mesh_shape = (nr, ne)`` mesh, on ``device`` (CUDA
    unless named).  The mesh shape and the slot are plain arguments, so
    the layout needs no process group; ``dense_dtype`` is f32 or bf16."""
    nr, ne = (int(s) for s in mesh_shape)
    if not 0 <= rank < nr * ne:
        raise ValueError(f"slot {rank} outside a {nr} x {ne} mesh")
    if dense_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dense_dtype must be float32 or bfloat16, not {dense_dtype}")
    dev = resolve_device(device)
    r, e = divmod(rank, ne)
    degrees = graph.degrees()

    adj: Dict[str, ShardedEdgeTypeAdj] = {}
    neg_cdf: Dict[str, torch.Tensor] = {}
    for (i, j), rels in sorted(graph.relations.items()):
        n_i, n_j = graph.num_nodes[i], graph.num_nodes[j]
        nb = -(-n_i // nr)
        k = len(rels)
        k_loc = -(-k // ne)
        parts = [splits[(i, j, kk)] for kk in range(k)]
        receivers = np.concatenate([s.adj_rows for s in parts]).astype(np.int64)
        senders = np.concatenate([s.adj_cols for s in parts]).astype(np.int64)
        vals = np.concatenate([s.adj_vals for s in parts]).astype(np.float32)
        rel = np.concatenate([np.full(s.adj_rows.shape[0], kk, np.int64)
                              for kk, s in enumerate(parts)])

        order, blk, shard, slot = slot_layout(receivers, nb, nr, ne)
        senders, receivers, rel, vals = senders[order], receivers[order], rel[order], vals[order]
        counts = np.bincount(blk * ne + shard, minlength=nr * ne)
        e_loc = _round_up(max(1, int(counts.max())), edge_pad_multiple)

        mine = (blk == r) & (shard == e)
        at = slot[mine]

        def stream(values, dtype):
            out = np.zeros(e_loc, dtype)
            out[at] = values[mine]
            return torch.from_numpy(out).to(dev)

        local_recv = receivers - blk * nb
        entry = ShardedEdgeTypeAdj(
            senders=stream(senders, np.int32), receivers=stream(local_recv, np.int32),
            rel=stream(rel, np.int32), vals=stream(vals, np.float32),
            num_rel=k, n_rows=n_i, n_cols=n_j, n_rows_block=nb, k_loc=k_loc,
        )
        if k_loc * nb * n_j <= densify_max_cells_per_device:
            # Relations e*k_loc.. of ALL of block r's edges.
            held = (blk == r) & (rel // k_loc == e)
            index = tuple(
                torch.from_numpy(a[held]).to(dev)
                for a in (rel % k_loc, local_recv, senders)
            )
            entry.dense = torch.zeros((k_loc, nb, n_j), dtype=dense_dtype, device=dev)
            entry.dense.index_put_(
                index, torch.from_numpy(vals[held]).to(dev, dense_dtype), accumulate=True
            )
        if tile_for_pallas and (entry.dense is None or tile_even_if_dense):
            flat = rel[mine] * n_j + senders[mine]
            recv = local_recv[mine]
            entry.tiles_fwd = build_tiles(flat, recv, vals[mine], k * n_j, nb).to(dev)
            entry.tiles_bwd = build_tiles(recv, flat, vals[mine], nb, k * n_j).to(dev)
        adj[etkey((i, j))] = entry
        neg_cdf[etkey((i, j))] = _neg_cdf(degrees[i], k).to(dev)

    features: Dict[str, Optional[torch.Tensor]] = {}
    for t in range(len(graph.num_nodes)):
        feat = graph.features[t]
        features[str(t)] = (
            None if feat.kind == "identity"
            else torch.as_tensor(feat.dense, dtype=torch.float32).to(dev)
        )
    return ShardedGraph(
        adj=adj,
        features=features,
        neg_cdf=neg_cdf,
        num_nodes=tuple(graph.num_nodes),
        feature_dims=tuple(graph.features[t].dim for t in range(len(graph.num_nodes))),
        decoders=tuple(
            (etkey(et), graph.decoders.get(et, "innerproduct"))
            for et in sorted(graph.relations)
        ),
        mesh_shape=(nr, ne),
        slot=int(rank),
        device=dev,
    )
