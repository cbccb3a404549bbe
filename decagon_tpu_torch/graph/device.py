"""Device-resident graph: per-edge-type COO streams, dense and int8 mask
stacks, and the negative-sampling CDFs.

Port of ``decagon_tpu/graph/device.py``.  Per edge type the normalized
train adjacencies are flattened into one padded COO stream (``senders``,
``receivers``, ``rel``, ``vals``; padding carries ``vals == 0``), and:

* the DENSE stack ``[K, N_i, N_j]`` (f32 or bf16) where ``K * N_i * N_j``
  is at most ``densify_max_cells`` and the edge type gets neither of the
  mask forms below (the JAX package builds it beside them too; at the
  paper's drug-drug shape that would be 3.2 GB no path reads);

* the FACTORED form (``dense_factored=True``): an int8 edge-count mask
  ``[K, N_i, N_j]``, its transpose, and the rank-1 normalization factors
  ``row_scale [K, N_i]`` / ``col_scale [K, N_j]`` (every value of a
  normalized adjacency is ``row_scale[k, i] * col_scale[k, j]``);
* the PAIRED form (``dense_paired=True``, square transpose-augmented edge
  types): relation ``K + k`` is relation ``k`` transposed, so only the
  direct half's masks are stored, ``pair_mask [K, N, N]`` int8, with
  ``pair_scales [K, 4, N]`` f32 holding rows ``(a_e, a_o, b_e, b_o)``:
  the row and column scales of the direct and the transposed half.

* the CSR layouts of the sparse kernel K6 (``tile_for_pallas=True``,
  ``ops/tiling.py``): ``tiles_fwd`` scatters into the ``n_rows`` output
  rows from the flat source ``rel * N_j + senders``, ``tiles_bwd`` is its
  transpose.  Built where the JAX package would hold no dense stack
  (``K * N_i * N_j > densify_max_cells``), or everywhere with
  ``tile_even_if_dense``.

``neg_cdf[etk]`` [K, N_i] f32 holds, per relation, the normalized
cumulative unigram^0.75 distribution over row nodes for negative sampling.

``fused`` (``build_fused=True``, the default, as in the JAX package) is
every edge type's adjacency as ONE COO stream over global index spaces
(``FusedAdj``), with its own two CSR layouts when tiling.

The port pads nothing but the COO streams: the JAX package pads the pair
stacks to its TPU block sizes, which the CUDA kernels do not need.  The
JAX package's ``tile_block`` (the TPU tile capacity) and its thread pool
for the native tiler have no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from decagon_tpu_torch import DeviceLike, resolve_device
from decagon_tpu_torch.graph.container import EdgeType, RelationGraph, RelationKey
from decagon_tpu_torch.graph.split import EdgeSplit
from decagon_tpu_torch.ops.tiling import CsrEdges, build_tiles


def etkey(edge_type: EdgeType) -> str:
    return f"{edge_type[0]},{edge_type[1]}"


def parse_etkey(key: str) -> EdgeType:
    i, j = key.split(",")
    return (int(i), int(j))


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _recover_rank1(splits, keys, n_i, n_j):
    """Per-relation rank-1 normalization factors for an edge type's
    relations, verified against the stored adjacency values: returns
    (row_scale [K, n_i], col_scale [K, n_j]) or None if any relation's
    normalization is not exactly rank-1 (``normalize.py``: square rule
    uses ONE degree vector; rect uses row/col degrees)."""
    row_scale = np.zeros((len(keys), n_i), np.float32)
    col_scale = np.zeros((len(keys), n_j), np.float32)

    def _dinv(counts):
        with np.errstate(divide="ignore"):
            v = np.power(counts.astype(np.float64), -0.5)
        v[~np.isfinite(v)] = 0.0
        return v

    for k, key in enumerate(keys):
        split = splits[key]
        r_k, c_k, v_k = split.adj_rows, split.adj_cols, split.adj_vals
        dr = _dinv(np.bincount(r_k, minlength=n_i))
        dc = _dinv(np.bincount(c_k, minlength=n_j))
        # Candidate factor pairs: the square rule keys ONE degree vector
        # off the a_rows side — which lands on the OUTPUT cols for a
        # direct relation and the output rows for its transpose
        # (normalize_square's (A+I)^T flip); the rect rule uses both
        # sides.  Accept whichever verifies.
        candidates = [(dr, dc)]
        if n_i == n_j:
            candidates = [(dc, dc), (dr, dr), (dr, dc)]
        for a_vec, b_vec in candidates:
            if np.allclose(
                v_k, (a_vec[r_k] * b_vec[c_k]).astype(np.float32),
                rtol=1e-5, atol=1e-7,
            ):
                row_scale[k] = a_vec
                col_scale[k] = b_vec
                break
        else:
            return None
    return row_scale, col_scale


def _halves_are_transposes(splits, i, k_half) -> bool:
    """True when every relation ``K + k``'s train adjacency is relation
    ``k``'s, transposed — what the paired form relies on.  The JAX package
    trusts ``transpose_of`` alone (``graph/device.py:369-380``); the port
    also compares the stored adjacencies."""
    for k in range(k_half):
        d, t = splits[(i, i, k)], splits[(i, i, k_half + k)]
        if not (
            np.array_equal(d.adj_rows, t.adj_cols)
            and np.array_equal(d.adj_cols, t.adj_rows)
            and np.array_equal(d.adj_vals, t.adj_vals)
        ):
            return False
    return True


def _neg_cdf(deg_list, k_rel: int) -> torch.Tensor:
    """[K, N_i] f32 CDFs: relation k draws row nodes from
    ``deg_list[k % len(deg_list)] ** 0.75`` (reference
    ``optimizer.py:36-49``; the JAX package keeps the reference's indexing
    into the type's square-relation degree list, with a modular wrap)."""
    rows = []
    for k in range(k_rel):
        deg = deg_list[k % len(deg_list)].astype(np.float64)
        weights = np.power(np.maximum(deg, 0.0), 0.75)
        total = weights.sum()
        if total <= 0:
            weights = np.ones_like(weights)
            total = weights.sum()
        cdf = np.cumsum(weights) / total
        cdf[-1] = 1.0
        rows.append(cdf)
    return torch.as_tensor(np.stack(rows), dtype=torch.float32)


def _count_mask(shape, index, weight, device) -> torch.Tensor:
    """int8 stack of ``shape`` with ``weight`` ADDED at each ``index``
    (duplicate cells count every edge, as the JAX scatter-add does)."""
    mask = torch.zeros(shape, dtype=torch.int8, device=device)
    mask.index_put_(index, weight, accumulate=True)
    return mask


@dataclasses.dataclass
class EdgeTypeAdj:
    """Flattened, padded COO stack of all relations of one edge type.

    ``receivers`` index rows of the adjacency (output nodes, type ``i``);
    ``senders`` index columns (source nodes, type ``j``).  ``rel`` is the
    within-type relation index.  Padding entries carry ``vals == 0`` and
    index node 0 / relation 0.
    """

    senders: torch.Tensor  # int32 [E_pad]
    receivers: torch.Tensor  # int32 [E_pad]
    rel: torch.Tensor  # int32 [E_pad]
    vals: torch.Tensor  # float32 [E_pad]
    num_rel: int
    n_rows: int
    n_cols: int
    dense: Optional[torch.Tensor] = None  # f32 or bf16 [K, n_rows, n_cols]
    dense_mask: Optional[torch.Tensor] = None  # int8 [K, n_rows, n_cols]
    dense_mask_t: Optional[torch.Tensor] = None  # int8 [K, n_cols, n_rows]
    row_scale: Optional[torch.Tensor] = None  # f32 [K, n_rows]
    col_scale: Optional[torch.Tensor] = None  # f32 [K, n_cols]
    pair_mask: Optional[torch.Tensor] = None  # int8 [K/2, N, N]
    pair_scales: Optional[torch.Tensor] = None  # f32 [K/2, 4, N]
    tiles_fwd: Optional[CsrEdges] = None  # into [n_rows] from [K * n_cols]
    tiles_bwd: Optional[CsrEdges] = None  # its transpose


@dataclasses.dataclass
class FusedAdj:
    """ALL edge types' normalized adjacencies as ONE flat COO stream.

    Source indices address the concatenation of every edge type's
    flattened per-relation projected stack ``[K_et * N_j(et), H]`` (blocks
    in sorted edge-type order, offsets in ``layout``); destination indices
    address the concatenation of per-edge-type output terms ``[N_i(et),
    H]`` (offsets in ``terms``).  An encoder layer then aggregates every
    edge type with one gather and one scatter-add (or one K6 launch); each
    term is still row-normalized on its own.
    """

    src: torch.Tensor  # int32 [E_pad] into the projected space
    dst: torch.Tensor  # int32 [E_pad] into the term space
    vals: torch.Tensor  # float32 [E_pad]; padding entries are 0
    layout: Tuple[Tuple[str, int, int, int], ...]  # (etkey, p_start, num_rel, n_cols)
    terms: Tuple[Tuple[str, int, int], ...]  # (etkey, t_start, n_rows)
    n_p_rows: int
    n_t_rows: int
    tiles_fwd: Optional[CsrEdges] = None  # into [n_t_rows] from [n_p_rows]
    tiles_bwd: Optional[CsrEdges] = None  # its transpose


@dataclasses.dataclass
class DeviceGraph:
    """Everything the encoder and the scorers need, on one device.

    ``features``: per node type, a dense [N, F] tensor or ``None`` for
    symbolic identity features (the projection is then the weight stack).
    ``neg_cdf``: per edge type, [K, N_i] cumulative unigram^0.75
    distributions over row-type nodes for negative sampling.
    """

    adj: Dict[str, EdgeTypeAdj]
    features: Dict[str, Optional[torch.Tensor]]
    neg_cdf: Dict[str, torch.Tensor]
    num_nodes: Tuple[int, ...]
    feature_dims: Tuple[int, ...]
    decoders: Tuple[Tuple[str, str], ...]
    device: torch.device
    fused: Optional[FusedAdj] = None

    @property
    def edge_types(self) -> List[EdgeType]:
        return sorted(parse_etkey(k) for k in self.adj)

    def num_relations(self, edge_type: EdgeType) -> int:
        return self.adj[etkey(edge_type)].num_rel

    def decoder_name(self, edge_type: EdgeType) -> str:
        return dict(self.decoders)[etkey(edge_type)]

    def to(self, device: DeviceLike) -> "DeviceGraph":
        """The same graph with every tensor (the CSR layouts' too) on
        ``device``: a graph built on the host in one process can then be
        moved to the card in another."""
        dev = resolve_device(device)
        return dataclasses.replace(
            self,
            adj={key: _moved(a, dev) for key, a in self.adj.items()},
            features={key: None if f is None else f.to(dev) for key, f in self.features.items()},
            neg_cdf={key: c.to(dev) for key, c in self.neg_cdf.items()},
            fused=None if self.fused is None else _moved(self.fused, dev),
            device=dev,
        )


def _moved(entry, dev: torch.device):
    """A copy of a dataclass of tensors and CSR layouts on ``dev``."""
    return dataclasses.replace(entry, **{
        f.name: getattr(entry, f.name).to(dev)
        for f in dataclasses.fields(entry)
        if isinstance(getattr(entry, f.name), (torch.Tensor, CsrEdges))
    })


def build_device_graph(
    graph: RelationGraph,
    splits: Dict[RelationKey, EdgeSplit],
    edge_pad_multiple: int = 1024,
    densify_max_cells: int = 8_000_000,
    dense_factored: bool = False,
    dense_paired: bool = False,
    dense_dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
    tile_for_pallas: bool = False,
    tile_even_if_dense: bool = False,
    build_fused: bool = True,
) -> DeviceGraph:
    """Flatten the normalized train adjacencies and the sampling CDFs onto
    ``device`` (CUDA unless named), with the factored and paired mask
    stacks, the CSR layouts of K6 and the fused stream on request.

    Size gates follow the JAX package: the dense stack (in ``dense_dtype``,
    f32 or bf16) and the factored masks are built when an edge type's
    ``K * N_i * N_j`` is at most ``densify_max_cells``, the paired masks
    (half the cells) at up to twice that.  An edge type that gets the
    paired masks gets no factored ones, and one that gets either gets no
    dense stack: every encoder path reads the mask form there (the JAX
    package builds all three).  The CSR layouts (``tile_for_pallas``) go
    where ``K * N_i * N_j > densify_max_cells`` (the JAX package's "no dense
    stack"), or everywhere with ``tile_even_if_dense``; the fused stream's
    where any edge type got them, or with ``tile_even_if_dense``.
    """
    dev = resolve_device(device)
    if dense_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dense_dtype must be float32 or bfloat16, not {dense_dtype}")
    adj: Dict[str, EdgeTypeAdj] = {}
    neg_cdf: Dict[str, torch.Tensor] = {}
    degrees = graph.degrees()

    for (i, j), rels in sorted(graph.relations.items()):
        parts = [splits[(i, j, k)] for k in range(len(rels))]
        receivers = np.concatenate([s.adj_rows for s in parts])
        senders = np.concatenate([s.adj_cols for s in parts])
        vals = np.concatenate([s.adj_vals for s in parts])
        rel = np.concatenate([
            np.full(s.adj_rows.shape[0], k, dtype=np.int32)
            for k, s in enumerate(parts)
        ])
        real = vals.shape[0]
        pad = _round_up(max(1, real), edge_pad_multiple) - real

        def stream(a, dtype):
            a = np.concatenate([a, np.zeros(pad, a.dtype)]) if pad else a
            return torch.as_tensor(a, dtype=dtype).to(dev)

        senders_dev = stream(senders.astype(np.int32), torch.int32)
        receivers_dev = stream(receivers.astype(np.int32), torch.int32)
        rel_dev = stream(rel, torch.int32)
        vals_dev = stream(vals.astype(np.float32), torch.float32)

        k_rel = len(rels)
        n_i, n_j = graph.num_nodes[i], graph.num_nodes[j]
        cells = k_rel * n_i * n_j
        rel_keys = [(i, j, k) for k in range(k_rel)]
        factors = None
        if (dense_factored or dense_paired) and cells <= densify_max_cells * 2:
            factors = _recover_rank1(splits, rel_keys, n_i, n_j)

        # Real entries only: the padding would add to cell (0, 0, 0).
        r_idx = rel_dev[:real].long()
        i_idx = receivers_dev[:real].long()
        j_idx = senders_dev[:real].long()
        ones = (vals_dev[:real] != 0).to(torch.int8)

        entry = EdgeTypeAdj(
            senders=senders_dev, receivers=receivers_dev, rel=rel_dev,
            vals=vals_dev, num_rel=k_rel, n_rows=n_i, n_cols=n_j,
        )
        k_half = k_rel // 2
        if (
            dense_paired
            and i == j
            and k_rel > 0
            and k_rel % 2 == 0
            and factors is not None
            and cells <= densify_max_cells * 2
            and all(
                rels[k_half + k].transpose_of == (i, j, k)
                for k in range(k_half)
            )
            and _halves_are_transposes(splits, i, k_half)
        ):
            direct = r_idx < k_half
            entry.pair_mask = _count_mask(
                (k_half, n_i, n_i),
                (r_idx[direct], i_idx[direct], j_idx[direct]),
                ones[direct], dev,
            )
            row_scale, col_scale = factors
            entry.pair_scales = torch.as_tensor(
                np.stack(
                    [row_scale[:k_half], row_scale[k_half:],
                     col_scale[:k_half], col_scale[k_half:]],
                    axis=1,
                )
            ).to(dev)
        elif dense_factored and cells <= densify_max_cells and factors is not None:
            entry.dense_mask = _count_mask(
                (k_rel, n_i, n_j), (r_idx, i_idx, j_idx), ones, dev
            )
            entry.dense_mask_t = _count_mask(
                (k_rel, n_j, n_i), (r_idx, j_idx, i_idx), ones, dev
            )
            entry.row_scale = torch.as_tensor(factors[0]).to(dev)
            entry.col_scale = torch.as_tensor(factors[1]).to(dev)
        elif cells <= densify_max_cells:
            entry.dense = torch.zeros((k_rel, n_i, n_j), dtype=dense_dtype, device=dev)
            entry.dense.index_put_(
                (r_idx, i_idx, j_idx), vals_dev[:real].to(dense_dtype), accumulate=True
            )
        if tile_for_pallas and (cells > densify_max_cells or tile_even_if_dense):
            flat_src = rel.astype(np.int64) * n_j + senders.astype(np.int64)
            entry.tiles_fwd = build_tiles(flat_src, receivers, vals, k_rel * n_j, n_i).to(dev)
            entry.tiles_bwd = build_tiles(receivers, flat_src, vals, n_i, k_rel * n_j).to(dev)
        adj[etkey((i, j))] = entry
        neg_cdf[etkey((i, j))] = _neg_cdf(degrees[i], k_rel).to(dev)

    fused = None
    if build_fused:
        any_tiled = any(a.tiles_fwd is not None for a in adj.values())
        fused = _fused_adj(
            graph, splits, edge_pad_multiple, dev,
            tile=tile_for_pallas and (any_tiled or tile_even_if_dense),
        )

    features: Dict[str, Optional[torch.Tensor]] = {}
    for t in range(len(graph.num_nodes)):
        feat = graph.features[t]
        features[str(t)] = (
            None if feat.kind == "identity"
            else torch.as_tensor(feat.dense, dtype=torch.float32).to(dev)
        )
    return DeviceGraph(
        adj=adj,
        features=features,
        neg_cdf=neg_cdf,
        num_nodes=tuple(graph.num_nodes),
        feature_dims=tuple(graph.features[t].dim for t in range(len(graph.num_nodes))),
        decoders=tuple(
            (etkey(et), graph.decoders.get(et, "innerproduct"))
            for et in sorted(graph.relations)
        ),
        device=dev,
        fused=fused,
    )


def _fused_adj(graph, splits, edge_pad_multiple: int, dev, tile: bool) -> FusedAdj:
    """The fused all-edge-type stream (``FusedAdj``), padded as the
    per-edge-type streams are, with its CSR layouts when ``tile``."""
    layout, terms = [], []
    p_start = t_start = 0
    src_parts, dst_parts, val_parts = [], [], []
    for (i, j), rels in sorted(graph.relations.items()):
        key = etkey((i, j))
        n_i, n_j = graph.num_nodes[i], graph.num_nodes[j]
        layout.append((key, p_start, len(rels), n_j))
        terms.append((key, t_start, n_i))
        for k in range(len(rels)):
            split = splits[(i, j, k)]
            src_parts.append(p_start + k * n_j + split.adj_cols.astype(np.int64))
            dst_parts.append(t_start + split.adj_rows.astype(np.int64))
            val_parts.append(split.adj_vals.astype(np.float32))
        p_start += len(rels) * n_j
        t_start += n_i
    src = np.concatenate(src_parts) if src_parts else np.zeros(0, np.int64)
    dst = np.concatenate(dst_parts) if dst_parts else np.zeros(0, np.int64)
    vals = np.concatenate(val_parts) if val_parts else np.zeros(0, np.float32)
    pad = _round_up(max(1, vals.shape[0]), edge_pad_multiple) - vals.shape[0]

    def stream(a, dtype):
        a = np.concatenate([a, np.zeros(pad, a.dtype)]) if pad else a
        return torch.as_tensor(a, dtype=dtype).to(dev)

    fused = FusedAdj(
        src=stream(src.astype(np.int32), torch.int32),
        dst=stream(dst.astype(np.int32), torch.int32),
        vals=stream(vals, torch.float32),
        layout=tuple(layout),
        terms=tuple(terms),
        n_p_rows=p_start,
        n_t_rows=t_start,
    )
    if tile:
        fused.tiles_fwd = build_tiles(src, dst, vals, p_start, t_start).to(dev)
        fused.tiles_bwd = build_tiles(dst, src, vals, t_start, p_start).to(dev)
    return fused
