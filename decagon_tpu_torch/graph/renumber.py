"""Degree-clustered node renumbering.

Port of ``decagon_tpu/graph/renumber.py`` (numpy only, the same output bit
for bit).  Each node type is relabelled by total degree, descending and
stable, so the most-referenced source rows sit at the front of the flat
projected table.  In the JAX package this raises the occupancy of the
tiled SpMM's contiguous source windows; on the card it packs the hot rows
of the CSR gather (``ops/spmm_pallas.py``) together in memory.

Renumbering happens at the graph level, before splitting: every downstream
structure (splits, device graph, batches, evaluation) lives in the
renumbered space, and every evaluation metric is permutation-invariant.
The returned ``old_of_new`` permutations map per-node tables back to
external row order (``restore_external_rows``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from decagon_tpu_torch.graph.container import NodeFeatures, Relation, RelationGraph


def renumber_by_degree(
    graph: RelationGraph,
) -> Tuple[RelationGraph, Dict[int, np.ndarray]]:
    """Relabel each node type by total degree (descending, stable).

    Returns ``(renumbered_graph, perms)`` with ``perms[t][new_id] =
    old_id``; ``restore_external_rows(table_new, perms[t])`` gives a
    per-node table in external row order.
    """
    n_types = len(graph.num_nodes)
    deg = [np.zeros(n, np.int64) for n in graph.num_nodes]
    for (i, j), rels in graph.relations.items():
        for rel in rels:
            deg[i] += np.bincount(rel.rows, minlength=graph.num_nodes[i])
            deg[j] += np.bincount(rel.cols, minlength=graph.num_nodes[j])
    perms: Dict[int, np.ndarray] = {}
    new_of_old: List[np.ndarray] = []
    for t in range(n_types):
        order = np.argsort(-deg[t], kind="stable").astype(np.int64)
        perms[t] = order  # old_of_new
        inv = np.empty_like(order)
        inv[order] = np.arange(order.size, dtype=np.int64)
        new_of_old.append(inv)

    relations = {}
    for (i, j), rels in graph.relations.items():
        relations[(i, j)] = [
            Relation(
                rows=new_of_old[i][rel.rows].astype(rel.rows.dtype),
                cols=new_of_old[j][rel.cols].astype(rel.cols.dtype),
                shape=rel.shape,
                name=rel.name,
                transpose_of=rel.transpose_of,
            )
            for rel in rels
        ]
    features = {}
    for t, feat in graph.features.items():
        if feat.kind == "identity":
            # a symbolic one-hot has no external row order to permute
            features[t] = feat
        else:
            features[t] = NodeFeatures.from_dense(np.asarray(feat.dense)[perms[t]])
    return (
        RelationGraph(
            node_type_names=graph.node_type_names,
            num_nodes=graph.num_nodes,
            relations=relations,
            features=features,
            decoders=dict(graph.decoders),
        ),
        perms,
    )


def restore_external_rows(table_new: np.ndarray, old_of_new: np.ndarray) -> np.ndarray:
    """A per-node table in renumbered row order, put back in external row
    order."""
    out = np.empty_like(table_new)
    out[old_of_new] = table_new
    return out
