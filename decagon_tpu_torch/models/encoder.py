"""Two-layer multi-relational graph-convolution encoder (deterministic).

Port of ``decagon_tpu/models/encoder.py`` for the serving slice:

    layer 1:  T1_{ij} = l2norm_rows( sum_k A^{ij}_k (X_j W1^{ij}_k) )
              h1_i    = relu( sum_j T1_{ij} )
    layer 2:  T2_{ij} = l2norm_rows( sum_k A^{ij}_k (h1_j W2^{ij}_k) )
              emb_i   = sum_j T2_{ij}                       (no relu)

(reference ``decagon/deep/model.py:64-88``, ``layers.py:70-118``).  Square
transpose-paired edge types aggregate through the paired kernel
(``ops/spmm_paired.py``) and store their weights transposed,
``[2, K/2, H, F]``; the others through the int8 factored stack
(``ops/segment.py``).  The dropout branches and the fused all-edge-type
stream come with the training slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from decagon_tpu_torch.graph.device import DeviceGraph, etkey
from decagon_tpu_torch.models.init import glorot
from decagon_tpu_torch.ops.segment import l2_normalize_rows, spmm_dense_factored
from decagon_tpu_torch.ops.spmm_paired import spmm_paired, spmm_paired_identity

Params = Dict[str, Dict[str, torch.Tensor]]

# spmm_impl values that take the paired path on edge types with a pair_mask
# ("paired_ref" forces the plain version on any device).
PAIRED_IMPLS = ("auto", "paired", "paired_ref")


def paired_edge_types(graph: DeviceGraph, spmm_impl: str) -> set:
    """Edge-type keys that run the PAIRED path — and therefore store their
    encoder weights transposed ``[2, K/2, H, F]``.  Must agree between
    ``init_encoder_params`` and ``encode``."""
    if spmm_impl not in PAIRED_IMPLS:
        raise NotImplementedError(
            f"spmm_impl {spmm_impl!r} is not ported yet; use one of "
            f"{PAIRED_IMPLS}"
        )
    return {key for key, adj in graph.adj.items() if adj.pair_mask is not None}


def init_encoder_params(
    generator: torch.Generator,
    graph: DeviceGraph,
    hidden1: int,
    hidden2: int,
    dtype: torch.dtype = torch.float32,
    spmm_impl: str = "auto",
) -> Params:
    """Stacked per-relation Glorot weights per edge type, drawn from
    ``generator``: enc1[etk] [K, F_j, hidden1], enc2[etk] [K, hidden1,
    hidden2]; paired edge types store the same weights transposed,
    [2, K/2, hidden1, F_j] / [2, K/2, hidden2, hidden1]."""
    paired = paired_edge_types(graph, spmm_impl)
    enc1, enc2 = {}, {}
    for et in graph.edge_types:
        key = etkey(et)
        k_rel = graph.num_relations(et)
        feat_dim = graph.feature_dims[et[1]]
        if key in paired:
            shape1 = (2, k_rel // 2, hidden1, feat_dim)
            shape2 = (2, k_rel // 2, hidden2, hidden1)
        else:
            shape1 = (k_rel, feat_dim, hidden1)
            shape2 = (k_rel, hidden1, hidden2)
        enc1[key] = glorot(generator, shape1, fan=(feat_dim, hidden1), dtype=dtype)
        enc2[key] = glorot(generator, shape2, fan=(hidden1, hidden2), dtype=dtype)
    return {"enc1": enc1, "enc2": enc2}


def _project(feat: Optional[torch.Tensor], weights: torch.Tensor) -> torch.Tensor:
    """Per-relation projected features P [K, N_src, H] (identity features:
    ``X @ W == W``)."""
    if feat is None:
        return weights
    return torch.einsum("nf,kfh->knh", feat, weights)


def _project_t(feat: Optional[torch.Tensor], weights_t: torch.Tensor) -> torch.Tensor:
    """Transposed projection for paired edge types: P^T [2, K, H, N]."""
    if feat is None:
        return weights_t
    return torch.einsum("skhf,nf->skhn", weights_t, feat)


def encode_layer(
    params: Params,
    graph: DeviceGraph,
    level: str,
    inputs: Dict[str, Optional[torch.Tensor]],
    relu: bool,
    spmm_impl: str = "auto",
) -> Dict[str, torch.Tensor]:
    """One encoder layer: per node type, the sum over incoming edge types
    of the row-normalized aggregation (``relu`` applied to the sum)."""
    paired = paired_edge_types(graph, spmm_impl)
    pimpl = "paired_ref" if spmm_impl == "paired_ref" else "auto"
    out: Dict[str, torch.Tensor] = {}
    for i in range(len(graph.num_nodes)):
        acc = None
        for et in graph.edge_types:
            if et[0] != i:
                continue
            key = etkey(et)
            adj = graph.adj[key]
            feat = inputs[str(et[1])]
            w = params[level][key]
            if key in paired and feat is None:
                agg = spmm_paired_identity(w, None, adj, impl=pimpl)
            elif key in paired:
                agg = spmm_paired(_project_t(feat, w), adj, impl=pimpl)
            elif adj.dense_mask is not None:
                agg = spmm_dense_factored(
                    _project(feat, w), adj.dense_mask, adj.dense_mask_t,
                    adj.row_scale, adj.col_scale,
                )
            else:
                raise NotImplementedError(
                    f"edge type {key} has neither a paired nor a factored mask "
                    "stack; build the device graph with dense_factored=True "
                    "(other aggregation forms come with a later slice)"
                )
            term = l2_normalize_rows(agg)
            acc = term if acc is None else acc + term
        if acc is None:
            raise ValueError(f"node type {i} has no incoming edge types")
        out[str(i)] = torch.relu(acc) if relu else acc
    return out


def encode(
    params: Params, graph: DeviceGraph, spmm_impl: str = "auto"
) -> Dict[str, torch.Tensor]:
    """Deterministic node embeddings per type: {"0": [N_0, H2], ...}."""
    h1 = encode_layer(params, graph, "enc1", graph.features, True, spmm_impl)
    return encode_layer(params, graph, "enc2", h1, False, spmm_impl)
