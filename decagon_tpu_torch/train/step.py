"""Evaluation steps: the deterministic encoder forward and the scorer.

Port of ``make_embed_fn`` / ``make_emb_scores`` from
``decagon_tpu/train/step.py:578-680``.  The training step comes with a
later slice.
"""

from __future__ import annotations

from typing import Callable

import torch

from decagon_tpu_torch.graph.container import EdgeType
from decagon_tpu_torch.graph.device import etkey
from decagon_tpu_torch.models import decoders as dec
from decagon_tpu_torch.models.model import DecagonModel
from decagon_tpu_torch.ops.sddmm_pallas import sddmm_edges


def make_embed_fn(model: DecagonModel) -> Callable:
    """Deterministic full-graph encoder forward:
    ``embed(params, graph) -> {"0": [N_0, H2], ...}``."""

    def embed(params, graph):
        return model.embeddings(params, graph)

    return embed


def make_emb_scores(model: DecagonModel, edge_type: EdgeType) -> Callable:
    """Scorer over precomputed embeddings with a per-edge relation index:
    ``scores(params, embeddings, ks, rows, cols) -> sigmoid
    probabilities`` of the same shape as ``ks``.

    Index tensors may be flat ``[B]`` or chunked ``[n_chunks, C]``; chunks
    are scored one after another, which bounds the plain version's
    gathered per-edge factors (bilinear gathers a [C, d, d] stack).
    ``sddmm_impl``: "auto" (the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors) or "jnp" (the plain gather-and-multiply
    path of ``models/decoders.py`` on any device).
    """
    name = model.graph_meta.decoder_name(edge_type)
    et_key = etkey(edge_type)
    row_t, col_t = str(edge_type[0]), str(edge_type[1])
    impl = model.config.sddmm_impl
    if impl not in ("auto", "jnp"):
        raise NotImplementedError(
            f"sddmm_impl {impl!r} is not ported; use 'auto' or 'jnp'"
        )
    if model.config.sddmm_precision != "highest":
        raise NotImplementedError(
            f"sddmm_precision {model.config.sddmm_precision!r} is not ported;"
            " only 'highest' is"
        )

    def one(params, embeddings, ks, rows, cols):
        dp = params["dec"][et_key]
        if impl == "auto":
            return sddmm_edges(
                embeddings[row_t].contiguous(), embeddings[col_t].contiguous(),
                ks, rows, cols,
                name=name,
                glb=dp.get("global"),
                rel_diag=dp.get("local_diag", dp.get("relation_diag")),
                rel_full=dp.get("relation"),
            )
        z_rows = embeddings[row_t][rows.long()]
        z_cols = embeddings[col_t][cols.long()]
        return dec.score_edges(dp, name, ks.long(), z_rows, z_cols)

    @torch.no_grad()
    def scores(params, embeddings, ks, rows, cols):
        if ks.dim() == 1:
            return torch.sigmoid(one(params, embeddings, ks, rows, cols))
        return torch.stack([
            torch.sigmoid(one(params, embeddings, k, r, c))
            for k, r, c in zip(ks, rows, cols)
        ])

    return scores
