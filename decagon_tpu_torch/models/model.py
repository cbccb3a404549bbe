"""DecagonModel: parameter construction and application.

Port of ``decagon_tpu/models/model.py``: the encoder
(``models/encoder.py``) tied to per-edge-type decoders
(``models/decoders.py``).  Parameters are an explicit nested dict of
tensors with the JAX package's layout (``models/convert.py`` carries them
across); the module holds the configuration and the graph's metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from decagon_tpu_torch.graph.container import EdgeType
from decagon_tpu_torch.graph.device import DeviceGraph, etkey
from decagon_tpu_torch.models import decoders as dec
from decagon_tpu_torch.models.encoder import (
    LayerBits,
    check_spmm_impl,
    draw_layer_bits,
    encode,
    init_encoder_params,
)
from decagon_tpu_torch.ops.segment import dropout
from decagon_tpu_torch.ops.spmm_pallas import PRECISIONS

Params = Dict[str, Dict]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model hyperparameters, with every field of the JAX package's
    ``ModelConfig`` (reference defaults: hidden 64->32, dropout 0.1).

    ``spmm_impl``: "auto"/"paired" (paired kernels on CUDA, plain versions
    on the CPU; on CUDA the other edge types take the factored or dense
    stack, else the CSR layouts through K6, else the COO stream),
    "paired_ref" (plain versions everywhere), "xla", "dense",
    "dense_factored" or "pallas" (``ops/segment.spmm`` for every edge
    type; "pallas_ref" is K6's plain version on any device), or "fused",
    "fused_pallas", "fused_pallas_ref" (every edge type at once over the
    fused stream).  ``spmm_precision`` ("highest" or "default") steers K6.
    ``sddmm_impl`` "auto" (kernel on CUDA, plain on the CPU), "jnp" (the
    plain gather-and-multiply path), "pallas" (the kernel, raising off the
    card) or "pallas_interpret" (raises, naming "jnp"; both checked by
    ``train/step.make_emb_scores``); ``sddmm_precision`` "highest" (K5) or
    "default" (K5-bf16).  ``remat`` recomputes the encoder in the backward
    pass (``torch.utils.checkpoint``).  Construction raises for the JAX
    package's interpret-mode impls, for an unknown precision and for a
    hidden width below 1; every positive width runs.
    """

    hidden1: int = 64
    hidden2: int = 32
    dropout: float = 0.1
    per_relation_dropout_max: int = 64
    spmm_impl: str = "auto"
    spmm_precision: str = "highest"
    sddmm_impl: str = "auto"
    sddmm_precision: str = "highest"
    remat: bool = False

    def __post_init__(self):
        check_spmm_impl(self.spmm_impl)
        for name in ("spmm_precision", "sddmm_precision"):
            if getattr(self, name) not in PRECISIONS:
                raise ValueError(f"{name} must be one of {PRECISIONS}, not {getattr(self, name)!r}")
        if self.hidden1 < 1 or self.hidden2 < 1:
            raise ValueError(
                f"hidden widths must be positive, got {self.hidden1}, {self.hidden2}"
            )


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {key: _to_device(value, device) for key, value in tree.items()}
    return tree.to(device)


class DecagonModel(nn.Module):
    """Holds the configuration and the graph's metadata; ``forward`` is
    the encoder (``embeddings``)."""

    def __init__(self, config: ModelConfig, graph: DeviceGraph):
        super().__init__()
        self.config = config
        self.graph_meta = graph

    def init_params(self, generator: torch.Generator, graph: DeviceGraph) -> Params:
        """Glorot weights drawn from ``generator``, moved to the graph's
        device.  Draw on a CPU generator to get the same weights for any
        device."""
        params = init_encoder_params(
            generator, graph, self.config.hidden1, self.config.hidden2,
            spmm_impl=self.config.spmm_impl,
        )
        params["dec"] = {
            etkey(et): dec.init_decoder_params(
                generator, graph.decoder_name(et), graph.num_relations(et),
                self.config.hidden2,
            )
            for et in graph.edge_types
        }
        return _to_device(params, graph.device)

    def embeddings(
        self,
        params: Params,
        graph: DeviceGraph,
        generator: Optional[torch.Generator] = None,
        deterministic: bool = True,
        layer_bits: Optional[LayerBits] = None,
        group=None,
    ) -> Dict[str, torch.Tensor]:
        """Node embeddings per type; with ``deterministic=False`` the
        encoder's dropout draws from ``generator`` (or takes
        ``layer_bits``, see ``models/encoder.encode``).  ``group``: the
        process group the aggregations are summed over (``encode``).

        With ``remat`` (and ``deterministic=False``) the encoder runs under
        ``torch.utils.checkpoint``: its activations are not kept but
        recomputed in the backward pass.  The checkpoint restores only the
        default generators' states, and the port draws dropout from
        explicit ones, so the layer bits are drawn here, before the
        checkpointed region, and passed in: the recomputation sees the
        same masks (``jax.checkpoint`` needs no such care, its key is a
        value).  The recomputation launches the forward kernels again."""
        cfg = self.config
        kw = dict(
            dropout_rate=cfg.dropout, spmm_impl=cfg.spmm_impl,
            per_relation_dropout_max=cfg.per_relation_dropout_max,
            spmm_precision=cfg.spmm_precision, group=group,
        )
        if not (cfg.remat and not deterministic):
            return encode(
                params, graph, generator, deterministic=deterministic,
                layer_bits=layer_bits, **kw,
            )
        if layer_bits is None and generator is not None and cfg.dropout > 0.0:
            layer_bits = draw_layer_bits(
                params, graph, generator, cfg.dropout, cfg.spmm_impl,
                cfg.per_relation_dropout_max,
            )

        def run(params, layer_bits):
            return encode(params, graph, None, deterministic=False, layer_bits=layer_bits, **kw)

        return checkpoint(run, params, layer_bits, use_reentrant=False, preserve_rng_state=False)

    forward = embeddings

    def score_edges(
        self,
        params: Params,
        graph: DeviceGraph,
        embeddings: Dict[str, torch.Tensor],
        edge_type: EdgeType,
        k,
        rows: torch.Tensor,
        cols: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        deterministic: bool = True,
    ) -> torch.Tensor:
        """Logit scores for B (row, col) pairs of relation ``k`` of
        ``edge_type`` (``k`` an int or a per-edge index tensor).

        Decoder-input dropout is opt-in (``deterministic=False`` and a
        ``generator``), as in the JAX package: the reference's training
        path applies none, so the train step does not use it."""
        name = graph.decoder_name(edge_type)
        z_rows = embeddings[str(edge_type[0])][rows.long()]
        z_cols = embeddings[str(edge_type[1])][cols.long()]
        if not deterministic and generator is not None:
            z_rows = dropout(generator, z_rows, self.config.dropout)
            z_cols = dropout(generator, z_cols, self.config.dropout)
        return dec.score_edges(
            params["dec"][etkey(edge_type)], name, k, z_rows, z_cols
        )
