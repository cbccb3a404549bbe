"""DecagonModel: parameter construction and application.

Port of ``decagon_tpu/models/model.py``: the encoder
(``models/encoder.py``) tied to per-edge-type decoders
(``models/decoders.py``).  Parameters are an explicit nested dict of
tensors with the JAX package's layout (``models/convert.py`` carries them
across); the module holds the configuration and the graph's metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from decagon_tpu_torch.graph.container import EdgeType
from decagon_tpu_torch.graph.device import DeviceGraph, etkey
from decagon_tpu_torch.models import decoders as dec
from decagon_tpu_torch.models.encoder import encode, init_encoder_params

Params = Dict[str, Dict]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model hyperparameters, with every field of the JAX package's
    ``ModelConfig`` (reference defaults: hidden 64->32, dropout 0.1).

    Ported values: ``spmm_impl`` "auto"/"paired" (kernels on CUDA, plain
    versions on the CPU) or "paired_ref" (plain versions everywhere);
    ``sddmm_impl`` "auto" (kernel on CUDA, plain on the CPU) or "jnp" (the
    plain gather-and-multiply path); ``sddmm_precision`` "highest".
    ``dropout``, ``per_relation_dropout_max``, ``spmm_precision`` and
    ``remat`` only matter for training, which comes with a later slice.
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


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {key: _to_device(value, device) for key, value in tree.items()}
    return tree.to(device)


class DecagonModel(nn.Module):
    """Holds the configuration and the graph's metadata; ``forward`` is
    the deterministic encoder (``embeddings``)."""

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

    @torch.no_grad()
    def embeddings(self, params: Params, graph: DeviceGraph) -> Dict[str, torch.Tensor]:
        return encode(params, graph, spmm_impl=self.config.spmm_impl)

    forward = embeddings

    @torch.no_grad()
    def score_edges(
        self,
        params: Params,
        graph: DeviceGraph,
        embeddings: Dict[str, torch.Tensor],
        edge_type: EdgeType,
        k,
        rows: torch.Tensor,
        cols: torch.Tensor,
    ) -> torch.Tensor:
        """Logit scores for B (row, col) pairs of relation ``k`` of
        ``edge_type`` (``k`` an int or a per-edge index tensor)."""
        name = graph.decoder_name(edge_type)
        z_rows = embeddings[str(edge_type[0])][rows.long()]
        z_cols = embeddings[str(edge_type[1])][cols.long()]
        return dec.score_edges(
            params["dec"][etkey(edge_type)], name, k, z_rows, z_cols
        )
