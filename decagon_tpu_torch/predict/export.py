"""Export offline-predictor artifacts from a saved checkpoint.

Capability spec: reference ``main/Predictor/CheckpointToNdarrayWriter.py``
(``:30-169``) — rebuild the model, restore the latest checkpoint, run the
deterministic forward, and write the artifact set the numpy predictor
consumes (``embeddings.npy``, per-relation ``EmbeddingImportance-<SE>.npy``,
``GlobalRelations.npy``).

Port of ``decagon_tpu/predict/export.py``.  ``main`` rebuilds the
dataset, graph and device graph through the functions the CLI trains on
(``train/layout.py``), so the template has the layout the CLI trained
(paired stacks on the card, renumbered nodes with ``RenumberNodes``,
whose embeddings are written back in external row order).  A checkpoint of another layout fails to restore
(``Checkpointer`` raises on a structure or shape mismatch).

Run as a module for the CLI surface::

    python -m decagon_tpu_torch.predict.export --config conf.json \
        --set NdarrayWriteDir=dumps
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from decagon_tpu_torch.config import Config
from decagon_tpu_torch.graph.device import DeviceGraph
from decagon_tpu_torch.models.model import DecagonModel
from decagon_tpu_torch.train.checkpoint import Checkpointer, export_ndarrays
from decagon_tpu_torch.train.layout import (
    build_dataset,
    build_training_device_graph,
    training_graph,
)
from decagon_tpu_torch.train.step import make_generator


def export_from_checkpoint(
    model: DecagonModel,
    device_graph: DeviceGraph,
    checkpoint_dir: str,
    out_dir: str,
    params_template,
    relation_names: Optional[List[str]] = None,
    node_perms: Optional[Dict[int, np.ndarray]] = None,
) -> None:
    """Restore the latest checkpoint and write the npy artifact set."""
    ckpt = Checkpointer(checkpoint_dir)
    state = ckpt.restore_latest(
        template={"params": params_template}, partial=True
    )
    if state is None:
        raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
    params = state["params"]
    with torch.no_grad():
        embeddings = model.embeddings(params, device_graph, deterministic=True)
    export_ndarrays(
        params, embeddings, device_graph, out_dir,
        relation_names=relation_names, node_perms=node_perms,
    )


def main(argv=None) -> None:
    """Config-driven export: rebuild the dataset/model exactly as the
    training CLI does, then restore + dump."""
    config = Config.from_argv(argv)
    device = config.device()
    seed = int(config.get("Seed", 0))
    graph, protein_ids, drug_ids, relation_names = build_dataset(config)
    tg = training_graph(config, graph, protein_ids, drug_ids)
    device_graph = build_training_device_graph(config, tg, device)
    model = DecagonModel(config.model_config(), device_graph)
    template = model.init_params(make_generator(seed, device), device_graph)
    # The reference's CheckpointToNdarrayWriter writes to NpSaveDir;
    # fall back to the logger's NdarrayWriteDir.
    out_dir = config.get(
        "NpSaveDir", config.get("NdarrayWriteDir", "ndarray-dump")
    )
    export_from_checkpoint(
        model,
        device_graph,
        config.get("CheckpointDirectory", "ckpts"),
        out_dir,
        template,
        relation_names=relation_names,
        node_perms=tg.node_perms,
    )
    print(f"exported artifacts -> {out_dir}")


if __name__ == "__main__":
    main()
