"""Offline-predictor workflow example.

Port of ``examples/np_predictor_example.py`` (reference
``NpPredictorExample/ExampleRunner.py:20-51``): train a model, export its
artifacts, then score a relation's held-out edges from the dumps alone —
including swapping in an externally-learned importance matrix (the
downstream-research hook).

    python -m decagon_tpu_torch.scripts.np_predictor_example [--device cpu]

The model trains on ``--device`` (CUDA unless named); the predictor is
numpy.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.data.record import write_heldout_edges_csv
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_synthetic_graph
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.predict.predictor import (
    NpPredictor,
    PredictionsInfo,
    TrainingEdgeIterator,
)
from decagon_tpu_torch.train.checkpoint import export_ndarrays
from decagon_tpu_torch.train.step import TrainConfig
from decagon_tpu_torch.train.trainer import Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. Train briefly on the dummy graph.
    graph = make_synthetic_graph(n_genes=200, n_drugs=100,
                                 n_drugdrug_types=2, seed=0)
    splits = split_graph(graph, val_frac=0.05, seed=1)
    dg = build_device_graph(graph, splits, device=device)
    model = DecagonModel(ModelConfig(hidden1=32, hidden2=16), dg)
    trainer = Trainer(model, graph, splits, dg,
                      TrainConfig(batch_size=128, scan_chunk=25), seed=0)
    trainer.train(num_epochs=2)

    with tempfile.TemporaryDirectory() as tmp:
        # 2. Export the artifact set + the held-out edge CSV.
        names = [f"C{k:07d}" for k in range(1, 5)]
        export_ndarrays(trainer.params, trainer.eval_embeddings(), dg, tmp,
                        relation_names=names)
        csv_path = write_heldout_edges_csv(
            graph, splits, os.path.join(tmp, "edges.csv"),
            relation_names=names,
        )

        # 3. Score from the dumps alone (no model, pure numpy).
        info = PredictionsInfo(tmp, csv_path,
                               list(range(graph.num_nodes[1])))
        predictor = NpPredictor(info, names[0])
        result = predictor.predict()
        print(f"default importance: AUROC={result.auroc:.3f} "
              f"AUPRC={result.auprc:.3f}")
        print(f"confusion:\n{result.confusion_matrix}")

        # 4. The research hook: swap in an external importance matrix.
        dim = info.embeddings.shape[1]
        custom = np.eye(dim, dtype=np.float32)
        result2 = predictor.predict(importance_matrix=custom)
        print(f"identity importance: AUROC={result2.auroc:.3f}")

        # 5. Iterate training edges (e.g. to fit that external matrix).
        rel = graph.relations[(1, 1)][0]
        it = TrainingEdgeIterator(info, names[0], rel.rows, rel.cols)
        edges = it.get_train_edges()
        stacked = it.get_train_edges_as_embeddings()
        print(f"train edges: {edges.shape}, stacked: {stacked.shape}")


if __name__ == "__main__":
    main()
