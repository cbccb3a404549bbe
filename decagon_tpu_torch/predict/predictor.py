"""Offline numpy predictor over exported checkpoint artifacts.

Parity spec: reference ``main/Predictor/NpPredictor.py`` — a pure-numpy
scoring service over the npy dumps (``embeddings.npy``,
``EmbeddingImportance-<SE>.npy``, ``GlobalRelations.npy``) and the
recorded held-out-edge CSV (``FromNode,ToNode,RelationId,Label`` in
STITCH format): scores ``sigmoid(E D G D E^T)`` on the relation's
held-out edges, returns AUROC/AUPRC/confusion, and supports swapping in
an externally-learned importance matrix — the downstream-research hook
(``NpPredictorExample/ExampleRunner.py:20-48``).
``TrainingEdgeIterator`` exposes the complement (all cells minus the
held-out ones) with labels, raw or as stacked embedding tensors.

Divergences from the reference (bit-rot not reproduced): scoring
computes only the sampled entries via gathers instead of materializing
the dense N x N probability matrix; the per-module global singleton +
lock is replaced by an explicit ``PredictionsInfo`` object.

Port of ``decagon_tpu/predict/predictor.py`` without scikit-learn: AUROC
and AUPRC come from ``train/evaluate.fast_auroc`` and
``fast_average_precision`` (equal to sklearn's to float precision), the
confusion matrix from numpy.  pandas stays an optional import of
``get_train_edges_as_dataframe``.
"""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from decagon_tpu_torch.graph.ids import DrugId
from decagon_tpu_torch.train.evaluate import fast_auroc, fast_average_precision


@dataclasses.dataclass
class PredictionResult:
    """Reference ``Dtos/PredictionsInformation.py:3-27``."""

    probabilities: np.ndarray
    labels: np.ndarray
    auroc: float
    auprc: float
    confusion_matrix: np.ndarray


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def confusion_matrix(labels: np.ndarray, predicted: np.ndarray) -> np.ndarray:
    """Counts ``[i, j]`` of samples with label ``classes[i]`` predicted as
    ``classes[j]``, ``classes`` the sorted values present in either array
    (sklearn's ``confusion_matrix`` without weights or a label list)."""
    classes = np.union1d(labels, predicted)
    n = classes.size
    index = np.searchsorted(classes, labels) * n + np.searchsorted(classes, predicted)
    return np.bincount(index, minlength=n * n).reshape(n, n)


class PredictionsInfo:
    """Loads the artifact set once: embeddings, global interaction,
    held-out edge dict (from the recorded CSV), train-edge complement.

    ``graph``: optional ``RelationGraph`` of the same dataset — when
    given, ``train_edges`` labels the all-pairs-minus-heldout complement
    from the drug-drug adjacencies exactly as the reference does (it
    rebuilds the matrices via its AdjacencyMatricesBuilder,
    ``NpPredictor.py:97-141``)."""

    def __init__(
        self,
        artifact_dir: str,
        test_edge_csv: str,
        drug_ids: Sequence[int],
        graph=None,
    ):
        root = Path(artifact_dir)
        self.artifact_dir = root
        self.embeddings = np.load(root / "embeddings.npy")
        self.global_interaction = np.load(root / "GlobalRelations.npy")
        self.drug_id_to_idx = {
            DrugId(d).to_external(): idx for idx, d in enumerate(drug_ids)
        }
        self.num_drugs = len(drug_ids)
        self.test_edges = self._read_test_edges(test_edge_csv)
        self._adjacencies: Dict[str, np.ndarray] = {}
        if graph is not None:
            dd = max(et for et in graph.relations if et[0] == et[1])
            for rel in graph.relations[dd]:
                if rel.transpose_of is None:
                    self._adjacencies[rel.name] = (rel.rows, rel.cols)

    def _read_test_edges(self, path: str) -> Dict[str, np.ndarray]:
        result: Dict[str, List[np.ndarray]] = {}
        with open(path) as f:
            for row in csv.DictReader(f):
                if not (
                    row["FromNode"].startswith("CID")
                    and row["ToNode"].startswith("CID")
                ):
                    continue
                try:
                    from_idx = self.drug_id_to_idx[row["FromNode"]]
                    to_idx = self.drug_id_to_idx[row["ToNode"]]
                except KeyError:
                    continue
                result.setdefault(row["RelationId"], []).append(
                    np.array([from_idx, to_idx, int(row["Label"])])
                )
        return {
            rel: np.stack(rows).astype(np.int64)
            for rel, rows in result.items()
        }

    def importance_matrix(self, relation_id: str) -> np.ndarray:
        return np.load(
            self.artifact_dir / f"EmbeddingImportance-{relation_id}.npy"
        )

    def train_edges(self, relation_id: str) -> np.ndarray:
        """All-cells-minus-heldout with 0/1 labels [M, 3] (reference
        ``_buildTrainEdgeDict``, ``NpPredictor.py:97-141``).

        Labels come from the dataset's drug-drug adjacency — construct
        ``PredictionsInfo`` with ``graph=`` (or use
        ``train_edges_with_adjacency`` to supply one relation directly).
        """
        if relation_id not in self._adjacencies:
            raise ValueError(
                f"no adjacency for relation {relation_id!r}: construct "
                "PredictionsInfo with graph=, or call "
                "train_edges_with_adjacency(relation_id, rows, cols)"
            )
        rows, cols = self._adjacencies[relation_id]
        return self.train_edges_with_adjacency(relation_id, rows, cols)

    def train_edges_with_adjacency(
        self, relation_id: str, adj_rows: np.ndarray, adj_cols: np.ndarray
    ) -> np.ndarray:
        n = self.num_drugs
        all_linear = np.arange(n * n, dtype=np.int64)
        held = self.test_edges.get(relation_id)
        if held is not None:
            held_linear = held[:, 0] * n + held[:, 1]
            train_linear = np.setdiff1d(all_linear, held_linear)
        else:
            train_linear = all_linear
        labels = np.zeros(n * n, dtype=np.int64)
        labels[np.asarray(adj_rows, np.int64) * n + np.asarray(adj_cols, np.int64)] = 1
        rows, cols = np.unravel_index(train_linear, (n, n))
        return np.stack([rows, cols, labels[train_linear]], axis=1)


class TrainingEdgeIterator:
    """Reference ``NpPredictor.py:156-212``."""

    def __init__(
        self,
        info: PredictionsInfo,
        relation_id: str,
        adj_rows: Optional[np.ndarray] = None,
        adj_cols: Optional[np.ndarray] = None,
    ):
        self.info = info
        self.relation_id = relation_id
        if adj_rows is None or adj_cols is None:
            self._edges = info.train_edges(relation_id)
        else:
            self._edges = info.train_edges_with_adjacency(
                relation_id, adj_rows, adj_cols
            )

    def get_train_edges(self) -> np.ndarray:
        return self._edges

    def get_train_edges_as_embeddings(self) -> np.ndarray:
        """``[M, d, d, 1]``: the row's embedding along ``[:, 0, :, 0]``, the
        column's along ``[:, :, 0, 0]``, the label at ``[:, 0, 0, 0]`` and
        zeros elsewhere (the JAX package leaves the rest uninitialised)."""
        raw = self._edges.astype(np.int32)
        emb = self.info.embeddings
        dim = emb.shape[1]
        out = np.zeros((raw.shape[0], dim, dim, 1))
        out[:, 0, :, 0] = emb[raw[:, 0]]
        out[:, :, 0, 0] = emb[raw[:, 1]]
        out[:, 0, 0, :] = raw[:, 2:3]
        return out

    def get_train_edges_as_dataframe(self):
        """Edges + labels as a pandas DataFrame (reference
        ``NpPredictor.py:156-212`` exposes the same tabular view)."""
        import pandas as pd

        return pd.DataFrame(
            self._edges, columns=["FromNode", "ToNode", "Label"]
        )


class NpPredictor:
    """Scores one relation's held-out edges from the artifact dumps."""

    def __init__(self, info: PredictionsInfo, relation_id: str):
        self.info = info
        self.relation_id = relation_id
        self.default_importance = info.importance_matrix(relation_id)
        edges = info.test_edges[relation_id]
        self.pos_edges = edges[edges[:, 2] == 1]
        self.neg_edges = edges[edges[:, 2] == 0]

    def predict(
        self, importance_matrix: Optional[np.ndarray] = None
    ) -> PredictionResult:
        imp = (
            self.default_importance
            if importance_matrix is None
            else importance_matrix
        )
        emb = self.info.embeddings
        # Sampled-entry scoring of E D G D E^T (no dense N x N matrix).
        left = emb @ imp @ self.info.global_interaction @ imp
        edges = np.vstack([self.neg_edges, self.pos_edges])
        logits = np.einsum(
            "bd,bd->b", left[edges[:, 0]], emb[edges[:, 1]]
        )
        probs = _sigmoid(logits)
        labels = edges[:, 2]
        return PredictionResult(
            probabilities=probs,
            labels=labels,
            auroc=fast_auroc(labels, probs),
            auprc=fast_average_precision(labels, probs),
            confusion_matrix=confusion_matrix(labels, np.round(probs)),
        )
