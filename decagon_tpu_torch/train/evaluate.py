"""Accuracy evaluation: AUROC / AUPRC / AP@k over held-out edges.

Port of ``decagon_tpu/train/evaluate.py``.  Parity spec: reference
``DecagonAccuracyEvaluator``
(``main/AccuracyEvaluators/Tensorflow/DecagonAccuracyEvaluator.py``) and
legacy ``get_accuracy_scores`` (``main.py:44-90``): sigmoid scores on
held-out positive and sampled-negative edges; AUROC, AUPRC (average
precision) and AP@k over the ranked scores
(``decagon/utility/rank_metrics.py:4-40``).  The rank metrics are numpy
and equal to the JAX package's; scores come from the sampled-edge scorer,
never from a dense N x N ``predictions`` matrix.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from decagon_tpu_torch import DeviceLike, resolve_device
from decagon_tpu_torch.graph.container import RelationGraph, RelationKey
from decagon_tpu_torch.graph.device import DeviceGraph
from decagon_tpu_torch.graph.split import EdgeSplit
from decagon_tpu_torch.models.model import DecagonModel
from decagon_tpu_torch.train.step import make_embed_fn, make_emb_scores


@dataclasses.dataclass
class AccuracyScores:
    auroc: float
    auprc: float
    apk: float


def average_precision_at_k(
    actual: Sequence[int], predicted: Sequence[int], k: int = 10
) -> float:
    """AP@k (reference ``rank_metrics.py:4-40`` semantics)."""
    if len(predicted) > k:
        predicted = predicted[:k]
    if not actual:
        return 0.0
    # a range is O(1) membership — callers pass range(n_pos) for the
    # pooled eval so no 10^6-element set/list ever materializes
    actual_set = actual if isinstance(actual, range) else set(actual)
    seen = set()
    score = 0.0
    hits = 0.0
    for i, p in enumerate(predicted):
        if p in actual_set and p not in seen:
            hits += 1.0
            score += hits / (i + 1.0)
        seen.add(p)
    return score / min(len(actual), k)


def mean_average_precision_at_k(
    actual: Sequence[Sequence[int]],
    predicted: Sequence[Sequence[int]],
    k: int = 10,
) -> float:
    """Mean AP@k over queries (reference ``rank_metrics.py:43-67``)."""
    if not actual:
        return 0.0
    return float(
        np.mean(
            [
                average_precision_at_k(a, p, k)
                for a, p in zip(actual, predicted)
            ]
        )
    )


def fast_auroc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Rank-statistic AUROC (Mann-Whitney U with average tie ranks) in one
    vectorized pass; equal to sklearn's ``roc_auc_score`` to float
    precision."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels)
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    _, inv, counts = np.unique(
        scores, return_inverse=True, return_counts=True
    )
    cum = np.cumsum(counts)
    avg_rank = (cum - counts + 1 + cum) / 2.0  # 1-based average ranks
    ranks = avg_rank[inv]
    u = ranks[labels > 0].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def fast_average_precision(
    labels: np.ndarray, scores: np.ndarray
) -> float:
    """Step-wise average precision, vectorized; matches sklearn's
    ``average_precision_score`` (AP = sum_n (R_n - R_{n-1}) P_n over
    distinct-score thresholds) to float precision."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels, np.float64)
    order = np.argsort(-scores, kind="mergesort")
    s = scores[order]
    y = labels[order]
    tp = np.cumsum(y)
    n_pos = tp[-1] if tp.size else 0.0
    if n_pos == 0:
        return float("nan")
    # threshold group boundaries: last index of each distinct score
    boundary = np.nonzero(np.diff(s))[0]
    idx = np.concatenate([boundary, [s.size - 1]])
    tps = tp[idx]
    precision = tps / (idx + 1.0)
    recall = tps / n_pos
    return float(
        np.sum(np.diff(recall, prepend=0.0) * precision)
    )


def pooled_rank_metrics(
    labels: np.ndarray, scores: np.ndarray
) -> Tuple[float, float]:
    """(AUROC, average precision) off ONE descending sort.

    Same math as ``fast_auroc`` / ``fast_average_precision`` (average
    tie ranks; step-wise AP over distinct thresholds — both
    sklearn-parity-tested) but sharing the single mergesort that
    dominates the pooled-eval host cost; accumulation in float64."""
    scores = np.asarray(scores, np.float32)
    labels = np.asarray(labels, np.float64)
    n = scores.size
    # unstable sort: tie ORDER is irrelevant here (both metrics group
    # ties), and introsort is ~2x mergesort at this size
    order = np.argsort(-scores)
    s = scores[order]
    tp = np.cumsum(labels[order], dtype=np.float64)
    n_pos = float(tp[-1]) if n else 0.0
    n_neg = n - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan"), float("nan")
    boundary = np.nonzero(np.diff(s))[0]
    idx = np.concatenate([boundary, [n - 1]])
    tps = tp[idx]
    precision = tps / (idx + 1.0)
    recall = tps / n_pos
    ap = float(np.sum(np.diff(recall, prepend=0.0) * precision))
    # average ASCENDING 1-based rank of each tie group, from its span
    # in the descending order: group [start..end] -> n - (start+end)/2
    starts = np.concatenate([[0], idx[:-1] + 1])
    avg_rank = n - (starts + idx) / 2.0
    group_pos = np.diff(np.concatenate([[0.0], tps]))
    pos_rank_sum = float(np.sum(avg_rank * group_pos))
    auroc = (pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
    return float(auroc), ap


def compute_scores(
    probs_pos: np.ndarray, probs_neg: np.ndarray, apk_k: int = 50
) -> AccuracyScores:
    probs_all = np.nan_to_num(np.concatenate([probs_pos, probs_neg]))
    labels_all = np.concatenate(
        [np.ones(len(probs_pos)), np.zeros(len(probs_neg))]
    )
    auroc, auprc = pooled_rank_metrics(labels_all, probs_all)
    # AP@k consumes only the top-k ranks: argpartition + sort of k
    # elements instead of materializing a million-element Python list
    n = probs_all.size
    if n > apk_k:
        top = np.argpartition(-probs_all, apk_k)[:apk_k]
        predicted = top[np.argsort(-probs_all[top], kind="stable")].tolist()
    else:
        predicted = np.argsort(-probs_all, kind="stable").tolist()
    apk = average_precision_at_k(
        range(len(probs_pos)), predicted, k=apk_k
    )
    return AccuracyScores(auroc=auroc, auprc=auprc, apk=apk)


class AccuracyEvaluator:
    """Scores held-out edges with ONE encoder forward per evaluation.

    The encoder runs once (``make_embed_fn``); every relation's holdout
    edges are then scored through the per-edge-type scorer carrying a
    per-edge relation index (``make_emb_scores``), so
    ``evaluate_all_drug_drug`` over all drug-drug relations costs one
    full-graph forward plus one chunked scoring pass per polarity.
    """

    def __init__(
        self,
        model: DecagonModel,
        graph: RelationGraph,
        splits: Dict[RelationKey, EdgeSplit],
        apk_k: int = 50,
        pad_multiple: int = 512,
        embed_fn=None,
        score_chunk: int = 65536,
        device: DeviceLike = None,
    ):
        """``embed_fn``: optional ``(params, device_graph) -> embeddings``
        override (the JAX CLI passes its trainer's, which the mesh path
        needs); the default is the deterministic forward.
        ``pad_multiple``: kept for the JAX package's signature, which
        stores it unused: batches are scored in ``score_chunk`` chunks.
        ``device``: where the staged index tensors live — the device of
        the device graph and parameters (CUDA unless named)."""
        self.model = model
        self.splits = splits
        self.apk_k = apk_k
        self.pad_multiple = pad_multiple
        self.score_chunk = score_chunk
        self.device = resolve_device(device)
        self._embed = embed_fn if embed_fn is not None else make_embed_fn(model)
        # Padded (ks, rows, cols) per holdout set, staged on the device
        # once: the splits do not change between evaluations.
        self._staged: Dict = {}
        self._score_fns = {
            et: make_emb_scores(model, et, self.device) for et in graph.edge_types
        }
        self._drug_drug = max(
            (et for et in graph.edge_types if et[0] == et[1]),
            default=None,
        )

    def embeddings(self, params, device_graph: DeviceGraph):
        """One deterministic full-graph forward."""
        return self._embed(params, device_graph)

    def _stage(
        self,
        batches: List[Tuple[int, np.ndarray]],
        cache_key=None,
    ):
        """Chunked (ks, rows, cols, counts) for a batch list, staged on the
        device as ``[n_chunks, score_chunk]`` int32 tensors (cached under
        ``cache_key`` when given).  Padding entries index relation 0 and
        node 0; their scores are dropped."""
        if cache_key is not None and cache_key in self._staged:
            return self._staged[cache_key]
        chunk = self.score_chunk
        counts = [e.shape[0] for _, e in batches]
        total = sum(counts)
        n_chunks = max(1, -(-total // chunk))
        ks = np.zeros(n_chunks * chunk, dtype=np.int32)
        rows = np.zeros(n_chunks * chunk, dtype=np.int32)
        cols = np.zeros(n_chunks * chunk, dtype=np.int32)
        at = 0
        for k, edges in batches:
            n = edges.shape[0]
            if n:
                ks[at : at + n] = k
                rows[at : at + n] = edges[:, 0]
                cols[at : at + n] = edges[:, 1]
            at += n
        staged = tuple(
            torch.from_numpy(a.reshape(n_chunks, chunk)).to(self.device)
            for a in (ks, rows, cols)
        ) + (counts,)
        if cache_key is not None:
            self._staged[cache_key] = staged
        return staged

    def _probs_flat(
        self,
        params,
        embeddings,
        edge_type: Tuple[int, int],
        batches: List[Tuple[int, np.ndarray]],
        cache_key=None,
    ) -> List[np.ndarray]:
        """Score many relations' edge lists in one chunked pass.

        ``batches``: [(k, edges[N,2])]; returns per-entry prob arrays in
        the same order."""
        if sum(e.shape[0] for _, e in batches) == 0:
            return [np.empty((0,), np.float32) for _ in batches]
        ks, rows, cols, counts = self._stage(batches, cache_key)
        fn = self._score_fns[edge_type]
        probs = fn(params, embeddings, ks, rows, cols).reshape(-1).cpu().numpy()
        out = []
        at = 0
        for n in counts:
            out.append(probs[at : at + n])
            at += n
        return out

    def _probs(
        self,
        params,
        device_graph: DeviceGraph,
        key: RelationKey,
        edges: np.ndarray,
        embeddings=None,
    ) -> np.ndarray:
        """Probabilities of one relation's ``edges[N, 2]`` (one forward
        unless ``embeddings`` are given): the CLI's per-relation greedy
        scorer."""
        if edges.size == 0:
            return np.empty((0,), dtype=np.float32)
        if embeddings is None:
            embeddings = self._embed(params, device_graph)
        (probs,) = self._probs_flat(params, embeddings, key[:2], [(key[2], edges)])
        return probs

    def evaluate(
        self,
        params,
        device_graph: DeviceGraph,
        key: RelationKey,
        use_test: bool = False,
        embeddings=None,
    ) -> AccuracyScores:
        split = self.splits[key]
        pos = split.test if use_test else split.val
        neg = split.test_false if use_test else split.val_false
        if embeddings is None:
            embeddings = self._embed(params, device_graph)
        pos_p, neg_p = self._probs_flat(
            params, embeddings, key[:2], [(key[2], pos), (key[2], neg)],
            cache_key=("one", key, bool(use_test)),
        )
        return compute_scores(pos_p, neg_p, apk_k=self.apk_k)

    def evaluate_all_drug_drug(
        self,
        params,
        device_graph: DeviceGraph,
        use_test: bool = False,
        embeddings=None,
    ) -> AccuracyScores:
        """Pooled scores over every drug-drug relation (reference
        ``evaluateAll``, ``DecagonAccuracyEvaluator.py:57-91``)."""
        if self._drug_drug is None:
            raise ValueError("graph has no square drug-drug edge type")
        if embeddings is None:
            embeddings = self._embed(params, device_graph)
        i, j = self._drug_drug
        pos_batches: List[Tuple[int, np.ndarray]] = []
        neg_batches: List[Tuple[int, np.ndarray]] = []
        for key, split in self.splits.items():
            if key[:2] != (i, j):
                continue
            pos_batches.append(
                (key[2], split.test if use_test else split.val)
            )
            neg_batches.append(
                (key[2], split.test_false if use_test else split.val_false)
            )
        pos_parts = self._probs_flat(
            params, embeddings, (i, j), pos_batches,
            cache_key=("all", (i, j), bool(use_test), "pos"),
        )
        neg_parts = self._probs_flat(
            params, embeddings, (i, j), neg_batches,
            cache_key=("all", (i, j), bool(use_test), "neg"),
        )
        return compute_scores(
            np.concatenate(pos_parts) if pos_parts else np.empty(0),
            np.concatenate(neg_parts) if neg_parts else np.empty(0),
            apk_k=self.apk_k,
        )
