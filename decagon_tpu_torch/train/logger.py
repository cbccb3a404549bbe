"""Metrics logging: per-iteration CSV and stdout, with checkpoint and
export hooks.

Port of ``decagon_tpu/train/logger.py`` (reference
``main/Logger/DecagonLogger.py``): auto-indexed
``decagon_iteration_results_%d.csv`` files with the columns
``DataSetId,Epoch,IterationNum,Loss,Latency,EvaluateAll,EdgeType,AUROC,
AUPRC,APK``, every-N gating composed with the checkpointer's gate, a
forced epoch-end row with the pooled drug-drug evaluation, and the npy
export on checkpoint (``train/checkpoint.export_ndarrays``).  In a
multi-process run every rank runs the hooks (the evaluation, the state
gather and the embedding are collectives on a mesh) and only rank 0 writes
the CSV, prints its rows and writes the export.
"""

from __future__ import annotations

import csv
import os
from pathlib import Path
from typing import List, Optional

from decagon_tpu_torch.graph.container import RelationKey
from decagon_tpu_torch.parallel.mesh import process_rank
from decagon_tpu_torch.train.checkpoint import Checkpointer, export_ndarrays
from decagon_tpu_torch.train.evaluate import AccuracyEvaluator, AccuracyScores
from decagon_tpu_torch.train.trainer import IterationResult, Trainer

LOG_FILE_FORMAT = "decagon_iteration_results_%d.csv"
FIELDS = [
    "DataSetId",
    "Epoch",
    "IterationNum",
    "Loss",
    "Latency",
    "EvaluateAll",
    "EdgeType",
    "AUROC",
    "AUPRC",
    "APK",
]


def _next_log_path(base_dir: str) -> str:
    Path(base_dir).mkdir(parents=True, exist_ok=True)
    prefix, suffix = LOG_FILE_FORMAT.split("%d")
    indices = []
    for fname in os.listdir(base_dir):
        if fname.startswith(prefix) and fname.endswith(suffix):
            middle = fname[len(prefix) : len(fname) - len(suffix)]
            if middle.isdigit():
                indices.append(int(middle))
    idx = max(indices) + 1 if indices else 0
    return os.path.join(base_dir, LOG_FILE_FORMAT % idx)


class MetricsLogger:
    """Attach via Trainer hooks; owns the CSV file and eval cadence."""

    def __init__(
        self,
        evaluator: AccuracyEvaluator,
        result_dir: str,
        dataset_id: str = "dataset",
        every_n_iterations: int = 1,
        eval_relation: RelationKey = (1, 1, 0),
        checkpointer: Optional[Checkpointer] = None,
        ndarray_dir: Optional[str] = None,
        relation_names: Optional[List[str]] = None,
        quiet: bool = False,
        node_perms=None,
    ):
        """``node_perms``: the ``{type: old_of_new}`` permutations of a
        renumbered graph (``graph.renumber.renumber_by_degree``), so that
        the npy export writes embeddings in external row order."""
        self.evaluator = evaluator
        self.node_perms = node_perms
        self.dataset_id = dataset_id
        self.every_n = max(1, every_n_iterations)
        self.eval_relation = eval_relation
        self.checkpointer = checkpointer
        self.ndarray_dir = ndarray_dir
        self.relation_names = relation_names
        self.quiet = quiet
        self.iterations_done = 0
        self.writes = process_rank() == 0
        self.path = self._file = None
        if self.writes:
            self.path = _next_log_path(result_dir)
            self._file = open(self.path, "w", newline="")
            self._writer = csv.DictWriter(self._file, fieldnames=FIELDS)
            self._writer.writeheader()

    # ---- Trainer hooks ---------------------------------------------------

    def on_iteration(self, trainer: Trainer, result: IterationResult) -> None:
        self.iterations_done += 1
        if self.checkpointer is not None:
            self.checkpointer.increment_iterations()
        if self.iterations_done % self.every_n == 0:
            scores = self.evaluator.evaluate(
                trainer.params, trainer.device_graph, self.eval_relation
            )
            self._write(result, scores, evaluate_all=False)
        if self.checkpointer is not None and self.checkpointer.should_checkpoint:
            self._checkpoint(trainer)

    def on_epoch_end(self, trainer: Trainer, epoch: int) -> None:
        scores = self.evaluator.evaluate_all_drug_drug(
            trainer.params, trainer.device_graph
        )
        result = IterationResult(
            epoch=epoch,
            iteration=self.iterations_done,
            loss=float("nan"),
            latency=0.0,
            edge_type=(-1, -1, -1),
        )
        self._write(result, scores, evaluate_all=True)
        if self.checkpointer is not None:
            self._checkpoint(trainer)

    # ---- internals --------------------------------------------------------

    def _checkpoint(self, trainer: Trainer) -> None:
        self.checkpointer.save(trainer.global_step, trainer.state_dict())
        if self.ndarray_dir is not None:
            embeddings = trainer.eval_embeddings()
            if not self.writes:
                return
            export_ndarrays(
                trainer.params,
                embeddings,
                trainer.device_graph,
                self.ndarray_dir,
                relation_names=self.relation_names,
                node_perms=self.node_perms,
            )

    def _write(
        self,
        result: IterationResult,
        scores: AccuracyScores,
        evaluate_all: bool,
    ) -> None:
        if not self.writes:
            return
        row = {
            "DataSetId": self.dataset_id,
            "Epoch": result.epoch,
            "IterationNum": result.iteration,
            "Loss": result.loss,
            "Latency": result.latency,
            "EvaluateAll": evaluate_all,
            "EdgeType": result.edge_type,
            "AUROC": scores.auroc,
            "AUPRC": scores.auprc,
            "APK": scores.apk,
        }
        self._writer.writerow(row)
        self._file.flush()
        if not self.quiet:
            print(
                f"[{self.dataset_id}] epoch {result.epoch} "
                f"iter {result.iteration} loss {result.loss:.5f} "
                f"latency {result.latency:.4f}s edge {result.edge_type} "
                f"AUROC {scores.auroc:.5f} AUPRC {scores.auprc:.5f} "
                f"APK {scores.apk:.5f} all={evaluate_all}"
            )

    def close(self) -> None:
        if self._file is not None and not self._file.closed:
            self._file.close()

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass
