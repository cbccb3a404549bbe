"""The training loop: epochs over the minibatch scheduler.

Port of ``decagon_tpu/train/trainer.py`` without its mesh branch (reference
``BaseDecagonTrainer``, ``main/Trainer/DecagonTrainer.py:44-102``): per
epoch, shuffle, iterate minibatches, one optimization step per batch (or
per group of ``relation_group`` batches), iteration and epoch hooks.  With
``scan_chunk > 0`` the steps run in chunks (``make_chunked_train_step`` /
``make_grouped_chunked_train_step``), which wait for the device only when a
hook reads the losses.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from decagon_tpu_torch.graph.container import RelationGraph, RelationKey
from decagon_tpu_torch.graph.device import DeviceGraph
from decagon_tpu_torch.graph.split import EdgeSplit
from decagon_tpu_torch.models.model import DecagonModel
from decagon_tpu_torch.train.sampler import Minibatch, MinibatchScheduler
from decagon_tpu_torch.train.step import (
    TrainConfig,
    fold_in,
    make_chunked_train_step,
    make_generator,
    make_grouped_chunked_train_step,
    make_train_steps,
    step_generator,
)


@dataclasses.dataclass
class IterationResult:
    """Per-iteration record (reference
    ``Dtos/Decagon/DecagonTrainingIterationResults.py:3-12``)."""

    epoch: int
    iteration: int
    loss: float
    latency: float
    edge_type: RelationKey


class Trainer:
    def __init__(
        self,
        model: DecagonModel,
        graph: RelationGraph,
        splits: Dict[RelationKey, EdgeSplit],
        device_graph: DeviceGraph,
        config: TrainConfig,
        seed: int = 0,
        iteration_hook: Optional[Callable[["Trainer", IterationResult], None]] = None,
        epoch_hook: Optional[Callable[["Trainer", int], None]] = None,
        mesh=None,
        init_state: Optional[Dict] = None,
    ):
        """Trains ``model`` on ``device_graph``'s device.  ``seed`` seeds
        the scheduler, the initial weights (drawn on a CPU generator, so
        every device gets the same ones) and the per-step generators.
        ``init_state``: an existing ``state_dict()`` to start from (its
        tensors are used as they are: pass a copy to keep the original,
        since ``pallas_adam`` updates leaves in place).  ``mesh`` is not
        ported and raises."""
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...) is not ported yet (ROADMAP queue 1, item 6: "
                "mesh parallelism on torch.distributed)"
            )
        self.model = model
        self.graph = graph
        self.splits = splits
        self.config = config
        self.group = max(1, config.relation_group)
        if self.group > 1 and config.scan_chunk <= 0:
            raise ValueError("relation_group > 1 requires scan_chunk > 0")
        self.scheduler = MinibatchScheduler(
            graph, splits, batch_size=config.batch_size, seed=seed,
            schedule=config.schedule,
        )
        self.device_graph = device_graph
        self.steps, self.optimizer = make_train_steps(model, device_graph, config)
        self.step_seed = fold_in(seed, 1)
        if init_state is not None:
            self.params = init_state["params"]
            self.opt_state = init_state["opt_state"]
            self.global_step = int(init_state.get("global_step", 0))
            self.opt_step = int(init_state.get("opt_step", self.global_step // self.group))
        else:
            self.params = model.init_params(
                make_generator(fold_in(seed, 0), "cpu"), device_graph
            )
            self.opt_state = self.optimizer.init(self.params)
            self.global_step = 0
            # Optimization steps, apart from batches: a grouped slot of G
            # batches takes one step number, so global_step // G would
            # repeat one whenever an epoch's batch count is not a multiple
            # of G.
            self.opt_step = 0
        self.iteration_hook = iteration_hook
        self.epoch_hook = epoch_hook
        self._chunk_fn = None
        self._branch_idx = {et: i for i, et in enumerate(device_graph.edge_types)}

    def eval_embeddings(self) -> Dict[str, torch.Tensor]:
        """Deterministic full-graph node tables for evaluation and export."""
        with torch.no_grad():
            return self.model.embeddings(self.params, self.device_graph)

    # ---- checkpoint state ---------------------------------------------

    def state_dict(self) -> Dict:
        """The training state: params, optimizer state and step counters.
        The tensors are the live ones, not copies."""
        return {
            "params": self.params,
            "opt_state": self.opt_state,
            "global_step": self.global_step,
            "opt_step": self.opt_step,
        }

    def load_state_dict(self, state: Dict) -> None:
        self.params = state["params"]
        self.opt_state = state["opt_state"]
        self.global_step = int(state["global_step"])
        self.opt_step = int(state.get("opt_step", self.global_step // self.group))

    def try_resume(self, checkpointer) -> bool:
        """Restore the latest checkpoint if one exists; returns whether a
        restore happened."""
        state = checkpointer.restore_latest(template=self.state_dict())
        if state is None:
            return False
        self.load_state_dict(state)
        return True

    def _device_index(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device_graph.device)

    def train_batch(self, batch: Minibatch) -> torch.Tensor:
        """One optimization step on one batch; returns the loss as a
        device tensor (reading it waits for the step)."""
        step_fn = self.steps[batch.edge_type]
        self.params, self.opt_state, loss = step_fn(
            self.params, self.opt_state, self.device_graph, int(batch.k),
            self._device_index(batch.rows), self._device_index(batch.cols),
            step_generator(self.step_seed, self.global_step, self.device_graph.device),
        )
        self.global_step += 1
        self.opt_step += 1
        return loss

    def train_chunk(self, batches: list, chunk_size: int) -> torch.Tensor:
        """Up to ``chunk_size`` optimization steps (of ``relation_group``
        batches each) in one call; a short chunk is padded with skipped
        steps.  Returns the per-step losses as a device tensor, without
        waiting for the device.  The losses equal ``train_batch``'s over
        the same batches (same per-step generators)."""
        if self._chunk_fn is None:
            make = make_grouped_chunked_train_step if self.group > 1 else make_chunked_train_step
            self._chunk_fn = make(self.model, self.device_graph, self.config, self.optimizer)
        n = len(batches)
        g = self.group
        assert 0 < n <= chunk_size * g
        b = self.config.batch_size
        if g > 1:
            branch = np.zeros((chunk_size, g), np.int32)
            ks = np.zeros((chunk_size, g), np.int32)
            rows = np.zeros((chunk_size, g, b), np.int32)
            cols = np.zeros((chunk_size, g, b), np.int32)
            valid = np.zeros((chunk_size, g), bool)
            for j, batch in enumerate(batches):
                s, gg = divmod(j, g)
                branch[s, gg] = self._branch_idx[batch.edge_type]
                ks[s, gg] = batch.k
                rows[s, gg] = batch.rows
                cols[s, gg] = batch.cols
                valid[s, gg] = True
            # Slot generators count optimization steps (global_step counts
            # batches).
            step_no = self.opt_step + np.arange(chunk_size)
            steps = -(-n // g)
        else:
            branch = np.zeros(chunk_size, np.int32)
            ks = np.zeros(chunk_size, np.int32)
            rows = np.zeros((chunk_size, b), np.int32)
            cols = np.zeros((chunk_size, b), np.int32)
            valid = np.zeros(chunk_size, bool)
            for j, batch in enumerate(batches):
                branch[j] = self._branch_idx[batch.edge_type]
                ks[j] = batch.k
                rows[j] = batch.rows
                cols[j] = batch.cols
                valid[j] = True
            step_no = self.global_step + np.arange(chunk_size)
            steps = n
        self.params, self.opt_state, losses = self._chunk_fn(
            self.params, self.opt_state, self.device_graph, self.step_seed,
            branch, ks, self._device_index(rows), self._device_index(cols),
            step_no, valid,
        )
        self.global_step += n
        self.opt_step += steps
        return losses[:steps]

    def _train_epoch_scanned(self, epoch: int, chunk_size: int) -> None:
        batches = list(self.scheduler.epoch())
        per_call = chunk_size * self.group
        iteration = 0
        for i in range(0, len(batches), per_call):
            group = batches[i : i + per_call]
            start = time.perf_counter()
            losses = self.train_chunk(group, chunk_size)
            if self.iteration_hook is None:
                # Reading the losses waits for the device; nobody listens.
                continue
            losses = losses.cpu().numpy()
            latency = (time.perf_counter() - start) / len(group)
            if self.group > 1:
                # One loss per optimization step (slot of G batches),
                # reported against the slot's first batch.
                for s, loss in enumerate(losses):
                    batch = group[s * self.group]
                    self.iteration_hook(self, IterationResult(
                        epoch=epoch, iteration=iteration, loss=float(loss),
                        latency=latency * self.group,
                        edge_type=(*batch.edge_type, batch.k),
                    ))
                    iteration += 1
                continue
            for batch, loss in zip(group, losses):
                self.iteration_hook(self, IterationResult(
                    epoch=epoch, iteration=iteration, loss=float(loss),
                    latency=latency, edge_type=(*batch.edge_type, batch.k),
                ))
                iteration += 1

    def train(self, num_epochs: Optional[int] = None) -> None:
        epochs = num_epochs or self.config.num_epochs
        for epoch in range(epochs):
            if self.config.scan_chunk > 0:
                self._train_epoch_scanned(epoch, self.config.scan_chunk)
            else:
                iteration = 0
                for batch in self.scheduler.epoch():
                    start = time.perf_counter()
                    loss = self.train_batch(batch)
                    if self.iteration_hook is not None:
                        # Wait for an honest latency only when someone
                        # listens.
                        loss = float(loss)
                        self.iteration_hook(self, IterationResult(
                            epoch=epoch, iteration=iteration, loss=loss,
                            latency=time.perf_counter() - start,
                            edge_type=(*batch.edge_type, batch.k),
                        ))
                    iteration += 1
            if self.epoch_hook is not None:
                self.epoch_hook(self, epoch)
