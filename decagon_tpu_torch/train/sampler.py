"""Host-side minibatch scheduler over relation edge lists.

A numpy copy of ``decagon_tpu/train/sampler.py`` (``Minibatch``,
``MinibatchScheduler``): the same seed gives the same batches, in the same
order, on both schedules.

``schedule="reference"`` is the reference's cycle (``decagon/deep/
minibatch.py:255-345``): iteration ``t % 4`` runs gene-gene (0,0,0),
gene-drug (0,1,0), drug-gene (1,0,0), then a random free (drug-drug)
relation (period 3 without (1,0,0)); fixed types recycle their batches,
free relations retire when exhausted, and the epoch ends when the free pool
is empty.  Batches are fixed-size slices; a relation with fewer than
``batch_size`` train edges emits one wrap-padded batch per slot.

``schedule="balanced"``: one epoch is every relation's batches exactly
once (full batches plus one wrap-padded tail), in one random interleave.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from decagon_tpu_torch.graph.container import RelationGraph, RelationKey
from decagon_tpu_torch.graph.split import EdgeSplit


@dataclasses.dataclass
class Minibatch:
    edge_type: Tuple[int, int]
    k: int
    global_idx: int
    rows: np.ndarray  # [B] int32
    cols: np.ndarray  # [B] int32


class MinibatchScheduler:
    FIXED_KEYS: Tuple[RelationKey, ...] = ((0, 0, 0), (0, 1, 0), (1, 0, 0))

    def __init__(
        self,
        graph: RelationGraph,
        splits: Dict[RelationKey, EdgeSplit],
        batch_size: int = 512,
        seed: int = 123,
        schedule: str = "reference",
    ):
        if schedule not in ("reference", "balanced"):
            raise ValueError(f"unknown schedule {schedule!r}")
        self.schedule = schedule
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.keys: List[RelationKey] = list(graph.relation_keys())
        self.key_to_idx = {key: idx for idx, key in enumerate(self.keys)}
        self.train_edges: Dict[RelationKey, np.ndarray] = {
            key: splits[key].train.copy() for key in self.keys
        }
        self.fixed_idxs = [
            self.key_to_idx[key]
            for key in self.FIXED_KEYS
            if key in self.key_to_idx
        ]
        self.mod = 4 if (1, 0, 0) in self.key_to_idx else 3
        self._cursor = np.zeros(len(self.keys), dtype=np.int64)
        self._free: List[int] = []
        self._iter = 0

    def epoch(self) -> Iterator[Minibatch]:
        """Shuffle and yield minibatches until the free pool drains."""
        if self.schedule == "balanced":
            yield from self._epoch_balanced()
            return
        self.shuffle()
        while True:
            batch = self._next()
            if batch is None:
                return
            yield batch

    def _epoch_balanced(self) -> Iterator[Minibatch]:
        """One epoch = EVERY relation's train edges at least once, in
        fixed-size batches, globally shuffled: full batches plus one
        wrap-padded tail batch when ``n % batch_size != 0`` (tiny
        relations reduce to a single wrap-padded batch, as in the
        reference schedule).  Wrap padding revisits a few head edges
        rather than dropping the tail (ADVICE r4)."""
        slots: List[Tuple[int, np.ndarray]] = []
        for idx, key in enumerate(self.keys):
            perm = self.rng.permutation(self.train_edges[key].shape[0])
            edges = self.train_edges[key][perm]
            self.train_edges[key] = edges
            n = edges.shape[0]
            if n == 0:
                continue
            if n < self.batch_size:
                reps = -(-self.batch_size // n)
                slots.append(
                    (idx, np.tile(edges, (reps, 1))[: self.batch_size])
                )
                continue
            full_end = (n // self.batch_size) * self.batch_size
            for start in range(0, full_end, self.batch_size):
                slots.append((idx, edges[start : start + self.batch_size]))
            if full_end < n:
                tail = np.concatenate(
                    [edges[full_end:], edges[: self.batch_size - (n - full_end)]]
                )
                slots.append((idx, tail))
        order = self.rng.permutation(len(slots))
        for slot in order:
            idx, batch = slots[slot]
            key = self.keys[idx]
            yield Minibatch(
                edge_type=key[:2],
                k=key[2],
                global_idx=idx,
                rows=np.ascontiguousarray(batch[:, 0], dtype=np.int32),
                cols=np.ascontiguousarray(batch[:, 1], dtype=np.int32),
            )

    def shuffle(self) -> None:
        for key in self.keys:
            perm = self.rng.permutation(self.train_edges[key].shape[0])
            self.train_edges[key] = self.train_edges[key][perm]
        self._cursor[:] = 0
        self._free = [
            idx for idx in range(len(self.keys)) if idx not in self.fixed_idxs
        ]
        self._iter = 0

    def num_batches_per_epoch(self) -> int:
        """Epoch length: EXACT for the balanced schedule, approximate
        for the reference schedule (whose free-pool draining depends on
        the random interleave).

        Relations with 0 < n < batch_size emit one wrap-padded batch per
        epoch (see ``_next``), so they count as 1 here."""
        if self.schedule == "balanced":
            return sum(
                -(-n // self.batch_size) if n else 0
                for n in (
                    self.train_edges[key].shape[0] for key in self.keys
                )
            )
        free = sum(
            max(n // self.batch_size, 1 if n else 0)
            for n in (
                self.train_edges[self.keys[idx]].shape[0]
                for idx in range(len(self.keys))
                if idx not in self.fixed_idxs
            )
        )
        # Fixed types interleave 1:1:1:(free) or 1:1:(free).
        return free * self.mod // max(1, self.mod - len(self.fixed_idxs))

    def _next(self) -> Optional[Minibatch]:
        while True:
            phase = self._iter % self.mod
            if phase < len(self.fixed_idxs):
                idx = self.fixed_idxs[phase]
                is_fixed = True
            else:
                if not self._free:
                    return None
                idx = int(self.rng.choice(self._free))
                is_fixed = False

            key = self.keys[idx]
            edges = self.train_edges[key]
            n = edges.shape[0]
            start = self._cursor[idx] * self.batch_size
            if start <= n - self.batch_size:
                self._cursor[idx] += 1
                batch = edges[start : start + self.batch_size]
                break
            if 0 < n < self.batch_size:
                # Relation smaller than one batch: emit ONE wrap-padded
                # fixed-size batch (else it would never train — the
                # reference fed it as a small dynamic batch,
                # minibatch.py:300-301).
                reps = -(-self.batch_size // n)  # ceil
                batch = np.tile(edges, (reps, 1))[: self.batch_size]
                if is_fixed:
                    self._cursor[idx] = 0
                else:
                    self._free.remove(idx)
                break
            if is_fixed:
                self._cursor[idx] = 0
                if n == 0:
                    # Empty fixed relation: skip its slot (the reference
                    # would spin forever here).
                    self._iter += 1
            else:
                self._free.remove(idx)
            if not self._free:
                return None

        self._iter += 1
        return Minibatch(
            edge_type=key[:2],
            k=key[2],
            global_idx=self.key_to_idx[key],
            rows=np.ascontiguousarray(batch[:, 0], dtype=np.int32),
            cols=np.ascontiguousarray(batch[:, 1], dtype=np.int32),
        )
