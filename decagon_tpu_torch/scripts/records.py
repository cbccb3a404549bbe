"""What the ported profilers and quality runs share: the card's fields of a
record, peak memory and the kernels' launch counts over a window.

Every record names the card it was taken on (``nvidia-smi``'s name and
power limit, the torch version) and, for each timed window, how many times
each hand-written kernel launched (``ops/cuda_build.LAUNCHES``), so a
reader knows which kernels a number went through.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import torch

from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.timing import hard_sync


def device_name(device: torch.device) -> str:
    """The card's ``nvidia-smi`` name and power limit, or the device's name
    off the card."""
    if device.type != "cuda":
        return str(device)
    from decagon_tpu_torch.scripts.probing import card

    return card()


def card_fields(device: torch.device) -> Dict[str, str]:
    """``torch`` (its version) and ``device`` (``device_name``)."""
    return {"torch": torch.__version__, "device": device_name(device)}


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_gib(device: torch.device) -> Optional[float]:
    """``torch.cuda.max_memory_allocated`` in GiB since the last reset (None
    off the card)."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def launched() -> Dict[str, int]:
    """The kernels that launched since ``cuda_build.reset_launches()``, with
    their counts."""
    return {k: v for k, v in cuda_build.LAUNCHES.items() if v}


def per(counts: Dict[str, int], n: int) -> Dict[str, float]:
    """The non-zero counts divided by ``n`` (launches a step or a call)."""
    return {k: v / max(1, n) for k, v in counts.items() if v}


def write_json(path: str, record) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


def merge_entry(path: str, name: str, entry) -> Dict:
    """The record of entries at ``path`` (empty if there is none) with
    ``name``'s entry replaced, written back."""
    record = {}
    if os.path.exists(path):
        with open(path) as f:
            record = json.load(f)
    record[name] = entry
    write_json(path, record)
    return record


def train_epochs(trainer, epochs: int = 1) -> Dict[str, float]:
    """``epochs`` epochs of ``trainer``, synced at the end: their seconds,
    batches (``steps``), optimization steps, ms a batch and K7's launches
    an optimization step (1 on the card, 0 off it)."""
    steps, opt_steps = trainer.global_step, trainer.opt_step
    cuda_build.reset_launches()
    t = time.perf_counter()
    trainer.train(num_epochs=epochs)
    hard_sync(trainer.params)
    return epoch_fields(time.perf_counter() - t, trainer.global_step - steps,
                        trainer.opt_step - opt_steps, launched().get("adam", 0))


def epoch_fields(train_s: float, steps: int, opt_steps: int, adam: int) -> Dict[str, float]:
    return dict(train_s=train_s, steps=steps, opt_steps=opt_steps,
                ms_per_step=train_s * 1e3 / max(1, steps), adam_launches=adam,
                adam_launches_per_opt_step=adam / max(1, opt_steps))


def sum_epochs(epochs) -> Dict[str, float]:
    """``train_epochs``' fields over several of its calls."""
    return epoch_fields(*(sum(e[k] for e in epochs)
                          for k in ("train_s", "steps", "opt_steps", "adam_launches")))


def evaluate(evaluator, params, device_graph, test: bool = True):
    """One embedding and the pooled drug-drug validation sweep (and the
    test sweep with ``test``): ``(val, test or None, fields)``, the fields
    the evaluation's seconds and its kernels' launches (K5 on the card)."""
    cuda_build.reset_launches()
    t = time.perf_counter()
    emb = evaluator.embeddings(params, device_graph)
    val = evaluator.evaluate_all_drug_drug(params, device_graph, embeddings=emb)
    tst = (evaluator.evaluate_all_drug_drug(params, device_graph, use_test=True, embeddings=emb)
           if test else None)
    return val, tst, dict(eval_s=time.perf_counter() - t, eval_launches=launched())
