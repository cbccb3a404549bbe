"""bf16 Adam moments: their quality over 10 epochs on the 50-relation graph,
and the paper-scale factored step's time with f32 and with bf16 moments.

    python -m decagon_tpu_torch.scripts.probe_adam_bf16 [--device cpu] [--out PATH]

Port of ``scripts/probe_adam_bf16.py``, part for part:

(b) quality, first: the planted 50-relation graph (2,000 proteins, 400
drugs, seed 7, ``planted_rank=16``), split 5% / 5% (seed 8), the device
graph with the int8 factored masks (``dense_factored=True``, dense cap
4 x 10^8 cells, no fused stream), hidden 64 -> 32 with dropout 0.1 and
"auto", and for each moment dtype a ``Trainer`` (seed 0) with batch 512,
lr 3e-3, chunks of 32, the balanced schedule and 8 batches an optimization
step: the pooled drug-drug validation AUROC after each of 10 epochs.
(a) time: the paper graph (19,081 proteins, 645 drugs, 963 side effects of
>= 500 edges, 4,651,131 drug-drug edges, ``ppi_attachment=37``, seed 7),
split 5% / 5% (seed 1), the factored masks (bf16, dense cap 10^9 cells),
``spmm_impl="dense_factored"``, and for each moment dtype a ``Trainer``
(seed 0, batch 512, lr 1e-3, chunks of 20): one warm-up chunk, then the
fastest of 5 synced chunks, in ms a step.  The two dtypes are K7's two
instantiations (f32 and bf16 moments).

The record keeps the JAX record's fields
(``artifacts/quality/adam_bf16_moments.json``: each dtype's validation
curve and step time) and adds the card's ``nvidia-smi`` name and power
limit, the torch version, peak memory and, per part and dtype, the kernels'
launches (K7 an optimization step, K5 an evaluation) and every chunk's
time: ``artifacts/quality/torch_adam_bf16_moments.json`` (``--out``).  Runs
on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, Optional

import torch

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts.records import card_fields, evaluate, launched, peak_gib, per
from decagon_tpu_torch.scripts.records import reset_peak, train_epochs, write_json
from decagon_tpu_torch.timing import hard_sync
from decagon_tpu_torch.train.evaluate import AccuracyEvaluator
from decagon_tpu_torch.train.step import TrainConfig
from decagon_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "artifacts", "quality", "torch_adam_bf16_moments.json")

# The JAX script's configuration.
DTYPES = ("float32", "bfloat16")
QUALITY_GRAPH = dict(n_proteins=2000, n_drugs=400, n_side_effects=50, seed=7, planted_rank=16)
QUALITY_SPLIT = dict(val_frac=0.05, test_frac=0.05, seed=8)
QUALITY_DEVICE_GRAPH = dict(densify_max_cells=400_000_000, build_fused=False,
                            dense_factored=True)
QUALITY_MODEL = dict(hidden1=64, hidden2=32, dropout=0.1, spmm_impl="auto")
QUALITY_TRAIN = dict(batch_size=512, learning_rate=3e-3, scan_chunk=32, schedule="balanced",
                     relation_group=8, num_epochs=1)
EPOCHS = 10
PERF_GRAPH = dict(n_proteins=19081, n_drugs=645, n_side_effects=963,
                  min_edges_per_relation=500, total_drugdrug_edges=4_651_131,
                  ppi_attachment=37, seed=7)
PERF_SPLIT = dict(val_frac=0.05, test_frac=0.05, seed=1)
PERF_DEVICE_GRAPH = dict(densify_max_cells=1_000_000_000, dense_dtype=torch.bfloat16,
                         build_fused=False, dense_factored=True)
PERF_MODEL = dict(hidden1=64, hidden2=32, dropout=0.1, spmm_impl="dense_factored")
PERF_TRAIN = dict(batch_size=512, learning_rate=1e-3, scan_chunk=20)
CHUNKS = 5


def quality(device, graph_kw: Optional[Dict] = None, epochs: int = EPOCHS,
            log: Callable = print) -> Dict:
    """Part (b): each dtype's validation AUROC after each epoch, and what
    each epoch ran."""
    graph = make_polypharmacy_like_graph(**(graph_kw or QUALITY_GRAPH))
    splits = split_graph(graph, **QUALITY_SPLIT)
    dg = build_device_graph(graph, splits, device=device, **QUALITY_DEVICE_GRAPH)
    model = DecagonModel(ModelConfig(**QUALITY_MODEL), dg)
    out = {}
    for dtype in DTYPES:
        cfg = TrainConfig(adam_moments_dtype=dtype, **QUALITY_TRAIN)
        tr = Trainer(model, graph, splits, dg, cfg, seed=0)
        ev = AccuracyEvaluator(model, graph, splits, device=device)
        traj, epochs_card = [], []
        for _ in range(epochs):
            train = train_epochs(tr)
            val, _, fields = evaluate(ev, tr.params, dg, test=False)
            traj.append(round(val.auroc, 5))
            epochs_card.append(dict(train, **fields))
        out[f"poly50_val_auroc_{dtype}"] = traj
        out[f"poly50_epochs_{dtype}"] = epochs_card
        log(f"{dtype}: {traj}")
    return out


def step_time(device, graph_kw: Optional[Dict] = None, chunk: int = PERF_TRAIN["scan_chunk"],
              chunks: int = CHUNKS, log: Callable = print) -> Dict:
    """Part (a): each dtype's fastest synced chunk in ms a step."""
    graph = make_polypharmacy_like_graph(**(graph_kw or PERF_GRAPH))
    splits = split_graph(graph, **PERF_SPLIT)
    dg = build_device_graph(graph, splits, device=device, **PERF_DEVICE_GRAPH)
    model = DecagonModel(ModelConfig(**PERF_MODEL), dg)
    out = {}
    for dtype in DTYPES:
        cfg = TrainConfig(adam_moments_dtype=dtype, **dict(PERF_TRAIN, scan_chunk=chunk))
        tr = Trainer(model, graph, splits, dg, cfg, seed=0)
        batches = []
        while len(batches) < chunk * (chunks + 2):
            batches.extend(tr.scheduler.epoch())
        reset_peak(device)
        hard_sync(tr.train_chunk(batches[:chunk], chunk))
        cuda_build.reset_launches()
        times = []
        for rep in range(chunks):
            lo = chunk * (1 + rep)
            t0 = time.perf_counter()
            tr.train_chunk(batches[lo:lo + chunk], chunk)
            hard_sync(tr.params)
            times.append((time.perf_counter() - t0) / chunk)
        out[f"fullscale_factored_ms_{dtype}"] = round(min(times) * 1e3, 2)
        out[f"fullscale_factored_{dtype}"] = dict(
            chunk_ms_per_step=[t * 1e3 for t in times],
            launches_per_step=per(launched(), chunks * chunk), peak_gib=peak_gib(device))
        log(f"fullscale {dtype}: {out[f'fullscale_factored_ms_{dtype}']} ms/step")
        del tr
    return out


def probe_adam_bf16(device=None, quality_kw: Optional[Dict] = None,
                    perf_kw: Optional[Dict] = None, epochs: int = EPOCHS,
                    chunk: int = PERF_TRAIN["scan_chunk"], chunks: int = CHUNKS,
                    log: Callable = print) -> Dict:
    """The record: part (b), then part (a), as the JAX script runs them."""
    device = resolve_device(device)
    out = quality(device, quality_kw, epochs, log)
    out.update(step_time(device, perf_kw, chunk, chunks, log))
    out.update(config=dict(quality=dict(graph=quality_kw or QUALITY_GRAPH, split=QUALITY_SPLIT,
                                        device_graph=QUALITY_DEVICE_GRAPH, model=QUALITY_MODEL,
                                        train=QUALITY_TRAIN, epochs=epochs),
                           perf=dict(graph=perf_kw or PERF_GRAPH, split=PERF_SPLIT,
                                     device_graph=dict(PERF_DEVICE_GRAPH,
                                                       dense_dtype="bfloat16"),
                                     model=PERF_MODEL, train=dict(PERF_TRAIN, scan_chunk=chunk),
                                     chunks=chunks)),
               **card_fields(device))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    out = probe_adam_bf16(args.device, log=lambda m: print(m, flush=True))
    write_json(args.out, out)
    print(json.dumps({k: v for k, v in out.items() if not isinstance(v, dict)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
