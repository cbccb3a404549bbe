"""Where one paper-scale epoch of the ungrouped step goes: the build, the
scheduler, the chunks synced and pipelined, the evaluation and a checkpoint.

    python -m decagon_tpu_torch.scripts.profile_epoch [--device cpu] [--out PATH]

Port of ``scripts/profile_epoch.py``, stage for stage, on its configuration:
the planted paper graph (19,081 proteins, 645 drugs, 963 side effects of
>= 500 edges, 4,651,131 drug-drug edges, ``ppi_attachment=37``, seed 7,
``planted_rank=16``), split 5% / 5% (seed 8), the device graph with bf16
dense stacks up to 10^9 cells and no fused stream (so "auto" aggregates
every edge type through ``ops/segment.spmm_dense``), hidden 64 -> 32 with
dropout 0.1, and the ``Trainer`` (seed 0) with batch 512, lr 1e-3, hinge
loss (margin 0.1) and chunks of 32: the ungrouped reference schedule, not
the quality run's grouped one.

Stages, in order: the host graph and the device graph; the ``Trainer``;
the scheduler's epoch (host only); the first chunk (the JAX script's
``chunk_compile_s``: the port compiles nothing, so this is the first
chunk's seconds, allocator and cuBLAS set-up included); 8 chunks each
synced; 30 chunks pipelined with one sync at the end, with the host's
seconds to issue each; the projected epoch (scheduler + steps x pipelined
ms); a cold and a warm evaluation (one embedding, the pooled drug-drug
validation and test sweeps); a checkpoint save.

The record keeps the JAX artifact's fields (``artifacts/perf/
epoch_profile.json``) and adds the card's: the torch version, the card's
``nvidia-smi`` name and power limit, peak memory, the kernels' launches in
the timed chunks and in the evaluations, and what a pipelined chunk hands
the card.  CUDA's launch queue is finite: once the host has queued enough
work ahead, issuing a kernel waits for the device, so the host's "dispatch"
seconds then include device time.  ``pipelined_ms_per_chunk`` beside
``host_dispatch_ms_per_chunk_*`` shows whether it did
(``dispatch_waited_for_device``), and on the card one more chunk under
``torch.profiler`` counts the kernels a chunk launches
(``kernels_per_chunk``) and the device's busy ms a step.

The checkpoint (0.7 GB at this config) is written to a temporary directory
that is deleted after, never into the tree (the JAX script writes
``artifacts/perf/profile_ckpt``).  Writes
``artifacts/perf/torch_epoch_profile.json`` (``--out``).  Runs on CUDA
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from typing import Dict, Optional

import torch

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts.records import card_fields, launched, peak_gib, per, reset_peak
from decagon_tpu_torch.scripts.records import write_json
from decagon_tpu_torch.timing import hard_sync
from decagon_tpu_torch.train.checkpoint import Checkpointer
from decagon_tpu_torch.train.evaluate import AccuracyEvaluator
from decagon_tpu_torch.train.step import TrainConfig
from decagon_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "artifacts", "perf", "torch_epoch_profile.json")

# The JAX script's configuration.
GRAPH = dict(n_proteins=19081, n_drugs=645, n_side_effects=963, min_edges_per_relation=500,
             total_drugdrug_edges=4_651_131, ppi_attachment=37, seed=7, planted_rank=16)
SPLIT = dict(val_frac=0.05, test_frac=0.05, seed=8)
DEVICE_GRAPH = dict(densify_max_cells=1_000_000_000, dense_dtype=torch.bfloat16,
                    build_fused=False)
MODEL = dict(hidden1=64, hidden2=32, dropout=0.1, spmm_impl="auto")
TRAIN = dict(batch_size=512, learning_rate=1e-3, loss="hinge", margin=0.1, num_epochs=1,
             scan_chunk=32)
N_SYNC, N_PIPE = 8, 30
PROFILE_STEPS = 8


def profile_epoch(device, graph_kw: Optional[Dict] = None, chunk: Optional[int] = None,
                  n_sync: int = N_SYNC, n_pipe: int = N_PIPE, log=print) -> Dict:
    """The record of one run; ``graph_kw`` and ``chunk`` default to the JAX
    script's (smaller ones for tests)."""
    device = resolve_device(device)
    graph_kw = dict(GRAPH if graph_kw is None else graph_kw)
    train_kw = dict(TRAIN, scan_chunk=chunk or TRAIN["scan_chunk"])
    out: Dict = {}
    reset_peak(device)
    t = time.perf_counter()
    graph = make_polypharmacy_like_graph(**graph_kw)
    splits = split_graph(graph, **SPLIT)
    out["graph_build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    dg = build_device_graph(graph, splits, device=device, **DEVICE_GRAPH)
    hard_sync(dg.neg_cdf)
    out["device_graph_build_s"] = time.perf_counter() - t
    log(f"built: {out}")

    model = DecagonModel(ModelConfig(**MODEL), dg)
    cfg = TrainConfig(**train_kw)
    t = time.perf_counter()
    trainer = Trainer(model, graph, splits, dg, cfg, seed=0)
    hard_sync(trainer.params)
    out["trainer_init_s"] = time.perf_counter() - t

    # --- scheduler enumeration (host only) ----------------------------
    t = time.perf_counter()
    batches = list(trainer.scheduler.epoch())
    out["scheduler_epoch_s"] = time.perf_counter() - t
    out["steps_per_epoch"] = len(batches)
    log(f"scheduler: {out['scheduler_epoch_s']:.2f}s for {len(batches)} batches")
    chunk = cfg.scan_chunk
    need = chunk * (2 + n_sync + n_pipe)
    while len(batches) < need:  # a small graph's epoch is shorter than the run
        batches += list(trainer.scheduler.epoch())

    # --- the first chunk ----------------------------------------------
    t = time.perf_counter()
    hard_sync(trainer.train_chunk(batches[:chunk], chunk))
    out["chunk_compile_s"] = time.perf_counter() - t
    log(f"first chunk in {out['chunk_compile_s']:.1f}s")

    # --- synced chunks (issue + device, serialized) -------------------
    cuda_build.reset_launches()
    times = []
    for i in range(1, 1 + n_sync):
        lo = i * chunk
        t = time.perf_counter()
        trainer.train_chunk(batches[lo:lo + chunk], chunk)
        hard_sync(trainer.params)
        times.append(time.perf_counter() - t)
    out["synced_ms_per_step_min"] = min(times) / chunk * 1e3
    out["synced_ms_per_step_median"] = statistics.median(times) / chunk * 1e3
    log(f"synced: {out['synced_ms_per_step_min']:.2f} ms/step min, "
        f"{out['synced_ms_per_step_median']:.2f} median")

    # --- pipelined chunks (the production loop) -----------------------
    host_times = []
    t_all = time.perf_counter()
    for i in range(1 + n_sync, 1 + n_sync + n_pipe):
        lo = i * chunk
        t = time.perf_counter()
        trainer.train_chunk(batches[lo:lo + chunk], chunk)
        host_times.append(time.perf_counter() - t)
    hard_sync(trainer.params)
    wall = time.perf_counter() - t_all
    counts = launched()
    out["pipelined_ms_per_step"] = wall / (n_pipe * chunk) * 1e3
    out["host_dispatch_ms_per_chunk_median"] = statistics.median(host_times) * 1e3
    out["host_dispatch_ms_per_chunk_max"] = max(host_times) * 1e3
    out["pipelined_ms_per_chunk"] = wall / n_pipe * 1e3
    out["host_dispatch_ms_per_chunk"] = [x * 1e3 for x in host_times]
    # Issuing waited for the device when the median chunk took the host
    # about as long as the device took it.
    out["dispatch_waited_for_device"] = (
        out["host_dispatch_ms_per_chunk_median"] >= 0.9 * out["pipelined_ms_per_chunk"])
    out["timed_launches_per_step"] = per(counts, (n_sync + n_pipe) * chunk)
    log(f"pipelined: {out['pipelined_ms_per_step']:.2f} ms/step; host dispatch "
        f"{out['host_dispatch_ms_per_chunk_median']:.2f} ms/chunk median of "
        f"{out['pipelined_ms_per_chunk']:.2f}")
    if device.type == "cuda":
        from decagon_tpu_torch.bench import device_profile

        prof = device_profile(trainer, PROFILE_STEPS, out["pipelined_ms_per_step"])
        out["kernels_per_chunk"] = prof["kernels_per_step"] * chunk
        out["profile"] = prof

    # --- projected epoch ----------------------------------------------
    out["projected_epoch_s"] = (out["scheduler_epoch_s"]
                                + out["pipelined_ms_per_step"] / 1e3 * out["steps_per_epoch"])

    # --- evaluation -----------------------------------------------------
    evaluator = AccuracyEvaluator(model, graph, splits, device=device)
    for kind in ("cold", "warm"):
        cuda_build.reset_launches()
        t = time.perf_counter()
        emb = evaluator.embeddings(trainer.params, dg)
        val = evaluator.evaluate_all_drug_drug(trainer.params, dg, embeddings=emb)
        evaluator.evaluate_all_drug_drug(trainer.params, dg, use_test=True, embeddings=emb)
        out[f"eval_{kind}_s"] = time.perf_counter() - t
        out[f"eval_{kind}_launches"] = launched()
    out["val_auroc"] = val.auroc
    log(f"eval cold {out['eval_cold_s']:.2f}s warm {out['eval_warm_s']:.2f}s "
        f"(val auroc {val.auroc:.3f})")

    # --- checkpoint save ------------------------------------------------
    ckpt_dir = tempfile.mkdtemp(prefix="profile_ckpt_")
    try:
        checkpointer = Checkpointer(ckpt_dir, max_to_keep=1)
        t = time.perf_counter()
        checkpointer.save(trainer.global_step, trainer.state_dict())
        out["checkpoint_save_s"] = time.perf_counter() - t
        out["checkpoint_gb"] = sum(
            os.path.getsize(os.path.join(ckpt_dir, f)) for f in os.listdir(ckpt_dir)) / 1e9
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    out["checkpoint_dir"] = "a temporary directory, deleted after the save"
    log(f"checkpoint {out['checkpoint_save_s']:.1f}s ({out['checkpoint_gb']:.2f} GB)")

    out.update(card_fields(device))
    out["peak_gib"] = peak_gib(device)
    out["config"] = dict(graph=graph_kw, split=SPLIT,
                         device_graph=dict(DEVICE_GRAPH, dense_dtype="bfloat16"), model=MODEL,
                         train=train_kw, synced_chunks=n_sync, pipelined_chunks=n_pipe)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = profile_epoch(args.device, log=lambda msg: print(
        f"[profile +{time.perf_counter() - t0:.0f}s] {msg}", flush=True))
    write_json(args.out, out)
    print(json.dumps({k: v for k, v in out.items() if k != "profile"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
