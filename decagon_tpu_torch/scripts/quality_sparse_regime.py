"""Beyond the paper's scale, the sparse regime learns: a few epochs on the
1,600-drug planted graph through K6, the optimizer K7 and the scorer K5.

    python -m decagon_tpu_torch.scripts.quality_sparse_regime [--epochs 4] [--noise 0.15] \\
        [--device cpu] [--artifact-dir DIR]

Port of ``scripts/quality_sparse_regime.py``, field for field: the graph
(19,081 proteins, 1,600 drugs, 963 side effects of >= 500 edges, 6,000,000
drug-drug edges, ``ppi_attachment=37``, seed 7, ``planted_rank=16``,
``planted_noise=--noise``), its split (5% / 5%, seed 8), the device graph of
``bench_sparse_regime`` (K6's CSR layouts on every edge type, no dense or
mask stack, no fused stream), hidden 64 -> 32 with dropout 0.1 and
``spmm_impl="pallas"`` at ``spmm_precision="default"`` (``sddmm_precision``
stays "highest", so the evaluation scores through K5), and the ``Trainer``
(seed 0) with batch 512, lr 3e-3, chunks of 32, the balanced schedule and 8
batches an optimization step.  Each epoch: one epoch of training, one
embedding, the pooled drug-drug evaluation of the validation and the test
edges on it, one CSV row.

Outputs ``artifacts/quality/torch_poly963_1600drugs_metrics.csv`` (the JAX
script's columns) and ``.meta.json`` (the JAX sidecar's fields, then the
card's ``nvidia-smi`` name and power limit, the torch version, the run's
seconds, the host build's and, per epoch, the training and evaluation
seconds, ms an optimization step, peak memory and the kernels' launches).
Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time
from typing import Dict, Optional

import torch

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts.bench_sparse_regime import sparse_device_graph
from decagon_tpu_torch.timing import hard_sync
from decagon_tpu_torch.train.evaluate import AccuracyEvaluator
from decagon_tpu_torch.train.step import TrainConfig
from decagon_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ART_DIR = os.path.join(ROOT, "artifacts", "quality")
NAME = "torch_poly963_1600drugs_metrics"

# The JAX run's configuration: its sidecar's ``graph`` (without the noise),
# ``split_seed``, ``model``, ``train`` and ``trainer_seed``; the two graph
# arguments its sidecar leaves out follow them.
GRAPH = dict(n_proteins=19081, n_drugs=1600, n_side_effects=963,
             total_drugdrug_edges=6_000_000, seed=7, planted_rank=16)
GRAPH_REST = dict(min_edges_per_relation=500, ppi_attachment=37)
SPLIT_SEED = 8
MODEL = dict(hidden1=64, hidden2=32, dropout=0.1, spmm_impl="pallas", spmm_precision="default")
TRAIN = dict(batch_size=512, learning_rate=3e-3, schedule="balanced", relation_group=8)
SCAN_CHUNK = 32
TRAINER_SEED = 0
COLUMNS = ["Epoch", "ValAUROC", "ValAUPRC", "TestAUROC", "TestAUPRC", "Seconds"]
# The kernels an epoch's launches are recorded for.
KERNELS = ("spmm_tiled", "adam", "sddmm", "sddmm_bf16", "paired_fwd", "paired_bwd")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--noise", type=float, default=0.15)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--artifact-dir", default=ART_DIR, help="where the CSV and sidecar go")
    return ap.parse_args(argv)


def train_config(train_kw: Dict) -> TrainConfig:
    return TrainConfig(scan_chunk=SCAN_CHUNK, **train_kw)


def run(args, graph_kw: Optional[Dict] = None, model_kw: Optional[Dict] = None,
        train_kw: Optional[Dict] = None, log=None) -> Dict:
    """Train ``args.epochs`` epochs; returns the rows, the paths written and
    the trainer.  ``graph_kw`` (the sidecar's graph fields and the two
    others), ``model_kw`` and ``train_kw`` default to the JAX run's."""
    t0 = time.time()
    log = log or (lambda msg: print(f"[sparse-q +{time.time() - t0:.0f}s] {msg}", flush=True))
    graph_kw = dict(GRAPH, **GRAPH_REST) if graph_kw is None else dict(graph_kw)
    graph_kw["planted_noise"] = args.noise
    model_kw = dict(MODEL if model_kw is None else model_kw)
    train_kw = dict(TRAIN if train_kw is None else train_kw)
    device = resolve_device(args.device)
    os.makedirs(args.artifact_dir, exist_ok=True)
    csv_path = os.path.join(args.artifact_dir, f"{NAME}.csv")
    meta_path = os.path.join(args.artifact_dir, f"{NAME}.meta.json")

    t = time.perf_counter()
    graph = make_polypharmacy_like_graph(**graph_kw)
    splits = split_graph(graph, val_frac=0.05, test_frac=0.05, seed=SPLIT_SEED)
    dg = sparse_device_graph(graph, splits, device)
    build_s = time.perf_counter() - t
    log(f"graph built in {build_s:.1f}s (K6 only: no dense or mask stack)")
    model = DecagonModel(ModelConfig(**model_kw), dg)
    trainer = Trainer(model, graph, splits, dg, train_config(train_kw), seed=TRAINER_SEED)
    evaluator = AccuracyEvaluator(model, graph, splits, device=device)
    if device.type == "cuda":
        from decagon_tpu_torch.scripts.probing import card

        device_name = card()
    else:
        device_name = str(device)

    meta = {
        "graph": {key: graph_kw[key] for key in (*GRAPH, "planted_noise")},
        "split_seed": SPLIT_SEED,
        "model": model_kw,
        "train": train_kw,
        "trainer_seed": TRAINER_SEED,
        "device": device_name,
        "torch": torch.__version__,
        "host_build_s": build_s,
        "seconds": 0.0,
        "epochs": 0,
        "timing": [],
    }
    rows = []
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(COLUMNS)
        for epoch in range(1, args.epochs + 1):
            cuda_build.reset_launches()
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            t_epoch = time.perf_counter()
            steps_before = trainer.opt_step
            trainer.train(num_epochs=1)
            hard_sync(trainer.params)
            trained = dict(cuda_build.LAUNCHES)
            t_eval = time.perf_counter()
            emb = evaluator.embeddings(trainer.params, dg)
            val = evaluator.evaluate_all_drug_drug(trainer.params, dg, embeddings=emb)
            test = evaluator.evaluate_all_drug_drug(trainer.params, dg, use_test=True,
                                                    embeddings=emb)
            t_end = time.perf_counter()
            steps = trainer.opt_step - steps_before
            meta["timing"].append(dict(
                epoch=epoch, train_s=t_eval - t_epoch, eval_s=t_end - t_eval, opt_steps=steps,
                ms_per_opt_step=(t_eval - t_epoch) * 1e3 / max(1, steps),
                peak_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                          if device.type == "cuda" else None),
                train_launches={k: trained[k] for k in KERNELS},
                eval_launches={k: cuda_build.LAUNCHES[k] - trained[k] for k in KERNELS},
            ))
            row = [epoch, f"{val.auroc:.5f}", f"{val.auprc:.5f}", f"{test.auroc:.5f}",
                   f"{test.auprc:.5f}", f"{time.time() - t0:.1f}"]
            writer.writerow(row)
            f.flush()
            rows.append(row)
            meta.update(seconds=time.time() - t0, epochs=epoch)
            with open(meta_path, "w") as mf:
                json.dump(meta, mf, indent=1)
            log(f"epoch {epoch}: val AUROC {val.auroc:.4f} test {test.auroc:.4f}; "
                f"{json.dumps(meta['timing'][-1])}")
    return dict(rows=rows, csv=csv_path, meta=meta_path, trainer=trainer)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
