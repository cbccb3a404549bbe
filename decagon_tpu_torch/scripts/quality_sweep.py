"""Seed sweep of the dummy-config quality gate.

    python -m decagon_tpu_torch.scripts.quality_sweep [--seeds 0-5] [--device cpu]

Trains the reference's dummy config (``make_synthetic_graph(500, 400, 3,
seed=0)``, split 5%/0% with seed 1, hidden 64 -> 32, dropout 0.1,
``TrainConfig(scan_chunk=50)``) with the ``Trainer``, one trainer seed
after another, and prints one JSON line per seed: the pooled drug-drug
test AUROC before training and after each of 10 epochs, which is what
the gate (``tests/test_torch_quality.py``, ``chip_smoke.py`` phase 13)
reads after its last epoch.  It shows at which epoch the gate passes for
every seed.
Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_synthetic_graph
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.train.evaluate import AccuracyEvaluator
from decagon_tpu_torch.train.step import TrainConfig
from decagon_tpu_torch.train.trainer import Trainer

EPOCHS = 10


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0-5", help="trainer seeds, 'lo-hi' inclusive")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    lo, _, hi = args.seeds.partition("-")
    device = resolve_device(args.device)
    graph = make_synthetic_graph(n_genes=500, n_drugs=400, n_drugdrug_types=3, seed=0)
    splits = split_graph(graph, val_frac=0.05, test_frac=0.0, seed=1)
    dg = build_device_graph(graph, splits, device=device)
    model = DecagonModel(ModelConfig(hidden1=64, hidden2=32, dropout=0.1), dg)
    evaluator = AccuracyEvaluator(model, graph, splits, device=device)
    for seed in range(int(lo), int(hi or lo) + 1):
        cfg = TrainConfig(batch_size=512, learning_rate=1e-3, num_epochs=1, scan_chunk=50)
        trainer = Trainer(model, graph, splits, dg, cfg, seed=seed)
        t = time.perf_counter()
        auroc = [evaluator.evaluate_all_drug_drug(trainer.params, dg, use_test=True).auroc]
        for _ in range(EPOCHS):
            trainer.train(num_epochs=1)
            auroc.append(evaluator.evaluate_all_drug_drug(trainer.params, dg, use_test=True).auroc)
        print(json.dumps({"seed": seed, "epochs": EPOCHS, "steps": trainer.global_step,
                          "seconds": time.perf_counter() - t, "auroc_by_epoch": auroc}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
