"""Schedule and relation-group convergence ablation on the 50-relation
planted graph.

    python -m decagon_tpu_torch.scripts.schedule_ablation [--epochs 10] \\
        [--configs ref_g1,bal_g1,bal_g8,bal_g8_lr3] [--device cpu] [--out PATH]

Port of ``scripts/schedule_ablation.py``, config for config: the planted
graph (2,000 proteins, 400 drugs, 50 side effects, seed 7,
``planted_rank=16``), split 5% / 5% (seed 8), the device graph with dense
stacks up to 4 x 10^8 cells and no fused stream (so "auto" aggregates every
edge type through ``ops/segment.spmm_dense`` on the card), hidden 64 -> 32
with dropout 0.1, and for each config a ``Trainer`` (seed 0) with batch
512, hinge loss (margin 0.1) in chunks of 32:

* ``ref_g1``: the reference schedule, one batch an optimization step;
* ``bal_g1``: the balanced schedule, one batch a step;
* ``bal_g8``: balanced, 8 batches a step (``relation_group=8``), lr 1e-3;
* ``bal_g8_lr3``: balanced, 8 batches a step, lr 3e-3.

Each runs ``--epochs`` epochs, with the pooled drug-drug validation AUROC
and AUPRC and the wall seconds after each.  Each config's entry keeps the
JAX record's fields (``batches_per_epoch``, the trajectory) and adds the
card's ``nvidia-smi`` name and power limit, the torch version, per epoch
the ms a batch and K7's launches an optimization step, the evaluation's
seconds and kernels' launches (K5 on the card), and peak memory.  Writes
``artifacts/quality/torch_schedule_ablation.json`` (``--out``; never the
JAX run's ``schedule_ablation.json``).  Runs on CUDA unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.scripts.records import card_fields, evaluate, peak_gib, reset_peak
from decagon_tpu_torch.scripts.records import train_epochs, write_json
from decagon_tpu_torch.train.evaluate import AccuracyEvaluator
from decagon_tpu_torch.train.step import TrainConfig
from decagon_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "artifacts", "quality", "torch_schedule_ablation.json")

# The JAX script's configuration.
GRAPH = dict(n_proteins=2000, n_drugs=400, n_side_effects=50, seed=7, planted_rank=16)
SPLIT = dict(val_frac=0.05, test_frac=0.05, seed=8)
DEVICE_GRAPH = dict(densify_max_cells=400_000_000, build_fused=False)
MODEL = dict(hidden1=64, hidden2=32, dropout=0.1, spmm_impl="auto")
TRAIN = dict(batch_size=512, loss="hinge", margin=0.1, num_epochs=1, scan_chunk=32)
CONFIGS = {
    "ref_g1": dict(schedule="reference", relation_group=1, learning_rate=1e-3),
    "bal_g1": dict(schedule="balanced", relation_group=1, learning_rate=1e-3),
    "bal_g8": dict(schedule="balanced", relation_group=8, learning_rate=1e-3),
    "bal_g8_lr3": dict(schedule="balanced", relation_group=8, learning_rate=3e-3),
}
EPOCHS = 10


def schedule_ablation(configs: List[str], epochs: int = EPOCHS, device=None,
                      graph_kw: Optional[Dict] = None, log: Callable = print) -> Dict:
    """The record: one entry a config of ``configs``."""
    device = resolve_device(device)
    t_all = time.perf_counter()
    graph = make_polypharmacy_like_graph(**(graph_kw or GRAPH))
    splits = split_graph(graph, **SPLIT)
    dg = build_device_graph(graph, splits, device=device, **DEVICE_GRAPH)
    model = DecagonModel(ModelConfig(**MODEL), dg)
    out = {}
    for tag in configs:
        cfg = TrainConfig(**TRAIN, **CONFIGS[tag])
        trainer = Trainer(model, graph, splits, dg, cfg, seed=0)
        evaluator = AccuracyEvaluator(model, graph, splits, device=device)
        steps = trainer.scheduler.num_batches_per_epoch()
        rows, epochs_card = [], []
        reset_peak(device)
        t_start = time.perf_counter()
        for epoch in range(1, epochs + 1):
            train = train_epochs(trainer)
            val, _, fields = evaluate(evaluator, trainer.params, dg, test=False)
            rows.append({"epoch": epoch, "val_auroc": round(val.auroc, 5),
                         "val_auprc": round(val.auprc, 5),
                         "wall_s": round(time.perf_counter() - t_start, 1)})
            epochs_card.append(dict(epoch=epoch, **train, **fields))
            log(f"[{tag} +{time.perf_counter() - t_all:.0f}s] epoch {epoch}: "
                f"val AUROC {val.auroc:.4f}")
        out[tag] = {"batches_per_epoch": steps, "trajectory": rows, "epochs": epochs_card,
                    "peak_gib": peak_gib(device),
                    "config": dict(graph=graph_kw or GRAPH, split=SPLIT,
                                   device_graph=DEVICE_GRAPH, model=MODEL,
                                   train=dict(TRAIN, **CONFIGS[tag]), seed=0),
                    **card_fields(device)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    out = schedule_ablation(args.configs.split(","), args.epochs, args.device,
                            log=lambda m: print(m, flush=True))
    write_json(args.out, out)
    print(json.dumps({t: v["trajectory"][-1] for t, v in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
