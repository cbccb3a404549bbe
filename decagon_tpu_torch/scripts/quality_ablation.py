"""Quality ablation on the dummy config: each variant trains the same graph
and split for a fixed horizon, with no plateau stop.

    python -m decagon_tpu_torch.scripts.quality_ablation [base lazy_adam xent lr_3e3] \\
        [--device cpu] [--out PATH]

Port of ``scripts/quality_ablation.py``, config for config: the dummy graph
(``make_synthetic_graph(500 genes, 400 drugs, 3 drug-drug relations,
seed=0)``), split 5% validation and the 50-edge test floor (seed 1: the
split of ``quality_run.py``'s seed 0), the device graph without the fused
stream, hidden 64 -> 32 with dropout 0.1 and ``spmm_impl="auto"`` (a dense
stack for every edge type at this size), and the ``Trainer`` (seed 0) with
batch 512, lr 1e-3, hinge loss (margin 0.1) in chunks of 50, for 150
epochs, evaluated every 10 and at the last.  The variants:

* ``base``: that configuration;
* ``lazy_adam``: the decoder's rows take the lazy (row-masked) Adam
  (``lazy_decoder_adam=True``): K7 updates the encoder's leaves, an eager
  update the decoder's lazy rows (``train/step._decoder_split``);
* ``xent``: sigmoid cross-entropy in place of the hinge loss;
* ``lr_3e3``: lr 3e-3.

Each variant's entry keeps the JAX record's fields (its trajectory of
validation AUROC, test AUROC and AUPRC; the best test AUROC, the best up
to epochs 50 and 100, the seconds) and adds the card's ``nvidia-smi`` name
and power limit, the torch version, each edge type's aggregation form,
and per evaluation the ms a step, K7's launches an optimization step, the
evaluation's seconds and kernels' launches (K5 on the card) and peak
memory.  Variants merge into an existing record, as the JAX script's do:
``artifacts/quality/torch_ablation.json`` (``--out``; never the JAX run's
``ablation.json``).  Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, Optional

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_synthetic_graph
from decagon_tpu_torch.models.encoder import resolve_impl
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.scripts.records import card_fields, evaluate, peak_gib, reset_peak
from decagon_tpu_torch.scripts.records import merge_entry, sum_epochs, train_epochs
from decagon_tpu_torch.train.evaluate import AccuracyEvaluator
from decagon_tpu_torch.train.step import TrainConfig
from decagon_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "artifacts", "quality", "torch_ablation.json")

# The JAX script's configuration.
GRAPH = dict(n_genes=500, n_drugs=400, n_drugdrug_types=3, seed=0)
SPLIT = dict(val_frac=0.05, test_frac=0.0)  # seed: the trainer's + 1
DEVICE_GRAPH = dict(build_fused=False)
MODEL = dict(hidden1=64, hidden2=32, dropout=0.1, spmm_impl="auto")
TRAIN = dict(batch_size=512, learning_rate=1e-3, loss="hinge", margin=0.1, num_epochs=1,
             scan_chunk=50)
VARIANTS = {
    "base": {},
    "lazy_adam": {"lazy_decoder_adam": True},
    "xent": {"loss": "xent"},
    "lr_3e3": {"learning_rate": 3e-3},
}
MAX_EPOCHS, EVAL_EVERY = 150, 10


def run_variant(name: str, overrides: Dict, max_epochs: int = MAX_EPOCHS,
                eval_every: int = EVAL_EVERY, seed: int = 0, device=None,
                graph_kw: Optional[Dict] = None, log: Callable = print) -> Dict:
    """One variant's entry of the record (the JAX function's fields and the
    port's)."""
    device = resolve_device(device)
    graph = make_synthetic_graph(**(graph_kw or GRAPH))
    splits = split_graph(graph, seed=seed + 1, **SPLIT)
    dg = build_device_graph(graph, splits, device=device, **DEVICE_GRAPH)
    model = DecagonModel(ModelConfig(**MODEL), dg)
    trainer = Trainer(model, graph, splits, dg, TrainConfig(**dict(TRAIN, **overrides)),
                      seed=seed)
    evaluator = AccuracyEvaluator(model, graph, splits, device=device)
    t0 = time.time()
    trajectory, evaluations = [], []
    reset_peak(device)
    since = []
    for epoch in range(1, max_epochs + 1):
        since.append(train_epochs(trainer))
        if epoch % eval_every and epoch != max_epochs:
            continue
        val, test, fields = evaluate(evaluator, trainer.params, dg)
        trajectory.append({"epoch": epoch, "val_auroc": round(val.auroc, 5),
                           "test_auroc": round(test.auroc, 5),
                           "test_auprc": round(test.auprc, 5)})
        evaluations.append(dict(epoch=epoch, **sum_epochs(since), peak_gib=peak_gib(device),
                                **fields))
        since = []
        log(f"[{name}] epoch {epoch}: val {val.auroc:.4f} test {test.auroc:.4f} "
            f"({time.time() - t0:.0f}s)")
    tests = [(t["epoch"], t["test_auroc"]) for t in trajectory]
    return {
        "trajectory": trajectory,
        "best_test_auroc": max(a for _, a in tests),
        "test_auroc_at_50": max((a for e, a in tests if e <= 50), default=float("nan")),
        "test_auroc_at_100": max((a for e, a in tests if e <= 100), default=float("nan")),
        "seconds": round(time.time() - t0, 1),
        "evaluations": evaluations,
        "aggregation": {key: resolve_impl(adj, MODEL["spmm_impl"])
                        for key, adj in sorted(dg.adj.items())},
        "config": dict(graph=graph_kw or GRAPH, split=dict(SPLIT, seed=seed + 1),
                       device_graph=DEVICE_GRAPH, model=MODEL, train=dict(TRAIN, **overrides),
                       seed=seed, max_epochs=max_epochs, eval_every=eval_every),
        **card_fields(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", choices=list(VARIANTS), help="default: all four")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    results = {}
    for name in args.variants or list(VARIANTS):
        results = merge_entry(args.out, name, run_variant(name, VARIANTS[name], device=device,
                                                          log=lambda m: print(m, flush=True)))
    print(json.dumps({k: {kk: v[kk] for kk in ("best_test_auroc", "test_auroc_at_50",
                                              "test_auroc_at_100")}
                      for k, v in results.items()}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
