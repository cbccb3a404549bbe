"""Quality probe: the dummy config's AUROC under hyperparameter variants.

    python -m decagon_tpu_torch.scripts.quality_probe [all|base|xent|lr3e3|nodrop|margin0|
        refproto|refproto-nodrop] [--device cpu] [--out PATH]

Port of ``scripts/quality_probe.py``, variant for variant: the dummy graph
(``make_synthetic_graph(500 genes, 400 drugs, 3 drug-drug relations,
seed=0)``), split at the variant's fractions (seed 1), the device graph
with ``tile_for_pallas=True``, hidden 64 -> 32, the ``Trainer`` (seed 0)
with batch 512 in chunks of 50, evaluated every 20 epochs and at the last.
``refproto`` is the reference protocol: validation 5%, the 50-edge test
floor, 60 epochs.

``tile_for_pallas`` builds K6's CSR layouts where an edge type has no
dense stack, as the JAX flag builds its tiles there; at this size every
edge type has one, so neither package builds any and "auto" aggregates
through the dense stacks (a CSR in place of the JAX tiles is a divergence
by design, ``ops/tiling.py``).

Prints the JAX script's lines; ``--out`` keeps every evaluation of each
variant run (validation and test AUROC, test AUPRC, seconds) with the
card's ``nvidia-smi`` name and power limit, the torch version, ms a step,
K7's launches an optimization step and the evaluation's kernels' launches
(K5 on the card), merged by variant into
``artifacts/quality/torch_quality_probe.json``.  Runs on CUDA unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Dict, Optional

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_synthetic_graph
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.scripts.records import card_fields, evaluate, merge_entry, sum_epochs
from decagon_tpu_torch.scripts.records import train_epochs
from decagon_tpu_torch.train.evaluate import AccuracyEvaluator
from decagon_tpu_torch.train.step import TrainConfig
from decagon_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "artifacts", "quality", "torch_quality_probe.json")

# The JAX script's configuration.
GRAPH = dict(n_genes=500, n_drugs=400, n_drugdrug_types=3, seed=0)
SPLIT_SEED = 1
DEVICE_GRAPH = dict(tile_for_pallas=True)
EVAL_EVERY = 20
VARIANTS = {
    "base": dict(),
    "xent": dict(loss="xent"),
    "lr3e3": dict(lr=3e-3),
    "nodrop": dict(dropout=0.0),
    "margin0": dict(margin=0.0),
    # Reference protocol: val = 5%, test = 50-edge floor, 60 epochs.
    "refproto": dict(val_frac=0.05, test_frac=0.0, epochs=60),
    "refproto-nodrop": dict(val_frac=0.05, test_frac=0.0, epochs=60, dropout=0.0),
}


def run(tag: str, epochs: int = 100, loss: str = "hinge", lr: float = 1e-3,
        dropout: float = 0.1, margin: float = 0.1, val_frac: float = 0.1,
        test_frac: float = 0.05, device=None, graph_kw: Optional[Dict] = None,
        log: Callable = print) -> Dict:
    """One variant (the JAX ``run``'s arguments): its evaluations."""
    device = resolve_device(device)
    graph = make_synthetic_graph(**(graph_kw or GRAPH))
    splits = split_graph(graph, val_frac=val_frac, test_frac=test_frac, seed=SPLIT_SEED)
    dg = build_device_graph(graph, splits, device=device, **DEVICE_GRAPH)
    model = DecagonModel(ModelConfig(hidden1=64, hidden2=32, dropout=dropout), dg)
    cfg = TrainConfig(batch_size=512, learning_rate=lr, loss=loss, margin=margin, num_epochs=1,
                      scan_chunk=50)
    trainer = Trainer(model, graph, splits, dg, cfg, seed=0)
    ev = AccuracyEvaluator(model, graph, splits, device=device)
    t0 = time.time()
    rows, since = [], []
    for ep in range(epochs):
        since.append(train_epochs(trainer))
        if (ep + 1) % EVAL_EVERY == 0 or ep + 1 == epochs:
            s, st, fields = evaluate(ev, trainer.params, dg)
            rows.append(dict(epoch=ep + 1, val_auroc=s.auroc, test_auroc=st.auroc,
                             test_auprc=st.auprc, seconds=time.time() - t0,
                             **sum_epochs(since), **fields))
            since = []
            log(f"[{tag}] ep {ep + 1}: val auroc={s.auroc:.3f} "
                f"test auroc={st.auroc:.3f} auprc={st.auprc:.3f} "
                f"({time.time() - t0:.0f}s)")
    return dict(config=dict(epochs=epochs, loss=loss, lr=lr, dropout=dropout, margin=margin,
                            val_frac=val_frac, test_frac=test_frac, split_seed=SPLIT_SEED,
                            graph=graph_kw or GRAPH, device_graph=DEVICE_GRAPH),
                evaluations=rows, **card_fields(device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="all", choices=["all"] + list(VARIANTS))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for tag, kw in VARIANTS.items():
        if args.which in ("all", tag):
            merge_entry(args.out, tag, run(tag, device=device,
                                           log=lambda m: print(m, flush=True), **kw))
    return 0


if __name__ == "__main__":
    sys.exit(main())
