"""Converged quality runs of the port, with metric CSVs: the dummy config
and the 50-relation graph trained to their plateaus.

    python -m decagon_tpu_torch.scripts.quality_run [dummy|poly50|all] \\
        [--device cpu] [--artifact-dir DIR] [--max-hours H] [--seed 0]

Port of ``scripts/quality_run.py``, config for config:

1. ``dummy``: the reference dummy config (500 genes, 400 drugs, 3 drug-drug
   relations and their transposes; ``make_synthetic_graph(seed=0)``), at
   most 200 epochs.  Asserts the final pooled drug-drug test AUROC >= 0.74,
   the bottom of the reference's recorded final band.
2. ``poly50``: the 50-relation planted polypharmacy-like graph (2,000
   proteins, 400 drugs, ``planted_rank=16``, seed 7), at most 80 epochs,
   held to the same 0.74.

Both: the split (validation 5%, test 0%: the 50-edge floor, seed + 1), the
device graph (``densify_max_cells=400_000_000``, CSR layouts on the card,
no fused stream), hidden 64 -> 32 with dropout 0.1 and ``spmm_impl="auto"``,
the ``Trainer`` (seed 0) with batch 512, lr 1e-3, hinge loss (margin 0.1)
in chunks of 50 steps; an evaluation every 5 epochs and at the last, a stop
once the validation AUROC has not risen by 0.001 for 8 evaluations.  At
these sizes every edge type gets a dense stack, so "auto" aggregates with
``ops/segment.spmm_dense`` on the card (the plain COO stream on the CPU);
the sidecar records the form each edge type took (``resolve_impl``).

Writes ``artifacts/quality/torch_{tag}_metrics.csv`` (the JAX script's
columns, never the JAX run's ``{tag}_metrics.csv``; the tag is the config's
name, ``{name}_seed{seed}`` for a seed other than 0) and
``torch_{tag}_metrics.meta.json``: the configuration, the card's
``nvidia-smi`` name and power limit, the torch version, each edge type's
aggregation form, why the run stopped, and per evaluation the epochs
trained since the last, their seconds and ms a step, K7's launches a step,
the evaluation's seconds and its kernels' launches (K5 on the card), and
peak memory.  ``--max-hours`` ends a run early: the sidecar then says at
which epoch and why.  Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time
from typing import Dict, Optional

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph, make_synthetic_graph
from decagon_tpu_torch.models.encoder import resolve_impl
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts.records import card_fields, launched, peak_gib, reset_peak
from decagon_tpu_torch.scripts.records import write_json
from decagon_tpu_torch.timing import hard_sync
from decagon_tpu_torch.train.evaluate import AccuracyEvaluator
from decagon_tpu_torch.train.step import TrainConfig
from decagon_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ART_DIR = os.path.join(ROOT, "artifacts", "quality")

# The JAX script's configuration.
CONFIGS = {
    "dummy": dict(graph="synthetic", graph_kw=dict(n_genes=500, n_drugs=400,
                                                   n_drugdrug_types=3, seed=0),
                  max_epochs=200),
    "poly50": dict(graph="polypharmacy", graph_kw=dict(n_proteins=2000, n_drugs=400,
                                                       n_side_effects=50, seed=7,
                                                       planted_rank=16),
                   max_epochs=80),
}
VAL_FRAC = 0.05
DEVICE_GRAPH = dict(densify_max_cells=400_000_000, build_fused=False)
MODEL = dict(hidden1=64, hidden2=32, dropout=0.1, spmm_impl="auto")
TRAIN = dict(batch_size=512, learning_rate=1e-3, loss="hinge", margin=0.1, num_epochs=1,
             scan_chunk=50)
GATE = 0.74
COLUMNS = ["Epoch", "ValAUROC", "ValAUPRC", "ValAPK", "TestAUROC", "TestAUPRC", "TestAPK",
           "Seconds"]


def train_to_plateau(
    tag: str,
    graph,
    max_epochs: int,
    eval_every: int = 5,
    patience: int = 8,
    min_delta: float = 0.001,
    seed: int = 0,
    test_frac: float = 0.0,
    device=None,
    artifact_dir: Optional[str] = None,
    max_seconds: Optional[float] = None,
):
    """Train ``graph`` until the plateau rule or ``max_epochs`` stops it (or
    ``max_seconds`` of wall time); returns ``(csv_path, (epoch, val,
    test))`` of the last evaluation, as the JAX function does."""
    device = resolve_device(device)
    artifact_dir = artifact_dir or ART_DIR
    # Reference split protocol: val = 5% of edges, test = the 50-edge floor.
    splits = split_graph(graph, val_frac=VAL_FRAC, test_frac=test_frac, seed=seed + 1)
    on_card = device.type == "cuda"
    dg = build_device_graph(graph, splits, tile_for_pallas=on_card, device=device,
                            **DEVICE_GRAPH)
    model = DecagonModel(ModelConfig(**MODEL), dg)
    trainer = Trainer(model, graph, splits, dg, TrainConfig(**TRAIN), seed=seed)
    evaluator = AccuracyEvaluator(model, graph, splits, device=device)

    os.makedirs(artifact_dir, exist_ok=True)
    csv_path = os.path.join(artifact_dir, f"torch_{tag}_metrics.csv")
    meta_path = os.path.join(artifact_dir, f"torch_{tag}_metrics.meta.json")
    meta = dict(
        config=dict(tag=tag, max_epochs=max_epochs, eval_every=eval_every, patience=patience,
                    min_delta=min_delta, seed=seed, val_frac=VAL_FRAC, test_frac=test_frac,
                    split_seed=seed + 1, device_graph=dict(DEVICE_GRAPH,
                                                           tile_for_pallas=on_card),
                    model=MODEL, train=TRAIN, gate=GATE),
        **card_fields(device),
        aggregation={key: resolve_impl(adj, MODEL["spmm_impl"])
                     for key, adj in sorted(dg.adj.items())},
        stopped=None, epochs=0, seconds=0.0, evaluations=[],
    )
    t0 = time.time()
    best_val = -1.0
    evals_since_best = 0
    final = None
    since = dict(epochs=0, train_s=0.0, steps=0, adam=0)
    reset_peak(device)
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(COLUMNS)
        for epoch in range(1, max_epochs + 1):
            steps_before = trainer.global_step
            cuda_build.reset_launches()
            t = time.perf_counter()
            trainer.train(num_epochs=1)
            hard_sync(trainer.params)
            since["train_s"] += time.perf_counter() - t
            since["steps"] += trainer.global_step - steps_before
            since["epochs"] += 1
            since["adam"] += launched().get("adam", 0)
            out_of_time = max_seconds is not None and time.time() - t0 >= max_seconds
            if epoch % eval_every and epoch != max_epochs and not out_of_time:
                continue
            cuda_build.reset_launches()
            t = time.perf_counter()
            emb = evaluator.embeddings(trainer.params, dg)
            val = evaluator.evaluate_all_drug_drug(trainer.params, dg, embeddings=emb)
            test = evaluator.evaluate_all_drug_drug(trainer.params, dg, use_test=True,
                                                    embeddings=emb)
            eval_s = time.perf_counter() - t
            writer.writerow(
                [epoch, f"{val.auroc:.5f}", f"{val.auprc:.5f}", f"{val.apk:.5f}",
                 f"{test.auroc:.5f}", f"{test.auprc:.5f}", f"{test.apk:.5f}",
                 f"{time.time() - t0:.1f}"]
            )
            f.flush()
            meta["evaluations"].append(dict(
                epoch=epoch, epochs_trained=since["epochs"], train_s=since["train_s"],
                steps=since["steps"], ms_per_step=since["train_s"] * 1e3 / max(1, since["steps"]),
                adam_launches_per_step=since["adam"] / max(1, since["steps"]),
                eval_s=eval_s, eval_launches=launched(),
                peak_gib=peak_gib(device),
            ))
            since = dict(epochs=0, train_s=0.0, steps=0, adam=0)
            print(
                f"[{tag}] epoch {epoch}: val AUROC {val.auroc:.4f} "
                f"test AUROC {test.auroc:.4f} AUPRC {test.auprc:.4f} "
                f"({time.time() - t0:.0f}s)",
                flush=True,
            )
            final = (epoch, val, test)
            stop = None
            if val.auroc > best_val + min_delta:
                best_val = val.auroc
                evals_since_best = 0
            else:
                evals_since_best += 1
                if evals_since_best >= patience:
                    print(f"[{tag}] plateau at epoch {epoch}")
                    stop = f"plateau at epoch {epoch}"
            if stop is None and epoch == max_epochs:
                stop = f"max_epochs ({max_epochs}) reached before a plateau"
            if stop is None and out_of_time:
                stop = (f"wall budget of {max_seconds:.0f} s spent after epoch {epoch}, "
                        "before a plateau")
            meta.update(stopped=stop, epochs=epoch, seconds=time.time() - t0)
            write_json(meta_path, meta)
            if stop is not None:
                break
    return csv_path, final


def make_graph(name: str):
    cfg = CONFIGS[name]
    if cfg["graph"] == "synthetic":
        return make_synthetic_graph(**cfg["graph_kw"])
    return make_polypharmacy_like_graph(**cfg["graph_kw"])


def run(name: str, device=None, artifact_dir: Optional[str] = None,
        max_seconds: Optional[float] = None, seed: int = 0):
    """One config to its plateau; asserts the gate on the final test AUROC,
    as the JAX script does.  ``seed``: ``train_to_plateau``'s (the trainer's
    and, plus one, the split's); the JAX script runs seed 0.  Another seed's
    files are tagged ``{name}_seed{seed}``, so seeds run side by side into
    one directory keep their own."""
    graph = make_graph(name)
    path, (epoch, val, test) = train_to_plateau(
        name if seed == 0 else f"{name}_seed{seed}", graph,
        max_epochs=CONFIGS[name]["max_epochs"], seed=seed, device=device,
        artifact_dir=artifact_dir, max_seconds=max_seconds,
    )
    print(
        f"{name} final: epoch {epoch} test AUROC {test.auroc:.4f} "
        f"AUPRC {test.auprc:.4f} APK {test.apk:.4f} -> {path}"
    )
    if test.auroc < GATE:
        raise AssertionError(
            f"{name} test AUROC {test.auroc:.4f} below the reference band floor {GATE}")
    return test


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="all", choices=["dummy", "poly50", "all"])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--artifact-dir", default=ART_DIR, help="where the CSVs and sidecars go")
    ap.add_argument("--max-hours", type=float, default=None,
                    help="wall budget of each run (default: none)")
    ap.add_argument("--seed", type=int, default=0,
                    help="train_to_plateau's seed (the JAX script's: 0)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    budget: Dict = dict(device=args.device, artifact_dir=args.artifact_dir, seed=args.seed,
                        max_seconds=None if args.max_hours is None else args.max_hours * 3600)
    if args.which in ("dummy", "all"):
        run("dummy", **budget)
    if args.which in ("poly50", "all"):
        run("poly50", **budget)
    print("quality runs OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
