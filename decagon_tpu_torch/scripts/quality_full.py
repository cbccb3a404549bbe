"""Paper-scale quality run of the port: trains the planted polypharmacy-like
graph to its plateau and streams per-epoch pooled drug-drug metrics.

    python -m decagon_tpu_torch.scripts.quality_full --noise 0.15 \\
        [--max-epochs N] [--max-hours H] [--ckpt-dir DIR] [--device cpu]

Port of ``scripts/quality_full.py``, field for field: the graph
(19,081 proteins, 645 drugs, 963 side effects of >= 500 edges, 4,651,131
drug-drug edges, ``planted_rank=16``, ``planted_noise=--noise``), its split
(5% / 5%, seed 8), the device graph (bf16 dense cap of 10^9 cells, factored
and paired masks, no fused stream), hidden 64 -> 32 with dropout 0.1 and
``spmm_impl="auto"`` (the paired kernels on the square edge types, the int8
factored stack on the rectangular ones), and the ``Trainer`` (seed 0) with
batch 512, hinge loss (margin 0.1), chunks of 32, the balanced schedule,
``relation_group=--group`` batches an optimization step and the learning
rate decayed over ``--lr-schedule-epochs`` epochs of optimization steps to a
tenth.  Each epoch: one epoch of training, one embedding, the pooled
drug-drug evaluation of the validation and the test edges on it, one CSV
row; a checkpoint every ``--ckpt-every`` epochs; a stop once the validation
AUROC has not risen by 0.001 for ``--patience`` epochs, or once the wall
budget is spent.

Outputs: ``artifacts/quality/torch_poly963{tag}_metrics.csv`` (the JAX
script's columns) and ``.meta.json`` (the JAX sidecar's fields, plus the
card's ``nvidia-smi`` name and power limit, the torch version, the run's
seconds and each epoch's training and evaluation seconds, ms an
optimization step and peak memory), where ``{tag}`` is ``_noise0.15`` at
``--noise 0.15`` and empty at the default 0.3.  Checkpoints (``torch.save`` files of the
parameters and Adam state, ~0.7 GB each at paper scale) go to
``artifacts/quality/torch_poly963_ckpt{tag}/`` (ignored by git) unless
``--ckpt-dir`` is given.

Resumable: run it again and it restores the newest checkpoint, drops the
CSV rows of epochs trained after it, replays the scheduler's shuffles of
the epochs done (so the resumed run takes the batches the uninterrupted
one takes), rebuilds the plateau count from the CSV and appends.  A run
that stops at its plateau deletes its checkpoints: nothing is left to
resume.  Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import shutil
import sys
import time
from typing import Dict, List, Optional

import torch

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.scripts.probing import card
from decagon_tpu_torch.timing import hard_sync
from decagon_tpu_torch.train.checkpoint import Checkpointer
from decagon_tpu_torch.train.evaluate import AccuracyEvaluator
from decagon_tpu_torch.train.step import TrainConfig
from decagon_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ART_DIR = os.path.join(ROOT, "artifacts", "quality")
CKPT_DIR = os.path.join(ART_DIR, "torch_poly963_ckpt")

# The JAX run's configuration (its sidecar's ``graph`` without the noise,
# ``split_seed``, ``model`` and ``trainer_seed``).
GRAPH = dict(
    n_proteins=19081, n_drugs=645, n_side_effects=963, min_edges_per_relation=500,
    total_drugdrug_edges=4_651_131, ppi_attachment=37, seed=7, planted_rank=16,
)
SPLIT_SEED = 8
MODEL = dict(hidden1=64, hidden2=32, dropout=0.1, spmm_impl="auto")
BATCH = 512
TRAINER_SEED = 0
COLUMNS = ["Epoch", "ValAUROC", "ValAUPRC", "ValAPK", "TestAUROC", "TestAUPRC", "TestAPK",
           "Seconds"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-hours", type=float, default=4.0)
    ap.add_argument("--max-epochs", type=int, default=60)
    ap.add_argument("--patience", type=int, default=6)
    ap.add_argument("--ckpt-every", type=int, default=3, help="epochs between checkpoints")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--lr-schedule", default="cosine", choices=["constant", "cosine", "step"])
    ap.add_argument("--lr-schedule-epochs", type=int, default=10,
                    help="epochs over which the rate decays to a tenth")
    ap.add_argument("--group", type=int, default=8, help="batches an optimization step")
    ap.add_argument("--noise", type=float, default=0.3, help="planted selection noise")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=None, help="checkpoint directory "
                    "(default artifacts/quality/torch_poly963_ckpt{tag})")
    ap.add_argument("--artifact-dir", default=ART_DIR, help="where the CSV and sidecar go")
    return ap.parse_args(argv)


def noise_tag(noise: float) -> str:
    return "" if noise == 0.3 else f"_noise{noise:g}"


def opt_steps_per_epoch(graph, splits, batch: int, group: int) -> int:
    """Optimization steps in one balanced epoch: every relation's train
    batches (a partial one rounded up), ``group`` of them a step."""
    n_batches = sum(
        -(-splits[k].train.shape[0] // batch)
        for k in graph.relation_keys()
        if splits[k].train.shape[0] > 0
    )
    return -(-n_batches // group)


def train_config(args, graph, splits, batch: int = BATCH) -> TrainConfig:
    return TrainConfig(
        batch_size=batch, learning_rate=args.lr, loss="hinge", margin=0.1, num_epochs=1,
        scan_chunk=32, schedule="balanced", relation_group=args.group,
        lr_schedule=args.lr_schedule,
        lr_schedule_steps=args.lr_schedule_epochs * opt_steps_per_epoch(
            graph, splits, batch, args.group),
        lr_min_frac=0.1,
    )


def provenance(graph_kw: Dict, model_kw: Dict, cfg: TrainConfig, device_name: str,
               seconds: float, epochs: int) -> Dict:
    """The JAX sidecar's fields with their meaning, then the port's own."""
    return {
        "graph": dict(graph_kw),
        "split_seed": SPLIT_SEED,
        "model": dict(model_kw),
        "train": {
            "batch_size": cfg.batch_size, "learning_rate": cfg.learning_rate,
            "loss": cfg.loss, "margin": cfg.margin, "schedule": cfg.schedule,
            "relation_group": cfg.relation_group, "lr_schedule": cfg.lr_schedule,
            "lr_schedule_steps": cfg.lr_schedule_steps, "lr_min_frac": cfg.lr_min_frac,
            "adam_moments_dtype": cfg.adam_moments_dtype, "grad_dtype": cfg.grad_dtype,
        },
        "trainer_seed": TRAINER_SEED,
        "device": device_name,
        "torch": torch.__version__,
        "seconds": seconds,
        "epochs": epochs,
    }


def read_rows(path: str, upto_epoch: int) -> List[Dict[str, str]]:
    """The CSV's rows of epochs up to ``upto_epoch`` (none if no file)."""
    if not os.path.exists(path):
        return []
    with open(path, newline="") as f:
        return [row for row in csv.DictReader(f) if int(row["Epoch"]) <= upto_epoch]


def replay_epochs(scheduler, epochs: int) -> None:
    """Draw ``epochs`` epochs of batches and drop them: the scheduler's
    generator and edge order then stand where the run that wrote the
    checkpoint left them."""
    for _ in range(epochs):
        for _ in scheduler.epoch():
            pass


def run(args, graph_kw: Optional[Dict] = None, model_kw: Optional[Dict] = None,
        batch: int = BATCH, log=None) -> Dict:
    """Train to the plateau (or the epoch or wall budget); returns the last
    epoch's row, the stop reason and the paths written.  ``graph_kw``,
    ``model_kw`` and ``batch`` default to the JAX run's."""
    t0 = time.time()
    log = log or (lambda msg: print(f"[quality +{time.time() - t0:.0f}s] {msg}", flush=True))
    graph_kw = dict(GRAPH if graph_kw is None else graph_kw, planted_noise=args.noise)
    model_kw = dict(MODEL if model_kw is None else model_kw)
    device = resolve_device(args.device)
    tag = noise_tag(args.noise)
    ckpt_dir = args.ckpt_dir or CKPT_DIR + tag
    os.makedirs(args.artifact_dir, exist_ok=True)
    csv_path = os.path.join(args.artifact_dir, f"torch_poly963{tag}_metrics.csv")
    meta_path = os.path.join(args.artifact_dir, f"torch_poly963{tag}_metrics.meta.json")

    graph = make_polypharmacy_like_graph(**graph_kw)
    splits = split_graph(graph, val_frac=0.05, test_frac=0.05, seed=SPLIT_SEED)
    dg = build_device_graph(
        graph, splits, densify_max_cells=1_000_000_000, dense_dtype=torch.bfloat16,
        build_fused=False, dense_factored=True, dense_paired=True, device=device,
    )
    log("graph + device graph built")
    model = DecagonModel(ModelConfig(**model_kw), dg)
    cfg = train_config(args, graph, splits, batch)
    trainer = Trainer(model, graph, splits, dg, cfg, seed=TRAINER_SEED)
    evaluator = AccuracyEvaluator(model, graph, splits, device=device)
    checkpointer = Checkpointer(ckpt_dir, max_to_keep=2)
    resumed = trainer.try_resume(checkpointer)
    steps_per_epoch = trainer.scheduler.num_batches_per_epoch()
    start_epoch = trainer.global_step // steps_per_epoch
    replay_epochs(trainer.scheduler, start_epoch)
    rows = read_rows(csv_path, start_epoch) if resumed else []
    if len(rows) != start_epoch:
        raise RuntimeError(f"{csv_path} holds {len(rows)} of the {start_epoch} epochs the "
                           f"checkpoint in {ckpt_dir} has trained")
    log(f"batches/epoch={steps_per_epoch} optimization steps/epoch="
        f"{opt_steps_per_epoch(graph, splits, batch, args.group)} resumed={resumed} "
        f"start_epoch={start_epoch} lr_schedule_steps={cfg.lr_schedule_steps}")

    best_val, since_best = -1.0, 0
    for row in rows:
        if float(row["ValAUROC"]) > best_val + 0.001:
            best_val, since_best = float(row["ValAUROC"]), 0
        else:
            since_best += 1
    seconds_before = float(rows[-1]["Seconds"]) if rows else 0.0
    device_name = card() if device.type == "cuda" else str(device)

    timing = []
    if resumed and os.path.exists(meta_path):
        with open(meta_path) as mf:
            timing = [t for t in json.load(mf).get("timing", []) if t["epoch"] <= start_epoch]

    def write_meta(epochs: int, seconds: float) -> None:
        meta = provenance(graph_kw, model_kw, cfg, device_name, seconds, epochs)
        meta["timing"] = timing
        with open(meta_path, "w") as mf:
            json.dump(meta, mf, indent=1)

    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(COLUMNS)
        for row in rows:
            writer.writerow([row[c] for c in COLUMNS])
    write_meta(start_epoch, seconds_before)
    stop, final, epoch = "max_epochs", None, start_epoch
    for epoch in range(start_epoch + 1, args.max_epochs + 1):
        t_epoch = time.perf_counter()
        steps_before = trainer.opt_step
        trainer.train(num_epochs=1)
        hard_sync(trainer.params)
        t_eval = time.perf_counter()
        emb = evaluator.embeddings(trainer.params, dg)
        val = evaluator.evaluate_all_drug_drug(trainer.params, dg, embeddings=emb)
        test = evaluator.evaluate_all_drug_drug(trainer.params, dg, use_test=True, embeddings=emb)
        t_end = time.perf_counter()
        seconds = seconds_before + time.time() - t0
        timing.append(dict(
            epoch=epoch, train_s=t_eval - t_epoch, eval_s=t_end - t_eval,
            opt_steps=trainer.opt_step - steps_before,
            ms_per_opt_step=(t_eval - t_epoch) * 1e3 / max(1, trainer.opt_step - steps_before),
            peak_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                      if device.type == "cuda" else None),
        ))
        log(f"timing {json.dumps(timing[-1])}")
        final = [epoch, f"{val.auroc:.5f}", f"{val.auprc:.5f}", f"{val.apk:.5f}",
                 f"{test.auroc:.5f}", f"{test.auprc:.5f}", f"{test.apk:.5f}", f"{seconds:.1f}"]
        with open(csv_path, "a", newline="") as f:
            csv.writer(f).writerow(final)
        write_meta(epoch, seconds)
        if epoch % args.ckpt_every == 0 or epoch == args.max_epochs:
            checkpointer.save(trainer.global_step, trainer.state_dict())
        log(f"epoch {epoch}: val AUROC {val.auroc:.4f} test AUROC {test.auroc:.4f} "
            f"AUPRC {test.auprc:.4f}")
        if val.auroc > best_val + 0.001:
            best_val, since_best = val.auroc, 0
        else:
            since_best += 1
            if since_best >= args.patience:
                stop = "plateau"
                log(f"plateau at epoch {epoch}")
                break
        if (time.time() - t0) / 3600 > args.max_hours:
            stop = "wall"
            log("wall-time budget reached")
            break
    if stop == "plateau":
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    if final is not None:
        log(f"FINAL epoch {final[0]}: test AUROC {final[4]} AUPRC {final[5]} "
            "(north star >= 0.87)")
    return dict(final=final, stop=stop, epoch=epoch, resumed=resumed, csv=csv_path,
                meta=meta_path, ckpt_dir=ckpt_dir, global_step=trainer.global_step,
                opt_step=trainer.opt_step, trainer=trainer)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
