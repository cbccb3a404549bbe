"""The public-data ingest at full size: a fixture with the real dataset's
shape and formats, parsed, loaded, split, moved to the card and trained.

    python -m decagon_tpu_torch.scripts.ingest_fullsize [--device cpu] [--scale S] [--out PATH]

Port of ``scripts/ingest_fullsize.py``.  The bio-decagon CSVs are not in the
repository, so the script draws a fixture with their shape, the draws of the
JAX script's ``synthesize`` one for one (``np.random.default_rng(11)``, the
same calls in the same order), and writes it in the reference's STITCH
formats (``CID`` + 9 digits, ``C`` + 7 digits) under the same headers:
4,943,515 combo rows over 645 drugs and 1,213 side effects (963 of them with
500 rows or more), 715,612 PPI rows over 19,081 proteins, 18,596 drug-target
rows and 174,977 mono rows.  ``draws(rng, scale)`` returns the arrays,
``write_fixture`` writes them; ``scale`` < 1 shrinks every count (the CPU
tests and ``chip_smoke.py``), and ``scale=1`` is the JAX fixture.  The files
go to a temporary directory that the script deletes.

Then the whole ingest path, as in the JAX script: the native C++ parse of
``combo.csv`` against the Python parse (each timed; they must be equal; the
parser is switched through ``native.DISABLE_ENV`` and the module's
``_LIB`` / ``_TRIED``), ``load_public_dataset`` on the four files, the split
(5% / 5%, seed 1), ``build_device_graph(densify_max_cells=0,
build_fused=False)`` (the COO stream) and two ``Trainer.train_batch`` steps
at hidden 64 -> 32, dropout 0.1, ``spmm_impl="xla"``, batch 512, lr 1e-3,
seed 0: ``ops/segment.py``'s gather and ``index_add_``, and K7 once a step
on the card.  ``two_cpu_train_steps_s`` keeps its JAX name and is measured
on the device the script runs on (``two_train_steps_device``).

Beyond the JAX script, on the same host graph: the device graph of
``decagon_tpu_torch/bench.py``'s headline (paired int8 stacks where
``_halves_are_transposes`` allows, factored masks elsewhere; the form of
each edge type is recorded; K6's layouts, which only the bench's sparse
configs read, are left out), two ``Trainer`` steps with its ``ModelConfig``
(``spmm_impl="paired"``) and the pooled drug-drug evaluation twice: with
that ``ModelConfig`` (``sddmm_precision="highest"``: K5) and with the
production scorer ``scripts/profile_sddmm.py`` times (``"default"``: bf16
tables, K5-bf16).  K1/K2 (with and without ``-ds``), K3/K4, K5, K5-bf16
and K7 on the card, with their launches, ms a step and peak GiB.  This is
the route a user takes from the public CSVs on the card.

Writes ``artifacts/perf/torch_ingest_fullsize.json`` (``--out``): every
field of the JAX record under its name, the seconds of each stage, peak
GiB, the kernels' launches, the torch version and the card's name and power
limit.  Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time
from typing import Callable, Dict

import numpy as np
import torch

from decagon_tpu_torch import native, resolve_device
from decagon_tpu_torch.data import public
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts.records import (
    card_fields, launched, peak_gib, reset_peak, write_json,
)
from decagon_tpu_torch.timing import hard_sync
from decagon_tpu_torch.train.evaluate import AccuracyEvaluator
from decagon_tpu_torch.train.step import TrainConfig
from decagon_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "artifacts", "perf", "torch_ingest_fullsize.json")

# The JAX script's fixture: node counts, the >=500-row and the smaller
# relations, the combo rows the large ones share, and the other files' rows.
FIXTURE = dict(n_drugs=645, n_proteins=19081, n_big=963, n_small=250, big_rows=4_400_000,
               n_ppi=715_612, n_tgt=18_596, n_mono=174_977, n_mono_se=10_184)
# The least each count takes when ``scale`` shrinks it (``big_rows`` is
# scaled as it is).
FLOORS = dict(n_drugs=150, n_proteins=200, n_big=3, n_small=2, n_ppi=400, n_tgt=100,
              n_mono=200, n_mono_se=20)
SEED = 11
FILES = {
    "combo": ("combo.csv", "STITCH 1,STITCH 2,Polypharmacy Side Effect,Side Effect Name",
              "CID%09d,CID%09d,C%07d,synthetic effect"),
    "ppi": ("ppi.csv", "Gene 1,Gene 2", "%d,%d"),
    "targets": ("targets.csv", "STITCH,Gene", "CID%09d,%d"),
    "mono": ("mono.csv", "STITCH,Individual Side Effect,Side Effect Name",
             "CID%09d,C%07d,synthetic mono"),
}
SPLIT = dict(val_frac=0.05, test_frac=0.05, seed=1)
DEVICE_GRAPH = dict(densify_max_cells=0, build_fused=False)
MODEL = dict(hidden1=64, hidden2=32, dropout=0.1, spmm_impl="xla")
TRAIN = dict(batch_size=512, learning_rate=1e-3)
TRAINER_SEED = 0
STEPS = 2
# ``bench.py``'s headline (``bench_paired_sparse``) without K6's layouts.
PAIRED_DEVICE_GRAPH = dict(densify_max_cells=1_000_000_000, dense_factored=True,
                           dense_paired=True, build_fused=False)
PAIRED_MODEL = dict(hidden1=64, hidden2=32, dropout=0.1, spmm_impl="paired")


def counts(scale: float = 1.0) -> Dict[str, float]:
    """``FIXTURE`` shrunk by ``scale`` (no count under its ``FLOORS``);
    ``FIXTURE`` itself at 1."""
    out = {k: max(floor, int(round(FIXTURE[k] * scale))) for k, floor in FLOORS.items()}
    out["big_rows"] = FIXTURE["big_rows"] * scale  # a float, as the JAX script scales by it
    return out


def draws(rng: np.random.Generator, scale: float = 1.0) -> Dict[str, np.ndarray]:
    """The fixture's columns, drawn as the JAX ``synthesize`` draws them (the
    same calls in the same order on ``rng``): ``{file: [columns]}`` of the
    integer IDs each file writes."""
    c = counts(scale)
    n_drugs, n_proteins = c["n_drugs"], c["n_proteins"]
    # Drug and protein STITCH integer IDs: arbitrary sparse ints.
    drug_ids = np.sort(rng.choice(90_000_000, n_drugs, replace=False)) + 1
    protein_ids = np.sort(rng.choice(200_000, n_proteins, replace=False)) + 1

    # combo: relations of >= 500 rows and some below the filter.
    sizes_big = rng.integers(500, 11_000, c["n_big"])
    sizes_big = (sizes_big * (c["big_rows"] / sizes_big.sum())).astype(np.int64) + 500
    sizes_small = rng.integers(5, 480, c["n_small"])
    sizes = np.concatenate([sizes_big, sizes_small])
    rel_ids = np.sort(rng.choice(9_999_999, len(sizes), replace=False))
    total = int(sizes.sum())
    a = rng.integers(0, n_drugs, total)
    b = rng.integers(0, n_drugs, total)
    fix = a == b
    b[fix] = (a[fix] + 1) % n_drugs
    rel = np.repeat(rel_ids, sizes)
    perm = rng.permutation(total)
    a, b, rel = a[perm], b[perm], rel[perm]

    pa = rng.integers(0, n_proteins, c["n_ppi"])
    pb = rng.integers(0, n_proteins, c["n_ppi"])
    fix = pa == pb
    pb[fix] = (pa[fix] + 1) % n_proteins

    td = rng.integers(0, n_drugs, c["n_tgt"])
    tp = rng.integers(0, n_proteins, c["n_tgt"])

    md = rng.integers(0, n_drugs, c["n_mono"])
    ms = rng.integers(0, c["n_mono_se"], c["n_mono"])
    mono_ids = np.sort(rng.choice(9_999_999, c["n_mono_se"], replace=False))
    return {
        "combo": [drug_ids[a], drug_ids[b], rel],
        "ppi": [protein_ids[pa], protein_ids[pb]],
        "targets": [drug_ids[td], protein_ids[tp]],
        "mono": [drug_ids[md], mono_ids[ms]],
    }


def write_csv(path: str, header: str, fmt: str, arrays, chunk: int = 200_000) -> None:
    """The JAX script's writer: ``header``, then ``fmt % row`` a line, in
    chunks."""
    n = len(arrays[0])
    with open(path, "w") as f:
        f.write(header + "\n")
        for lo in range(0, n, chunk):
            rows = zip(*(a[lo: lo + chunk] for a in arrays))
            f.write("\n".join(fmt % row for row in rows))
            f.write("\n")


def write_fixture(columns: Dict[str, list], out_dir: str) -> Dict[str, str]:
    """The four CSVs of ``draws`` under ``out_dir``; their paths."""
    paths = {}
    for key, (name, header, fmt) in FILES.items():
        paths[key] = os.path.join(out_dir, name)
        write_csv(paths[key], header, fmt, columns[key])
    return paths


def fixture_fields(columns: Dict[str, list], paths: Dict[str, str]) -> Dict[str, int]:
    """The JAX record's ``fixture``: each file's rows, the combo file's bytes."""
    out = {f"{key}_rows": len(columns[key][0]) for key in FILES}
    out["combo_bytes"] = os.path.getsize(paths["combo"])
    return out


def _native(on: bool) -> None:
    """The port's native library on or off for the parses that follow."""
    if on:
        os.environ.pop(native.DISABLE_ENV, None)
    else:
        os.environ[native.DISABLE_ENV] = "1"
    native._LIB, native._TRIED = None, False


def parse_fields(combo: str) -> Dict:
    """The JAX record's parse fields: the native and Python parses of
    ``combo``, each timed, and whether they are equal (the library is left
    on).  Raises if they differ or the library did not build."""
    out = {}
    if native.get_library() is None:
        raise RuntimeError("the native library did not build")
    t = time.perf_counter()
    arr = native.parse_edge_csv(combo, 3)
    native_s = time.perf_counter() - t
    out["native_parse"] = dict(seconds=native_s, rows_per_s=arr.shape[0] / native_s,
                               rows=int(arr.shape[0]))
    try:
        _native(False)
        t = time.perf_counter()
        arr_py = public._parse_int_csv(combo, 3)
        py_s = time.perf_counter() - t
    finally:
        _native(True)
    out["python_parse"] = dict(seconds=py_s, rows_per_s=arr_py.shape[0] / py_s,
                               rows=int(arr_py.shape[0]))
    np.testing.assert_array_equal(arr, arr_py)
    out["native_vs_python_equal"] = True
    out["native_speedup"] = py_s / native_s
    return out


def adj_forms(dg) -> Dict[str, str]:
    """Each edge type's aggregation form on the device graph."""
    def form(a):
        if a.pair_mask is not None:
            return "paired"
        if a.dense_mask is not None:
            return "factored"
        if a.dense is not None:
            return "dense"
        return "coo"

    return {key: form(a) for key, a in dg.adj.items()}


def train_steps(graph, splits, dg, model_kw: Dict, device, steps: int = STEPS) -> Dict:
    """``steps`` ``train_batch`` steps of a fresh ``Trainer`` (each loss read,
    as the JAX script's ``float``): the losses, the seconds of all and of
    each, the kernels' launches over them, and the ``Trainer``."""
    model = DecagonModel(ModelConfig(**model_kw), dg)
    trainer = Trainer(model, graph, splits, dg, TrainConfig(**TRAIN), seed=TRAINER_SEED)
    cuda_build.reset_launches()
    losses, step_s = [], []
    t = time.perf_counter()
    for batch in trainer.scheduler.epoch():
        t_step = time.perf_counter()
        losses.append(float(trainer.train_batch(batch)))
        step_s.append(time.perf_counter() - t_step)
        if len(losses) >= steps:
            break
    return dict(seconds=time.perf_counter() - t, step_s=step_s, losses=losses,
                losses_finite=all(map(math.isfinite, losses)), launches=launched(),
                trainer=trainer)


def paired_leg(graph, splits, device, log: Callable) -> Dict:
    """The bench headline's device graph, two steps and a pooled
    evaluation on the ingested graph."""
    reset_peak(device)
    t = time.perf_counter()
    dg = build_device_graph(graph, splits, device=device, **PAIRED_DEVICE_GRAPH)
    hard_sync(dg.neg_cdf)
    out = {"device_graph_s": time.perf_counter() - t, "forms": adj_forms(dg),
           "pair_mask_gb": sum(a.pair_mask.numel() for a in dg.adj.values()
                               if a.pair_mask is not None) / 1e9}
    log(f"paired device graph: {out['device_graph_s']:.1f}s, forms {out['forms']}")
    run = train_steps(graph, splits, dg, PAIRED_MODEL, device)
    trainer = run.pop("trainer")
    out.update(run, ms_per_step=run["step_s"][-1] * 1e3)
    for key, model in (("eval", trainer.model), ("eval_bf16_tables", DecagonModel(
            ModelConfig(**PAIRED_MODEL, sddmm_precision="default"), dg))):
        cuda_build.reset_launches()
        t = time.perf_counter()
        scores = AccuracyEvaluator(model, graph, splits, device=device).evaluate_all_drug_drug(
            trainer.params, dg)
        out[key] = dict(seconds=time.perf_counter() - t, auroc=scores.auroc,
                        auprc=scores.auprc, apk=scores.apk, launches=launched())
    out["peak_gib"] = peak_gib(device)
    log(f"paired leg: losses {out['losses']}, launches {out['launches']}, evaluations "
        f"{out['eval']}, {out['eval_bf16_tables']}")
    return out


def ingest(device: str = "cuda", scale: float = 1.0, log: Callable = print) -> Dict:
    """The record (the module docstring) at ``scale``."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    out: Dict = {"scale": scale, **card_fields(dev),
                 "two_train_steps_device": str(dev.type), "stage_s": {}}
    stages = out["stage_s"]
    if dev.type == "cuda":
        cuda_build.library()
    with tempfile.TemporaryDirectory(prefix="decagon_ingest_") as tmp:
        t = time.perf_counter()
        columns = draws(np.random.default_rng(SEED), scale)
        stages["draws"] = time.perf_counter() - t
        t = time.perf_counter()
        paths = write_fixture(columns, tmp)
        stages["write"] = time.perf_counter() - t
        out["fixture"] = fixture_fields(columns, paths)
        del columns
        log(f"fixture: {out['fixture']} (draws {stages['draws']:.1f}s, "
            f"write {stages['write']:.1f}s)")
        out.update(parse_fields(paths["combo"]))
        log(f"native parse {out['native_parse']}, python parse {out['python_parse']}")
        t = time.perf_counter()
        ds = public.load_public_dataset(paths["combo"], paths["ppi"], paths["targets"],
                                        paths["mono"])
        out["load_public_dataset_s"] = time.perf_counter() - t
    graph = ds.graph
    out["relations_after_filter"] = sum(
        1 for r in graph.relations[(1, 1)] if not getattr(r, "name", "").endswith("_T"))
    out["n_drugs"] = graph.num_nodes[1]
    out["n_proteins"] = graph.num_nodes[0]
    log(f"load_public_dataset: {out['load_public_dataset_s']:.1f}s, "
        f"{out['relations_after_filter']} relations kept")

    reset_peak(dev)
    t = time.perf_counter()
    splits = split_graph(graph, **SPLIT)
    stages["split"] = time.perf_counter() - t
    t = time.perf_counter()
    dg = build_device_graph(graph, splits, device=dev, **DEVICE_GRAPH)
    hard_sync(dg.neg_cdf)
    stages["device_graph"] = time.perf_counter() - t
    out["split_and_device_graph_s"] = stages["split"] + stages["device_graph"]
    run = train_steps(graph, splits, dg, MODEL, dev)
    run.pop("trainer")
    out["two_cpu_train_steps_s"] = run["seconds"]
    out["losses_finite"] = run["losses_finite"]
    out["xla_steps"] = dict(run, peak_gib=peak_gib(dev))
    log(f"{STEPS} xla steps on {dev.type}: {run['seconds']:.1f}s, losses {run['losses']}, "
        f"launches {run['launches']}")
    del dg
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["paired"] = paired_leg(graph, splits, dev, log)
    out["wall_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    out = ingest(args.device, args.scale)
    write_json(args.out, out)
    print(json.dumps({k: v for k, v in out.items() if k not in ("xla_steps", "paired")}))
    print("wrote", args.out)
    return out


if __name__ == "__main__":
    main()
