"""Per-kernel device profile of steady-state ``Trainer`` chunks at paper
scale: where a factored, dense or paired step's device time goes.

    python -m decagon_tpu_torch.scripts.profile_factored_ops [--relations 963] \\
        [--spmm dense_factored|dense|paired] [--chunk 20] [--out NAME] [--device cpu]

Port of ``scripts/profile_factored_ops.py``: the paper graph (19,081
proteins, 645 drugs, ``--relations`` side effects of >= 500 edges,
4,651,131 drug-drug edges, ``ppi_attachment=37``, seed 7), split 5% / 5%
(seed 1), the device graph with the dense cap at 10^9 cells (bf16), no
fused stream, the ``Trainer`` (seed 0, batch 512, chunks of ``--chunk``) at
``--spmm``: two warm-up chunks, one timed chunk (host clock, synced), then
one chunk traced.  The JAX script parses the TPU's xplane and sums each
HLO op's self time; the port traces the chunk with ``bench.device_profile``
(device activity on the card, host activity on the CPU), which sums each
kernel's self time by name, and ``planes`` reshapes its rows into the JAX
record's (each op's share of the total and its launches), the top 40 kept.

One divergence: the JAX script builds every mask form on one graph
(``dense_factored=True, dense_paired=True``); the port builds no factored
masks for a paired edge type (``graph/device.py``), so the graph holds what
``--spmm`` reads: the factored masks everywhere for "dense_factored", the
half masks on the square types and the factored masks on the rectangular
ones for "paired", the bf16 dense stacks for "dense".

The record keeps the JAX record's fields (``config`` with
``steps_traced``, ``wall_ms_per_step``, ``planes``: each traced timeline's
``total_ms`` and its ``ops``, each with ``op``, ``ms`` and ``n``, plus the
port's ``share``) and adds the card's ``nvidia-smi`` name and power limit,
the torch version, the device's busy ms a step against the wall ms a step
(its idle share), the kernels the step launches a step, peak memory and the
hand-written kernels' launches in the traced chunk.  Writes
``artifacts/perf/torch_<--out>`` (default ``factored_op_profile.json``;
``--spmm paired --out paired_op_profile.json`` is the counterpart of the
JAX package's ``paired_op_profile.json``).  Runs on CUDA unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, Optional

import torch

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.bench import device_profile
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts.records import card_fields, launched, peak_gib, reset_peak
from decagon_tpu_torch.scripts.records import write_json
from decagon_tpu_torch.timing import hard_sync
from decagon_tpu_torch.train.step import TrainConfig
from decagon_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ART = os.path.join(ROOT, "artifacts", "perf")

# The JAX script's configuration.
GRAPH = dict(n_proteins=19081, n_drugs=645, min_edges_per_relation=500,
             total_drugdrug_edges=4_651_131, ppi_attachment=37, seed=7)
SPLIT = dict(val_frac=0.05, test_frac=0.05, seed=1)
DEVICE_GRAPH = dict(densify_max_cells=1_000_000_000, dense_dtype=torch.bfloat16,
                    build_fused=False)
# The mask forms each --spmm reads (the JAX script builds both on one graph).
MASKS = {"dense_factored": dict(dense_factored=True),
         "paired": dict(dense_factored=True, dense_paired=True),
         "dense": {}}
TOP_N = 40


def planes(profile: Dict, device, top_n: int = TOP_N) -> Dict:
    """The JAX record's ``planes`` from ``bench.device_profile``'s rows (taken
    with ``top=None``): one timeline's ``total_ms`` over the traced steps and
    its ``top_n`` largest ``ops``, each with its self ``ms``, launches ``n``
    and ``share`` of the total (names cut to 80 characters, as the bench's
    are)."""
    steps = profile["steps"]
    total = profile["device_busy_ms_per_step"] * steps
    ops = [{"op": r["name"], "ms": r["ms_per_step"] * steps,
            "n": round(r["launches_per_step"] * steps),
            "share": r["ms_per_step"] * steps / total if total else 0.0}
           for r in profile["top"][:top_n]]
    kind = "kernels" if device.type == "cuda" else "host ops"
    return {f"{device}/{kind}": {"total_ms": total, "ops": ops}}


def profile_ops(spmm: str = "dense_factored", relations: int = 963, chunk: int = 20,
                device=None, graph_kw: Optional[Dict] = None, batch_size: int = 512) -> Dict:
    """The record; ``graph_kw`` defaults to the JAX script's graph."""
    device = resolve_device(device)
    graph_kw = dict(GRAPH, n_side_effects=relations) if graph_kw is None else graph_kw
    t0 = time.perf_counter()
    graph = make_polypharmacy_like_graph(**graph_kw)
    splits = split_graph(graph, **SPLIT)
    dg = build_device_graph(graph, splits, device=device, **DEVICE_GRAPH, **MASKS[spmm])
    hard_sync(dg.neg_cdf)
    print(f"graph built {time.perf_counter() - t0:.0f}s", flush=True)

    model = DecagonModel(ModelConfig(spmm_impl=spmm), dg)
    cfg = TrainConfig(batch_size=batch_size, scan_chunk=chunk)
    trainer = Trainer(model, graph, splits, dg, cfg, seed=0)
    batches = []
    while len(batches) < chunk * 2:
        for b in trainer.scheduler.epoch():
            batches.append(b)
            if len(batches) >= chunk * 2:
                break

    reset_peak(device)
    # Warm-up: allocator, cuBLAS and the kernels' library.
    hard_sync(trainer.train_chunk(batches[:chunk], chunk))
    hard_sync(trainer.train_chunk(batches[chunk:2 * chunk], chunk))
    print("warmed up", flush=True)
    t = time.perf_counter()
    hard_sync(trainer.train_chunk(batches[:chunk], chunk))
    wall_ms = (time.perf_counter() - t) / chunk * 1e3
    cuda_build.reset_launches()
    prof = device_profile(trainer, chunk, wall_ms, top=None, on_card=device.type == "cuda")
    traced_launches = launched()
    print("traced", flush=True)
    result = {
        "config": {"relations": relations, "spmm_impl": spmm, "scan_chunk": chunk,
                   "steps_traced": prof["steps"], "graph": graph_kw, "split": SPLIT,
                   "device_graph": dict(DEVICE_GRAPH, dense_dtype="bfloat16", **MASKS[spmm])},
        "wall_ms_per_step": wall_ms,
        "planes": planes(prof, device),
        "busy_ms_per_step": prof["device_busy_ms_per_step"],
        "idle_share": prof["idle_share"],
        "kernels_per_step": prof["kernels_per_step"],
        "launches_per_step": {k: v / prof["steps"] for k, v in traced_launches.items()},
        "peak_gib": peak_gib(device),
        **card_fields(device),
    }
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--relations", type=int, default=963)
    ap.add_argument("--spmm", default="dense_factored", choices=sorted(MASKS))
    ap.add_argument("--chunk", type=int, default=20)
    ap.add_argument("--out", default="factored_op_profile.json",
                    help="file name under artifacts/perf, prefixed with torch_")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    result = profile_ops(args.spmm, args.relations, args.chunk, args.device)
    path = args.out if os.path.dirname(args.out) else os.path.join(ART, f"torch_{args.out}")
    write_json(path, result)
    for pname, p in result["planes"].items():
        print(f"== {pname}: total {p['total_ms']:.3f} ms over {args.chunk} steps")
        for o in p["ops"][:25]:
            print(f"  {o['ms']:9.3f} ms  x{o['n']:<5d} {o['op'][:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
