"""The paper graph's stages timed apart: generation, split, device graph,
``Trainer`` set-up, the first chunk, steady chunks.

    python -m decagon_tpu_torch.scripts.probe_fullscale [--relations 963] \\
        [--proteins 19081] [--drugs 645] [--edges 4651131] [--impl auto] \\
        [--chunk 20] [--densify-max-cells 8000000] [--dense-dtype f32|bf16] \\
        [--no-tiles] [--steps 3] [--device cpu] [--out PATH]

Port of ``scripts/probe_fullscale.py``, flag for flag: the graph
(``make_polypharmacy_like_graph``, >= 500 edges a relation,
``ppi_attachment=37``, seed 7), split 5% / 5% (seed 1), the device graph
(K6's CSR layouts on the card unless ``--no-tiles``, at the dense cap
``--densify-max-cells`` in ``--dense-dtype``), hidden 64 -> 32 with dropout
0.1 at ``--impl``, the ``Trainer`` (seed 0, batch 512, lr 1e-3, chunks of
``--chunk``); the first chunk, then ``--steps`` chunks each synced: ms a
step (the fastest chunk) and edges/s (adjacency nonzeros a second).  At the
defaults every edge type is above the 8M-cell cap, so "auto" sends each
through K6.

The JAX script's ``hbm_stats`` becomes ``torch.cuda.memory_stats`` (the
allocated and reserved bytes, current and peak, in GiB) after the graph,
after the parameters and after the first chunk.  Each edge type's line
gives its relations, shape, nonzeros, padded stream length, whether it
holds a dense stack, and in place of the JAX tiles' count and occupancy
the CSR's own row statistics, forward and backward (``ops/tiling.py``'s
``tiling_stats``): K6 reads a destination-sorted CSR, not the JAX
package's C-edge tiles, by design, so tile occupancy has no counterpart.

Prints the JAX script's lines and writes them as one record,
``artifacts/perf/torch_fullscale_probe.json`` (``--out``), with the card's
``nvidia-smi`` name and power limit, the torch version and the kernels'
launches a timed step.  Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict

import torch

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.bench import graph_nnz
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.models.encoder import resolve_impl
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.ops.tiling import tiling_stats
from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts.records import card_fields, launched, per, write_json
from decagon_tpu_torch.timing import hard_sync
from decagon_tpu_torch.train.step import TrainConfig
from decagon_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "artifacts", "perf", "torch_fullscale_probe.json")
GRAPH = dict(min_edges_per_relation=500, ppi_attachment=37, seed=7)
SPLIT = dict(val_frac=0.05, test_frac=0.05, seed=1)
MEMORY_KEYS = ("allocated_bytes.all.current", "allocated_bytes.all.peak",
               "reserved_bytes.all.current", "reserved_bytes.all.peak")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--relations", type=int, default=963)
    ap.add_argument("--proteins", type=int, default=19081)
    ap.add_argument("--drugs", type=int, default=645)
    ap.add_argument("--edges", type=int, default=4_651_131)
    ap.add_argument("--impl", default="auto")
    ap.add_argument("--chunk", type=int, default=20)
    ap.add_argument("--densify-max-cells", type=int, default=8_000_000)
    ap.add_argument("--dense-dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--no-tiles", action="store_true")
    ap.add_argument("--steps", type=int, default=3, help="timed chunks")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT)
    return ap.parse_args(argv)


def hbm_stats(device) -> Dict[str, float]:
    """The card's allocated and reserved GiB, current and peak (empty off
    the card)."""
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {k: stats[k] / 2**30 for k in MEMORY_KEYS if stats.get(k)}


def probe(args, log=print) -> Dict:
    device = resolve_device(args.device)
    rec: Dict = {"config": {k: v for k, v in vars(args).items() if k != "out"}, "stages_s": {}}

    t = time.perf_counter()

    def stage(name):
        nonlocal t
        now = time.perf_counter()
        rec["stages_s"][name] = now - t
        log(f"[{now - t:8.2f}s] {name}")
        t = now

    graph = make_polypharmacy_like_graph(
        n_proteins=args.proteins, n_drugs=args.drugs, n_side_effects=args.relations,
        total_drugdrug_edges=args.edges, **GRAPH,
    )
    rec["edges_raw"] = sum(r.rows.shape[0] for rels in graph.relations.values() for r in rels)
    rec["relations"] = sum(len(rels) for rels in graph.relations.values())
    log(f"graph: {rec['relations']} relations (incl transposes), {rec['edges_raw']} edges")
    stage("synthetic graph")

    splits = split_graph(graph, **SPLIT)
    stage("split + negatives")

    dg = build_device_graph(
        graph, splits, tile_for_pallas=device.type == "cuda" and not args.no_tiles,
        densify_max_cells=args.densify_max_cells,
        dense_dtype=torch.bfloat16 if args.dense_dtype == "bf16" else torch.float32,
        device=device,
    )
    hard_sync(dg.neg_cdf)
    stage("build_device_graph")
    rec["hbm_after_graph"] = hbm_stats(device)
    log(f"HBM after graph: {rec['hbm_after_graph']}")
    rec["adj"] = {}
    for key, adj in sorted(dg.adj.items()):
        line = dict(K=adj.num_rel, n_rows=adj.n_rows, n_cols=adj.n_cols,
                    nnz=int(torch.count_nonzero(adj.vals)), pad=int(adj.vals.shape[0]),
                    dense=adj.dense is not None, aggregation=resolve_impl(adj, args.impl))
        extra = ""
        if adj.tiles_fwd is not None:
            line["csr_fwd"], line["csr_bwd"] = tiling_stats(adj.tiles_fwd), tiling_stats(
                adj.tiles_bwd)
            extra = "".join(
                f" csr_{d}: rows={s['rows']} max_row={s['max_row']} short={s['short_rows']}"
                f" long={s['long_rows']} segments={s['segments']}"
                for d, s in (("fwd", line["csr_fwd"]), ("bwd", line["csr_bwd"])))
        rec["adj"][key] = line
        log(f"  adj[{key}]: K={line['K']} {line['n_rows']}x{line['n_cols']} nnz={line['nnz']} "
            f"pad={line['pad']} dense={'yes' if line['dense'] else 'no'}{extra}")

    model = DecagonModel(ModelConfig(hidden1=64, hidden2=32, dropout=0.1, spmm_impl=args.impl),
                         dg)
    cfg = TrainConfig(batch_size=512, learning_rate=1e-3, scan_chunk=args.chunk)
    trainer = Trainer(model, graph, splits, dg, cfg, seed=0)
    hard_sync(trainer.params)
    stage("trainer init (params + opt)")
    rec["hbm_after_params"] = hbm_stats(device)
    log(f"HBM after params: {rec['hbm_after_params']}")

    batches = []
    need = args.chunk * (args.steps + 2)
    while len(batches) < need:
        for b in trainer.scheduler.epoch():
            batches.append(b)
            if len(batches) >= need:
                break
    stage(f"sampled {len(batches)} batches")

    hard_sync(trainer.train_chunk(batches[:args.chunk], args.chunk))
    stage("compile + first chunk")
    rec["hbm_after_first_step"] = hbm_stats(device)
    log(f"HBM after first step: {rec['hbm_after_first_step']}")

    nnz = graph_nnz(dg)
    cuda_build.reset_launches()
    times = []
    for i in range(args.steps):
        lo = args.chunk * (1 + i)
        start = time.perf_counter()
        trainer.train_chunk(batches[lo:lo + args.chunk], args.chunk)
        hard_sync(trainer.params)
        times.append(time.perf_counter() - start)
    per_step = min(times) / args.chunk
    rec.update(nnz=nnz, ms_per_step=per_step * 1e3, edges_per_s=nnz / per_step, times_s=times,
               launches_per_step=per(launched(), args.steps * args.chunk),
               **card_fields(device))
    log(f"steady state: {per_step * 1e3:.2f} ms/step; {nnz / per_step / 1e6:.1f}M edges/s "
        f"(times: {[round(x, 3) for x in times]})")
    return rec


def main(argv=None) -> int:
    args = parse_args(argv)
    rec = probe(args, log=lambda msg: print(msg, flush=True))
    write_json(args.out, rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
