"""Training throughput of each ``spmm_impl`` on the mid-scale
polypharmacy-like graph (2,000 proteins, 400 drugs, 50 side effects).

    python -m decagon_tpu_torch.scripts.bench_scale [n_side_effects] [impls] \\
        [--device cpu] [--out PATH]

Port of ``scripts/bench_scale.py``: the graph
(``make_polypharmacy_like_graph(2000, 400, n_side_effects, seed=7)``, default
50 side effects and their transposes), split 5% / 0% (seed 1); for each
implementation (default "xla,pallas") a device graph with the CSR layouts
of K6 when the name holds "pallas" or is "auto" (on the edge types above
the default ``densify_max_cells`` of 8M: here drug-drug), the ``Trainer``
(seed 0, batch 512, lr 1e-3, chunks of 50), one warm-up chunk and two timed
ones (one sync at the end).  Prints one JSON line per implementation with
the JAX script's fields (``impl``, ``n_side_effects``, ``nnz``, ``step_ms``,
``edges_per_s``: the graph's adjacency nonzeros over the step time,
``graph_build_s``) and the card's: the torch version, the card's
``nvidia-smi`` name and power limit, peak memory, each edge type's
aggregation form and the kernels' launches a timed step (K6's tell which
edge types went through it: one forward and one backward launch per K6
edge type and layer).

"pallas" asks K6 of every edge type, and the edge types at or below the
dense cap carry a dense stack and no CSR layout
(``decagon_tpu/graph/device.py:405``), so on this graph it raises the
JAX package's ``ValueError`` before any step, as the JAX script does; the
port records the error in that implementation's line and goes on.  "auto"
is the form that takes K6 on the drug-drug stack and the dense stacks
elsewhere.  The lines are also written, as a JSON list, to
``artifacts/perf/torch_scale_bench.json`` (``--out``).  Runs on CUDA unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

import torch

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.bench import graph_nnz
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.models.encoder import resolve_impl
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts.records import card_fields, launched, peak_gib, per, reset_peak
from decagon_tpu_torch.scripts.records import write_json
from decagon_tpu_torch.timing import hard_sync
from decagon_tpu_torch.train.step import TrainConfig
from decagon_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "artifacts", "perf", "torch_scale_bench.json")

# The JAX script's configuration.
GRAPH = dict(n_proteins=2000, n_drugs=400, seed=7)
SPLIT = dict(val_frac=0.05, test_frac=0.0, seed=1)
MODEL = dict(hidden1=64, hidden2=32, dropout=0.1)
TRAIN = dict(batch_size=512, learning_rate=1e-3)
CHUNK = 50
N_SE = 50
IMPLS = ["xla", "pallas"]
DENSIFY_MAX_CELLS = 8_000_000  # build_device_graph's default, which the JAX script keeps


def bench_impl(graph, splits, impl: str, device, n_se: int, chunk: int = CHUNK,
               densify_max_cells: int = DENSIFY_MAX_CELLS) -> Dict:
    """One implementation's line."""
    t_build = time.perf_counter()
    dg = build_device_graph(graph, splits, tile_for_pallas=("pallas" in impl or impl == "auto"),
                            densify_max_cells=densify_max_cells, device=device)
    hard_sync(dg.neg_cdf)
    build_s = time.perf_counter() - t_build
    nnz = graph_nnz(dg)
    line = {"impl": impl, "n_side_effects": n_se, "nnz": nnz, "graph_build_s": build_s}
    model = DecagonModel(ModelConfig(spmm_impl=impl, **MODEL), dg)
    cfg = TrainConfig(scan_chunk=chunk, **TRAIN)
    trainer = Trainer(model, graph, splits, dg, cfg, seed=0)
    line["aggregation"] = {key: resolve_impl(adj, impl) for key, adj in sorted(dg.adj.items())}
    batches = list(trainer.scheduler.epoch())
    while len(batches) < 3 * chunk:
        batches += list(trainer.scheduler.epoch())
    print(f"# [{impl}] device graph built ({build_s:.1f}s)", flush=True)
    reset_peak(device)
    try:
        hard_sync(trainer.train_chunk(batches[:chunk], chunk))  # warm-up
    except ValueError as exc:
        if "no tilings" not in str(exc):
            raise
        # The JAX package raises the same error before any step.
        line.update(step_ms=None, edges_per_s=None, error=f"ValueError: {exc}")
        return line
    n_timed = 2 * chunk
    cuda_build.reset_launches()
    start = time.perf_counter()
    for i in range(chunk, chunk + n_timed, chunk):
        trainer.train_chunk(batches[i:i + chunk], chunk)
    hard_sync(trainer.params)
    step_ms = (time.perf_counter() - start) / n_timed * 1e3
    line.update(step_ms=step_ms, edges_per_s=nnz / step_ms * 1e3,
                launches_per_step=per(launched(), n_timed), peak_gib=peak_gib(device))
    return line


def bench_scale(n_se: int = N_SE, impls: Optional[List[str]] = None, device=None,
                graph_kw: Optional[Dict] = None, chunk: int = CHUNK,
                densify_max_cells: int = DENSIFY_MAX_CELLS) -> List[Dict]:
    """Every implementation's line; ``graph_kw`` defaults to the JAX
    script's graph (a small graph's edge types all fall under the default
    dense cap: tests lower it to run K6)."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    graph = make_polypharmacy_like_graph(n_side_effects=n_se, **(graph_kw or GRAPH))
    print(f"# graph built ({time.perf_counter() - t0:.1f}s)", flush=True)
    splits = split_graph(graph, **SPLIT)
    print(f"# splits done ({time.perf_counter() - t0:.1f}s)", flush=True)
    card = card_fields(device)
    lines = []
    for impl in impls or IMPLS:
        line = dict(bench_impl(graph, splits, impl, device, n_se, chunk, densify_max_cells),
                    **card)
        print(json.dumps(line), flush=True)
        lines.append(line)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_side_effects", nargs="?", type=int, default=N_SE)
    ap.add_argument("impls", nargs="?", default=",".join(IMPLS))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    lines = bench_scale(args.n_side_effects, args.impls.split(","), args.device)
    write_json(args.out, lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
