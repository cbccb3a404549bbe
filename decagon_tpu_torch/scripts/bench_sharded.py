"""Sharded-step throughput against the single device on the same workload.

    python -m decagon_tpu_torch.scripts.bench_sharded [--device cpu] [--full] [--out PATH]

Port of ``scripts/bench_sharded.py``.  The default run, on poly50 (2,000
proteins, 400 drugs, 50 side effects, seed 7; split 5% / 5%, seed 1; dense
stacks up to 4*10^8 cells on both sides, no fused stream), hidden 64 -> 32,
dropout 0.1, batch 512, lr 1e-3, ``spmm_impl="auto"``:

* the single-device ``Trainer``: ``pipelined_ms`` (60 steps back to back
  after 10, one sync at the end), ``synced_ms`` (the median of 20 steps
  each synced, after 4) and, with ``scan_chunk=16``, ``chunked_ms`` (6
  chunks of 16 after 2);
* the mesh ``Trainer`` from a copy of the single one's state, the same
  three: on the card the (1, 1) mesh, one rank over NCCL in this process
  (the sharding machinery with no partitioning); with ``--device cpu``
  gloo worlds of (1, 8) and (2, 4) ranks, one process a rank, as the JAX
  CPU run's virtual meshes (each rank times its own ``Trainer``; the
  slowest rank's time is the mesh's).

``--full``: the paper graph (19,081 / 645 / 963, 4,651,131 drug-drug edges,
``ppi_attachment=37``, seed 7; split 5% / 5%, seed 1), bf16 dense stacks up
to 10^9 cells, chunks of 16 (3 timed) on the single device and on the
(1, 1) NCCL mesh, the sharded ``Trainer`` from a copy of the single one's
state, merged into the record's ``fullscale_963rel`` entry in two steps
(the single half first).

Each timing resets the kernels' launch counts: K7 launches once a step in
every trainer on the card (``launches_per_step``).  Beside the JAX fields
the record holds ``first_step_loss``: one step of the single and of each
mesh ``Trainer`` on the same batch and the same injected draws
(``multihost_bench.draws``), which must agree.  Writes
``artifacts/perf/torch_sharded_bench_cuda.json`` (or ``_cpu``; ``--out``),
merging its keys into what is there.  Runs on CUDA unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts import multihost_bench as mb
from decagon_tpu_torch.scripts import worlds
from decagon_tpu_torch.scripts.records import card_fields, launched, merge_entry, per
from decagon_tpu_torch.timing import hard_sync
from decagon_tpu_torch.train.step import TrainConfig, step_generator
from decagon_tpu_torch.train.trainer import Trainer

MODULE = "decagon_tpu_torch.scripts.bench_sharded"
ART = os.path.join(worlds.ROOT, "artifacts", "perf")

# The JAX script's configuration.
GRAPH = dict(n_proteins=2000, n_drugs=400, n_side_effects=50, seed=7)
SPLIT = dict(val_frac=0.05, test_frac=0.05, seed=1)
DENSIFY = 400_000_000
TRAIN = dict(batch_size=512, learning_rate=1e-3)
CHUNK = 16
PAPER = dict(n_proteins=19081, n_drugs=645, n_side_effects=963, min_edges_per_relation=500,
             total_drugdrug_edges=4_651_131, ppi_attachment=37, seed=7)
FULL_DENSIFY = 1_000_000_000
FULL_CHUNKS = 3
CPU_SHAPES = [(1, 8), (2, 4)]
# (steps, warmup) of pipelined_ms and synced_ms, (chunk, n_chunks) of chunked_ms.
TIMING = {"pipelined": (60, 10), "synced": (20, 4), "chunked": (CHUNK, 6)}


def out_path(device: torch.device) -> str:
    return os.path.join(ART, f"torch_sharded_bench_{'cuda' if device.type == 'cuda' else 'cpu'}"
                             ".json")


def _batches(trainer, n: int) -> list:
    batches = []
    while len(batches) < n:
        batches.extend(itertools.islice(trainer.scheduler.epoch(), n - len(batches)))
    return batches


def pipelined_ms(trainer, steps: int = 60, warmup: int = 10) -> Tuple[float, Dict]:
    """Steady-state ms a step: back-to-back steps, one sync at the end; and
    the kernels' launches a timed step."""
    batches = _batches(trainer, warmup + steps)
    for b in batches[:warmup]:
        trainer.train_batch(b)
    hard_sync(trainer.params)
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    for b in batches[warmup: warmup + steps]:
        trainer.train_batch(b)
    hard_sync(trainer.params)
    return (time.perf_counter() - t0) / steps * 1e3, per(launched(), steps)


def synced_ms(trainer, steps: int = 20, warmup: int = 4) -> Tuple[float, Dict]:
    """Per-step-synced latency, the median (a diagnostic: includes the
    host's dispatch and the read-back)."""
    batches = _batches(trainer, warmup + steps)
    for b in batches[:warmup]:
        trainer.train_batch(b)
    hard_sync(trainer.params)
    cuda_build.reset_launches()
    times = []
    for b in batches[warmup: warmup + steps]:
        t0 = time.perf_counter()
        trainer.train_batch(b)
        hard_sync(trainer.params)
        times.append(time.perf_counter() - t0)
    return float(np.median(times) * 1e3), per(launched(), steps)


def chunked_ms(trainer, chunk: int = CHUNK, n_chunks: int = 6) -> Tuple[float, Dict]:
    """ms a step through the chunked path (one ``train_chunk`` a chunk),
    after 2 warm-up chunks."""
    batches = _batches(trainer, chunk * (n_chunks + 2))
    for i in range(2):
        trainer.train_chunk(batches[i * chunk: (i + 1) * chunk], chunk)
    hard_sync(trainer.params)
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    for i in range(2, 2 + n_chunks):
        trainer.train_chunk(batches[i * chunk: (i + 1) * chunk], chunk)
    hard_sync(trainer.params)
    return (time.perf_counter() - t0) / (n_chunks * chunk) * 1e3, per(launched(), n_chunks * chunk)


def first_loss(trainer, draw_params, draw_graph, model) -> float:
    """The loss of one step of a fresh ``trainer``'s step on its first
    scheduled batch (the same in every process), with the injected draws of
    step 0, on copies of its state."""
    cfg = trainer.config
    batch = next(iter(trainer.scheduler.epoch()))
    bits, u = mb.draws(draw_params, draw_graph, model, cfg, 0)
    dev = trainer.device_graph.device
    rows = torch.from_numpy(batch.rows).to(dev)
    cols = torch.from_numpy(batch.cols).to(dev)
    step = trainer.steps[batch.edge_type]
    _, _, loss = step(copy.deepcopy(trainer.params), copy.deepcopy(trainer.opt_state),
                      trainer.device_graph, batch.k, rows, cols, step_generator(0, 0, dev),
                      layer_bits=bits, neg_u=u)
    return float(loss)


def time_trainers(make: Callable, tag: str, timing: Dict, result: Dict, launches: Dict,
                  reference_ms: Optional[float] = None):
    """The three timings of ``make(cfg)``'s trainers, into ``result`` under
    ``tag`` (JAX field names) and ``launches``; returns the unchunked
    trainer."""
    steps, warm = timing["pipelined"]
    t = make(TrainConfig(**TRAIN))
    ms, launches[f"{tag}_pipelined"] = pipelined_ms(t, steps, warm)
    result[f"{tag}_ms_per_step"] = round(ms, 3)
    if reference_ms is not None:
        result[f"{tag}_vs_single"] = round(ms / reference_ms, 3)
    steps, warm = timing["synced"]
    ms, launches[f"{tag}_synced"] = synced_ms(t, steps, warm)
    result[f"{tag}_ms_per_step_synced"] = round(ms, 3)
    chunk, n_chunks = timing["chunked"]
    t_c = make(TrainConfig(**TRAIN, scan_chunk=chunk))
    ms, launches[f"{tag}_chunk16"] = chunked_ms(t_c, chunk, n_chunks)
    result[f"{tag}_chunk16_ms_per_step"] = round(ms, 3)
    if reference_ms is not None:
        result[f"{tag}_chunk16_vs_single"] = round(ms / reference_ms, 3)
    return t


def _world(graph_kw: Optional[Dict]):
    return mb.world(GRAPH if graph_kw is None else graph_kw, SPLIT)


def bench_mesh(shape, graph, splits, model_kw: Dict, device, init_state, timing: Dict,
               reference_ms: float, backend: str) -> Dict:
    """In a process group of ``shape``'s size: the mesh ``Trainer``'s three
    timings from ``init_state``, its launches a step and its first-step
    loss (``first_loss``)."""
    from decagon_tpu_torch.parallel.mesh import make_mesh, mesh_slot
    from decagon_tpu_torch.parallel.rowshard import build_sharded_device_graph

    mesh = make_mesh(shape=shape, backend=backend)
    # The single device's densify budget: otherwise the sharded step takes
    # the COO stream on edge types the single device densifies.
    sg = build_sharded_device_graph(graph, splits, shape, mesh_slot(mesh), device,
                                    densify_max_cells_per_device=DENSIFY)
    model = DecagonModel(ModelConfig(**model_kw), sg)
    tag = f"sharded_{shape[0]}x{shape[1]}"
    result, launches = {}, {}

    def make(cfg):
        # A fresh copy of the state for each trainer.
        return Trainer(model, graph, splits, sg, cfg, seed=0, mesh=mesh,
                       init_state=copy.deepcopy(init_state))

    full = copy.deepcopy(init_state["params"])
    result["first_step_loss"] = first_loss(make(TrainConfig(**TRAIN)), full, sg, model)
    time_trainers(make, tag, timing, result, launches, reference_ms)
    result["launches_per_step"] = launches
    return result


def rank_main(rank: int, n_ranks: int, port: int, nr: int, ne: int, device: str,
              state_path: str, reference_ms: float, graph_kw: Optional[Dict] = None,
              model_kw: Optional[Dict] = None, timing: Optional[Dict] = None,
              threads: Optional[int] = None) -> Dict:
    """One rank of a CPU mesh world: ``bench_mesh`` from the single
    ``Trainer``'s saved state (``state_path``)."""
    torch.set_num_threads(threads or max(1, (os.cpu_count() or 1) // n_ranks))
    dev = worlds.rank_device(device)
    created = worlds.join_group(rank, n_ranks, port)
    try:
        graph, splits = _world(graph_kw)
        state = torch.load(state_path, map_location=dev, weights_only=False)
        return bench_mesh((nr, ne), graph, splits, model_kw or {}, dev, state,
                          {k: tuple(v) for k, v in (timing or TIMING).items()}, reference_ms,
                          "gloo")
    finally:
        worlds.leave_group(created)


def bench(device="cuda", graph_kw: Optional[Dict] = None, model_kw: Optional[Dict] = None,
          timing: Dict = TIMING, shapes: Optional[List[Tuple[int, int]]] = None,
          log: Callable = print) -> Dict:
    """The default run's record (``graph_kw``, ``model_kw``, ``timing`` cut
    it for tests).  On the card the (1, 1) mesh joins this process's group
    when it has one (a world of one NCCL rank), else makes one."""
    device = worlds.rank_device(device)
    if device.type == "cuda":
        cuda_build.library()
    model_kw = dict({"spmm_impl": "auto"}, **(model_kw or {}))
    graph, splits = _world(graph_kw)
    dg = build_device_graph(graph, splits, densify_max_cells=DENSIFY, build_fused=False,
                            device=device)
    model = DecagonModel(ModelConfig(**model_kw), dg)
    if shapes is None:
        shapes = [(1, 1)] if device.type == "cuda" else CPU_SHAPES
    result = {"backend": device.type, "devices": max(nr * ne for nr, ne in shapes),
              **card_fields(device)}
    launches: Dict = {}
    t = time_trainers(lambda cfg: Trainer(model, graph, splits, dg, cfg, seed=0), "single",
                      timing, result, launches)
    log(f"[bench_sharded] single: {result['single_ms_per_step']:.3f} ms a step")
    # The mesh trainers start from the single one's state (the JAX script's
    # copy), and so does the single process's first step.
    state = copy.deepcopy(t.state_dict())
    del t
    result["first_step_loss"] = {"single": first_loss(
        Trainer(model, graph, splits, dg, TrainConfig(**TRAIN), seed=0,
                init_state=copy.deepcopy(state)), state["params"], dg, model)}
    for shape in shapes:
        tag = f"sharded_{shape[0]}x{shape[1]}"
        if device.type == "cuda":
            if shape != (1, 1):
                raise ValueError("one card: only the (1, 1) NCCL mesh (NCCL cannot place two "
                                 "ranks on one card)")
            created = worlds.join_group(0, 1, worlds.free_port(), backend="nccl")
            try:
                r = bench_mesh(shape, graph, splits, model_kw, device, state, timing,
                               result["single_ms_per_step"], "nccl")
            finally:
                worlds.leave_group(created)
        else:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "state.pt")
                torch.save(state, path)
                ranks = worlds.run_world(MODULE, shape[0] * shape[1], dict(
                    nr=shape[0], ne=shape[1], device=str(device), state_path=path,
                    reference_ms=result["single_ms_per_step"], graph_kw=graph_kw,
                    model_kw=model_kw, timing=timing))
            r = {k: max(ranks[i][k] for i in ranks) for k in ranks[0]
                 if k.endswith("ms_per_step") or k.endswith("_synced") or k.endswith("_single")}
            r["first_step_loss"] = worlds.agree(ranks, "first_step_loss")
            r["launches_per_step"] = ranks[0]["launches_per_step"]
        result["first_step_loss"][tag] = r.pop("first_step_loss")
        launches.update(r.pop("launches_per_step"))
        result.update(r)
        log(f"[bench_sharded] {tag}: {result[f'{tag}_ms_per_step']:.3f} ms a step")
    fl = result["first_step_loss"]
    result["first_step_loss"]["max_abs_diff"] = max(abs(v - fl["single"]) for k, v in fl.items()
                                                    if k != "single")
    result["launches_per_step"] = launches
    return result


def bench_fullscale_sharded(device="cuda", graph_kw: Dict = PAPER, chunk: int = CHUNK,
                            n_chunks: int = FULL_CHUNKS, out: Optional[str] = None,
                            log: Callable = print) -> Dict:
    """The paper-scale entry: the single device's chunked step and the
    (1, 1) NCCL mesh's, bf16 dense stacks both; merged into ``out`` under
    ``fullscale_963rel`` (the single half first)."""
    from decagon_tpu_torch.bench import graph_nnz

    device = worlds.rank_device(device)
    if device.type != "cuda":
        raise ValueError("--full runs the (1, 1) NCCL mesh: it needs the card")
    cuda_build.library()
    out = out or out_path(device)
    graph, splits = mb.world(graph_kw, SPLIT)
    dg = build_device_graph(graph, splits, densify_max_cells=FULL_DENSIFY,
                            dense_dtype=torch.bfloat16, build_fused=False, device=device)
    model = DecagonModel(ModelConfig(spmm_impl="auto"), dg)
    cfg = TrainConfig(**TRAIN, scan_chunk=chunk)
    nnz = graph_nnz(dg)
    single = Trainer(model, graph, splits, dg, cfg, seed=0)
    single_ms, single_launches = chunked_ms(single, chunk, n_chunks)
    entry = {"nnz": nnz, "single_chunk16_ms_per_step": round(single_ms, 3),
             "single_launches_per_step": single_launches, **card_fields(device)}
    # Incremental save: the single half survives a failing mesh half.
    merge_entry(out, "fullscale_963rel", entry, update=True)
    log(f"[bench_sharded --full] single chunk16: {single_ms:.3f} ms a step")
    state = copy.deepcopy(single.state_dict())
    del single, dg
    torch.cuda.empty_cache()

    from decagon_tpu_torch.parallel.mesh import make_mesh
    from decagon_tpu_torch.parallel.rowshard import build_sharded_device_graph

    created = worlds.join_group(0, 1, worlds.free_port(), backend="nccl")
    try:
        mesh = make_mesh(shape=(1, 1), backend="nccl")
        sg = build_sharded_device_graph(graph, splits, (1, 1), 0, device,
                                        densify_max_cells_per_device=FULL_DENSIFY,
                                        dense_dtype=torch.bfloat16)
        st = Trainer(DecagonModel(ModelConfig(spmm_impl="auto"), sg), graph, splits, sg, cfg,
                     seed=0, mesh=mesh, init_state=state)
        sharded_ms, sharded_launches = chunked_ms(st, chunk, n_chunks)
    finally:
        worlds.leave_group(created)
    entry.update({
        "sharded_1x1_chunk16_ms_per_step": round(sharded_ms, 3),
        "sharded_vs_single": round(sharded_ms / single_ms, 3),
        "sharded_edges_per_s": round(nnz / (sharded_ms / 1e3), 1),
        "sharded_launches_per_step": sharded_launches,
    })
    merge_entry(out, "fullscale_963rel", entry, update=True)
    log(json.dumps(entry, indent=1))
    return entry


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.full:
        return bench_fullscale_sharded(args.device, out=args.out)
    result = bench(args.device)
    out = args.out or out_path(torch.device(args.device))
    merge_entry(out, None, result)
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    if worlds.is_worker(sys.argv[1:]):
        worlds.worker(rank_main, sys.argv[2])
    else:
        main()
