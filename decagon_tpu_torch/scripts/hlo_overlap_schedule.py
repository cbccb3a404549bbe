"""The overlap path's issue schedule: which forward collectives one rank
starts asynchronously, and how much compute it issues while each is in
flight, with ``comm_overlap`` on and off.

    python -m decagon_tpu_torch.scripts.hlo_overlap_schedule [--device cpu] [--out PATH]

Port of ``scripts/hlo_overlap_schedule.py``.  The JAX script compiles the
weight-sharded train step on an 8-device CPU (4, 2) mesh with overlap on and
off and walks XLA's optimized schedule for async ``-start`` / ``-done`` pairs
and the compute ops scheduled between them.  The port has no compiled
program: its counterpart of the schedule is the order in which rank 0
issues its work in one training step, and that order is the port's own
(``parallel/sharded.py``'s ``encode_sharded``, ``parallel/collectives.py``'s
``Pending`` and ``Collective.start``).  The step runs under
``collectives.inventory(clock)``: each forward collective is recorded as
started asynchronously (a real ``Work`` added to a ``Pending``) or not (a
synchronous call, or one staged through the host: a CUDA tensor under
gloo), and ``clock`` counts the compute operations the rank has issued, so
that a pair's ``ops_between`` is what it issued between the start and the
``Pending.wait()`` that ends it.  The operations counted: aten matrix
products, gathers and scatters, seen through a ``TorchDispatchMode``
(``COUNTED``), and launches of the port's own kernels
(``ops/cuda_build.LAUNCHES``).

The JAX script's configuration: ``make_polypharmacy_like_graph(600 proteins,
200 drugs, 12 side effects, planted_rank=8, seed=7)``, split 0.1 / 0.0 (seed
8), hidden 32 -> 16, batch 128, the weight-sharded step, a (4, 2) mesh,
``comm_overlap`` on and off, one step on the first batch of relation (1, 1,
0) (numpy seed 0).  The worlds (``scripts/worlds.py``, one process a rank):
8 gloo ranks on ``cuda:0`` (every collective staged through the host),
8 gloo ranks on the CPU (``--device cpu``; also run on the card's machine,
where gloo's CPU collectives are asynchronous), and on the card a (1, 1)
NCCL mesh, the one place on one card where the starts are asynchronous on
the device: groups of one rank still issue their collectives.

Prediction (from the code, written before the first run): the graph has
four edge types, so with overlap on under an asynchronous backend each
layer has four edge-sum pairs (``all-reduce``) and four row-gather pairs
(``all-gather``): 16 pairs a step.  Every edge type's edge sum is started
while the next edge types' projections and aggregations are issued, so all
but the last of a layer's edge sums have compute between (6 a step); the
gathers are all issued together and waited for at once, so none has.  A
layer-1 edge type issues one counted operation (its aggregation; identity
features need no product), a layer-2 one at least two (the projection and
the aggregation); a layer's spans hold 3 + 2 + 1 edge types' work, so
``total_compute_ops_inside_spans`` >= 6 * 1 + 6 * 2 = 18.  With overlap off there are no
pairs; under staged gloo (CUDA tensors) there are none either way, as
XLA:CPU had none.  Overlap on and off give the same loss.

Measured (NVIDIA H100 80GB HBM3, 700.00 W, torch 2.11.0+cu128): as
predicted in every world.  The 8-rank gloo world on ``cuda:0``: 0 pairs on
and off (every collective staged).  The 8-rank gloo world on the CPU and
the (1, 1) NCCL mesh, overlap on: 16 pairs (8 ``all-reduce``, 8
``all-gather``), 6 with compute between, 18 counted operations inside the
spans (the edge sums' spans hold 3, 2, 1, 0 operations in layer 1 and 6,
4, 2, 0 in layer 2; every gather 0), of 36-37 issued in the step; off, 0.
Equal losses on and off in each world.

Writes ``artifacts/perf/torch_hlo_overlap_schedule.json`` (``--out``), with
the card's name and power limit.  Runs its ranks on CUDA unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts import worlds
from decagon_tpu_torch.scripts.records import card_fields, launched, write_json

MODULE = "decagon_tpu_torch.scripts.hlo_overlap_schedule"
OUT = os.path.join(worlds.ROOT, "artifacts", "perf", "torch_hlo_overlap_schedule.json")

# The JAX script's configuration.
GRAPH = dict(n_proteins=600, n_drugs=200, n_side_effects=12, seed=7, planted_rank=8)
SPLIT = dict(val_frac=0.1, test_frac=0.0, seed=8)
MODEL = dict(hidden1=32, hidden2=16)
BATCH = 128
SHAPE = (4, 2)
EDGE_TYPE, K = (1, 1), 0

# The aten operations the clock counts (``func.overloadpacket`` names, a
# trailing "_" dropped), by kind.
COUNTED = {
    "matrix product": ("mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "dot", "matmul"),
    "gather": ("index_select", "gather", "index", "embedding", "take"),
    "scatter": ("index_add", "scatter", "scatter_add", "scatter_reduce", "index_put",
                "_index_put_impl", "embedding_dense_backward"),
}
_KIND = {name: kind for kind, names in COUNTED.items() for name in names}
COUNTED_BY = ("a TorchDispatchMode over the rank's aten calls (matrix products, gathers, "
              "scatters: COUNTED) plus launches of the port's own kernels "
              "(ops/cuda_build.LAUNCHES)")


class OpClock(TorchDispatchMode):
    """Counts the compute operations a rank issues (``COUNTED`` and the
    port's kernel launches); ``__call__`` reads the count."""

    def __init__(self):
        super().__init__()
        self.ops: Counter = Counter()

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # A private hook of ``TorchDispatchMode``, checked against torch
        # 2.11 (the card's 2.11.0+cu128 and the CPU build).  Nothing under
        # the clock is compiled: ``__torch_dispatch__`` stays unwrapped, so
        # its first call does not import ``torch._dynamo`` (~2 s a process
        # on the CPU, ~15 s in four ranks on the card).
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__.rstrip("_") or func.overloadpacket.__name__
        if name in _KIND:
            self.ops[name] += 1
        return func(*args, **(kwargs or {}))

    def __call__(self) -> int:
        return sum(self.ops.values()) + sum(cuda_build.LAUNCHES.values())


def first_batch(splits, batch_size: int) -> np.ndarray:
    train = splits[EDGE_TYPE + (K,)].train
    return train[np.random.default_rng(0).integers(0, len(train), batch_size)]


def schedule(calls: List[Dict]) -> Dict:
    """The JAX script's fields from one step's inventory: the forward
    collectives started asynchronously and waited for (the pairs), those
    with compute issued between start and wait, the compute inside the
    spans, the pairs by kind; every pair's span, the staged and
    synchronous calls apart; and the asynchronous starts no
    ``Pending.wait()`` ended (a fault of the overlap path: its result was
    read, or dropped, before the collective finished)."""
    spans = [{"kind": c["kind"], "group": c["group"],
              "ops_between": c["waited_at"] - c["issued_at"]}
             for c in calls if c["async"] and "waited_at" in c]
    unwaited = [c["kind"] for c in calls if c["async"] and "waited_at" not in c]
    return {
        "async_collective_pairs": len(spans),
        "pairs_with_compute_between": sum(1 for s in spans if s["ops_between"] > 0),
        "total_compute_ops_inside_spans": sum(s["ops_between"] for s in spans),
        "by_kind": dict(Counter(s["kind"] for s in spans)),
        "spans": spans,
        "synchronous_collectives": dict(Counter(c["kind"] for c in calls if not c["async"])),
        "async_never_waited": dict(Counter(unwaited)),
    }


def rank_main(rank: int, n_ranks: int, port: int, nr: int, ne: int, overlap: bool,
              device: str = "cuda", backend: str = "gloo", graph_kw: Optional[Dict] = None,
              batch_size: int = BATCH, threads: int = 1) -> Dict:
    """One rank of a ``(nr, ne)`` world: one weight-sharded step under the
    clocked inventory; its schedule, the operations it issued in the step
    (by name), its loss (the mesh's sum) and the kernels' launches."""
    from decagon_tpu_torch.parallel import collectives
    from decagon_tpu_torch.parallel.mesh import make_mesh, mesh_groups
    from decagon_tpu_torch.scripts.multihost_bench import mesh_setup, world
    from decagon_tpu_torch.train.step import TrainConfig, step_generator

    torch.set_num_threads(threads)
    dev = worlds.rank_device(device)
    created = worlds.join_group(rank, n_ranks, port, backend=backend)
    try:
        graph, splits = world(GRAPH if graph_kw is None else graph_kw, SPLIT)
        cfg = TrainConfig(batch_size=batch_size, comm_overlap=bool(overlap))
        mesh = make_mesh(shape=(nr, ne), backend=backend)
        sg, model, params, local, state, step = mesh_setup(
            graph, splits, mesh, (nr, ne), dev, MODEL, cfg)
        b = first_batch(splits, batch_size)
        rows, cols = (torch.from_numpy(b[:, c]).to(dev) for c in (0, 1))
        cuda_build.reset_launches()
        clock = OpClock()
        with clock, collectives.inventory(clock) as calls:
            _, _, loss = step(local, state, sg, K, rows, cols, step_generator(0, 0, dev))
            loss = float(loss)
        row_g, edge_g = mesh_groups(mesh)
        names = {id(row_g): "row", id(edge_g): "edge", id(None): "world"}
        calls = [dict(c, group=names[id(c["group"])]) for c in calls]
        return dict(schedule(calls), pid=rank, loss=loss,
                    ops_issued_in_step=clock(), ops_by_name=dict(clock.ops),
                    launches=launched(), staged=bool(dev.type == "cuda" and backend == "gloo"),
                    edge_types=[list(et) for et in sg.edge_types])
    finally:
        worlds.leave_group(created)


def variant(results: Dict[int, Dict]) -> Dict:
    """A world's entry from its ranks: rank 0's schedule, with the mesh's
    loss every rank agrees on and each rank's K7 launches; raises if any
    rank left an asynchronous start unwaited."""
    worlds.agree(results, "loss")
    unwaited = {r: x["async_never_waited"] for r, x in results.items() if x["async_never_waited"]}
    if unwaited:
        raise RuntimeError(f"asynchronous starts no Pending.wait() ended, by rank: {unwaited}")
    return dict(results[0], adam_launches_per_rank=[results[r]["launches"].get("adam", 0)
                                                    for r in sorted(results)])


def run(nr: int, ne: int, overlap: bool, device: str, backend: str) -> Dict:
    return variant(worlds.run_world(MODULE, nr * ne, dict(nr=nr, ne=ne, overlap=overlap,
                                                          device=device, backend=backend)))


def world_entry(nr: int, ne: int, device: str, backend: str) -> Dict:
    """Overlap on and off in one kind of world; their losses must agree."""
    out = {"mesh": [nr, ne], "backend": backend, "device": device,
           "overlap_on": run(nr, ne, True, device, backend),
           "overlap_off": run(nr, ne, False, device, backend)}
    out["on_off_loss_equal"] = out["overlap_on"]["loss"] == out["overlap_off"]["loss"]
    return out


def hlo_overlap_schedule(device: str = "cuda", log=print) -> Dict:
    """The record: the ``SHAPE`` gloo world on ``device`` (its entries also
    under the JAX keys), and on the card a gloo world on the CPU and the
    (1, 1) NCCL mesh."""
    dev = worlds.rank_device(device)
    if dev.type == "cuda":
        cuda_build.library()  # built once, before the ranks load it
    t0 = time.perf_counter()
    nr, ne = SHAPE
    runs = {f"gloo_{dev.type}_{nr}x{ne}": (nr, ne, device, "gloo")}
    if dev.type == "cuda":
        runs[f"gloo_cpu_{nr}x{ne}"] = (nr, ne, "cpu", "gloo")
        runs["nccl_cuda_1x1"] = (1, 1, device, "nccl")
    out = {"config": (f"{GRAPH['n_proteins']} prot / {GRAPH['n_drugs']} drugs / "
                      f"{GRAPH['n_side_effects']} rels, ({nr},{ne}) mesh of {nr * ne} ranks, "
                      "weight-sharded step, one step"),
           "counted_by": COUNTED_BY, **card_fields(dev), "worlds": {}}
    for tag, (a, b, d, backend) in runs.items():
        out["worlds"][tag] = world_entry(a, b, d, backend)
        on = out["worlds"][tag]["overlap_on"]
        log(f"[hlo +{time.perf_counter() - t0:.0f}s] {tag}: overlap on "
            f"{on['async_collective_pairs']} pairs, {on['pairs_with_compute_between']} with "
            f"compute between, {on['total_compute_ops_inside_spans']} ops inside")
    primary = out["worlds"][next(iter(runs))]
    for key in ("overlap_on", "overlap_off"):
        out[key] = {k: primary[key][k] for k in (
            "async_collective_pairs", "pairs_with_compute_between",
            "total_compute_ops_inside_spans", "by_kind", "ops_issued_in_step")}
    out["finding"] = {tag: {v: w[v]["async_collective_pairs"] for v in ("overlap_on",
                                                                        "overlap_off")}
                      for tag, w in out["worlds"].items()}
    out["note"] = (
        "ops_issued_in_step stands in place of the JAX record's hlo_total_lines: the counted "
        "compute operations rank 0 issued in the step (no compiled program exists). Pairs are "
        "forward collectives started with async_op and ended by Pending.wait(); backward "
        "collectives and the gradient reduction run synchronously. Under gloo a CUDA tensor "
        "goes through the host synchronously (collectives._staged), so a gloo world on the "
        "card has no pairs whatever comm_overlap says.")
    out["wall_s"] = round(time.perf_counter() - t0, 1)
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    out = hlo_overlap_schedule(args.device)
    write_json(args.out, out)
    print(json.dumps({k: out[k] for k in ("overlap_on", "overlap_off", "finding")}))
    print("wrote", args.out)
    return out


if __name__ == "__main__":
    if worlds.is_worker(sys.argv[1:]):
        worlds.worker(rank_main, sys.argv[2])
    else:
        main()
