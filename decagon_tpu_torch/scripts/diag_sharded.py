"""Split the (1, 1) mesh's overhead over the single device by ablation.

    python -m decagon_tpu_torch.scripts.diag_sharded [--device cpu] [--out PATH]

Port of ``scripts/diag_sharded.py``: on ``bench_sharded``'s workload
(poly50, split seed 1, dense stacks up to 4*10^8 cells, ``spmm_impl="auto"``,
batch 512), matched ablations of the single device and the (1, 1) mesh
(one rank over NCCL on the card, over gloo with ``--device cpu``), each
``timeit``'s mean of 20 calls after 3, one sync at the end:

* ``*_step_ms``: the full ``Trainer`` step on one batch (the mesh's from a
  copy of the single one's state);
* ``*_embed_ms``: the deterministic encoder forward (the model's
  ``embeddings``; the mesh's ``embed_fn``);
* ``*_embed_dropout_ms``: the encoder forward with dropout (the mesh's
  ``encode_sharded`` with its relation-sharded keys).

The JAX script's ``*_cost`` hold XLA's ``cost_analysis`` of each step; the
port has no compiled program and fills the same keys with what one step
shows: ``flops`` from ``torch.utils.flop_counter.FlopCounterMode`` (the
matrix products of the forward and backward; K7 and the collectives are
not counted), ``bytes accessed`` and ``transcendentals`` null with the
reason, and, from one step under ``torch.profiler`` (device activity only),
the device's busy ms and kernel launches (``device_busy_ms``, ``kernels``;
null off the card).  ``launches_per_call``: the hand-written kernels of
each timed call (K7 once a step on the card).  Prints one JSON object, and
writes it to ``artifacts/perf/torch_diag_sharded.json`` (``--out``).  Runs
on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time
from typing import Callable, Dict, Optional

import torch

from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts import bench_sharded as bs
from decagon_tpu_torch.scripts import worlds
from decagon_tpu_torch.scripts.records import card_fields, launched, per, write_json
from decagon_tpu_torch.timing import hard_sync
from decagon_tpu_torch.train.step import TrainConfig, make_generator
from decagon_tpu_torch.train.trainer import Trainer

OUT = os.path.join(bs.ART, "torch_diag_sharded.json")
N, WARMUP = 20, 3
NO_BYTES = ("not measured: no compiled program reports the bytes a step moves; a kernel-level "
            "count needs a hardware profiler (ncu)")
NO_TRANSCENDENTALS = "not counted: FlopCounterMode counts matrix products only"


def timeit(fn: Callable, n: int = N, warmup: int = WARMUP):
    """Mean ms of ``fn()`` over ``n`` calls after ``warmup``, one sync at the
    end (``fn`` returns what to wait for), and its kernels' launches a
    call."""
    out = None
    for _ in range(warmup):
        out = fn()
    hard_sync(out)
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    hard_sync(out)
    return (time.perf_counter() - t0) / n * 1e3, per(launched(), n)


def step_cost(fn: Callable, on_card: bool) -> Dict:
    """The ``*_cost`` entry of one call of ``fn``: its matrix-product flops
    and, on the card, the device's busy ms and kernel launches."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        hard_sync(fn())
    cost = {"flops": float(counter.get_total_flops()), "bytes accessed": None,
            "bytes_accessed_reason": NO_BYTES, "transcendentals": None,
            "transcendentals_reason": NO_TRANSCENDENTALS, "device_busy_ms": None,
            "kernels": None}
    if on_card:
        from decagon_tpu_torch.bench import profile_call

        prof = profile_call(fn, 1, 1.0, top=None)
        cost["device_busy_ms"] = prof["device_busy_ms_per_step"]
        cost["kernels"] = prof["kernels_per_step"]
    return cost


def diag(device="cuda", graph_kw: Optional[Dict] = None, n: int = N, warmup: int = WARMUP,
         backend: Optional[str] = None, profile: bool = True) -> Dict:
    """The record (``graph_kw``, ``n``, ``warmup`` cut it for tests).  The
    (1, 1) mesh joins this process's group when it has one.  ``profile``:
    the ``*_cost`` entries' profiled step on the card (its first use in a
    process costs seconds of set-up)."""
    from decagon_tpu_torch.parallel.mesh import make_mesh
    from decagon_tpu_torch.parallel.rowshard import build_sharded_device_graph
    from decagon_tpu_torch.parallel.sharded import encode_sharded, shardable_weight_keys

    device = worlds.rank_device(device)
    on_card = device.type == "cuda"
    if on_card:
        cuda_build.library()
    backend = backend or ("nccl" if on_card else "gloo")
    graph, splits = bs._world(graph_kw)
    dg = build_device_graph(graph, splits, densify_max_cells=bs.DENSIFY, build_fused=False,
                            device=device)
    model = DecagonModel(ModelConfig(spmm_impl="auto"), dg)
    cfg = TrainConfig(**bs.TRAIN)
    res: Dict = {"backend": device.type, **card_fields(device)}
    launches: Dict = {}

    single = Trainer(model, graph, splits, dg, cfg, seed=0)
    b = list(single.scheduler.epoch())[:8][0]

    def single_step():
        single.train_batch(b)
        return single.params

    res["single_step_ms"], launches["single_step"] = timeit(single_step, n, warmup)
    with torch.no_grad():
        res["single_embed_ms"], launches["single_embed"] = timeit(
            lambda: model.embeddings(single.params, dg), n, warmup)
        gen = make_generator(0, device)
        res["single_embed_dropout_ms"], launches["single_embed_dropout"] = timeit(
            lambda: model.embeddings(single.params, dg, gen, deterministic=False), n, warmup)

    created = worlds.join_group(0, 1, worlds.free_port(), backend=backend)
    try:
        mesh = make_mesh(shape=(1, 1), backend=backend)
        sg = build_sharded_device_graph(graph, splits, (1, 1), 0, device,
                                        densify_max_cells_per_device=bs.DENSIFY)
        smodel = DecagonModel(ModelConfig(spmm_impl="auto"), sg)
        st = Trainer(smodel, graph, splits, sg, cfg, seed=0, mesh=mesh,
                     init_state=copy.deepcopy(single.state_dict()))

        def sharded_step():
            st.train_batch(b)
            return st.params

        res["sharded_step_ms"], launches["sharded_step"] = timeit(sharded_step, n, warmup)
        mc = smodel.config
        keys = shardable_weight_keys(sg) if st.shard_weights else frozenset()
        with torch.no_grad():
            res["sharded_embed_ms"], launches["sharded_embed"] = timeit(
                lambda: st.embed_fn(st.params, sg), n, warmup)
            res["sharded_embed_dropout_ms"], launches["sharded_embed_dropout"] = timeit(
                lambda: encode_sharded(
                    st.params, sg, mesh, gen, dropout_rate=mc.dropout, deterministic=False,
                    spmm_impl=mc.spmm_impl, per_relation_dropout_max=mc.per_relation_dropout_max,
                    spmm_precision=mc.spmm_precision, sharded_keys=keys), n, warmup)
        res["single_cost"] = step_cost(single_step, on_card and profile)
        res["sharded_cost"] = step_cost(sharded_step, on_card and profile)
    finally:
        worlds.leave_group(created)
    res["launches_per_call"] = launches
    return res


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    res = diag(args.device)
    write_json(args.out, res)
    print(json.dumps(res, indent=1, default=str))
    return res


if __name__ == "__main__":
    main()
