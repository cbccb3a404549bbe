"""The mesh ``Trainer``'s step against the single-process sparse ``Trainer``'s
on one card at paper scale, and where the mesh's extra time goes.

    python -m decagon_tpu_torch.scripts.probe_mesh_step [--chunk 8] [--windows 3] [--out FILE]

Builds ``bench.PAPER``'s graph and split (5% / 5%, seed 1), the single
process's sparse graph (K6's layouts on every edge type, no fused stream)
and, in a world of one rank over NCCL, the (1, 1) mesh's sharded graph
with K6's layouts.  Both ``Trainer``\\ s run hidden 64 -> 32, dropout 0.1,
batch 512, ``spmm_precision="highest"``: the single process with
``spmm_impl="pallas"``, the mesh with "auto" (K6 where there is no dense
block: every edge type here), with ``comm_overlap`` on and off.  Each is
timed in turns (single, mesh, mesh without overlap, then the same three
again): one warm-up chunk, then ``--windows`` timed chunks of ``--chunk``
steps (``bench.steady_state_ms``).  Then one chunk of the single process
and one of the mesh run under ``torch.profiler`` (CPU and CUDA activity):
the host's self time by operation (the largest, and the collectives'
total), the device's busy ms a step, and the calls a step of each
collective.  Prints one JSON object last, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import socket

import torch

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.bench import PAPER, steady_state_ms
from decagon_tpu_torch.scripts.probing import card

# Operation names of the collectives in a profile.
_COLLECTIVES = ("c10d::", "nccl:", "record_param_comms")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _profile(trainer, chunk: int, top: int) -> dict:
    """One chunk of ``chunk`` steps under ``torch.profiler``: host self ms
    a step by operation, the collectives' calls and ms a step, device busy
    ms a step."""
    from torch.profiler import ProfilerActivity, profile

    batches = []
    while len(batches) < chunk:
        batches.extend(list(trainer.scheduler.epoch())[: chunk - len(batches)])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_chunk(batches, chunk)
        torch.cuda.synchronize()
    rows = prof.key_averages()
    host = sorted(((r.key, r.self_cpu_time_total / 1e3 / chunk, r.count / chunk) for r in rows
                   if r.device_type == torch.autograd.DeviceType.CPU), key=lambda x: -x[1])
    coll = [h for h in host if h[0].startswith(_COLLECTIVES)]
    # Kernels only: a CPU operation's device time repeats its kernels'.
    device = sum(r.self_device_time_total for r in rows
                 if r.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / chunk
    return {
        "host_self_ms_per_step": sum(h[1] for h in host),
        "device_busy_ms_per_step": device,
        "collective_host_ms_per_step": sum(h[1] for h in coll),
        "collectives": {k: {"ms": ms, "calls_per_step": n} for k, ms, n in coll},
        "top_host_ops": [{"op": k, "ms_per_step": ms, "calls_per_step": n}
                         for k, ms, n in host[:top]],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from decagon_tpu_torch.graph.device import build_device_graph
    from decagon_tpu_torch.graph.split import split_graph
    from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
    from decagon_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from decagon_tpu_torch.parallel.rowshard import build_sharded_device_graph
    from decagon_tpu_torch.train.step import TrainConfig
    from decagon_tpu_torch.train.trainer import Trainer

    device = resolve_device("cuda")
    graph = make_polypharmacy_like_graph(**PAPER)
    splits = split_graph(graph, val_frac=0.05, test_frac=0.05, seed=1)
    dg = build_device_graph(graph, splits, densify_max_cells=0, tile_for_pallas=True,
                            build_fused=False, device=device)
    initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0, backend="nccl")
    try:
        mesh = make_mesh(shape=(1, 1), backend="nccl")
        sg = build_sharded_device_graph(graph, splits, (1, 1), 0, device, tile_for_pallas=True)

        def cfg(**kw):
            return ModelConfig(hidden1=64, hidden2=32, dropout=0.1, **kw)

        def trainers():
            tc = TrainConfig(batch_size=512, scan_chunk=args.chunk)
            yield "single", Trainer(DecagonModel(cfg(spmm_impl="pallas"), dg), graph, splits,
                                    dg, tc, seed=args.seed)
            for overlap in (True, False):
                tco = TrainConfig(batch_size=512, scan_chunk=args.chunk, comm_overlap=overlap)
                yield ("mesh" if overlap else "mesh_no_overlap"), Trainer(
                    DecagonModel(cfg(spmm_impl="auto"), sg), graph, splits, sg, tco,
                    seed=args.seed, mesh=mesh)

        times = {}
        for turn in range(2):
            names = list(trainers())
            for name, trainer in (names if turn == 0 else names[::-1]):
                t = steady_state_ms(trainer, args.chunk, args.windows)
                t.pop("losses")
                times.setdefault(name, []).append(t)
                print(f"[probe_mesh_step] {name} turn {turn}: {json.dumps(t)}", flush=True)
                del trainer
        profiles = {name: _profile(trainer, args.chunk, args.top)
                    for name, trainer in list(trainers())[:2]}
    finally:
        dist.destroy_process_group()
    out = {"device": card(), "torch": torch.__version__, "chunk": args.chunk,
           "windows": args.windows, "times": times, "profiles": profiles,
           "median_ms": {k: [t["median_ms"] for t in v] for k, v in times.items()}}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("device", "median_ms")}))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
