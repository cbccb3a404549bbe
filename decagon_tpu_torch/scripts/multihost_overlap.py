"""Two-rank boundary-exchange overlap A/B: ``comm_overlap`` on and off with
real row traffic.

    python -m decagon_tpu_torch.scripts.multihost_overlap [--device cpu] [--steps 24] [--out PATH]

Port of ``scripts/multihost_overlap.py``: two ranks, each pinned to a core
(``taskset`` where it exists), gloo over localhost, the poly50 graph
(2,000 proteins, 400 drugs, 50 side effects, ``planted_rank=16``; split
seed 8) on a (row=2, edge=1) mesh, whose ``row`` all-gather is the boundary
exchange; hidden 64 -> 32, dropout 0.1, batch 512, lr 1e-3, the
weight-sharded step, 24 steps (``multihost_bench``'s batches and injected
draws).  Steady ms a step for:

* ``overlap_on``: ``encode_sharded`` issues every edge type's aggregation
  and ``edge`` sum before waiting for any, then every ``row`` gather
  before reading any (``comm_overlap=True``, the default);
* ``overlap_off``: each edge type's exchange completes before the next
  one's projection (the control);
* ``inprocess_2dev`` keeps the JAX key (one process, two CPU devices
  there, the collectives in-process copies) and holds the single process's
  step on the same graph, config and batches: the compute with no exchange
  (the port has no in-process mesh).

The pair runs twice in turns (on, off, off, on; the JAX script ran each
once): each key keeps its median, with every turn's steady ms beside it.
``derived`` follows the JAX formulas: ``overlap_gain_fraction = (off -
on) / off``, ``comm_share_upper_bound = (off - inprocess) / off``,
``overlap_factor = (off - on) / (off - inprocess)`` (null unless off is
slower than the single process).  On and off must give the same
``loss_head``.  On the card both ranks share ``cuda:0`` over gloo, with each
collective staged through the host (``parallel/collectives.py``): NCCL
cannot place two ranks on one card.  ``nccl_pair`` tries exactly that (two
NCCL ranks on the card, one step) and the record keeps the outcome, the
error text where NCCL refuses.  Writes
``artifacts/perf/torch_multihost_overlap.json`` (``--out``), which
``scaling_model.py`` reads (it applies the factor only from an NCCL world
across cards: ``config.backend``, ``config.cards``).  Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import Callable, Dict, Optional

import torch

from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts import multihost_bench as mb
from decagon_tpu_torch.scripts import worlds
from decagon_tpu_torch.scripts.records import card_fields, write_json
from decagon_tpu_torch.train.step import TrainConfig

MODULE = "decagon_tpu_torch.scripts.multihost_overlap"
OUT = os.path.join(worlds.ROOT, "artifacts", "perf", "torch_multihost_overlap.json")

STEPS = 24
SHAPE = (2, 1)
# The on / off pair runs this many times, in turns (on, off, off, on).
TURNS = 2
NCCL_TIMEOUT_S = 180


def rank_main(rank: int, n_ranks: int, port: int, overlap: bool, steps: int = STEPS,
              device: str = "cuda", graph_kw: Optional[Dict] = None,
              model_kw: Optional[Dict] = None, batch_size: int = mb.TRAIN["batch_size"],
              backend: str = "gloo", threads: int = 1) -> Dict:
    """One rank of the (2, 1) world: the weight-sharded step with
    ``comm_overlap=overlap`` on ``multihost_bench``'s batches and draws.  A
    world of one rank is the single process (``inprocess_2dev``)."""
    from decagon_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(threads)
    if n_ranks == 1:
        return mb.single_trace(steps, device, graph_kw, model_kw, batch_size)
    dev = worlds.rank_device(device)
    created = worlds.join_group(rank, n_ranks, port, backend=backend)
    try:
        graph, splits = mb.world(graph_kw)
        cfg = TrainConfig(**dict(mb.TRAIN, batch_size=batch_size), comm_overlap=bool(overlap))
        mesh = make_mesh(shape=SHAPE, backend=backend)
        sg, model, params, local, state, step = mb.mesh_setup(
            graph, splits, mesh, SHAPE, dev, dict(mb.MODEL, **(model_kw or {})), cfg)
        out = mb.train_trace(step, local, state, sg, mb.batches(splits, steps, batch_size), dev,
                             lambda i: mb.draws(params, sg, model, cfg, i))
        out.pop("params")
        return dict(out, pid=rank)
    finally:
        worlds.leave_group(created)


def entry(results: Dict[int, Dict]) -> Dict:
    """A run's entry: ``multihost_bench.summarize``'s with the loss trace's
    head (the JAX field) in place of the trace."""
    out = mb.summarize(results)
    out["loss_head"] = out.pop("losses")[:3]
    return out


def run_config(nproc: int, overlap: bool, steps: int = STEPS, device: str = "cuda",
               **kw) -> Dict:
    # The single process gets the two ranks' cores, unpinned.
    return entry(worlds.run_world(MODULE, nproc, dict(overlap=overlap, steps=steps,
                                                      device=device, threads=3 - nproc, **kw),
                                  pin=nproc > 1))


def nccl_pair(steps: int = 1, **kw) -> Dict:
    """Two NCCL ranks on ``cuda:0`` taking ``steps`` overlapped steps: the
    outcome, with the error text where NCCL refuses (or the loss head where
    it runs)."""
    try:
        results = worlds.run_world(MODULE, 2, dict(overlap=True, steps=steps, device="cuda",
                                                   backend="nccl", **kw),
                                   timeout=NCCL_TIMEOUT_S)
    except (RuntimeError, TimeoutError) as exc:
        text = str(exc)
        lines = [ln for ln in text.splitlines()
                 if any(w in ln for w in ("NCCL", "nccl", "Duplicate GPU"))]
        return {"ran": False, "error": text[-3000:], "nccl_lines": lines[-8:]}
    return {"ran": True, **entry(results)}


def derive(out: Dict) -> None:
    on = out["overlap_on"]["steady_ms_per_step"]
    off = out["overlap_off"]["steady_ms_per_step"]
    inp = out["inprocess_2dev"]["steady_ms_per_step"]
    out["derived"] = {
        "overlap_gain_fraction": round((off - on) / off, 4),
        "comm_share_upper_bound": round(max(0.0, (off - inp) / off), 4),
        "overlap_factor": round((off - on) / max(1e-9, off - inp), 4) if off > inp else None,
        "note": (
            "overlap_gain_fraction = wall saved by letting the boundary exchange overlap local "
            "aggregation; comm_share_upper_bound = (serialized - inprocess)/serialized, an "
            "upper bound on the gloo exchange share; overlap_factor = fraction of the exposed "
            "communication hidden by the two-phase schedule"),
    }
    out["on_off_loss_head_equal"] = out["overlap_on"]["loss_head"] == \
        out["overlap_off"]["loss_head"]


def merge_turns(entries) -> Dict:
    """One key's entry over its turns: the first run's fields with the
    median steady ms, and every turn's (``turns_steady_ms_per_step``); the
    turns must give one loss head."""
    if any(e["loss_head"] != entries[0]["loss_head"] for e in entries):
        raise AssertionError(f"the turns disagree on the loss head: {entries}")
    ms = [e["steady_ms_per_step"] for e in entries]
    return dict(entries[0], steady_ms_per_step=statistics.median(ms),
                turns_steady_ms_per_step=ms)


def multihost_overlap(device: str = "cuda", steps: int = STEPS, log: Callable = print,
                      **kw) -> Dict:
    """The record; ``kw`` (``graph_kw``, ``model_kw``, ``batch_size``) cuts
    the workload for tests.  On the card, also ``nccl_pair``."""
    dev = worlds.rank_device(device)
    if dev.type == "cuda":
        cuda_build.library()  # built once, before the ranks load it
    t0 = time.perf_counter()
    out = {
        "config": {
            "graph": "2000 prot / 400 drugs / 50 rels (planted_rank 16)",
            "mesh": "(row=2, edge=1)",
            "steps": steps,
            # What ``scaling_model.py`` reads before it applies the factor:
            # only an NCCL world across cards exchanges asynchronously.
            "backend": "gloo",
            "cards": 1 if dev.type == "cuda" else 0,
            "pinning": "taskset 1 core/process" + (
                ", both ranks on cuda:0 over gloo (each collective staged through the host)"
                if dev.type == "cuda" else ", CPU ranks over gloo"),
        },
        "inprocess_note": (
            "inprocess_2dev keeps the JAX key; the port has no in-process mesh, so it holds the "
            "single process's step on the same graph, config, batches and injected draws: the "
            "compute with no exchange"),
        **card_fields(dev),
    }
    runs = {"overlap_on": [], "overlap_off": []}
    pair = (("overlap_on", True), ("overlap_off", False))
    for turn in range(TURNS):
        for key, overlap in (pair if turn % 2 == 0 else pair[::-1]):
            runs[key].append(run_config(2, overlap, steps, device, **kw))
            log(f"[overlap +{time.perf_counter() - t0:.0f}s] {key} {json.dumps(runs[key][-1])}")
    for key, entries in runs.items():
        out[key] = merge_turns(entries)
    out["inprocess_2dev"] = run_config(1, True, steps, device, **kw)
    log(f"[overlap +{time.perf_counter() - t0:.0f}s] inprocess_2dev "
        f"{json.dumps(out['inprocess_2dev'])}")
    derive(out)
    if dev.type == "cuda":
        out["nccl_two_ranks_one_card"] = nccl_pair(**kw)
        log(f"[overlap +{time.perf_counter() - t0:.0f}s] two NCCL ranks on one card: "
            f"{json.dumps(out['nccl_two_ranks_one_card'])[:2000]}")
    out["wall_s"] = round(time.perf_counter() - t0, 1)
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    out = multihost_overlap(args.device, args.steps)
    write_json(args.out, out)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    if worlds.is_worker(sys.argv[1:]):
        worlds.worker(rank_main, sys.argv[2])
    else:
        main()
