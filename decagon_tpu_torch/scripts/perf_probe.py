"""Perf probe: the dummy config's chunked train step split into parts, for
each aggregation form.

    python -m decagon_tpu_torch.scripts.perf_probe [CHUNK] [IMPLS] [--device cpu] \\
        [--out PATH]

Port of ``scripts/perf_probe.py``, line for line, on the bench's dummy
workload (``make_synthetic_graph(500 genes, 400 drugs, 3 drug-drug
relations, seed=0)``, split 5% / the 50-edge test floor, seed 1; hidden
64 -> 32, dropout 0.1; the ``Trainer``, seed 0, batch 512, lr 1e-3, chunks
of ``CHUNK`` = 50 steps), for each ``spmm_impl`` of ``IMPLS`` (comma-
separated; default ``xla,fused,pallas,fused_pallas``):

a) ``full chunked step``: the ``Trainer``'s chunk (forward, backward, K7);
b) ``encoder fwd only``: ``CHUNK`` forwards with dropout, no gradients;
c) ``encoder fwd+bwd``: ``CHUNK`` forwards and the gradients of the
   embeddings' sum of squares;
d) ``step w/ flat Adam``: the chunked step with every leaf raveled into one
   flat f32 vector each step (the JAX script's ``optax.flatten``): the port
   sends that one leaf through K7 (``flat_optimizer``), bf16 moments as the
   config's.

Each is timed as ``REPS`` calls after one warm-up call, with one sync at
the end (the JAX script's ``lax.scan`` loops are loops of eager calls
here), in ms a step.  Then one more call of each runs under
``torch.profiler`` (``bench.profile_call``): the device's busy ms and idle
share a step, its kernels a step and the top kernels; and the hand-written
kernels' launches a step (``ops/cuda_build.LAUNCHES``).

The JAX package builds its tiles only for edge types without a dense stack,
and at this size each edge type has one, so its "pallas" and "fused_pallas"
lines raise there.  The port builds K6's CSR layouts for every edge type
(``tile_even_if_dense``) for those two forms, so they measure K6, as the
script was written to.  "auto" (the bench's ``toy_dense``: the dense stacks
on the card) may be named in ``IMPLS`` too.

Prints the JAX script's lines and writes them as one record,
``artifacts/perf/torch_perf_probe.json`` (``--out``), with the card's
``nvidia-smi`` name and power limit and the torch version.  Runs on CUDA
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Dict, Optional

import torch

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.bench import profile_call
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_synthetic_graph
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.ops.optim import GradientTransformation, tree_map
from decagon_tpu_torch.scripts.records import card_fields, launched, per, write_json
from decagon_tpu_torch.timing import hard_sync
from decagon_tpu_torch.train.step import (
    TrainConfig, fold_generator, make_chunked_train_step, make_generator, make_optimizer,
    value_and_grad,
)
from decagon_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "artifacts", "perf", "torch_perf_probe.json")

# The JAX script's configuration.
GRAPH = dict(n_genes=500, n_drugs=400, n_drugdrug_types=3, seed=0)
SPLIT = dict(val_frac=0.05, test_frac=0.0, seed=1)
MODEL = dict(hidden1=64, hidden2=32, dropout=0.1)
TRAIN = dict(batch_size=512, learning_rate=1e-3)
CHUNK = 50
IMPLS = ["xla", "fused", "pallas", "fused_pallas"]
REPS = 5
# The JAX script's printed lines: the record's key for each.
LINES = {"full_chunked_step": "full chunked step", "encoder_fwd_only": "encoder fwd only",
         "encoder_fwd_bwd": "encoder fwd+bwd", "step_flat_adam": "step w/ flat Adam"}


def timeit(fn: Callable, n: int = REPS):
    """Seconds a call of ``fn`` over ``n`` calls after one warm-up call,
    one sync at the end (``fn`` returns what to wait for), and the
    hand-written kernels' launches a call."""
    hard_sync(fn())
    cuda_build.reset_launches()
    start = time.perf_counter()
    for _ in range(n):
        out = fn()
    hard_sync(out)
    return (time.perf_counter() - start) / n, per(launched(), n)


def leaves(tree):
    """The tensors of a nested dict, in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [leaf for value in tree.values() for leaf in leaves(value)]
    return [tree]


def flat_optimizer(inner: GradientTransformation) -> GradientTransformation:
    """``optax.flatten``'s counterpart: ``inner`` over ONE flat f32 vector,
    the leaves raveled and concatenated every step and the result split
    back into their shapes.  ``apply`` rounds each gradient leaf as
    ``round_grad`` says before raveling (the per-leaf cast of the step), so
    on the card ``inner``'s apply is one K7 launch over the one leaf."""

    def ravel(tree):
        return torch.cat([x.reshape(-1).float() for x in leaves(tree)])

    def unravel(flat, like):
        parts = iter(torch.split(flat, [x.numel() for x in leaves(like)]))
        return tree_map(lambda x: next(parts).view(x.shape).to(x.dtype), like)

    def init(params):
        return inner.init({"flat": ravel(params)})

    def update(grads, state):
        upd, state = inner.update({"flat": ravel(grads)}, state)
        return unravel(upd["flat"], grads), state

    def apply(grads, state, params, round_grad=None, in_place=None):
        if round_grad is not None:
            grads = tree_map(lambda g: g.to(torch.bfloat16) if round_grad(g) else g, grads)
        new, state = inner.apply({"flat": ravel(grads)}, state, {"flat": ravel(params)})
        return unravel(new["flat"], params), state

    return GradientTransformation(init, update, apply)


def encoder_fwd(model, dg, params, chunk: int, gen: Optional[torch.Generator]):
    """``chunk`` forwards (dropout drawn from ``gen`` folded with the step,
    none when ``gen`` is None), no gradients: one scalar of each."""
    with torch.no_grad():
        return torch.stack([
            model.embeddings(params, dg, None if gen is None else fold_generator(gen, i),
                             deterministic=gen is None)["1"][0, 0] for i in range(chunk)])


def encoder_fwd_bwd(model, dg, params, chunk: int, gen: torch.Generator):
    """``chunk`` forwards with dropout and the gradients of the embeddings'
    sum of squares: one scalar of each step's gradients."""

    def loss(p, i):
        emb = model.embeddings(p, dg, fold_generator(gen, i), deterministic=False)
        return sum(torch.sum(e * e) for e in emb.values())

    return torch.stack([value_and_grad(loss, params, i)[1]["enc1"]["1,1"].reshape(-1)[0]
                        for i in range(chunk)])


def builds_tiles(impl: str) -> bool:
    return "pallas" in impl


def probe_impl(impl: str, graph, splits, device, chunk: int = CHUNK, reps: int = REPS,
               log: Callable = print) -> Dict:
    """The four lines of one ``spmm_impl``: ms a step, launches a step and a
    profiled call of each."""
    on_card = device.type == "cuda"
    dg = build_device_graph(graph, splits, tile_for_pallas=builds_tiles(impl),
                            tile_even_if_dense=builds_tiles(impl), device=device)
    model = DecagonModel(ModelConfig(spmm_impl=impl, **MODEL), dg)
    cfg = TrainConfig(scan_chunk=chunk, **TRAIN)
    trainer = Trainer(model, graph, splits, dg, cfg, seed=0)
    batches = list(trainer.scheduler.epoch())
    while len(batches) < chunk:
        batches += list(trainer.scheduler.epoch())
    batches = batches[:chunk]

    def full():
        trainer.train_chunk(batches, chunk)
        return trainer.params

    params = trainer.params
    gen = make_generator(0, device)
    flat_opt = flat_optimizer(make_optimizer(cfg))
    flat_chunk = make_chunked_train_step(model, dg, cfg, flat_opt)
    zeros = torch.zeros((chunk, cfg.batch_size), dtype=torch.int32, device=device)
    state = [trainer.params, flat_opt.init(trainer.params)]

    def run_flat():
        p, s, losses = flat_chunk(state[0], state[1], dg, 0, [0] * chunk, [0] * chunk, zeros,
                                  zeros, list(range(chunk)), [True] * chunk)
        state[0], state[1] = p, s
        return losses

    fns = {"full_chunked_step": full,
           "encoder_fwd_only": lambda: encoder_fwd(model, dg, params, chunk, gen),
           "encoder_fwd_bwd": lambda: encoder_fwd_bwd(model, dg, params, chunk, gen),
           "step_flat_adam": run_flat}
    out = {"tiles": builds_tiles(impl)}
    for key, fn in fns.items():
        seconds, launches = timeit(fn, reps)
        ms = seconds / chunk * 1e3
        log(f"[{impl}] {LINES[key] + ':':<19} {ms:.3f} ms/step")
        out[key] = dict(ms_per_step=ms, launches_per_step=per(launches, chunk),
                        profile=profile_call(fn, chunk, ms, top=8, on_card=on_card))
    return out


def perf_probe(impls, chunk: int = CHUNK, device=None, graph_kw: Optional[Dict] = None,
               reps: int = REPS, log: Callable = print) -> Dict:
    """The record: one entry an ``spmm_impl`` of ``impls``."""
    device = resolve_device(device)
    graph = make_synthetic_graph(**(graph_kw or GRAPH))
    splits = split_graph(graph, **SPLIT)
    rec = {"config": dict(graph=graph_kw or GRAPH, split=SPLIT, model=MODEL, train=TRAIN,
                          chunk=chunk, reps=reps, lines=LINES,
                          flat_adam="every leaf raveled into one f32 vector each step, "
                                    "one K7 launch over it (optax.flatten in the JAX script)",
                          profile="one more call of each line under torch.profiler "
                                  "(bench.profile_call); on the CPU, host self time"),
           "impls": {}, **card_fields(device)}
    for impl in impls:
        rec["impls"][impl] = probe_impl(impl, graph, splits, device, chunk, reps, log)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("chunk", nargs="?", type=int, default=CHUNK)
    ap.add_argument("impls", nargs="?", default=",".join(IMPLS))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    rec = perf_probe(args.impls.split(","), args.chunk, args.device,
                     log=lambda m: print(m, flush=True))
    write_json(args.out, rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
