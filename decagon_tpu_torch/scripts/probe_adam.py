"""Optimizer-cost probe on the paper-scale parameter tree: three Adams
alone and inside the step, as dependent chains with one sync at the end.

    python -m decagon_tpu_torch.scripts.probe_adam [--relations 963] [--device cpu] \\
        [--out PATH]

Port of ``scripts/probe_adam.py``: the paper graph (19,081 proteins, 645
drugs, ``--relations`` side effects of >= 500 edges, 4,651,131 drug-drug
edges, ``ppi_attachment=37``, seed 7), split 5% / 5% (seed 1), the device
graph with bf16 dense stacks up to 10^9 cells and no fused stream ("auto":
``ops/segment.spmm_dense`` on the card), default widths, weights from seed
0, and one batch of relation 0 of drug-drug (1, 1) (rows and columns from
numpy seeds 0 and 1; ``profile_fullscale_step.ablation``'s loss, the hinge
on unigram negatives).  Timed, each as 12 calls of ``state = fn(state)``
after 2 warm-up calls, one sync at the end:

* ``fwd_bwd``: the loss's value and gradients, the chain kept dependent
  by ``p - 0 * g``;
* for each optimizer (lr 1e-3, b1 0.9, b2 0.999, eps 1e-8, f32 moments, as
  the JAX script's): the update alone on cached gradients, and the step
  (gradients and update):

  - ``adam_flatten``: every leaf raveled into one flat f32 vector each
    step (``optax.flatten`` there; ``perf_probe.flat_optimizer`` here), one
    K7 launch over it;
  - ``adam_plain``: an eager elementwise update a leaf (optax's ``adam``
    there; ``ops/optim.adam_apply_ref`` here: no hand-written kernel);
  - ``adam_fused``: the one-pass Adam, one K7 launch over every leaf
    (``decagon_tpu.ops.optim.fused_adam`` there).

As in the JAX script the gradients are not cast.  The record keeps the JAX
artifact's fields (``artifacts/perf/adam_probe.json``) and adds the card's
``nvidia-smi`` name and power limit, the torch version, peak memory and
each chain's kernel launches a call: ``artifacts/perf/torch_adam_probe.json``
(``--out``).  Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, Optional

import torch

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.ops.optim import (
    GradientTransformation, adam_apply_ref, fused_adam, tree_map,
)
from decagon_tpu_torch.scripts.perf_probe import flat_optimizer, leaves
from decagon_tpu_torch.scripts.profile_fullscale_step import ablation, batch
from decagon_tpu_torch.scripts.records import card_fields, launched, peak_gib, per, reset_peak
from decagon_tpu_torch.scripts.records import write_json
from decagon_tpu_torch.timing import hard_sync
from decagon_tpu_torch.train.step import TrainConfig, fold_generator, make_generator

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "artifacts", "perf", "torch_adam_probe.json")

# The JAX script's configuration.
GRAPH = dict(n_proteins=19081, n_drugs=645, min_edges_per_relation=500,
             total_drugdrug_edges=4_651_131, ppi_attachment=37, seed=7)
SPLIT = dict(val_frac=0.05, test_frac=0.05, seed=1)
DEVICE_GRAPH = dict(densify_max_cells=1_000_000_000, dense_dtype=torch.bfloat16,
                    build_fused=False)
ADAM = dict(b1=0.9, b2=0.999, eps=1e-8)
LR = 1e-3
N, WARMUP = 12, 2


def variants() -> Dict[str, GradientTransformation]:
    """The three optimizers, f32 moments."""
    return {
        "adam_flatten": flat_optimizer(fused_adam(LR, **ADAM)),
        "adam_plain": fused_adam(LR, one_pass=adam_apply_ref, **ADAM),
        "adam_fused": fused_adam(LR, **ADAM),
    }


def timed_pipelined(fn: Callable, state, n: int = N, warmup: int = WARMUP):
    """ms a call of ``state = fn(state)`` over a dependent chain, and the
    hand-written kernels' launches a call."""
    for _ in range(warmup):
        state = fn(state)
    hard_sync(state)
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    for _ in range(n):
        state = fn(state)
    hard_sync(state)
    return (time.perf_counter() - t0) / n * 1e3, per(launched(), n)


def probe_adam(relations: int = 963, device=None, graph_kw: Optional[Dict] = None,
               batch_size: int = 512, n: int = N, log: Callable = print) -> Dict:
    """The record; ``graph_kw`` defaults to the JAX script's graph."""
    device = resolve_device(device)
    t0 = time.time()
    graph_kw = dict(GRAPH, n_side_effects=relations) if graph_kw is None else graph_kw
    graph = make_polypharmacy_like_graph(**graph_kw)
    splits = split_graph(graph, **SPLIT)
    dg = build_device_graph(graph, splits, device=device, **DEVICE_GRAPH)
    log(f"[probe_adam +{time.time() - t0:.0f}s] device graph built")
    model = DecagonModel(ModelConfig(spmm_impl="auto"), dg)
    cfg = TrainConfig(batch_size=batch_size)
    fwd_bwd = ablation(model, dg, cfg, *batch(graph.num_nodes[1], batch_size, device))["fwd_bwd"]
    params = model.init_params(make_generator(0, "cpu"), dg)
    param_bytes = sum(x.numel() * x.element_size() for x in leaves(params))
    log(f"[probe_adam +{time.time() - t0:.0f}s] params: {param_bytes / 2**20:.0f} MiB")
    reset_peak(device)

    def fwd_bwd_chain(carry):
        p, gen = carry
        gen = fold_generator(gen, 1)
        _, grads = fwd_bwd(p, gen)
        with torch.no_grad():
            return tree_map(lambda a, g: a - 0.0 * g, p, grads), gen

    result = {"param_mib": round(param_bytes / 2**20, 1)}
    launches = {}
    result["fwd_bwd_ms"], launches["fwd_bwd"] = timed_pipelined(
        fwd_bwd_chain, (params, make_generator(1, device)), n)
    log(f"[probe_adam +{time.time() - t0:.0f}s] fwd_bwd {result['fwd_bwd_ms']:.3f} ms")
    _, grads0 = fwd_bwd(params, make_generator(1, device))
    hard_sync(grads0)

    for name, opt in variants().items():
        opt_state = opt.init(params)

        def adam_chain(carry, _opt=opt):
            p, s = carry
            with torch.no_grad():
                return _opt.apply(grads0, s, p)

        result[f"{name}_ms"], launches[name] = timed_pipelined(
            adam_chain, (tree_map(torch.clone, params), opt_state), n)
        log(f"[probe_adam +{time.time() - t0:.0f}s] {name} {result[f'{name}_ms']:.3f} ms")

        def step_chain(carry, _opt=opt):
            p, s, gen = carry
            gen = fold_generator(gen, 1)
            _, grads = fwd_bwd(p, gen)
            with torch.no_grad():
                p, s = _opt.apply(grads, s, p)
            return p, s, gen

        start = (tree_map(torch.clone, params), opt.init(params), make_generator(2, device))
        result[f"step_{name}_ms"], launches[f"step_{name}"] = timed_pipelined(step_chain, start,
                                                                             n)
        log(f"[probe_adam +{time.time() - t0:.0f}s] step_{name} "
            f"{result[f'step_{name}_ms']:.3f} ms")
    result.update(launches_per_call=launches, peak_gib=peak_gib(device),
                  config=dict(graph=graph_kw, split=SPLIT,
                              device_graph=dict(DEVICE_GRAPH, dense_dtype="bfloat16"),
                              spmm_impl="auto", batch_size=batch_size, lr=LR, **ADAM, n=n,
                              warmup=WARMUP),
                  notes=dict(adam_flatten="every leaf raveled into one f32 vector each step, "
                                          "one K7 launch over it (optax.flatten there)",
                             adam_plain="an eager elementwise chain a leaf, no hand-written "
                                        "kernel (optax.adam there)",
                             adam_fused="K7: one launch over every leaf"),
                  **card_fields(device))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--relations", type=int, default=963)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    result = probe_adam(args.relations, args.device, log=lambda m: print(m, flush=True))
    write_json(args.out, result)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
