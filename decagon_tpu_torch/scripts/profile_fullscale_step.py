"""The paper-scale factored train step split by ablation: forward, forward
with dropout, forward and backward, Adam alone, the whole step.

    python -m decagon_tpu_torch.scripts.profile_fullscale_step [--relations 963] \\
        [--device cpu] [--out PATH]

Port of ``scripts/profile_fullscale_step.py``: the paper graph (19,081
proteins, 645 drugs, ``--relations`` side effects of >= 500 edges,
4,651,131 drug-drug edges, ``ppi_attachment=37``, seed 7), split 5% / 5%
(seed 1), the device graph with the int8 factored masks
(``dense_factored=True``, dense cap 10^9 cells, bf16, no fused stream), so
"auto" aggregates every edge type through ``ops/segment.spmm_dense_factored``;
hidden 64 -> 32, dropout 0.1, ``TrainConfig(batch_size=512)``, weights from
seed 0, and one batch of relation 0 of drug-drug (1, 1): rows and columns
from numpy seeds 0 and 1.  Timed, each as pipelined calls with one sync at
the end (2 warm-up calls, then 10):

* ``fwd``: the deterministic two-layer forward (``DecagonModel.embeddings``);
* ``fwd_drop``: the forward with dropout (the training forward);
* ``fwd_bwd``: the hinge loss's value and gradients (the forward with
  dropout, ``score_edges`` of the positives and of unigram negatives,
  ``LOSSES["hinge"]``; no optimizer);
* ``adam_only``: the optimizer on cached gradients.  The JAX script times
  optax's ``update`` then ``apply_updates``; the port's optimizer does both
  in one call of its ``apply`` (``train/step.make_optimizer``), one launch
  of K7 on the card.  As in the JAX script the gradients are not cast;
* ``full_step``: gradients and Adam in one call.

The record keeps the JAX artifact's fields (``artifacts/perf/
fullscale_step_profile.json``, its ``note`` and ``superseded_by`` saying
what the port's numbers are) and adds the card's ``nvidia-smi`` name and
power limit, the torch version, peak memory and each function's kernel
launches a call.  Writes ``artifacts/perf/torch_fullscale_step_profile.json``
(``--out``).  Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.models.losses import LOSSES
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts.records import card_fields, launched, peak_gib, per, reset_peak
from decagon_tpu_torch.scripts.records import write_json
from decagon_tpu_torch.timing import hard_sync
from decagon_tpu_torch.train.negatives import sample_unigram
from decagon_tpu_torch.train.step import (
    TrainConfig, make_generator, make_optimizer, split_generator, value_and_grad,
)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "artifacts", "perf", "torch_fullscale_step_profile.json")

# The JAX script's configuration.
GRAPH = dict(n_proteins=19081, n_drugs=645, min_edges_per_relation=500,
             total_drugdrug_edges=4_651_131, ppi_attachment=37, seed=7)
SPLIT = dict(val_frac=0.05, test_frac=0.05, seed=1)
DEVICE_GRAPH = dict(densify_max_cells=1_000_000_000, dense_dtype=torch.bfloat16,
                    build_fused=False, dense_factored=True)
EDGE_TYPE, RELATION = (1, 1), 0
NOTE = ("each function timed as 10 calls after 2 warm-up calls with one sync at the end "
        "(host clock); the whole step (full_step) against its parts: fwd_bwd holds the "
        "training forward (fwd_drop), the scoring and the backward, adam_only the optimizer's "
        "one call (K7 on the card)")
SUPERSEDED_BY = ("decagon_tpu_torch/scripts/profile_factored_ops.py's records "
                 "(artifacts/perf/torch_factored_op_profile.json, torch_paired_op_profile.json): "
                 "the device time of each kernel of the Trainer's step")


def ablation(model, dg, cfg: TrainConfig, rows, cols, k: int = RELATION,
             edge_type=EDGE_TYPE) -> Dict[str, Callable]:
    """The five functions, as the JAX script's jitted ones: ``fwd(params)``,
    ``fwd_drop(params, gen)``, ``fwd_bwd(params, gen, layer_bits=None,
    neg_u=None)`` -> (loss, grads), ``adam_only(params, opt_state, grads)``
    and ``full_step(params, opt_state, gen)``.  ``layer_bits`` / ``neg_u``
    replace the dropout and the negative-sampling draws."""
    optimizer = make_optimizer(cfg)
    et_key = f"{edge_type[0]},{edge_type[1]}"

    def fwd(params):
        with torch.no_grad():
            return model.embeddings(params, dg, deterministic=True)

    def fwd_drop(params, gen):
        with torch.no_grad():
            return model.embeddings(params, dg, gen, deterministic=False)

    def loss_fn(params, gen, layer_bits=None, neg_u=None):
        enc_gen, sample_gen = split_generator(gen)
        emb = model.embeddings(params, dg, enc_gen, deterministic=False, layer_bits=layer_bits)
        pos = model.score_edges(params, dg, emb, edge_type, k, rows, cols)
        neg_rows = sample_unigram(sample_gen, dg.neg_cdf[et_key][k], cfg.batch_size, u=neg_u)
        neg = model.score_edges(params, dg, emb, edge_type, k, neg_rows, cols)
        return LOSSES["hinge"](pos, neg, cfg.margin)

    def fwd_bwd(params, gen, layer_bits=None, neg_u=None):
        return value_and_grad(loss_fn, params, gen, layer_bits=layer_bits, neg_u=neg_u)

    def adam_only(params, opt_state, grads):
        with torch.no_grad():
            return optimizer.apply(grads, opt_state, params)

    def full_step(params, opt_state, gen):
        loss, grads = fwd_bwd(params, gen)
        new_params, new_state = adam_only(params, opt_state, grads)
        return new_params, new_state, loss

    return dict(fwd=fwd, fwd_drop=fwd_drop, fwd_bwd=fwd_bwd, adam_only=adam_only,
                full_step=full_step, optimizer=optimizer)


def timed(fn: Callable, *args, reps: int = 10, warmup: int = 2):
    """Pipelined ms a call (``reps`` calls, one trailing sync) and the
    kernels' launches a call."""
    for _ in range(warmup):
        out = fn(*args)
    hard_sync(out)
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    hard_sync(out)
    return (time.perf_counter() - t0) / reps * 1e3, per(launched(), reps)


def batch(n_drugs: int, batch_size: int, device):
    """The JAX script's rows and columns: numpy seeds 0 and 1."""
    rows = np.random.default_rng(0).integers(0, n_drugs, size=batch_size)
    cols = np.random.default_rng(1).integers(0, n_drugs, size=batch_size)
    return (torch.from_numpy(rows.astype(np.int32)).to(device),
            torch.from_numpy(cols.astype(np.int32)).to(device))


def profile_step(relations: int = 963, device=None, graph_kw: Optional[Dict] = None,
                 reps: int = 10, batch_size: int = 512) -> Dict:
    """The record; ``graph_kw`` defaults to the JAX script's graph."""
    device = resolve_device(device)
    graph_kw = dict(GRAPH, n_side_effects=relations) if graph_kw is None else graph_kw
    graph = make_polypharmacy_like_graph(**graph_kw)
    splits = split_graph(graph, **SPLIT)
    dg = build_device_graph(graph, splits, device=device, **DEVICE_GRAPH)
    # "auto" on the factored masks: the JAX package's accelerator dispatch.
    model = DecagonModel(ModelConfig(spmm_impl="auto"), dg)
    cfg = TrainConfig(batch_size=batch_size)
    fns = ablation(model, dg, cfg, *batch(graph.num_nodes[1], batch_size, device))
    params = model.init_params(make_generator(0, "cpu"), dg)
    opt_state = fns["optimizer"].init(params)
    gen = make_generator(1, device)
    reset_peak(device)
    _, grads = fns["fwd_bwd"](params, gen)
    hard_sync(grads)
    result, launches = {}, {}
    for name, args in (("fwd", (params,)), ("fwd_drop", (params, gen)),
                       ("fwd_bwd", (params, gen)), ("adam_only", (params, opt_state, grads)),
                       ("full_step", (params, opt_state, gen))):
        result[f"{name}_ms"], launches[name] = timed(fns[name], *args, reps=reps)
    result.update(note=NOTE, superseded_by=SUPERSEDED_BY, launches_per_call=launches,
                  peak_gib=peak_gib(device), config=dict(graph=graph_kw, split=SPLIT,
                  device_graph=dict(DEVICE_GRAPH, dense_dtype="bfloat16"), spmm_impl="auto",
                  batch_size=batch_size, edge_type=list(EDGE_TYPE), relation=RELATION, reps=reps),
                  **card_fields(device))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--relations", type=int, default=963)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    result = profile_step(args.relations, args.device)
    write_json(args.out, result)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
