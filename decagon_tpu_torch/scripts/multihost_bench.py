"""Four-rank mesh bench: exactness across processes, the bf16 gradient
reduction with row traffic, and the step's wall time by mesh shape.

    python -m decagon_tpu_torch.scripts.multihost_bench [--device cpu] [--steps 24] [--out PATH]

Port of ``scripts/multihost_bench.py``: four ranks (one process each,
gloo over localhost) train the weight-sharded step on the poly50 graph
(2,000 proteins, 400 drugs, 50 side effects, ``planted_rank=16``, seed 7;
split 5% / 5%, seed 8), hidden 64 -> 32, dropout 0.1, batch 512, lr 1e-3,
24 steps of relation (1, 1, 0) on batches drawn from numpy seed 0, on the
meshes (2, 2) (f32 and bf16 ``grad_reduce_dtype``), (4, 1) and (1, 4):

* every rank must report the same summed loss trace (``worlds.agree``);
* ``1proc_4dev_2x2`` keeps the JAX key (one process, four virtual devices
  there) and holds the single process's trace on the same batches (the port
  has no in-process mesh): the unsharded step with the mesh's update (no
  gradient cast: the mesh steps cast none, as in the JAX package).  Since
  the mesh folds its dropout generators by edge slot, every run takes the
  same injected draws (``draws``: each step's dropout bits and negative
  uniforms from one CPU generator, ``layer_bits=`` / ``neg_u=``), so
  ``cross_process_equals_single_process`` holds the (2, 2) trace to the
  single process's at the JAX bound, 1e-4 on every loss;
* ``bf16_reduce_drift``: the (2, 2) bf16 trace against the f32 one, as the
  JAX script computes it;
* beyond the JAX script, ``reruns``: the single process and the (2, 2) mesh
  once more, each trace against its first run (how far the device's own
  summation order moves a trace), and ``teacher_forced``: each f32 mesh
  at each point of the single process's trajectory (its parameters, Adam
  state and gradients saved before every step), on the step's batch and
  draws: the loss, the gradients after the mesh's reduction, the
  parameters after the mesh's step and after the mesh's update of the
  single process's gradients, each against the single process's (the worst
  leaf over every rank's blocks), so that the two steps are held against
  each other where the trajectories have parted;
* ``teacher_forced_rule``: the rule that decides whether a mesh's trace
  leaving the single process's is a fault, stated before the card run
  that judged it.  At each of the single process's saved points, on every
  f32 mesh: (a) the loss within ``RULE_LOSS_ABS`` (the JAX bound, now per
  step from a shared point); (b) on every leaf and every rank's block, the
  gradients after the mesh's reduction within ``RULE_GRADS_REL`` of the
  leaf's largest magnitude; (c) the mesh's update applied to the single
  process's gradients gives the single process's next parameters bit for
  bit.  The control, the (2, 2) mesh with a bf16 row reduction
  (``CONTROL``), goes through the same points, and (b) must reject it.  A
  fault in the gradients or the update fails (b) or (c): the CPU tests
  inject two into the reduction and see the rule reject them.

Not built: the JAX record's literal counterpart, the same sharded program
with its four ranks in one process.  The port's collectives run inside
``autograd.Function.backward`` (``parallel/collectives.py``), and autograd
runs the CUDA nodes of every thread's backward on one device thread, so four
in-process ranks on ``cuda:0`` would block one another.

On the card every rank sits on ``cuda:0`` (NCCL cannot place two ranks on
one card): the steady ms read gloo, the host staging of
``parallel/collectives.py``'s ``_staged`` path and four processes sharing
one card and the host's cores, not NVLink (the record's ``caveat``).
K7 launches once an optimization step in every rank.  Writes
``artifacts/perf/torch_multihost_bench.json`` (``--out``).  Runs on CUDA
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.models.encoder import draw_layer_bits
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts import worlds
from decagon_tpu_torch.scripts.records import card_fields, launched, per, write_json
from decagon_tpu_torch.train.step import (
    TrainConfig, apply_optimizer, fold_in, make_loss_fn, make_optimizer, make_train_step,
    split_generator, step_generator, value_and_grad,
)

MODULE = "decagon_tpu_torch.scripts.multihost_bench"
ROOT = worlds.ROOT
OUT = os.path.join(ROOT, "artifacts", "perf", "torch_multihost_bench.json")

# The JAX script's configuration.
GRAPH = dict(n_proteins=2000, n_drugs=400, n_side_effects=50, seed=7, planted_rank=16)
SPLIT = dict(val_frac=0.05, test_frac=0.05, seed=8)
MODEL = dict(hidden1=64, hidden2=32, dropout=0.1)
TRAIN = dict(batch_size=512, learning_rate=1e-3)
STEPS = 24
EDGE_TYPE, K = (1, 1), 0
# tag: (nr, ne, processes, grad_reduce_dtype); one process = the single
# process's trace.
CONFIGS = {
    "1proc_4dev_2x2": (2, 2, 1, "float32"),
    "4proc_2x2": (2, 2, 4, "float32"),
    "4proc_2x2_bf16": (2, 2, 4, "bfloat16"),
    "4proc_4x1": (4, 1, 4, "float32"),
    "4proc_1x4": (1, 4, 4, "float32"),
}
EXACT_TOL = 1e-4
# Run a second time, each trace against its first run.
RERUN = ("1proc_4dev_2x2", "4proc_2x2")
# The seed of the injected draws (``draws``).
DRAW_SEED = 11
# ``teacher_forced_rule`` (the module docstring): (a) the loss's absolute
# gap, (b) the reduced gradients' gap over the leaf's largest magnitude,
# (c) the update's gap on the single process's gradients (bit for bit).
RULE_LOSS_ABS = EXACT_TOL
RULE_GRADS_REL = 1e-5
RULE_UPDATE_ONLY_REL = 0.0
# The control that rule (b) must reject: (nr, ne, grad_reduce_dtype).
CONTROL = (2, 2, "bfloat16")


def world(graph_kw: Optional[Dict] = None, split=SPLIT):
    """The graph of ``graph_kw`` (this script's by default) and its split."""
    graph = make_polypharmacy_like_graph(**(GRAPH if graph_kw is None else graph_kw))
    return graph, split_graph(graph, **split)


def batches(splits, steps: int, batch_size: int) -> List[np.ndarray]:
    """The JAX script's batches: ``steps`` draws of ``batch_size`` train
    edges of relation (1, 1, 0), numpy seed 0."""
    train = splits[EDGE_TYPE + (K,)].train
    rng = np.random.default_rng(0)
    return [train[rng.integers(0, len(train), batch_size)] for _ in range(steps)]


def draws(params, graph, model: DecagonModel, cfg: TrainConfig, i: int):
    """Step ``i``'s dropout bits (both layers, the single-process format)
    and negative uniforms, from one CPU generator: the same in every
    process."""
    c = model.config
    gen = torch.Generator().manual_seed(fold_in(DRAW_SEED, i))
    bits = draw_layer_bits(params, graph, gen, c.dropout, c.spmm_impl,
                           c.per_relation_dropout_max)
    u = torch.rand(cfg.batch_size * max(1, cfg.neg_sample_size), generator=gen)
    return bits, u.to(graph.device)


def train_trace(step: Callable, params, opt_state, graph, batch_list, device,
                draw: Optional[Callable] = None, save: Optional[Callable] = None) -> Dict:
    """The steps on ``batch_list``, each loss read (a sync a step, as the JAX
    script's ``float(loss)``): the losses, the first step's seconds, the
    steady ms a step (steps 3.. N over N - 2 steps) and the kernels'
    launches a step.  ``save(i, params, opt_state, rows, cols, draws)`` is
    called before each step, and ``save(N, params, opt_state)`` after the
    last (the times then include it)."""
    losses, t_first, t_steady = [], None, None
    cuda_build.reset_launches()
    for i, b in enumerate(batch_list):
        t0 = time.perf_counter()
        rows = torch.from_numpy(b[:, 0]).to(device)
        cols = torch.from_numpy(b[:, 1]).to(device)
        extra = {}
        if draw is not None:
            extra["layer_bits"], extra["neg_u"] = draw(i)
        if save is not None:
            save(i, params, opt_state, rows, cols, extra)
        params, opt_state, loss = step(params, opt_state, graph, K, rows, cols,
                                       step_generator(0, i, device), **extra)
        losses.append(float(loss))
        if i == 0:
            t_first = time.perf_counter() - t0
        elif i == 1:
            t_steady = time.perf_counter()
    n = len(batch_list)
    steady = (time.perf_counter() - t_steady) / max(1, n - 2) if n > 2 else float("nan")
    if save is not None:
        save(n, params, opt_state)
    return {"losses": [round(x, 6) for x in losses], "first_step_s": round(t_first, 3),
            "steady_ms_per_step": round(steady * 1e3, 3),
            "launches_per_step": per(launched(), n), "params": params}


def mesh_setup(graph, splits, mesh, shape, device, model_kw: Dict, cfg: TrainConfig,
               shard_weights: bool = True):
    """This rank's sharded graph, model, full initial params (the draws'
    shapes), local params and Adam state, and the sharded step."""
    from decagon_tpu_torch.parallel.mesh import mesh_slot
    from decagon_tpu_torch.parallel.rowshard import build_sharded_device_graph
    from decagon_tpu_torch.parallel.sharded import (
        local_relation_block, make_sharded_train_step,
    )

    sg = build_sharded_device_graph(graph, splits, shape, mesh_slot(mesh), device)
    model = DecagonModel(ModelConfig(**model_kw), sg)
    params = model.init_params(torch.Generator().manual_seed(0), sg)
    opt = make_optimizer(cfg)
    opt_state = opt.init(params)
    if shard_weights:
        local, state = local_relation_block(params, sg), local_relation_block(opt_state, sg)
    else:
        local, state = params, opt_state
    step = make_sharded_train_step(model, EDGE_TYPE, cfg, opt, mesh, sg,
                                   shard_weights=shard_weights)
    return sg, model, params, local, state, step


def rank_main(rank: int, n_ranks: int, port: int, nr: int, ne: int, dtype: str,
              steps: int = STEPS, device: str = "cuda", graph_kw: Optional[Dict] = None,
              model_kw: Optional[Dict] = None, batch_size: int = TRAIN["batch_size"],
              threads: Optional[int] = None, save_dir: Optional[str] = None,
              teacher_dir: Optional[str] = None) -> Dict:
    """One rank of a ``(nr, ne)`` world: the weight-sharded step on the
    injected draws; its trace, times and K7 launches a step.  Joins the
    process group (or uses the one this process holds).  A world of one
    rank is the single process (``single_trace``, saving its parameters
    to ``save_dir``); with ``teacher_dir`` the rank gives
    ``teacher_points`` instead of training."""
    from decagon_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(threads or max(1, (os.cpu_count() or 1) // n_ranks))
    if n_ranks == 1:
        return single_trace(steps, device, graph_kw, model_kw, batch_size, save_dir)
    dev = worlds.rank_device(device)
    created = worlds.join_group(rank, n_ranks, port)
    try:
        graph, splits = world(graph_kw)
        cfg = TrainConfig(**dict(TRAIN, batch_size=batch_size), grad_reduce_dtype=dtype)
        mesh = make_mesh(shape=(nr, ne), backend="gloo")
        sg, model, params, local, state, step = mesh_setup(
            graph, splits, mesh, (nr, ne), dev, dict(MODEL, **(model_kw or {})), cfg)
        if teacher_dir is not None:
            return dict(teacher_points(mesh, sg, model, params, cfg, splits, steps, dev,
                                       teacher_dir, batch_size), pid=rank)
        out = train_trace(step, local, state, sg, batches(splits, steps, batch_size), dev,
                          lambda i: draws(params, sg, model, cfg, i))
        out.pop("params")
        return dict(out, pid=rank)
    finally:
        worlds.leave_group(created)


def single_trace(steps: int = STEPS, device: str = "cuda", graph_kw: Optional[Dict] = None,
                 model_kw: Optional[Dict] = None, batch_size: int = TRAIN["batch_size"],
                 save_dir: Optional[str] = None) -> Dict:
    """The single process on the same batches and draws: the unsharded step
    with the mesh's update (``grad_dtype`` f32: no cast).  ``save_dir``:
    each step's starting point is saved there (``point_<i>.pt``: its
    parameters, Adam state and gradients; ``point_<N>.pt`` the last
    parameters), and the times include the saves; on the CPU they run on one
    thread, since several threads sum a scatter-add in no fixed order and the
    saved gradients would then not be the ones the step applied."""
    dev = worlds.rank_device(device)
    threads = torch.get_num_threads()
    if save_dir is not None and dev.type == "cpu":
        torch.set_num_threads(1)
    try:
        return _single_trace(steps, dev, graph_kw, model_kw, batch_size, save_dir)
    finally:
        torch.set_num_threads(threads)


def _single_trace(steps, dev, graph_kw, model_kw, batch_size, save_dir) -> Dict:
    graph, splits = world(graph_kw)
    dg = build_device_graph(graph, splits, densify_max_cells=400_000_000, build_fused=False,
                            device=dev)
    model = DecagonModel(ModelConfig(**dict(MODEL, **(model_kw or {}))), dg)
    cfg = TrainConfig(**dict(TRAIN, batch_size=batch_size), grad_dtype="float32")
    opt = make_optimizer(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), dg)
    save = None
    if save_dir is not None:
        loss_fn = make_loss_fn(model, EDGE_TYPE, cfg)

        def save(i, p, state, rows=None, cols=None, extra=None):
            point = {"params": p, "opt_state": state}
            if rows is not None:
                gens = split_generator(step_generator(0, i, dev))
                point["grads"] = value_and_grad(loss_fn, p, dg, K, rows, cols, *gens,
                                                **extra)[1]
            torch.save(point, os.path.join(save_dir, f"point_{i}.pt"))

    out = train_trace(make_train_step(model, EDGE_TYPE, cfg, opt), params, opt.init(params), dg,
                      batches(splits, steps, batch_size), dev,
                      lambda i: draws(params, dg, model, cfg, i), save)
    out.pop("params")
    return dict(out, pid=0)


def leaf_gap(got, want, base=None) -> Dict:
    """The worst leaf of ``got`` against ``want`` (trees of one structure):
    its name, largest absolute difference and that difference over the
    leaf's largest magnitude in ``want`` or, given ``base``, over its
    largest change from ``base`` to ``want`` (``rel``)."""
    from decagon_tpu_torch.train.step import _leaves

    worst = {"leaf": None, "max_abs": 0.0, "rel": 0.0}
    bases = _leaves(base) if base is not None else [(None, None)] * len(_leaves(want))
    for (name, a), (_, b), (_, c) in zip(_leaves(got), _leaves(want), bases):
        if not b.numel():
            continue
        a, b = a.float(), b.float()
        d = float((a - b).abs().max())
        scale = float((b if c is None else b - c.float()).abs().max())
        rel = d / scale if scale > 0 else d
        if worst["leaf"] is None or rel > worst["rel"]:
            worst = {"leaf": "/".join(map(str, name)), "max_abs": d, "rel": rel}
    return worst


def teacher_points(mesh, sg, model, params, cfg: TrainConfig, splits, steps: int, device,
                   teacher_dir: str, batch_size: int) -> Dict:
    """The mesh at each of the single process's saved points
    (``teacher_dir``), on the step's batch and draws: its loss, its
    gradients after the mesh's reduction against the single process's
    (this rank's relation blocks), and this rank's parameters after one
    sharded step from the point's parameters and Adam state against the
    single process's next point (``leaf_gap``, over the single step's
    change of each leaf); ``update_only``: the same with the mesh's update
    applied to the single process's gradients."""
    from decagon_tpu_torch.parallel.sharded import (
        local_relation_block, make_sharded_grads_fn, make_sharded_train_step,
    )

    grads = make_sharded_grads_fn(model, EDGE_TYPE, cfg, mesh, sg, shard_weights=True)
    opt = make_optimizer(cfg)
    step = make_sharded_train_step(model, EDGE_TYPE, cfg, opt, mesh, sg, shard_weights=True)

    def load(i):
        return torch.load(os.path.join(teacher_dir, f"point_{i}.pt"), map_location=device,
                          weights_only=False)

    out = {"losses": [], "grads": [], "params": [], "update_only": []}
    nxt = load(0)
    for i, b in enumerate(batches(splits, steps, batch_size)):
        point, nxt = nxt, load(i + 1)
        bits, u = draws(params, sg, model, cfg, i)
        rows, cols = (torch.from_numpy(b[:, c]).to(device) for c in (0, 1))
        start = local_relation_block(point["params"], sg)
        state = local_relation_block(point["opt_state"], sg)
        want = local_relation_block(nxt["params"], sg)
        single_grads = local_relation_block(point["grads"], sg)
        loss, g = grads(start, sg, K, rows, cols, step_generator(0, i, device),
                        layer_bits=bits, neg_u=u)
        out["losses"].append(round(float(loss), 6))
        out["grads"].append(leaf_gap(g, single_grads))
        # Copies: the update may write its leaves and moments in place.
        new, _, _ = step(copy.deepcopy(start), copy.deepcopy(state), sg, K, rows, cols,
                         step_generator(0, i, device), layer_bits=bits, neg_u=u)
        out["params"].append(leaf_gap(new, want, start))
        # The mesh's update applied to the single process's gradients: the
        # update alone, without the two gradients' rounding apart.
        with torch.no_grad():
            new, _ = apply_optimizer(opt, cfg, single_grads, copy.deepcopy(state),
                                     copy.deepcopy(start))
        out["update_only"].append(leaf_gap(new, want, start))
    return out


def summarize(results: Dict[int, Dict]) -> Dict:
    """A world's entry: the agreed trace, rank 0's first step, the slowest
    rank's steady ms and every rank's K7 launches a step."""
    return {
        "losses": worlds.agree(results),
        "first_step_s": results[0]["first_step_s"],
        "steady_ms_per_step": max(r["steady_ms_per_step"] for r in results.values()),
        "adam_launches_per_step": [results[r]["launches_per_step"].get("adam", 0.0)
                                   for r in sorted(results)],
    }


def run_config(nr: int, ne: int, nproc: int, dtype: str, steps: int = STEPS,
               device: str = "cuda", **kw) -> Dict:
    return summarize(worlds.run_world(MODULE, nproc, dict(nr=nr, ne=ne, dtype=dtype,
                                                          steps=steps, device=device, **kw)))


def derive(out: Dict) -> None:
    """The JAX script's verdicts from the configs' traces."""
    a = out["configs"]["1proc_4dev_2x2"]["losses"]
    b = out["configs"]["4proc_2x2"]["losses"]
    out["cross_process_equals_single_process"] = bool(
        max(abs(x - y) for x, y in zip(a, b)) < EXACT_TOL)
    out["max_abs_vs_single_process"] = {
        tag: max(abs(x - y) for x, y in zip(a, c["losses"]))
        for tag, c in out["configs"].items() if tag != "1proc_4dev_2x2"}
    f32 = out["configs"]["4proc_2x2"]["losses"]
    bf16 = out["configs"]["4proc_2x2_bf16"]["losses"]
    out["bf16_reduce_drift"] = {
        "max_abs": round(max(abs(x - y) for x, y in zip(f32, bf16)), 5),
        "final_rel": round(abs(f32[-1] - bf16[-1]) / abs(f32[-1]), 5),
        "note": "nr=2 mesh: the row-axis enc-grad sum really runs in bf16 here (the nr=1 "
                "gate skips the cast)",
    }


def _worst(entries: List[Dict]) -> Dict:
    return max(entries, key=lambda e: e["rel"])


def teacher_tag(nr: int, ne: int, dtype: str) -> str:
    """The ``CONFIGS`` tag of a 4-rank mesh and reduction dtype."""
    return f"4proc_{nr}x{ne}" + ("" if dtype == "float32" else "_bf16")


def teacher_forced(meshes, steps: int, device: str, **kw) -> Dict:
    """The single process's trace, its points saved at every step, and each
    ``(nr, ne, grad_reduce_dtype)`` mesh of ``meshes`` at each of those
    points (``teacher_points``): whether the two steps compute one function,
    one gradient and one update where the trajectories part.  Each step's
    gradient and parameter gaps are the worst over the ranks."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        single = worlds.run_world(MODULE, 1, dict(nr=1, ne=1, dtype="float32", steps=steps,
                                                  device=device, save_dir=tmp, **kw))[0]
        for nr, ne, dtype in meshes:
            ranks = worlds.run_world(MODULE, nr * ne, dict(
                nr=nr, ne=ne, dtype=dtype, steps=steps, device=device, teacher_dir=tmp, **kw))
            out[teacher_tag(nr, ne, dtype)] = teacher_entry(single["losses"], ranks)
    return out


def judge(entry: Dict) -> Dict:
    """Rule (a)-(c) on a ``teacher_entry``: each part's worst figure beside
    its limit, the step it came from, and whether the part and the whole
    hold.  A NaN figure holds nothing."""
    def worst_step(by_step):
        return max(range(len(by_step)), key=lambda i: by_step[i]["rel"])

    diffs = entry["abs_diff_by_step"]
    parts = {
        "a_loss_abs": dict(worst=entry["max_abs"], limit=RULE_LOSS_ABS,
                           step=max(range(len(diffs)), key=diffs.__getitem__),
                           holds=entry["max_abs"] < RULE_LOSS_ABS),
        "b_grads_rel": dict(worst=entry["grads_worst"]["rel"], limit=RULE_GRADS_REL,
                            leaf=entry["grads_worst"]["leaf"],
                            step=worst_step(entry["grads_by_step"]),
                            holds=entry["grads_worst"]["rel"] < RULE_GRADS_REL),
        "c_update_only_rel": dict(worst=entry["update_only_worst"]["rel"],
                                  limit=RULE_UPDATE_ONLY_REL,
                                  leaf=entry["update_only_worst"]["leaf"],
                                  step=worst_step(entry["update_only_by_step"]),
                                  holds=entry["update_only_worst"]["rel"] <= RULE_UPDATE_ONLY_REL),
    }
    return dict(parts, holds=all(p["holds"] for p in parts.values()))


def rule_record(teacher: Dict) -> Dict:
    """``teacher_forced_rule``: ``judge`` of every f32 mesh of ``teacher``
    and of the control, whether the rule holds on every f32 mesh and
    whether it rejects the control."""
    control = teacher_tag(*CONTROL)
    meshes = {tag: judge(e) for tag, e in teacher.items() if tag != control}
    out = {"rule": ("at each of the single process's saved points: (a) |loss - single| < "
                    f"{RULE_LOSS_ABS}; (b) every leaf and rank block of the reduced gradients "
                    f"within {RULE_GRADS_REL} of the leaf's largest magnitude; (c) the mesh's "
                    "update of the single process's gradients equals its next parameters bit "
                    "for bit"),
           "meshes": meshes, "holds_on_every_f32_mesh": all(m["holds"] for m in meshes.values())}
    if control in teacher:
        out["control"] = {control: judge(teacher[control])}
        out["control_rejected"] = not out["control"][control]["holds"]
    return out


def teacher_entry(single_losses: List[float], ranks: Dict[int, Dict]) -> Dict:
    """``teacher_forced``'s entry from the single process's losses and the
    ranks' ``teacher_points``."""
    mesh = worlds.agree(ranks)
    diffs = [abs(x - y) for x, y in zip(single_losses, mesh)]
    grads = [_worst([r["grads"][i] for r in ranks.values()]) for i in range(len(mesh))]
    params = [_worst([r["params"][i] for r in ranks.values()]) for i in range(len(mesh))]
    update = [_worst([r["update_only"][i] for r in ranks.values()]) for i in range(len(mesh))]
    return {"single_losses": single_losses, "mesh_losses": mesh,
            "abs_diff_by_step": diffs, "max_abs": max(diffs),
            "grads_by_step": grads, "grads_worst": _worst(grads),
            "params_by_step": params, "params_worst": _worst(params),
            "update_only_by_step": update, "update_only_worst": _worst(update)}


def multihost_bench(device: str = "cuda", steps: int = STEPS, configs=None,
                    log: Callable = print, **kw) -> Dict:
    """The record; ``configs`` and ``kw`` (``graph_kw``, ``model_kw``,
    ``batch_size``) cut the workload."""
    dev = worlds.rank_device(device)
    if dev.type == "cuda":
        cuda_build.library()  # built once, before the ranks load it
    t0 = time.perf_counter()
    out = {
        "caveat": (
            "one card: the 4 ranks share cuda:0 over gloo (NCCL cannot place two ranks on one "
            "card), so steady_ms_per_step reads gloo, the host staging of each collective "
            "(parallel/collectives.py _staged) and 4 processes sharing one card and the "
            "host's cores, not NVLink; the contention-free traffic inventory is "
            "torch_hlo_collectives.json. steady_ms_per_step: steps 3..N over N - 2 steps (the "
            "JAX script divides the same window by N - 1)" if dev.type == "cuda" else
            "CPU ranks over gloo, sharing the host's cores: steady_ms_per_step reads gloo and "
            "core contention"),
        "workload": "poly50, batch 512, weight-sharded step",
        "single_process_note": (
            "1proc_4dev_2x2 keeps the JAX key; the port has no in-process mesh, so it holds the "
            "single process's trace (the unsharded step with the mesh's update, no gradient "
            "cast) on the same batches; every config takes the same injected dropout bits and "
            "negative uniforms"),
        **card_fields(dev),
        "configs": {},
    }
    for tag, (nr, ne, nproc, dtype) in (configs or CONFIGS).items():
        r = run_config(nr, ne, nproc, dtype, steps, device, **kw)
        out["configs"][tag] = r
        log(f"[mh +{time.perf_counter() - t0:.0f}s] {tag}: {r['steady_ms_per_step']} ms/step, "
            f"K7 {r['adam_launches_per_step']} a step")
    derive(out)
    out["reruns"] = {}
    for tag in (t for t in RERUN if t in out["configs"]):
        first = out["configs"][tag]["losses"]
        again = run_config(*(configs or CONFIGS)[tag], steps, device, **kw)["losses"]
        out["reruns"][tag] = {"losses": again, "max_abs_vs_first_run": max(
            abs(x - y) for x, y in zip(first, again))}
        log(f"[mh +{time.perf_counter() - t0:.0f}s] {tag} again: "
            f"{out['reruns'][tag]['max_abs_vs_first_run']} from its first run")
    runs = (configs or CONFIGS).values()
    meshes = sorted({(nr, ne, dtype) for nr, ne, nproc, dtype in runs
                     if nproc > 1 and (dtype == "float32" or (nr, ne, dtype) == CONTROL)})
    out["teacher_forced"] = teacher_forced(meshes, steps, device, **kw)
    for tag, tf in out["teacher_forced"].items():
        log(f"[mh +{time.perf_counter() - t0:.0f}s] {tag} on the single process's points: "
            f"loss {tf['max_abs']}, gradients {tf['grads_worst']}, parameters "
            f"{tf['params_worst']}, the update alone {tf['update_only_worst']}")
    out["teacher_forced_rule"] = rule_record(out["teacher_forced"])
    log(f"[mh +{time.perf_counter() - t0:.0f}s] the rule: "
        f"{json.dumps(out['teacher_forced_rule'])}")
    out["wall_s"] = round(time.perf_counter() - t0, 1)
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    out = multihost_bench(args.device, args.steps)
    write_json(args.out, out)
    print(json.dumps({k: v for k, v in out.items() if k != "configs"}))
    print("wrote", args.out)
    return out


if __name__ == "__main__":
    if worlds.is_worker(sys.argv[1:]):
        worlds.worker(rank_main, sys.argv[2])
    else:
        main()
