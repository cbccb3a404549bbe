"""Train and evaluation steps.

Port of ``decagon_tpu/train/step.py``: ``TrainConfig``, the optimizer
(fused Adam with its learning-rate schedules, whose update on CUDA is one
launch of the multi-tensor one-pass Adam kernel K7 for every leaf; the
lazy decoder Adam; ``pallas_adam``'s in-place leaves), the single step
``make_train_step``, the chunked steps ``make_chunked_train_step`` and
``make_grouped_chunked_train_step``, and the evaluation steps
``make_eval_scores``, ``make_embed_fn`` and ``make_emb_scores``.  Each
step: the full-graph encoder forward with dropout, positive scores on the
batch edges, ``batch_size`` negative rows from the relation's
unigram^0.75 CDF, hinge or cross-entropy loss, gradients by autograd,
Adam.

Randomness.  A step's draws come from ``step_generator(base_seed,
step_no)``, a pure function of two integers (the counterpart of
``jax.random.fold_in(base_rng, step_no)``), split into the encoder's and
the sampler's generators as the JAX step splits its key.  So a chunk of
steps and the same steps taken one by one draw the same numbers.  The
generators are seeded on the host: no step waits for the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from decagon_tpu_torch import DeviceLike
from decagon_tpu_torch.graph.container import EdgeType
from decagon_tpu_torch.graph.device import DeviceGraph, etkey
from decagon_tpu_torch.models import decoders as dec
from decagon_tpu_torch.models.losses import LOSSES
from decagon_tpu_torch.models.model import DecagonModel
from decagon_tpu_torch.ops.optim import (
    GradientTransformation,
    fused_adam,
    pallas_gate,
    tree_map,
)
from decagon_tpu_torch.ops.sddmm_pallas import MAX_DIM as SDDMM_MAX_DIM
from decagon_tpu_torch.ops.sddmm_pallas import sddmm_edges
from decagon_tpu_torch.train.negatives import sample_unigram


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization hyperparameters, with every field of the JAX package's
    ``TrainConfig`` and its defaults (reference ``configuration.json``).

    Every field runs.  Three are read by the mesh path only
    (``Trainer(mesh=...)``, ``parallel/sharded.py``): ``shard_weights``
    keeps the dense edge types' enc stacks and moments as each rank's
    relation block; ``comm_overlap`` issues every edge type's exchange
    before waiting for any; ``grad_reduce_dtype`` ("float32" or
    "bfloat16") is the type the relation-sharded gradients cross the
    ``row`` axis in, on a mesh of more than one row block.  As in the JAX
    package the mesh steps do not cast gradients (``grad_dtype``).
    ``relation_group > 1`` needs ``scan_chunk > 0``, as in the JAX
    package; ``lr_schedule`` is ``"constant"``, ``"cosine"`` or ``"step"``
    over ``lr_schedule_steps`` optimization steps (constant when
    ``lr_schedule_steps <= 0``); ``pallas_adam`` updates 3-D f32 leaves of
    at least 2^20 elements in place (in the same launch of the one-pass
    Adam kernel as the other leaves) on CUDA when there is no schedule and
    no lazy decoder Adam.
    """

    batch_size: int = 512
    learning_rate: float = 1e-3
    lr_schedule: str = "constant"
    lr_schedule_steps: int = 0
    lr_min_frac: float = 0.1
    lr_decay_rate: float = 0.5
    loss: str = "hinge"
    margin: float = 0.1
    neg_sample_size: int = 1
    neg_sample_weight: float = 1.0
    num_epochs: int = 50
    scan_chunk: int = 0
    schedule: str = "reference"
    pallas_adam: bool = False
    relation_group: int = 1
    adam_moments_dtype: str = "bfloat16"
    grad_dtype: str = "bfloat16"
    lazy_decoder_adam: bool = False
    shard_weights: bool = True
    comm_overlap: bool = True
    grad_reduce_dtype: str = "float32"


# TF1 AdamOptimizer defaults (reference optimizer.py:111-114).
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


def _lazy_rows_adam(
    learning_rate: float, b1: float, b2: float, eps: float
) -> GradientTransformation:
    """Adam with per-row lazy moments: rows (slices over the last axis)
    whose gradient is entirely zero keep m, v and the parameter unchanged
    (TF1's ``_apply_sparse`` for gathered rows).  Bias correction uses the
    global step count.  Same expressions, in the same order, as the JAX
    package's."""

    def init(params):
        return {
            "m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "t": 0,
        }

    def update(grads, state):
        t = state["t"] + 1
        tf = torch.tensor(float(t), dtype=torch.float32)
        b1t = (1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), tf)).item()
        b2t = (1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), tf)).item()

        def one(g, m, v):
            mask = torch.any(g != 0, dim=-1, keepdim=True)
            m_new = torch.where(mask, b1 * m + (1 - b1) * g, m)
            v_new = torch.where(mask, b2 * v + (1 - b2) * g * g, v)
            upd = torch.where(
                mask,
                -learning_rate * (m_new / b1t) / (torch.sqrt(v_new / b2t) + eps),
                0.0,
            )
            return upd, m_new, v_new

        outs = tree_map(one, grads, state["m"], state["v"])
        upd, m, v = (tree_map(lambda o, i=i: o[i], outs) for i in range(3))
        return upd, {"m": m, "v": v, "t": t}

    return GradientTransformation(init, update)


def _decoder_split(enc: GradientTransformation, dec_opt: GradientTransformation):
    """``enc`` over every top-level subtree but ``"dec"``, ``dec_opt`` over
    ``{"dec": ...}``, each with its own state and step count (optax's
    ``multi_transform`` with labels ``"enc"``/``"dec"``).  State
    ``{"enc": ..., "dec": ...}``."""

    def parts(tree):
        return {k: v for k, v in tree.items() if k != "dec"}, {"dec": tree["dec"]}

    def init(params):
        p_enc, p_dec = parts(params)
        return {"enc": enc.init(p_enc), "dec": dec_opt.init(p_dec)}

    def update(grads, state):
        g_enc, g_dec = parts(grads)
        u_enc, s_enc = enc.update(g_enc, state["enc"])
        u_dec, s_dec = dec_opt.update(g_dec, state["dec"])
        both = {**u_enc, **u_dec}
        return {k: both[k] for k in grads}, {"enc": s_enc, "dec": s_dec}

    def apply(grads, state, params, round_grad=None, in_place=None):
        # ``enc``'s one-pass update for its subtree; ``dec_opt``'s update
        # and ``p + u`` for the decoder's, its gradients cast first.
        (g_enc, g_dec), (p_enc, p_dec) = parts(grads), parts(params)
        p_enc, s_enc = enc.apply(g_enc, state["enc"], p_enc, round_grad, in_place)
        if round_grad is not None:
            g_dec = tree_map(lambda g: g.to(torch.bfloat16) if round_grad(g) else g, g_dec)
        u_dec, s_dec = dec_opt.update(g_dec, state["dec"])
        both = {**p_enc, **tree_map(lambda p, u: (p + u).to(p.dtype), p_dec, u_dec)}
        return {k: both[k] for k in params}, {"enc": s_enc, "dec": s_dec}

    return GradientTransformation(init, update, apply)


def _lr_schedule_fn(cfg: TrainConfig) -> Optional[Callable[[int], float]]:
    """``lr(t)`` of the int optimization step, in f32 as the JAX package
    traces it, or None for a constant rate."""
    kind = cfg.lr_schedule
    total = int(cfg.lr_schedule_steps)
    base = cfg.learning_rate
    if kind == "constant" or total <= 0:
        return None
    if kind == "cosine":
        floor = base * float(cfg.lr_min_frac)

        def cosine(t: int) -> float:
            frac = torch.clamp(torch.tensor(float(t), dtype=torch.float32) / total, max=1.0)
            return (floor + (base - floor) * 0.5 * (1.0 + torch.cos(math.pi * frac))).item()

        return cosine
    if kind == "step":
        rate = float(cfg.lr_decay_rate)

        def step_decay(t: int) -> float:
            tf = torch.tensor(float(t), dtype=torch.float32)
            return (base * torch.pow(
                torch.tensor(rate, dtype=torch.float32), torch.floor(tf / total)
            )).item()

        return step_decay
    raise ValueError(f"unknown lr_schedule: {kind}")


def make_optimizer(
    cfg: TrainConfig, one_pass: Optional[Callable] = None
) -> GradientTransformation:
    """The fused Adam with the configured moment dtype and learning-rate
    schedule; with ``lazy_decoder_adam`` the decoder subtree takes the lazy
    row Adam instead (no schedule allowed there, as in the JAX package).
    ``one_pass``: the fused Adam's ``apply`` (``ops/optim.adam_apply``
    unless given; ``adam_apply_ref`` runs the plain version on the card)."""
    if cfg.loss not in LOSSES:
        raise ValueError(f"unknown loss: {cfg.loss!r}")
    moments = (
        torch.bfloat16 if cfg.adam_moments_dtype in ("bfloat16", "bf16") else None
    )
    schedule = _lr_schedule_fn(cfg)
    adam = fused_adam(
        cfg.learning_rate, b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS,
        moments_dtype=moments, schedule=schedule, one_pass=one_pass,
    )
    if not cfg.lazy_decoder_adam:
        return adam
    if schedule is not None:
        raise ValueError("lr_schedule is not supported with lazy_decoder_adam")
    return _decoder_split(adam, _lazy_rows_adam(cfg.learning_rate, ADAM_B1, ADAM_B2, ADAM_EPS))


def grad_rounding(cfg: TrainConfig) -> Optional[Callable[[torch.Tensor], bool]]:
    """Which gradient leaves ``grad_dtype`` rounds to bf16: those of at
    least 2^20 elements when it is bf16 (None: none)."""
    if cfg.grad_dtype not in ("bfloat16", "bf16"):
        return None
    return lambda g: g.numel() >= (1 << 20)


def cast_grads(cfg: TrainConfig, grads):
    """Cast gradient leaves of at least 2^20 elements to bf16 when
    ``grad_dtype`` is bf16; smaller leaves stay f32."""
    rounds = grad_rounding(cfg)
    if rounds is None:
        return grads
    return tree_map(lambda g: g.to(torch.bfloat16) if rounds(g) else g, grads)


def apply_optimizer(optimizer, cfg: TrainConfig, grads, opt_state, params, cast: bool = False):
    """New ``(params, opt_state)``: the optimizer's ``apply``, the
    multi-tensor one-pass kernel K7 on CUDA (new tensors), for the fused
    Adam's leaves and the lazy decoder Adam's encoder leaves alike.
    ``cast``: the gradients still take ``grad_dtype``'s rounding, which
    the kernel does as it reads them (the single-device steps pass their
    raw gradients, the mesh steps cast none).  With ``pallas_adam`` under
    the JAX package's conditions (no schedule, no lazy decoder Adam) the
    leaves of its gate (``ops/optim.pallas_gate``) are updated in place
    in the same launch."""
    round_grad = grad_rounding(cfg) if cast else None
    in_place = None
    if cfg.pallas_adam and _lr_schedule_fn(cfg) is None and not cfg.lazy_decoder_adam:
        in_place = pallas_gate(round_grad=round_grad)
    return optimizer.apply(grads, opt_state, params, round_grad, in_place)


# ---- per-step generators ---------------------------------------------

_MASK64 = (1 << 64) - 1
_SPLIT = 1 << 62  # keeps split children apart from fold_in children


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (splitmix64 of both):
    the counterpart of ``jax.random.fold_in`` on integer seeds."""
    return _splitmix64(_splitmix64(seed & _MASK64) ^ (data & _MASK64)) >> 1


def make_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def step_generator(base_seed: int, step_no: int, device) -> torch.Generator:
    """The generator of step ``step_no`` on ``device``: a pure function of
    the two integers, seeded on the host."""
    return make_generator(fold_in(base_seed, step_no), device)


def fold_generator(generator: torch.Generator, data: int) -> torch.Generator:
    """A generator seeded from ``generator``'s seed and ``data`` (the
    counterpart of ``fold_in(key, data)``), on the same device."""
    return make_generator(fold_in(generator.initial_seed(), data), generator.device)


def split_generator(generator: torch.Generator, n: int = 2) -> List[torch.Generator]:
    """``n`` new generators on ``generator``'s device, seeded from its seed
    (the counterpart of ``jax.random.split``; no device work)."""
    seed = generator.initial_seed()
    return [make_generator(fold_in(seed, _SPLIT + i), generator.device) for i in range(n)]


def _leaves(tree, prefix=()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    if isinstance(tree, dict):
        out = []
        for key in tree:
            out.extend(_leaves(tree[key], prefix + (key,)))
        return out
    return [(prefix, tree)]


def _rebuild(tree, values, it=None):
    it = iter(values) if it is None else it
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], values, it) for key in tree}
    return next(it)


def make_scoring_loss(model: DecagonModel, edge_type: EdgeType, cfg: TrainConfig) -> Callable:
    """``loss(params, graph, embeddings, k, rows, cols, sample_gen,
    neg_u=None)``: positive scores, ``batch_size * neg_sample_size``
    negatives, and the configured loss, given the embeddings.  ``neg_u``
    replaces the negative-sampling uniforms."""
    et_key = etkey(edge_type)

    def loss_fn(params, graph: DeviceGraph, embeddings, k, rows, cols, sample_gen, neg_u=None):
        # Scoring is deterministic given the embeddings: the reference
        # train path applies dropout only inside the encoder.
        pos = model.score_edges(params, graph, embeddings, edge_type, k, rows, cols)
        ns = max(1, cfg.neg_sample_size)
        neg_rows = sample_unigram(
            sample_gen, graph.neg_cdf[et_key][k], cfg.batch_size * ns, u=neg_u
        )
        neg_cols = cols.repeat(ns) if ns > 1 else cols
        neg = model.score_edges(
            params, graph, embeddings, edge_type, k, neg_rows, neg_cols
        )
        if cfg.loss == "hinge":
            pos_t = pos.repeat(ns) if ns > 1 else pos
            return LOSSES["hinge"](pos_t, neg, cfg.margin)
        return LOSSES["xent"](pos, neg, cfg.neg_sample_weight)

    return loss_fn


def make_loss_fn(model: DecagonModel, edge_type: EdgeType, cfg: TrainConfig) -> Callable:
    """``loss(params, graph, k, rows, cols, enc_gen, sample_gen,
    layer_bits=None, neg_u=None)``: the body of the JAX package's
    ``make_train_step.loss_fn``.  ``layer_bits`` and ``neg_u`` replace the
    dropout and the negative-sampling draws."""
    scoring = make_scoring_loss(model, edge_type, cfg)

    def loss_fn(params, graph: DeviceGraph, k, rows, cols, enc_gen, sample_gen,
                layer_bits=None, neg_u=None):
        embeddings = model.embeddings(
            params, graph, enc_gen, deterministic=False, layer_bits=layer_bits
        )
        return scoring(params, graph, embeddings, k, rows, cols, sample_gen, neg_u=neg_u)

    return loss_fn


def value_and_grad(loss_fn: Callable, params, *args, marks=None, **kwargs):
    """``(loss, grads)`` of ``loss_fn(params, ...)`` with respect to every
    leaf of ``params`` (zeros for a leaf the loss does not reach), as
    ``jax.value_and_grad``.  ``marks``, when given, is called with
    "forward" and "backward" as each phase is queued."""
    leaves = [t.detach().requires_grad_(True) for _, t in _leaves(params)]
    loss = loss_fn(_rebuild(params, leaves), *args, **kwargs)
    if marks is not None:
        marks("forward")
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    if marks is not None:
        marks("backward")
    return loss.detach(), _rebuild(params, grads)


def _update(cfg, optimizer, loss_fn, params, opt_state, *args, **kwargs):
    """One optimization step: gradients of ``loss_fn``, then the
    optimizer with the gradient cast.  Returns ``(params, opt_state,
    loss)``."""
    marks = kwargs.get("marks")
    loss, grads = value_and_grad(loss_fn, params, *args, **kwargs)
    with torch.no_grad():
        params, opt_state = apply_optimizer(optimizer, cfg, grads, opt_state, params, cast=True)
    if marks is not None:
        marks("update")
    return params, opt_state, loss


def make_train_step(
    model: DecagonModel,
    edge_type: EdgeType,
    cfg: TrainConfig,
    optimizer: GradientTransformation,
) -> Callable:
    """``step(params, opt_state, graph, k, rows, cols, generator,
    layer_bits=None, neg_u=None, marks=None) -> (params, opt_state,
    loss)`` for one edge type.  The generator splits into the encoder's
    and the sampler's, as the JAX step splits its key; like the key, it is
    read by its seed, so the same generator gives the same draws.  Pass
    each step its own, ``step_generator(base_seed, step_no)`` (the JAX
    step's ``fold_in(base_rng, step_no)``), as the ``Trainer`` does.
    ``marks`` is called with
    "forward", "backward" and "update" as each phase is queued (for
    timing).  With ``pallas_adam`` the kernel's leaves are updated in
    place (the JAX step donates its parameters)."""
    loss_fn = make_loss_fn(model, edge_type, cfg)

    def step(params, opt_state, graph, k, rows, cols, generator,
             layer_bits=None, neg_u=None, marks=None):
        enc_gen, sample_gen = split_generator(generator)
        return _update(
            cfg, optimizer, loss_fn, params, opt_state, graph, k, rows, cols,
            enc_gen, sample_gen, layer_bits=layer_bits, neg_u=neg_u, marks=marks,
        )

    return step


def make_train_steps(
    model: DecagonModel, graph: DeviceGraph, cfg: TrainConfig
) -> Tuple[Dict[EdgeType, Callable], GradientTransformation]:
    """One ``make_train_step`` per edge type, sharing one optimizer."""
    optimizer = make_optimizer(cfg)
    steps = {et: make_train_step(model, et, cfg, optimizer) for et in graph.edge_types}
    return steps, optimizer


def _host_list(x) -> list:
    """A host-side sequence (list, numpy array or CPU tensor) as a list."""
    if isinstance(x, torch.Tensor):
        return x.tolist()
    return np.asarray(x).tolist()


def _nan(device) -> torch.Tensor:
    return torch.full((), float("nan"), dtype=torch.float32, device=device)


def make_chunked_train_step(
    model: DecagonModel,
    graph: DeviceGraph,
    cfg: TrainConfig,
    optimizer: GradientTransformation,
) -> Callable:
    """Many optimization steps in one call, over any mix of edge types.

    Returns ``chunk(params, opt_state, graph, base_seed, branch[C], k[C],
    rows[C, B], cols[C, B], step_no[C], valid[C], layer_bits=None,
    neg_u=None) -> (params, opt_state, losses[C])``.  ``branch`` indexes
    ``graph.edge_types``; ``branch``, ``k``, ``step_no`` and ``valid`` are
    host sequences, ``rows``/``cols`` tensors on the graph's device.  Step
    ``c`` is ``make_train_step``'s math on ``step_generator(base_seed,
    step_no[c])``, so a chunk and the same steps taken one by one give the
    same losses.  A step with ``valid[c]`` False pads the chunk: it is
    skipped on the host, leaves params and state untouched and reports a
    NaN loss.  The losses come back as one device tensor, and nothing in
    the loop waits for the device.  ``layer_bits`` / ``neg_u``: optional
    per-step lists replacing the dropout and negative draws.

    The JAX package runs the chunk as one compiled ``lax.scan``; here it is
    a loop of eager steps, so chunking saves the per-step host sync only.
    """
    loss_fns = [make_loss_fn(model, et, cfg) for et in graph.edge_types]
    return chunk_loop(loss_fns, lambda *a, **kw: _update(cfg, optimizer, *a, **kw))


def chunk_loop(loss_fns, update) -> Callable:
    """The chunk of ``make_chunked_train_step`` over ``loss_fns`` (one an
    edge type), each step taken by ``update(loss_fn, params, opt_state,
    graph, k, rows, cols, enc_gen, sample_gen, layer_bits=, neg_u=) ->
    (params, opt_state, loss)``; the mesh steps share it."""

    def chunk(params, opt_state, graph, base_seed, branch, k, rows, cols,
              step_no, valid, layer_bits=None, neg_u=None):
        branch, k, step_no, valid = map(_host_list, (branch, k, step_no, valid))
        losses = []
        for c, ok in enumerate(valid):
            if not ok:
                losses.append(_nan(graph.device))
                continue
            enc_gen, sample_gen = split_generator(
                step_generator(base_seed, step_no[c], graph.device)
            )
            params, opt_state, loss = update(
                loss_fns[branch[c]], params, opt_state, graph,
                k[c], rows[c], cols[c], enc_gen, sample_gen,
                layer_bits=None if layer_bits is None else layer_bits[c],
                neg_u=None if neg_u is None else neg_u[c],
            )
            losses.append(loss)
        return params, opt_state, torch.stack(losses)

    return chunk


def make_grouped_chunked_train_step(
    model: DecagonModel,
    graph: DeviceGraph,
    cfg: TrainConfig,
    optimizer: GradientTransformation,
) -> Callable:
    """Chunked training with ``G = cfg.relation_group`` relation-batches
    per optimization step sharing one encoder forward.

    Returns ``chunk(params, opt_state, graph, base_seed, branch[C, G],
    k[C, G], rows[C, G, B], cols[C, G, B], step_no[C], valid[C, G],
    layer_bits=None, neg_u=None) -> (params, opt_state, losses[C])``.
    Slot ``c`` runs the encoder once with the encoder generator of
    ``step_generator(base_seed, step_no[c])``, scores each valid
    sub-batch ``g`` with negatives from ``fold_generator(sample_gen, g)``
    (the JAX package's ``fold_in(sample_rng, g)``), sums the losses and
    takes one Adam update; ``losses[c]`` is that sum, NaN for a slot with
    no valid sub-batch, which is skipped on the host.  ``neg_u``, when
    given, is per slot a list of per-sub-batch uniforms.
    """
    scorers = [make_scoring_loss(model, et, cfg) for et in graph.edge_types]

    def slot_loss(params, graph, branch, k, rows, cols, valid, enc_gen, sample_gen,
                  layer_bits=None, neg_u=None):
        embeddings = model.embeddings(
            params, graph, enc_gen, deterministic=False, layer_bits=layer_bits
        )
        total = None
        for g, ok in enumerate(valid):
            if not ok:
                continue
            sub = scorers[branch[g]](
                params, graph, embeddings, k[g], rows[g], cols[g],
                fold_generator(sample_gen, g), neg_u=None if neg_u is None else neg_u[g],
            )
            total = sub if total is None else total + sub
        return total

    return grouped_chunk_loop(slot_loss, lambda *a, **kw: _update(cfg, optimizer, *a, **kw))


def grouped_chunk_loop(slot_loss, update) -> Callable:
    """The chunk of ``make_grouped_chunked_train_step`` over ``slot_loss(
    params, graph, branch[G], k[G], rows[G], cols[G], valid[G], enc_gen,
    sample_gen, layer_bits=, neg_u=)``, each slot's step taken by ``update``
    (as ``chunk_loop``'s); the mesh steps share it."""

    def chunk(params, opt_state, graph, base_seed, branch, k, rows, cols,
              step_no, valid, layer_bits=None, neg_u=None):
        branch, k, step_no, valid = map(_host_list, (branch, k, step_no, valid))
        losses = []
        for c, slot_valid in enumerate(valid):
            if not any(slot_valid):
                losses.append(_nan(graph.device))
                continue
            enc_gen, sample_gen = split_generator(
                step_generator(base_seed, step_no[c], graph.device)
            )
            params, opt_state, loss = update(
                slot_loss, params, opt_state, graph,
                branch[c], k[c], rows[c], cols[c], slot_valid, enc_gen, sample_gen,
                layer_bits=None if layer_bits is None else layer_bits[c],
                neg_u=None if neg_u is None else neg_u[c],
            )
            losses.append(loss)
        return params, opt_state, torch.stack(losses)

    return chunk


def make_eval_scores(model: DecagonModel, edge_type: EdgeType) -> Callable:
    """Deterministic edge scorer for one edge type: ``scores(params, graph,
    k, rows, cols) -> sigmoid probabilities``.  It runs the full encoder
    forward on every call; evaluation over many relations should embed
    once (``make_embed_fn``) and score through ``make_emb_scores``, as
    ``AccuracyEvaluator`` does."""

    @torch.no_grad()
    def scores(params, graph: DeviceGraph, k, rows, cols):
        embeddings = model.embeddings(params, graph)
        return torch.sigmoid(
            model.score_edges(params, graph, embeddings, edge_type, k, rows, cols)
        )

    return scores


def make_embed_fn(model: DecagonModel) -> Callable:
    """Deterministic full-graph encoder forward:
    ``embed(params, graph) -> {"0": [N_0, H2], ...}``."""

    @torch.no_grad()
    def embed(params, graph):
        return model.embeddings(params, graph)

    return embed


def _require_card(device: torch.device) -> None:
    """``sddmm_impl="pallas"`` forces the kernel: raise off the card, as the
    JAX package raises off its accelerator."""
    if device.type != "cuda":
        raise ValueError(
            f"sddmm_impl='pallas' runs the CUDA kernel and needs a CUDA device (got "
            f"{device.type!r}); use 'auto' or 'jnp'"
        )


def make_emb_scores(
    model: DecagonModel, edge_type: EdgeType, device: DeviceLike = None
) -> Callable:
    """Scorer over precomputed embeddings with a per-edge relation index:
    ``scores(params, embeddings, ks, rows, cols) -> sigmoid
    probabilities`` of the same shape as ``ks``.

    Index tensors may be flat ``[B]`` or chunked ``[n_chunks, C]``; chunks
    are scored one after another, which bounds the plain version's
    gathered per-edge factors (bilinear gathers a [C, d, d] stack).
    ``sddmm_impl``, the JAX package's four values:

    * "auto": the CUDA kernel (K5, or K5-bf16 at ``sddmm_precision=
      "default"``) for CUDA tensors, its plain version for CPU tensors;
    * "jnp": the plain gather-and-multiply path of ``models/decoders.py``
      on any device, in f32, as the JAX package's jnp path ignores the
      precision;
    * "pallas": the kernel, always.  It needs the card: ``ValueError``
      where the embeddings are not CUDA tensors (when the scorer is built
      if ``device`` is given, else at the first call), and where the
      embedding width exceeds the kernel's 128;
    * "pallas_interpret": the JAX package's interpret mode, which has no
      counterpart here: ``ValueError`` naming "jnp".
    """
    name = model.graph_meta.decoder_name(edge_type)
    et_key = etkey(edge_type)
    row_t, col_t = str(edge_type[0]), str(edge_type[1])
    impl = model.config.sddmm_impl
    if impl == "pallas_interpret":
        raise ValueError(
            "sddmm_impl='pallas_interpret' (the JAX package's interpret mode) has no "
            "counterpart in the port; use 'jnp' for the plain path"
        )
    if impl not in ("auto", "jnp", "pallas"):
        raise ValueError(
            f"sddmm_impl must be 'auto', 'jnp', 'pallas' or 'pallas_interpret', not {impl!r}"
        )
    if impl == "pallas":
        if model.config.hidden2 > SDDMM_MAX_DIM:
            raise ValueError(
                f"sddmm_impl='pallas': embedding width {model.config.hidden2} exceeds the "
                f"kernel's {SDDMM_MAX_DIM}; use 'jnp' or 'auto'"
            )
        if device is not None:
            _require_card(torch.device(device))
    precision = model.config.sddmm_precision

    def tables(params, embeddings):
        """The kernel's operands, cast to bf16 once a scoring pass at
        "default" (K5-bf16 reads bf16 tables)."""
        dp = params["dec"][et_key]
        t = dict(
            z_rows=embeddings[row_t].contiguous(), z_cols=embeddings[col_t].contiguous(),
            glb=dp.get("global"), rel_diag=dp.get("local_diag", dp.get("relation_diag")),
            rel_full=dp.get("relation"),
        )
        if precision == "default":
            cast = {}
            t = {k: None if v is None else cast.setdefault(id(v), v.to(torch.bfloat16))
                 for k, v in t.items()}
        return t

    def one(params, embeddings, t, ks, rows, cols):
        if impl != "jnp":
            return sddmm_edges(t["z_rows"], t["z_cols"], ks, rows, cols, name=name,
                               glb=t["glb"], rel_diag=t["rel_diag"], rel_full=t["rel_full"],
                               precision=precision)
        z_rows = embeddings[row_t][rows.long()]
        z_cols = embeddings[col_t][cols.long()]
        return dec.score_edges(params["dec"][et_key], name, ks.long(), z_rows, z_cols)

    @torch.no_grad()
    def scores(params, embeddings, ks, rows, cols):
        if impl == "pallas":
            _require_card(embeddings[row_t].device)
        t = tables(params, embeddings) if impl != "jnp" else None
        if ks.dim() == 1:
            return torch.sigmoid(one(params, embeddings, t, ks, rows, cols))
        return torch.stack([
            torch.sigmoid(one(params, embeddings, t, k, r, c))
            for k, r, c in zip(ks, rows, cols)
        ])

    return scores
