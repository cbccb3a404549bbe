"""Train and evaluation steps.

Port of ``decagon_tpu/train/step.py``: ``TrainConfig``, the single-step
``make_train_step`` with its fused Adam (``ops/optim.py``), and the
evaluation steps ``make_embed_fn`` / ``make_emb_scores``.  Each step: the
full-graph encoder forward with dropout, positive scores on the batch
edges, ``batch_size`` negative rows from the relation's unigram^0.75 CDF,
hinge or cross-entropy loss, gradients by autograd, Adam.  The chunked and
grouped steps, learning-rate schedules, lazy decoder Adam, the Pallas Adam
and the mesh come with later slices; the fields that select them raise
``NotImplementedError`` where they are read.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import torch

from decagon_tpu_torch.graph.container import EdgeType
from decagon_tpu_torch.graph.device import DeviceGraph, etkey
from decagon_tpu_torch.models import decoders as dec
from decagon_tpu_torch.models.losses import LOSSES
from decagon_tpu_torch.models.model import DecagonModel
from decagon_tpu_torch.ops.optim import GradientTransformation, fused_adam, tree_map
from decagon_tpu_torch.ops.sddmm_pallas import sddmm_edges
from decagon_tpu_torch.train.negatives import sample_unigram


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization hyperparameters, with every field of the JAX package's
    ``TrainConfig`` and its defaults (reference ``configuration.json``).

    Ported: ``batch_size``, ``learning_rate``, ``loss`` ("hinge" or
    "xent"), ``margin``, ``neg_sample_size``, ``neg_sample_weight``,
    ``num_epochs``, ``schedule``, ``adam_moments_dtype``, ``grad_dtype``,
    and ``lr_schedule="constant"`` (or any schedule with
    ``lr_schedule_steps <= 0``, which the JAX package also treats as
    constant).  Not ported, and raising where read: ``scan_chunk > 0``,
    ``relation_group > 1``, ``lazy_decoder_adam``, ``pallas_adam`` and a
    decaying ``lr_schedule``.  ``shard_weights``, ``comm_overlap`` and
    ``grad_reduce_dtype`` are read by the mesh path only.
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


def _unported(cfg: TrainConfig) -> List[str]:
    out = []
    if cfg.scan_chunk > 0:
        out.append("scan_chunk > 0 (chunked steps)")
    if cfg.relation_group > 1:
        out.append("relation_group > 1 (grouped steps)")
    if cfg.lazy_decoder_adam:
        out.append("lazy_decoder_adam")
    if cfg.lr_schedule != "constant" and cfg.lr_schedule_steps > 0:
        out.append(f"lr_schedule {cfg.lr_schedule!r}")
    return out


def make_optimizer(cfg: TrainConfig) -> GradientTransformation:
    """The fused Adam with the configured moment dtype and a constant
    learning rate."""
    missing = _unported(cfg)
    if missing:
        raise NotImplementedError(
            "not ported yet (ROADMAP queue 1, 'Training slice B'): " + ", ".join(missing)
        )
    if cfg.loss not in LOSSES:
        raise ValueError(f"unknown loss: {cfg.loss!r}")
    moments = (
        torch.bfloat16 if cfg.adam_moments_dtype in ("bfloat16", "bf16") else None
    )
    return fused_adam(
        cfg.learning_rate, b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS,
        moments_dtype=moments,
    )


def cast_grads(cfg: TrainConfig, grads):
    """Cast gradient leaves of at least 2^20 elements to bf16 when
    ``grad_dtype`` is bf16; smaller leaves stay f32."""
    if cfg.grad_dtype not in ("bfloat16", "bf16"):
        return grads
    return tree_map(
        lambda g: g.to(torch.bfloat16) if g.numel() >= (1 << 20) else g, grads
    )


def apply_optimizer(optimizer, cfg: TrainConfig, grads, opt_state, params):
    """New ``(params, opt_state)``: ``params + updates`` in each leaf's
    dtype.  The Pallas one-pass Adam (K7) is not ported."""
    if cfg.pallas_adam:
        raise NotImplementedError(
            "pallas_adam is the one-pass Adam kernel (K7), not ported yet"
        )
    updates, opt_state = optimizer.update(grads, opt_state)
    params = tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
    return params, opt_state


def split_generator(generator: torch.Generator, n: int = 2) -> List[torch.Generator]:
    """``n`` new generators on ``generator``'s device, seeded from its
    stream (the counterpart of ``jax.random.split``)."""
    seeds = torch.randint(
        0, 2**62, (n,), generator=generator, device=generator.device
    ).tolist()
    return [torch.Generator(device=generator.device).manual_seed(s) for s in seeds]


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


def make_loss_fn(model: DecagonModel, edge_type: EdgeType, cfg: TrainConfig) -> Callable:
    """``loss(params, graph, k, rows, cols, enc_gen, sample_gen,
    layer_bits=None, neg_u=None)``: the body of the JAX package's
    ``make_train_step.loss_fn``.  ``layer_bits`` and ``neg_u`` replace the
    dropout and the negative-sampling draws."""
    et_key = etkey(edge_type)
    loss_name = cfg.loss

    def loss_fn(params, graph: DeviceGraph, k, rows, cols, enc_gen, sample_gen,
                layer_bits=None, neg_u=None):
        embeddings = model.embeddings(
            params, graph, enc_gen, deterministic=False, layer_bits=layer_bits
        )
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
        if loss_name == "hinge":
            pos_t = pos.repeat(ns) if ns > 1 else pos
            return LOSSES["hinge"](pos_t, neg, cfg.margin)
        return LOSSES["xent"](pos, neg, cfg.neg_sample_weight)

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


def make_train_step(
    model: DecagonModel,
    edge_type: EdgeType,
    cfg: TrainConfig,
    optimizer: GradientTransformation,
) -> Callable:
    """``step(params, opt_state, graph, k, rows, cols, generator,
    layer_bits=None, neg_u=None, marks=None) -> (params, opt_state,
    loss)`` for one edge type.  The generator splits into the encoder's
    and the sampler's, as the JAX step splits its key.  ``marks`` is
    called with "forward", "backward" and "update" as each phase is
    queued (for timing)."""
    if cfg.pallas_adam:
        raise NotImplementedError(
            "pallas_adam is the one-pass Adam kernel (K7), not ported yet"
        )
    loss_fn = make_loss_fn(model, edge_type, cfg)

    def step(params, opt_state, graph, k, rows, cols, generator,
             layer_bits=None, neg_u=None, marks=None):
        enc_gen, sample_gen = split_generator(generator)
        loss, grads = value_and_grad(
            loss_fn, params, graph, k, rows, cols, enc_gen, sample_gen,
            layer_bits=layer_bits, neg_u=neg_u, marks=marks,
        )
        grads = cast_grads(cfg, grads)
        with torch.no_grad():
            params, opt_state = apply_optimizer(optimizer, cfg, grads, opt_state, params)
        if marks is not None:
            marks("update")
        return params, opt_state, loss

    return step


def make_embed_fn(model: DecagonModel) -> Callable:
    """Deterministic full-graph encoder forward:
    ``embed(params, graph) -> {"0": [N_0, H2], ...}``."""

    @torch.no_grad()
    def embed(params, graph):
        return model.embeddings(params, graph)

    return embed


def make_emb_scores(model: DecagonModel, edge_type: EdgeType) -> Callable:
    """Scorer over precomputed embeddings with a per-edge relation index:
    ``scores(params, embeddings, ks, rows, cols) -> sigmoid
    probabilities`` of the same shape as ``ks``.

    Index tensors may be flat ``[B]`` or chunked ``[n_chunks, C]``; chunks
    are scored one after another, which bounds the plain version's
    gathered per-edge factors (bilinear gathers a [C, d, d] stack).
    ``sddmm_impl``: "auto" (the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors) or "jnp" (the plain gather-and-multiply
    path of ``models/decoders.py`` on any device).
    """
    name = model.graph_meta.decoder_name(edge_type)
    et_key = etkey(edge_type)
    row_t, col_t = str(edge_type[0]), str(edge_type[1])
    impl = model.config.sddmm_impl
    if impl not in ("auto", "jnp"):
        raise NotImplementedError(
            f"sddmm_impl {impl!r} is not ported; use 'auto' or 'jnp'"
        )
    if model.config.sddmm_precision != "highest":
        raise NotImplementedError(
            f"sddmm_precision {model.config.sddmm_precision!r} is not ported;"
            " only 'highest' is"
        )

    def one(params, embeddings, ks, rows, cols):
        dp = params["dec"][et_key]
        if impl == "auto":
            return sddmm_edges(
                embeddings[row_t].contiguous(), embeddings[col_t].contiguous(),
                ks, rows, cols,
                name=name,
                glb=dp.get("global"),
                rel_diag=dp.get("local_diag", dp.get("relation_diag")),
                rel_full=dp.get("relation"),
            )
        z_rows = embeddings[row_t][rows.long()]
        z_cols = embeddings[col_t][cols.long()]
        return dec.score_edges(dp, name, ks.long(), z_rows, z_cols)

    @torch.no_grad()
    def scores(params, embeddings, ks, rows, cols):
        if ks.dim() == 1:
            return torch.sigmoid(one(params, embeddings, ks, rows, cols))
        return torch.stack([
            torch.sigmoid(one(params, embeddings, k, r, c))
            for k, r, c in zip(ks, rows, cols)
        ])

    return scores
