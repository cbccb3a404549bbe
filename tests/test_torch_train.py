"""The port's training step against the JAX package on the CPU.

Both packages get the same graph, the same parameters (JAX's, carried
across with ``params_from_numpy``), and the same random draws: the JAX
package's own dropout bits, ``bernoulli(fold_in(enc_rng, tag * 7919))``
per layer, go into the port through ``layer_bits``, and its negative-
sampling uniforms through ``neg_u`` (threefry and Philox streams differ,
so no other route gives exact parity).  The JAX side runs with
``jax.default_backend`` reporting an accelerator, so the rectangular edge
types take the int8 factored stack as the port does (``tests/
test_torch_slice.py``); the paired types run ``paired_ref`` and their
non-kernel backward there.

Tolerances.  Losses and gradients: 1e-4 of each leaf's largest magnitude
(same cast points, f32 sums in another order), except the layer-1 paired
weight gradients, which come from the keep-scale backward: it rounds each
product to bf16 on both sides, and two sums that differ in their last bits
may round to neighbouring bf16 values, one bf16 ulp (at most 2^-7 of the
element); there the bound is ``2^-7 |want| + 1e-4 max|want|`` elementwise
with at most 0.1% of the elements beyond 1e-4 of the max.  Adam: the
moments within one bf16 ulp, the parameters within 1e-6 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from decagon_tpu.graph.device import build_device_graph as jax_build
from decagon_tpu.graph.split import split_graph as jax_split
from decagon_tpu.graph.synthetic import make_polypharmacy_like_graph as jax_graph
from decagon_tpu.models.losses import LOSSES as JAX_LOSSES
from decagon_tpu.models.model import DecagonModel as JaxModel
from decagon_tpu.models.model import ModelConfig as JaxConfig
from decagon_tpu.ops.optim import fused_adam as jax_fused_adam
from decagon_tpu.train import step as jax_step
from decagon_tpu.train.negatives import sample_unigram as jax_sample_unigram
from decagon_tpu_torch.graph.device import build_device_graph, etkey
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.models.convert import adam_state_from_numpy, params_from_numpy
from decagon_tpu_torch.models.encoder import layer_mask_spans, paired_edge_types
from decagon_tpu_torch.models.losses import LOSSES
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.ops.optim import fused_adam
from decagon_tpu_torch.train import step as step_mod
from decagon_tpu_torch.train.evaluate import AccuracyEvaluator
from decagon_tpu_torch.train.negatives import sample_unigram

SMALL = dict(
    n_proteins=300, n_drugs=60, n_side_effects=6, min_edges_per_relation=20,
    ppi_attachment=5, seed=7,
)
HIDDEN = dict(hidden1=16, hidden2=8)
BATCH = 64


@pytest.fixture
def accelerator_dispatch(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


@pytest.fixture(scope="module")
def pair():
    g_ref = jax_graph(**SMALL)
    s_ref = jax_split(g_ref, val_frac=0.05, test_frac=0.05, seed=1)
    dg_ref = jax_build(g_ref, s_ref, dense_factored=True, dense_paired=True, build_fused=False)
    model_ref = JaxModel(JaxConfig(**HIDDEN), dg_ref)
    params_ref = model_ref.init_params(jax.random.PRNGKey(0), dg_ref)
    g = make_polypharmacy_like_graph(**SMALL)
    s = split_graph(g, val_frac=0.05, test_frac=0.05, seed=1)
    dg = build_device_graph(g, s, dense_factored=True, dense_paired=True, device="cpu")
    model = DecagonModel(ModelConfig(**HIDDEN), dg)
    params = params_from_numpy(jax.device_get(params_ref), device="cpu")
    return dict(g=g_ref, s=s_ref, dg=dg_ref, model=model_ref, params=params_ref), dict(
        g=g, s=s, dg=dg, model=model, params=params
    )


def _batch(splits, edge_type, k, seed):
    edges = splits[edge_type + (k,)].train
    idx = np.random.default_rng(seed).integers(0, edges.shape[0], BATCH)
    return edges[idx, 0].astype(np.int32), edges[idx, 1].astype(np.int32)


def _jax_draws(port, rng, cfg):
    """The JAX step's dropout bits per layer and negative uniforms for
    ``rng`` (the key ``loss_fn`` receives), as the port takes them."""
    enc_rng, sample_rng = jax.random.split(rng)
    params, dg, model = port["params"], port["dg"], port["model"]
    paired = paired_edge_types(dg, model.config.spmm_impl)
    h1 = {str(t): torch.zeros((n, model.config.hidden1)) for t, n in enumerate(dg.num_nodes)}
    bits = {}
    for tag, (level, inputs) in enumerate((("enc1", dg.features), ("enc2", h1)), start=1):
        _, total = layer_mask_spans(
            params, dg, level, inputs, paired, model.config.per_relation_dropout_max
        )
        b = jax.random.bernoulli(
            jax.random.fold_in(enc_rng, tag * 7919), p=1.0 - model.config.dropout,
            shape=(total,),
        )
        bits[level] = torch.from_numpy(np.asarray(b))
    u = jax.random.uniform(sample_rng, (cfg.batch_size * max(1, cfg.neg_sample_size),))
    return bits, torch.from_numpy(np.asarray(u))


def _jax_loss_fn(model, edge_type, cfg):
    """The body of the JAX package's ``make_train_step.loss_fn``."""
    et_key = etkey(edge_type)

    def loss_fn(params, graph, k, rows, cols, rng):
        enc_rng, sample_rng = jax.random.split(rng)
        emb = model.embeddings(params, graph, enc_rng, deterministic=False)
        pos = model.score_edges(params, graph, emb, edge_type, k, rows, cols)
        ns = max(1, cfg.neg_sample_size)
        neg_rows = jax_sample_unigram(sample_rng, graph.neg_cdf[et_key][k], cfg.batch_size * ns)
        neg_cols = jnp.tile(cols, ns) if ns > 1 else cols
        neg = model.score_edges(params, graph, emb, edge_type, k, neg_rows, neg_cols)
        if cfg.loss == "hinge":
            pos_t = jnp.tile(pos, ns) if ns > 1 else pos
            return JAX_LOSSES["hinge"](pos_t, neg, cfg.margin)
        return JAX_LOSSES["xent"](pos, neg, cfg.neg_sample_weight)

    return loss_fn


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key in tree:
            out.update(_flat(tree[key], f"{prefix}/{key}"))
        return out
    return {prefix: np.asarray(tree, np.float64)}


def _hold(got, want, bf16_rounded=False):
    assert got.shape == want.shape
    err = np.abs(got - want)
    tight = 1e-4 * max(np.abs(want).max(), 1e-30)
    if not bf16_rounded:
        assert err.max() <= tight, err.max() / max(np.abs(want).max(), 1e-30)
        return
    assert (err <= tight + 2.0 ** -7 * np.abs(want)).all()
    assert (err > tight).sum() <= max(1, 1e-3 * err.size)


STEP_CASES = [
    pytest.param((1, 1), 3, "hinge", id="paired-hinge"),
    pytest.param((1, 1), 5, "xent", id="paired-xent"),
    pytest.param((0, 1), 0, "hinge", id="rect-hinge"),
    pytest.param((1, 0), 0, "xent", id="rect-xent"),
]


@pytest.mark.parametrize("edge_type,k,loss", STEP_CASES)
def test_step_loss_and_gradients_match_reference(pair, accelerator_dispatch, edge_type, k, loss):
    ref, port = pair
    cfg_kw = dict(batch_size=BATCH, loss=loss, neg_sample_size=1)
    jcfg = jax_step.TrainConfig(**cfg_kw)
    cfg = step_mod.TrainConfig(**cfg_kw)
    rows, cols = _batch(port["s"], edge_type, k, seed=k)
    rng = jax.random.PRNGKey(11)
    want_loss, want = jax.value_and_grad(_jax_loss_fn(ref["model"], edge_type, jcfg))(
        ref["params"], ref["dg"], k, jnp.asarray(rows), jnp.asarray(cols), rng
    )
    bits, u = _jax_draws(port, rng, cfg)
    got_loss, got = step_mod.value_and_grad(
        step_mod.make_loss_fn(port["model"], edge_type, cfg), port["params"], port["dg"],
        k, torch.from_numpy(rows), torch.from_numpy(cols), None, None,
        layer_bits=bits, neg_u=u,
    )
    assert np.isfinite(float(want_loss)) and float(want_loss) > 0
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-4)
    paired = paired_edge_types(port["dg"], "auto")
    flat_got, flat_want = _flat(got), _flat(jax.device_get(want))
    assert sorted(flat_got) == sorted(flat_want)
    nonzero = 0
    for name, w in flat_want.items():
        level, key = name.split("/")[1:3]
        _hold(flat_got[name], w, bf16_rounded=level == "enc1" and key in paired)
        nonzero += bool(np.abs(w).max() > 0)
    assert nonzero >= 4


def test_full_step_matches_reference(pair, accelerator_dispatch):
    """``make_train_step`` (gradients, bf16-moment Adam) against the JAX
    step from the same parameters and draws: loss and every parameter."""
    ref, port = pair
    edge_type, k = (1, 1), 2
    jcfg = jax_step.TrainConfig(batch_size=BATCH)
    cfg = step_mod.TrainConfig(batch_size=BATCH)
    rows, cols = _batch(port["s"], edge_type, k, seed=3)
    jopt = jax_step.make_optimizer(jcfg)
    jstate = jopt.init(ref["params"])
    jparams = jax.tree_util.tree_map(jnp.copy, ref["params"])
    base, step_no = jax.random.PRNGKey(5), 0
    jstep = jax_step.make_train_step(ref["model"], edge_type, jcfg, jopt)
    new_j, _, loss_j = jstep(
        jparams, jstate, ref["dg"], k, jnp.asarray(rows), jnp.asarray(cols), base, step_no
    )
    bits, u = _jax_draws(port, jax.random.fold_in(base, step_no), cfg)
    opt = step_mod.make_optimizer(cfg)
    step = step_mod.make_train_step(port["model"], edge_type, cfg, opt)
    new_p, state, loss_p = step(
        port["params"], opt.init(port["params"]), port["dg"], k,
        torch.from_numpy(rows), torch.from_numpy(cols), torch.Generator().manual_seed(0),
        layer_bits=bits, neg_u=u,
    )
    np.testing.assert_allclose(float(loss_p), float(loss_j), rtol=1e-4)
    assert state["t"] == 1
    flat_got, flat_want = _flat(new_p), _flat(jax.device_get(new_j))
    for name, w in flat_want.items():
        np.testing.assert_allclose(flat_got[name], w, rtol=0, atol=1e-6 * np.abs(w).max())


def test_fused_adam_step_matches_reference():
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 5, 7), "b": {"c": (11,), "d": (4, 4)}}

    def tree(fn, node=shapes):
        if isinstance(node, dict):
            return {key: tree(fn, v) for key, v in node.items()}
        return fn(node)

    params = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    grads = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    m = tree(lambda s: (0.1 * rng.standard_normal(s)).astype(np.float32))
    v = tree(lambda s: (0.01 * rng.random(s)).astype(np.float32))
    jopt = jax_fused_adam(1e-3, moments_dtype=jnp.bfloat16)
    to_bf16 = lambda t: jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), t)  # noqa: E731
    jstate = {"m": to_bf16(m), "v": to_bf16(v), "t": jnp.asarray(3, jnp.int32)}
    upd, jnew = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate)
    want_p = jax.device_get(optax.apply_updates(jax.tree_util.tree_map(jnp.asarray, params), upd))
    jnew = jax.device_get(jnew)

    opt = fused_adam(1e-3, moments_dtype=torch.bfloat16)
    state = adam_state_from_numpy(jax.device_get(jstate), device="cpu")
    assert state["m"]["a"].dtype == torch.bfloat16 and state["t"] == 3
    tparams = params_from_numpy(params, device="cpu")
    upd_t, new = opt.update(params_from_numpy(grads, device="cpu"), state)
    got_p = step_mod.tree_map(lambda p, u: p + u, tparams, upd_t)
    assert new["t"] == 4 and int(jnew["t"]) == 4
    for name, w in _flat(want_p).items():
        np.testing.assert_allclose(_flat(got_p)[name], w, rtol=1e-6)
    for moment in ("m", "v"):
        got_m = _flat({k: step_mod.tree_map(lambda t: t.float(), x) for k, x in new[moment].items()})
        want_m = _flat(jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jnew[moment]))
        for name, w in want_m.items():
            ulp = np.abs(w) * 2.0 ** -7 + 1e-30
            assert (np.abs(got_m[name] - w) <= ulp).all(), (moment, name)


def test_sample_unigram_matches_reference_with_injected_uniforms():
    rng = np.random.default_rng(1)
    w = rng.random(50) ** 3
    cdf = np.cumsum(w) / w.sum()
    cdf[-1] = 1.0
    cdf = cdf.astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jax_sample_unigram(key, jnp.asarray(cdf), 4096)
    u = jax.random.uniform(key, (4096,), dtype=jnp.float32)
    got = sample_unigram(None, torch.from_numpy(cdf), 4096, u=torch.from_numpy(np.asarray(u)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_unigram_distribution():
    """With its own draws, the sampler's frequencies follow the CDF: each
    within 5 standard errors of its probability."""
    w = np.arange(1, 21, dtype=np.float64) ** 0.75
    cdf = torch.tensor(np.cumsum(w) / w.sum(), dtype=torch.float32)
    cdf[-1] = 1.0
    n = 200_000
    idx = sample_unigram(torch.Generator().manual_seed(0), cdf, n)
    freq = np.bincount(idx.numpy(), minlength=20) / n
    p = w / w.sum()
    assert (np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n)).all()


@pytest.mark.parametrize("name", ["hinge", "xent"])
def test_losses_match_reference(name):
    rng = np.random.default_rng(2)
    pos = rng.standard_normal(257).astype(np.float32) * 3
    neg = rng.standard_normal(257).astype(np.float32) * 3
    arg = 0.1 if name == "hinge" else 0.7
    want, want_g = jax.value_and_grad(lambda a, b: JAX_LOSSES[name](a, b, arg), (0, 1))(
        jnp.asarray(pos), jnp.asarray(neg)
    )
    tp = torch.from_numpy(pos).requires_grad_(True)
    tn = torch.from_numpy(neg).requires_grad_(True)
    got = LOSSES[name](tp, tn, arg)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(want_g[0]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tn.grad.numpy(), np.asarray(want_g[1]), rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def default_graphs():
    """Both packages' device graphs with ``build_device_graph``'s
    defaults: no factored or paired stacks, the dense stack and the COO
    stream only."""
    g_ref = jax_graph(**SMALL)
    dg_ref = jax_build(g_ref, jax_split(g_ref, val_frac=0.05, test_frac=0.05, seed=1))
    g = make_polypharmacy_like_graph(**SMALL)
    dg = build_device_graph(g, split_graph(g, val_frac=0.05, test_frac=0.05, seed=1),
                            device="cpu")
    return dg_ref, dg


@pytest.mark.parametrize("impl", ["auto", "xla", "dense"])
def test_default_graph_encodes_like_reference(default_graphs, impl):
    dg_ref, dg = default_graphs
    assert all(a.pair_mask is None and a.dense_mask is None for a in dg.adj.values())
    assert all(a.dense is not None for a in dg.adj.values())
    model_ref = JaxModel(JaxConfig(spmm_impl=impl, **HIDDEN), dg_ref)
    params_ref = model_ref.init_params(jax.random.PRNGKey(1), dg_ref)
    want = model_ref.embeddings(params_ref, dg_ref)
    model = DecagonModel(ModelConfig(spmm_impl=impl, **HIDDEN), dg)
    got = model.embeddings(params_from_numpy(jax.device_get(params_ref), device="cpu"), dg)
    for t in want:
        np.testing.assert_allclose(got[t].detach().numpy(), np.asarray(want[t]),
                                   rtol=1e-4, atol=1e-4)


def test_default_graph_neg_cdf_matches_reference(default_graphs):
    dg_ref, dg = default_graphs
    for key, want in dg_ref.neg_cdf.items():
        np.testing.assert_array_equal(dg.neg_cdf[key].numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "impl", ["pallas", "pallas_interpret", "fused", "fused_pallas", "paired_interpret"]
)
def test_unported_spmm_impls_raise(default_graphs, impl):
    """The tiled SpMM and the fused stream are ported: their impls build
    and store the unpaired weight layout.  The JAX package's interpret
    modes raise NotImplementedError (CUDA kernels have none; the message
    names the plain version), an unknown impl ValueError."""
    _, dg = default_graphs
    if impl.endswith("_interpret"):
        with pytest.raises(NotImplementedError, match="_ref"):
            ModelConfig(spmm_impl=impl)
        with pytest.raises(NotImplementedError):
            paired_edge_types(dg, impl)
    else:
        assert ModelConfig(spmm_impl=impl).spmm_impl == impl
        assert paired_edge_types(dg, impl) == set()
    with pytest.raises(ValueError):
        ModelConfig(spmm_impl="no-such-impl")


def test_model_config_widths_and_remat():
    assert ModelConfig(hidden1=24, hidden2=40).hidden1 == 24
    with pytest.raises(ValueError):
        ModelConfig(hidden1=0)
    assert ModelConfig(remat=True).remat
    with pytest.raises(ValueError):
        ModelConfig(spmm_precision="fast")


def test_train_config_round_trips_and_unported_fields_raise():
    """Every option of ``TrainConfig`` is ported now (the mesh fields are
    read by ``parallel/``, ``tests/test_torch_parallel.py``); what raises,
    as in the JAX package, is a schedule with the lazy decoder Adam."""
    assert dataclasses.asdict(step_mod.TrainConfig()) == dataclasses.asdict(jax_step.TrainConfig())
    for kw in (dict(scan_chunk=4), dict(relation_group=2), dict(lazy_decoder_adam=True),
               dict(lr_schedule="cosine", lr_schedule_steps=10), dict(pallas_adam=True)):
        assert step_mod.make_optimizer(step_mod.TrainConfig(**kw)) is not None
    assert step_mod.make_optimizer(step_mod.TrainConfig(lr_schedule="cosine")) is not None
    with pytest.raises(ValueError):
        step_mod.make_optimizer(step_mod.TrainConfig(
            lazy_decoder_adam=True, lr_schedule="step", lr_schedule_steps=5))
    with pytest.raises(ValueError):
        step_mod.make_optimizer(step_mod.TrainConfig(lr_schedule="linear", lr_schedule_steps=5))


def test_cast_grads_matches_reference():
    grads = {"big": torch.ones(1 << 20), "small": torch.ones(10)}
    out = step_mod.cast_grads(step_mod.TrainConfig(), grads)
    assert out["big"].dtype == torch.bfloat16 and out["small"].dtype == torch.float32
    out = step_mod.cast_grads(step_mod.TrainConfig(grad_dtype="float32"), grads)
    assert out["big"].dtype == torch.float32


def test_evaluator_takes_embed_fn_and_pad_multiple(pair):
    _, port = pair
    calls = []

    def embed_fn(params, graph):
        calls.append(1)
        return port["model"].embeddings(params, graph)

    ev = AccuracyEvaluator(port["model"], port["g"], port["s"], pad_multiple=256,
                           embed_fn=embed_fn, device="cpu")
    assert ev.pad_multiple == 256
    scores = ev.evaluate(port["params"], port["dg"], (1, 1, 0))
    assert calls == [1] and 0.0 <= scores.auroc <= 1.0
