"""The sparse-regime encoder of the port against the JAX package on the CPU:
``spmm_impl`` "pallas" (K6 per edge type) against the JAX
"pallas_interpret", "fused" against the JAX "fused", "fused_pallas" (K6
over the fused stream) against the JAX "fused_pallas_interpret", and
``remat``.

Both packages build the same small graph with CSR / tile layouts on every
edge type and the fused stream; the port gets the JAX parameters, the JAX
dropout bits (``layer_bits``) and negative-sampling uniforms (``neg_u``).

Tolerances.  Embeddings and losses: 1e-5 of the largest magnitude (f32
sums in other orders).  Gradients: 1e-4 of each leaf's largest magnitude,
as in ``test_torch_train.py`` (the cotangent passes both layers and the
row normalization, each summing in another order).  At ``"default"`` a
bf16-rounded operand (layer 2's projection, the backward's cotangent) is
a value that the two packages computed in f32 in different orders, so it
can round to the neighbouring bf16 value: each output or gradient element
is then held to ``2^-7 |want| + 1e-4 max|want|`` (a flipped rounding
moves an operand by one bf16 ulp, at most 2^-7 of its value), with at
most 1% of the elements beyond 1e-4 of the max.  ``remat`` against no ``remat`` in the
port: bitwise, with deterministic CPU algorithms.
"""

import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decagon_tpu.graph.device import build_device_graph as jax_build
from decagon_tpu.graph.split import split_graph as jax_split
from decagon_tpu.graph.synthetic import make_polypharmacy_like_graph as jax_graph
from decagon_tpu.models.losses import LOSSES as JAX_LOSSES
from decagon_tpu.models.model import DecagonModel as JaxModel
from decagon_tpu.models.model import ModelConfig as JaxConfig
from decagon_tpu.train import step as jax_step
from decagon_tpu.train.negatives import sample_unigram as jax_sample_unigram
from decagon_tpu_torch.graph.device import build_device_graph, etkey
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.models.convert import params_from_numpy
from decagon_tpu_torch.models.encoder import draw_layer_bits, layer_mask_spans, resolve_impl
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.train import step as step_mod

SMALL = dict(
    n_proteins=300, n_drugs=60, n_side_effects=6, min_edges_per_relation=20,
    ppi_attachment=5, seed=7,
)
HIDDEN = dict(hidden1=16, hidden2=8)
BATCH = 64
JAX_IMPL = {"pallas": "pallas_interpret", "fused": "fused",
            "fused_pallas": "fused_pallas_interpret"}


@pytest.fixture(scope="module")
def world():
    g_ref = jax_graph(**SMALL)
    s_ref = jax_split(g_ref, val_frac=0.05, test_frac=0.05, seed=1)
    kw = dict(tile_for_pallas=True, tile_even_if_dense=True, edge_pad_multiple=256)
    dg_ref = jax_build(g_ref, s_ref, tile_block=64, **kw)
    params_ref = JaxModel(JaxConfig(**HIDDEN), dg_ref).init_params(jax.random.PRNGKey(0), dg_ref)
    g = make_polypharmacy_like_graph(**SMALL)
    s = split_graph(g, val_frac=0.05, test_frac=0.05, seed=1)
    dg = build_device_graph(g, s, device="cpu", **kw)
    params = params_from_numpy(jax.device_get(params_ref), device="cpu")
    return dict(dg_ref=dg_ref, params_ref=params_ref, s=s, dg=dg, params=params)


def _hold(got, want, precision="highest", tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    tight = tol * max(np.abs(want).max(), 1e-30)
    if precision == "highest":
        assert err.max() <= tight, err.max() / max(np.abs(want).max(), 1e-30)
        return
    assert (err <= tight + 2.0 ** -7 * np.abs(want)).all()
    assert (err > tight).sum() <= max(1, 1e-2 * err.size)


EMBED_CASES = [
    pytest.param("pallas", "highest", id="pallas-highest"),
    pytest.param("pallas", "default", id="pallas-default"),
    pytest.param("fused", "highest", id="fused"),
    pytest.param("fused_pallas", "highest", id="fused_pallas-highest"),
    pytest.param("fused_pallas", "default", id="fused_pallas-default"),
]


@pytest.mark.parametrize("impl,precision", EMBED_CASES)
def test_embeddings_match_reference(world, impl, precision):
    cfg = dict(spmm_precision=precision, **HIDDEN)
    want = JaxModel(JaxConfig(spmm_impl=JAX_IMPL[impl], **cfg), world["dg_ref"]).embeddings(
        world["params_ref"], world["dg_ref"]
    )
    got = DecagonModel(ModelConfig(spmm_impl=impl, **cfg), world["dg"]).embeddings(
        world["params"], world["dg"]
    )
    for t in want:
        _hold(got[t].numpy(), want[t], precision, tol=1e-5)


def _jax_draws(world, model, rng, cfg):
    """The JAX step's dropout bits per layer and negative uniforms for
    ``rng``, as the port takes them (no edge type is paired here)."""
    enc_rng, sample_rng = jax.random.split(rng)
    dg, params = world["dg"], world["params"]
    h1 = {str(t): torch.zeros((n, model.config.hidden1)) for t, n in enumerate(dg.num_nodes)}
    bits = {}
    for tag, (level, inputs) in enumerate((("enc1", dg.features), ("enc2", h1)), start=1):
        _, total = layer_mask_spans(params, dg, level, inputs, set(),
                                    model.config.per_relation_dropout_max)
        b = jax.random.bernoulli(jax.random.fold_in(enc_rng, tag * 7919),
                                 p=1.0 - model.config.dropout, shape=(total,))
        bits[level] = torch.from_numpy(np.array(b))
    u = jax.random.uniform(sample_rng, (cfg.batch_size,))
    return bits, torch.from_numpy(np.array(u))


def _jax_loss_fn(model, edge_type, cfg):
    """The body of the JAX package's ``make_train_step.loss_fn`` (hinge,
    one negative per positive)."""
    def loss_fn(params, graph, k, rows, cols, rng):
        enc_rng, sample_rng = jax.random.split(rng)
        emb = model.embeddings(params, graph, enc_rng, deterministic=False)
        pos = model.score_edges(params, graph, emb, edge_type, k, rows, cols)
        neg_rows = jax_sample_unigram(sample_rng, graph.neg_cdf[etkey(edge_type)][k],
                                      cfg.batch_size)
        neg = model.score_edges(params, graph, emb, edge_type, k, neg_rows, cols)
        return JAX_LOSSES["hinge"](pos, neg, cfg.margin)

    return loss_fn


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key in tree:
            out.update(_flat(tree[key], f"{prefix}/{key}"))
        return out
    return {prefix: np.asarray(tree, np.float64)}


def _batch(world, edge_type, k, seed):
    edges = world["s"][edge_type + (k,)].train
    idx = np.random.default_rng(seed).integers(0, edges.shape[0], BATCH)
    return edges[idx, 0].astype(np.int32), edges[idx, 1].astype(np.int32)


STEP_CASES = [
    pytest.param("pallas", "highest", False, (1, 1), id="pallas-highest-dd"),
    pytest.param("pallas", "default", False, (0, 1), id="pallas-default-rect"),
    pytest.param("fused", "highest", False, (1, 1), id="fused-dd"),
    pytest.param("fused_pallas", "highest", False, (0, 0), id="fused_pallas-ppi"),
    pytest.param("pallas", "highest", True, (1, 1), id="pallas-remat-dd"),
]


@pytest.mark.parametrize("impl,precision,remat,edge_type", STEP_CASES)
def test_step_gradients_match_reference(world, impl, precision, remat, edge_type):
    """One train step's loss and every gradient leaf, with the JAX
    package's dropout bits and negatives injected; the remat case against
    the JAX ``remat=True``."""
    cfg_kw = dict(spmm_precision=precision, remat=remat, **HIDDEN)
    model_ref = JaxModel(JaxConfig(spmm_impl=JAX_IMPL[impl], **cfg_kw), world["dg_ref"])
    model = DecagonModel(ModelConfig(spmm_impl=impl, **cfg_kw), world["dg"])
    jcfg = jax_step.TrainConfig(batch_size=BATCH, loss="hinge")
    cfg = step_mod.TrainConfig(batch_size=BATCH, loss="hinge")
    k = 0
    rows, cols = _batch(world, edge_type, k, seed=5)
    rng = jax.random.PRNGKey(11)
    want_loss, want = jax.value_and_grad(_jax_loss_fn(model_ref, edge_type, jcfg))(
        world["params_ref"], world["dg_ref"], k, jnp.asarray(rows), jnp.asarray(cols), rng
    )
    bits, u = _jax_draws(world, model, rng, cfg)
    got_loss, got = step_mod.value_and_grad(
        step_mod.make_loss_fn(model, edge_type, cfg), world["params"], world["dg"],
        k, torch.from_numpy(rows), torch.from_numpy(cols), None, None,
        layer_bits=bits, neg_u=u,
    )
    assert np.isfinite(float(want_loss)) and float(want_loss) > 0
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    flat_got, flat_want = _flat(got), _flat(jax.device_get(want))
    assert sorted(flat_got) == sorted(flat_want)
    nonzero = 0
    for name, w in flat_want.items():
        _hold(flat_got[name], w, precision)
        nonzero += bool(np.abs(w).max() > 0)
    assert nonzero >= 4


@contextlib.contextmanager
def _deterministic():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("impl", ["pallas", "fused_pallas"])
def test_remat_gives_the_same_gradients(world, impl):
    """The port's own dropout draws (explicit generators): with ``remat``
    the bits are drawn before the checkpointed region, so the recomputed
    forward uses the same masks and every gradient is bitwise equal."""
    cfg = step_mod.TrainConfig(batch_size=BATCH)
    rows, cols = (torch.from_numpy(a) for a in _batch(world, (1, 1), 2, seed=6))
    out = []
    with _deterministic():
        for remat in (False, True):
            model = DecagonModel(ModelConfig(spmm_impl=impl, remat=remat, **HIDDEN), world["dg"])
            loss, grads = step_mod.value_and_grad(
                step_mod.make_loss_fn(model, (1, 1), cfg), world["params"], world["dg"], 2,
                rows, cols, torch.Generator().manual_seed(3), torch.Generator().manual_seed(4),
            )
            out.append((loss, _flat(grads)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for name in g0:
        np.testing.assert_array_equal(g1[name], g0[name])
    assert any(np.abs(g).max() > 0 for g in g0.values())


def test_draw_layer_bits_is_the_encoder_draw(world):
    """``encode``'s own draw and ``draw_layer_bits`` from one seed give the
    same embeddings, and ``layer_bits`` of the wrong length raise."""
    model = DecagonModel(ModelConfig(spmm_impl="pallas", **HIDDEN), world["dg"])
    a = model.embeddings(world["params"], world["dg"], torch.Generator().manual_seed(9),
                         deterministic=False)
    bits = draw_layer_bits(world["params"], world["dg"], torch.Generator().manual_seed(9), 0.1,
                           "pallas")
    b = model.embeddings(world["params"], world["dg"], deterministic=False, layer_bits=bits)
    for t in a:
        assert torch.equal(a[t], b[t])
    with pytest.raises(ValueError):
        model.embeddings(world["params"], world["dg"], deterministic=False,
                         layer_bits={"enc1": bits["enc1"][1:], "enc2": bits["enc2"]})


@pytest.mark.parametrize("cuda", [False, True], ids=["cpu", "cuda"])
def test_auto_takes_the_csr_only_on_cuda(world, cuda):
    """"auto": the factored and dense stacks first, the CSR layouts (K6)
    on CUDA only, the COO stream otherwise, as the JAX accelerator and CPU
    dispatches do; an explicit impl wins."""
    adj = world["dg"].adj["1,1"]
    assert adj.tiles_fwd is not None and adj.dense is not None
    on = SimpleNamespace(is_cuda=cuda)
    sparse = SimpleNamespace(dense_mask=None, dense=None, tiles_fwd=adj.tiles_fwd, senders=on)
    assert resolve_impl(sparse, "auto") == ("pallas" if cuda else "xla")
    dense = SimpleNamespace(dense_mask=None, dense=adj.dense, tiles_fwd=adj.tiles_fwd, senders=on)
    assert resolve_impl(dense, "auto") == ("dense" if cuda else "xla")
    factored = SimpleNamespace(dense_mask=adj.dense, dense=None, tiles_fwd=None, senders=on)
    assert resolve_impl(factored, "auto") == "dense_factored"
    assert resolve_impl(dense, "pallas") == "pallas"
