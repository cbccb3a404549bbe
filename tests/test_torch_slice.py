"""The port's serving slice against the JAX package at a small size:
encoder forward, then held-out edge scoring through the evaluator.

JAX parameters are carried across with ``params_from_numpy``.  The JAX
reference runs ``spmm_impl="paired_ref"`` with ``jax.default_backend``
reporting an accelerator: its CPU dispatch sends the rectangular edge
types through the f32 COO segment-sum, while on an accelerator (and in
the port, on every device) they take the int8 factored stack, whose
operands round to bf16.  Tolerance ``rtol=atol=1e-4`` on embeddings and
metrics: same cast points, f32 sums in another order.
"""

import jax
import numpy as np
import pytest
import torch

from decagon_tpu.graph.device import build_device_graph as jax_build
from decagon_tpu.graph.split import split_graph as jax_split
from decagon_tpu.graph.synthetic import make_polypharmacy_like_graph as jax_graph
from decagon_tpu.models.model import DecagonModel as JaxModel
from decagon_tpu.models.model import ModelConfig as JaxConfig
from decagon_tpu.train.evaluate import AccuracyEvaluator as JaxEvaluator
from decagon_tpu.train.step import make_embed_fn
from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.train.evaluate import AccuracyEvaluator

SMALL = dict(
    n_proteins=300, n_drugs=60, n_side_effects=6, min_edges_per_relation=20,
    ppi_attachment=5, seed=7,
)
HIDDEN = dict(hidden1=16, hidden2=8)
KEYS = [(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0), (1, 1, 7)]


@pytest.fixture(scope="module")
def slice_pair():
    g_ref = jax_graph(**SMALL)
    s_ref = jax_split(g_ref, val_frac=0.05, test_frac=0.05, seed=1)
    dg_ref = jax_build(
        g_ref, s_ref, dense_factored=True, dense_paired=True, build_fused=False
    )
    model_ref = JaxModel(JaxConfig(spmm_impl="paired_ref", **HIDDEN), dg_ref)
    params_ref = model_ref.init_params(jax.random.PRNGKey(0), dg_ref)

    g = make_polypharmacy_like_graph(**SMALL)
    s = split_graph(g, val_frac=0.05, test_frac=0.05, seed=1)
    dg = build_device_graph(g, s, dense_factored=True, dense_paired=True, device="cpu")
    model = DecagonModel(ModelConfig(**HIDDEN), dg)
    params = params_from_numpy(jax.device_get(params_ref), device="cpu")

    ref = dict(graph=g_ref, splits=s_ref, dg=dg_ref, model=model_ref, params=params_ref)
    port = dict(graph=g, splits=s, dg=dg, model=model, params=params)
    return ref, port


@pytest.fixture
def accelerator_dispatch(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_embeddings_match_reference(slice_pair, accelerator_dispatch):
    ref, port = slice_pair
    want = make_embed_fn(ref["model"])(ref["params"], ref["dg"])
    got = port["model"].embeddings(port["params"], port["dg"])
    assert sorted(got) == sorted(want) == ["0", "1"]
    for t in want:
        assert tuple(got[t].shape) == tuple(want[t].shape)
        _close(got[t].numpy(), np.asarray(want[t]))


def _scores(s):
    return np.array([s.auroc, s.auprc, s.apk])


@pytest.mark.parametrize("use_test", [False, True], ids=["val", "test"])
def test_evaluate_all_drug_drug_matches_reference(slice_pair, accelerator_dispatch, use_test):
    ref, port = slice_pair
    want = JaxEvaluator(ref["model"], ref["graph"], ref["splits"]).evaluate_all_drug_drug(
        ref["params"], ref["dg"], use_test=use_test
    )
    got = AccuracyEvaluator(
        port["model"], port["graph"], port["splits"], score_chunk=512, device="cpu"
    ).evaluate_all_drug_drug(port["params"], port["dg"], use_test=use_test)
    _close(_scores(got), _scores(want))


def test_evaluate_matches_reference(slice_pair, accelerator_dispatch):
    ref, port = slice_pair
    ev_ref = JaxEvaluator(ref["model"], ref["graph"], ref["splits"])
    ev = AccuracyEvaluator(port["model"], port["graph"], port["splits"], device="cpu")
    emb = ev.embeddings(port["params"], port["dg"])
    for key in KEYS:
        want = ev_ref.evaluate(ref["params"], ref["dg"], key)
        got = ev.evaluate(port["params"], port["dg"], key, embeddings=emb)
        _close(_scores(got), _scores(want))


def test_plain_scorer_path_matches_kernel_wrapper(slice_pair):
    """``sddmm_impl="jnp"`` (gather-and-multiply in models/decoders.py) and
    ``"auto"`` (the kernel wrapper's plain version on the CPU) agree."""
    _, port = slice_pair
    out = []
    for impl in ("auto", "jnp"):
        model = DecagonModel(ModelConfig(sddmm_impl=impl, **HIDDEN), port["dg"])
        ev = AccuracyEvaluator(model, port["graph"], port["splits"], device="cpu")
        out.append(_scores(ev.evaluate_all_drug_drug(port["params"], port["dg"])))
    np.testing.assert_allclose(out[0], out[1], rtol=1e-6)


def test_params_round_trip(slice_pair):
    ref, _ = slice_pair
    tree = jax.device_get(ref["params"])
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_entry_points_raise_without_cuda(slice_pair, monkeypatch):
    """With no card and no device="cpu", the port refuses to run rather
    than fall back to the CPU."""
    _, port = slice_pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        build_device_graph(port["graph"], port["splits"], dense_paired=True)
    with pytest.raises(RuntimeError):
        params_from_numpy({"enc1": {"0,0": np.zeros(2, np.float32)}})
    with pytest.raises(RuntimeError):
        AccuracyEvaluator(port["model"], port["graph"], port["splits"])
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("edge_type,k", [((0, 0), 1), ((0, 1), 0), ((1, 1), 5)])
def test_decoder_scores_match_reference(slice_pair, accelerator_dispatch, edge_type, k):
    """``DecagonModel.score_edges`` on sampled pairs and
    ``decoders.score_matrix`` on all pairs of one relation."""
    from decagon_tpu.models import decoders as jax_dec
    from decagon_tpu_torch.graph.device import etkey
    from decagon_tpu_torch.models import decoders as dec

    ref, port = slice_pair
    emb_ref = make_embed_fn(ref["model"])(ref["params"], ref["dg"])
    emb = port["model"].embeddings(port["params"], port["dg"])
    n_r, n_c = port["dg"].num_nodes[edge_type[0]], port["dg"].num_nodes[edge_type[1]]
    rng = np.random.default_rng(7)
    rows = rng.integers(0, n_r, 64).astype(np.int32)
    cols = rng.integers(0, n_c, 64).astype(np.int32)
    want = ref["model"].score_edges(
        ref["params"], ref["dg"], emb_ref, edge_type, k, rows, cols
    )
    got = port["model"].score_edges(
        port["params"], port["dg"], emb, edge_type, k,
        torch.from_numpy(rows), torch.from_numpy(cols),
    )
    _close(got.numpy(), np.asarray(want))
    key, name = etkey(edge_type), port["dg"].decoder_name(edge_type)
    want_m = jax_dec.score_matrix(
        ref["params"]["dec"][key], name, k,
        emb_ref[str(edge_type[0])], emb_ref[str(edge_type[1])],
    )
    got_m = dec.score_matrix(
        port["params"]["dec"][key], name, k,
        emb[str(edge_type[0])], emb[str(edge_type[1])],
    )
    assert tuple(got_m.shape) == (n_r, n_c)
    _close(got_m.numpy(), np.asarray(want_m))
