"""The step and optimizer probes: the port's ``decagon_tpu_torch/scripts/``
``perf_probe``, ``perf_probe2``, ``probe_adam``, ``probe_adam_bf16`` and
``probe_dense_layout`` against the JAX package's scripts of the same names.

(a) Configuration: each script's graph, split, device graph, model and
training settings equal the JAX script's, read from its source with ``ast``
(``probe_adam_bf16.py`` runs when imported).
(b) Each script needs the card unless told ``--device cpu``.
(c) A small CPU run of each writes a record that holds the JAX fields (the
JAX artifact's where there is one, else the lines the JAX script prints).
(d) Parity: the three Adams of ``probe_adam`` equal optax's ``adam`` after
3 steps on the same numpy gradients (1e-6); ``probe_dense_layout``'s two
forms equal each other and the JAX forms at a small K and N (the port's
bf16 products against JAX's f32 ones: half a bf16 step, 2^-8 of the
largest magnitude; the two forms one step apart at most, 2^-7); the
JAX package's "pallas" raises on the dummy graph, which has a dense stack
on every edge type, and the port's CSR layouts on every edge type give
``perf_probe``'s "pallas" the COO stream's embeddings (1e-5).
(e) The checked-in card records name the card, hold the JAX fields and
carry the launches of the kernels on their paths: K7 on every trainer
step, K6 on ``perf_probe``'s "pallas" lines.
"""

import ast
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from decagon_tpu_torch.scripts import perf_probe as pp
from decagon_tpu_torch.scripts import perf_probe2 as pp2
from decagon_tpu_torch.scripts import probe_adam as pa
from decagon_tpu_torch.scripts import probe_adam_bf16 as pab
from decagon_tpu_torch.scripts import probe_dense_layout as pdl
from tests.test_torch_scripts_profile import SMALL, _calls, _dtype, _kw, _one, _tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUMMY = dict(n_genes=60, n_drugs=40, n_drugdrug_types=2, seed=0)
POLY = dict(n_proteins=200, n_drugs=40, n_side_effects=4, seed=7, planted_rank=4)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _artifact(*path):
    with open(os.path.join(ROOT, "artifacts", *path)) as f:
        return json.load(f)


def _printed(name):
    """The labels of the lines the JAX script prints (its f-strings' text
    between the tag and the colon)."""
    out = []
    for call in _calls(_tree(name), "print"):
        if call.args and isinstance(call.args[0], ast.JoinedStr):
            text = "".join(v.value for v in call.args[0].values if isinstance(v, ast.Constant))
            out.append(text.split("] ", 1)[-1].split(":")[0])
    return out


# ---- (a) configuration ---------------------------------------------------

def test_perf_probe_config():
    tree = _tree("perf_probe")
    assert _one(tree, "make_synthetic_graph") == pp.GRAPH
    assert _one(tree, "split_graph") == pp.SPLIT
    assert _one(tree, "build_device_graph") == {"tile_for_pallas": "'pallas' in impl"}
    model = _one(tree, "ModelConfig")
    assert model.pop("spmm_impl") == "impl" and model == pp.MODEL
    train = _one(tree, "TrainConfig")
    assert train.pop("scan_chunk") == "chunk" and train == pp.TRAIN
    src = ast.unparse(tree)
    assert f"else {pp.CHUNK}" in src and f"else {pp.IMPLS}" in src
    (timeit,) = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "timeit"]
    assert timeit.args.kw_defaults[-1].value == pp.REPS
    assert _printed("perf_probe") == list(pp.LINES.values())


def test_perf_probe2_config():
    tree = _tree("perf_probe2")
    assert _one(tree, "make_synthetic_graph") == pp.GRAPH
    assert _one(tree, "split_graph") == pp.SPLIT
    assert _one(tree, "build_device_graph") == {"tile_for_pallas": True,
                                                "tile_block": "tile_block"}
    src = ast.unparse(tree)
    assert f"chunk = {pp2.CHUNK}" in src and f"impl = '{pp2.IMPL}'" in src
    assert f"else {pp2.TILE_BLOCK}" in src
    train = _one(tree, "TrainConfig")
    assert train.pop("scan_chunk") == "chunk" and train == pp.TRAIN


def test_probe_adam_config():
    tree = _tree("probe_adam")
    graph = _one(tree, "make_polypharmacy_like_graph")
    assert graph.pop("n_side_effects") == "args.relations" and graph == pa.GRAPH
    assert _one(tree, "split_graph") == pa.SPLIT
    assert _dtype(_one(tree, "build_device_graph")) == pa.DEVICE_GRAPH
    assert _one(tree, "ModelConfig") == {"spmm_impl": "auto"}
    assert _one(tree, "TrainConfig") == {"batch_size": 512}
    (timed,) = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
                and n.name == "timed_pipelined"]
    assert [d.value for d in timed.args.defaults] == [pa.N, pa.WARMUP]
    for call in _calls(tree, "adam") + _calls(tree, "fused_adam"):
        assert call.args[0].value == pa.LR and _kw(call) == pa.ADAM
    src = ast.unparse(tree)
    assert all(f"'{name}'" in src for name in pa.variants())


def test_probe_adam_bf16_config():
    tree = _tree("probe_adam_bf16")
    graphs = [_kw(c) for c in _calls(tree, "make_polypharmacy_like_graph")]
    assert graphs == [pab.QUALITY_GRAPH, pab.PERF_GRAPH]
    assert [_kw(c) for c in _calls(tree, "split_graph")] == [pab.QUALITY_SPLIT, pab.PERF_SPLIT]
    assert [_dtype(_kw(c)) for c in _calls(tree, "build_device_graph")] == [
        pab.QUALITY_DEVICE_GRAPH, pab.PERF_DEVICE_GRAPH]
    assert [_kw(c) for c in _calls(tree, "ModelConfig")] == [pab.QUALITY_MODEL, pab.PERF_MODEL]
    trains = [_kw(c) for c in _calls(tree, "TrainConfig")]
    assert [t.pop("adam_moments_dtype") for t in trains] == ["dtype", "dtype"]
    assert trains == [pab.QUALITY_TRAIN, pab.PERF_TRAIN]
    src = ast.unparse(tree)
    assert f"for dtype in {pab.DTYPES}" in src and f"range({pab.EPOCHS})" in src
    assert f"range({pab.CHUNKS})" in src
    assert f"20 * {pab.CHUNKS + 2}" in src and pab.PERF_TRAIN["scan_chunk"] == 20


def test_probe_dense_layout_config():
    tree = _tree("probe_dense_layout")
    assert _one(tree, "make_polypharmacy_like_graph") == pdl.GRAPH
    assert _one(tree, "split_graph") == pdl.SPLIT
    assert _dtype(_one(tree, "build_device_graph")) == pdl.DEVICE_GRAPH
    src = ast.unparse(tree)
    assert f"for key in {pdl.KEYS}" in src and f"a.n_cols, {pdl.H})" in src
    assert "'kij,kjh->ih'" in src


# ---- (b) the card ------------------------------------------------------------

@pytest.mark.parametrize("main", [pp.main, pp2.main, pa.main, pab.main, pdl.main],
                         ids=["perf_probe", "perf_probe2", "probe_adam", "probe_adam_bf16",
                              "probe_dense_layout"])
def test_scripts_need_the_card_unless_told_otherwise(main, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--out", str(tmp_path / "record.json")])
    assert not os.listdir(tmp_path)


# ---- (c) small records ---------------------------------------------------

def _run_main(main, args, tmp_path):
    out = str(tmp_path / "record.json")
    main(args + ["--device", "cpu", "--out", out])
    with open(out) as f:
        return json.load(f)


def test_perf_probe_small_record_holds_the_printed_lines(tmp_path, monkeypatch):
    monkeypatch.setattr(pp, "GRAPH", DUMMY)
    rec = _run_main(pp.main, ["2", "xla,pallas"], tmp_path)
    assert sorted(rec["impls"]) == ["pallas", "xla"] and rec["device"] == "cpu"
    for impl, entry in rec["impls"].items():
        assert entry["tiles"] == (impl == "pallas")
        for key in pp.LINES:
            line = entry[key]
            assert line["ms_per_step"] > 0
            assert {"device_busy_ms_per_step", "idle_share", "kernels_per_step", "top"} <= set(
                line["profile"])


def test_perf_probe2_small_record(tmp_path, monkeypatch):
    monkeypatch.setattr(pp2, "perf_probe2", functools.partial(
        pp2.perf_probe2, chunk=2, graph_kw=DUMMY, reps=1))
    rec = _run_main(pp2.main, ["64", "rbg"], tmp_path)
    assert rec["tile_block"] == 64 and rec["rng_requested"] == "rbg" and rec["rng"] == "philox"
    for key in ("full_chunked_step_ms", "encoder_fwd_det_False_ms", "encoder_fwd_det_True_ms"):
        assert rec[key] > 0
    assert set(rec["notes"]) == {"rng", "tile_block", "tiles"}


def test_probe_adam_small_record_holds_the_jax_fields(tmp_path, monkeypatch):
    monkeypatch.setattr(pa, "probe_adam", functools.partial(
        pa.probe_adam, graph_kw=SMALL, batch_size=64, n=2, log=lambda m: None))
    rec = _run_main(pa.main, [], tmp_path)
    assert set(_artifact("perf", "adam_probe.json")) <= set(rec)
    assert set(rec["launches_per_call"]) == {"fwd_bwd", *pa.variants(),
                                             *(f"step_{v}" for v in pa.variants())}


def test_probe_adam_bf16_small_record_holds_the_jax_fields(tmp_path, monkeypatch):
    monkeypatch.setattr(pab, "probe_adam_bf16", functools.partial(
        pab.probe_adam_bf16, quality_kw=POLY, perf_kw=SMALL, epochs=2, chunk=2, chunks=1,
        log=lambda m: None))
    rec = _run_main(pab.main, [], tmp_path)
    assert set(_artifact("quality", "adam_bf16_moments.json")) <= set(rec)
    for dtype in pab.DTYPES:
        assert len(rec[f"poly50_val_auroc_{dtype}"]) == 2
        (epoch, _) = rec[f"poly50_epochs_{dtype}"]
        assert epoch["opt_steps"] == -(-epoch["steps"] // 8)
    assert rec["config"]["perf"]["model"]["spmm_impl"] == "dense_factored"


def test_probe_dense_layout_small_record(tmp_path, monkeypatch):
    monkeypatch.setattr(pdl, "GRAPH", SMALL)
    rec = _run_main(pdl.main, [], tmp_path)
    for key in pdl.KEYS:
        line = rec[key]
        assert line["out_dtype"] == "torch.bfloat16" and line["einsum_ms"] > 0
        assert line["flat_copy_gb"] == line["stack_gb"]
        assert max(line["einsum_max_rel_err"], line["mm2d_max_rel_err"]) <= 2 ** -8
        assert line["forms_max_rel_diff"] <= 2 ** -7


# ---- (d) parity ----------------------------------------------------------------

def test_adam_variants_equal_optax_adam():
    rng = np.random.default_rng(0)
    shapes = {"enc1": {"0,0": (3, 5, 4)}, "dec": {"1,1": (7,)}, "w": (2, 3)}

    def tree(make, s=shapes):
        return {k: tree(make, v) if isinstance(v, dict) else make(v) for k, v in s.items()}

    params = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    grads = [tree(lambda s: rng.standard_normal(s).astype(np.float32)) for _ in range(3)]
    opt = optax.adam(pa.LR, **pa.ADAM)
    want, state = jax.tree.map(jnp.asarray, params), None
    state = opt.init(want)
    for g in grads:
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, want)
        want = optax.apply_updates(want, upd)
    to_torch = functools.partial(jax.tree.map, lambda x: torch.from_numpy(np.array(x)))
    for name, variant in pa.variants().items():
        p = to_torch(params)
        s = variant.init(p)
        for g in grads:
            p, s = variant.apply(to_torch(g), s, p)
        got = jax.tree.map(lambda x: x.numpy(), p)
        for w, x in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert x.shape == w.shape and x.dtype == np.float32
            np.testing.assert_allclose(x, np.asarray(w), rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("k,ni,nj", [(3, 17, 11), (1, 40, 40)])
def test_dense_layout_forms_equal_the_jax_forms(k, ni, nj):
    rng = np.random.default_rng(k)
    d3 = (rng.random((k, ni, nj)) < 0.3).astype(np.float32) * rng.random((k, ni, nj))
    p = rng.standard_normal((k, nj, 8)).astype(np.float32)
    jd3, jp = jnp.asarray(d3, jnp.bfloat16), jnp.asarray(p, jnp.bfloat16)
    # The JAX script's two forms.
    jd2 = jnp.reshape(jnp.transpose(jd3, (1, 0, 2)), (ni, k * nj))
    want_e = np.asarray(jnp.einsum("kij,kjh->ih", jd3, jp, preferred_element_type=jnp.float32))
    want_m = np.asarray(jnp.dot(jd2, jp.reshape(-1, jp.shape[-1]),
                                preferred_element_type=jnp.float32))
    td3 = torch.from_numpy(np.array(jd3.astype(jnp.float32))).to(torch.bfloat16)
    tp = torch.from_numpy(np.array(jp.astype(jnp.float32))).to(torch.bfloat16)
    td2 = pdl.flat_stack(td3)
    assert torch.equal(td2.float(), torch.from_numpy(np.array(jd2.astype(jnp.float32))))
    got_e, got_m = pdl.eins(tp, td3), pdl.mm2d(tp, td2)
    assert got_e.dtype == got_m.dtype == torch.bfloat16
    # Each bf16 output within half a bf16 step of the largest value (2^-8 of
    # it) of the JAX forms' f32 ones; the two within one step (2^-7).
    scale = np.abs(want_e).max()
    for got in (got_e, got_m):
        for want in (want_e, want_m):
            assert np.abs(got.float().numpy() - want).max() <= 2.0 ** -8 * scale
    assert (got_e.float() - got_m.float()).abs().max() <= 2.0 ** -7 * scale


def test_pallas_on_the_dummy_graph():
    """The JAX package builds no tiles where a dense stack exists, so its
    "pallas" raises on the dummy graph; the port's ``perf_probe`` builds the
    CSR layouts everywhere and its "pallas" (K6's plain version here)
    gives the COO stream's embeddings."""
    from decagon_tpu.graph.device import build_device_graph as jax_build
    from decagon_tpu.graph.split import split_graph as jax_split
    from decagon_tpu.graph.synthetic import make_synthetic_graph as jax_graph
    from decagon_tpu.models.model import DecagonModel as JaxModel
    from decagon_tpu.models.model import ModelConfig as JaxConfig
    from decagon_tpu_torch.graph.device import build_device_graph
    from decagon_tpu_torch.graph.split import split_graph
    from decagon_tpu_torch.graph.synthetic import make_synthetic_graph
    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig

    g = jax_graph(**DUMMY)
    dg = jax_build(g, jax_split(g, **pp.SPLIT), tile_for_pallas=True, tile_block=64)
    assert all(adj.dense is not None and adj.tiles_fwd is None for adj in dg.adj.values())
    model = JaxModel(JaxConfig(spmm_impl="pallas", **pp.MODEL), dg)
    params = model.init_params(jax.random.PRNGKey(0), dg)
    with pytest.raises(ValueError, match="no tilings"):
        model.embeddings(params, dg, deterministic=True)

    g = make_synthetic_graph(**DUMMY)
    s = split_graph(g, **pp.SPLIT)
    tiled = build_device_graph(g, s, tile_for_pallas=pp.builds_tiles("pallas"),
                               tile_even_if_dense=pp.builds_tiles("pallas"), device="cpu")
    assert all(adj.tiles_fwd is not None for adj in tiled.adj.values())
    xla = DecagonModel(ModelConfig(spmm_impl="xla", **pp.MODEL), tiled)
    pallas = DecagonModel(ModelConfig(spmm_impl="pallas", **pp.MODEL), tiled)
    params = xla.init_params(torch.Generator().manual_seed(0), tiled)
    with torch.no_grad():
        want = xla.embeddings(params, tiled, deterministic=True)
        got = pallas.embeddings(params, tiled, deterministic=True)
    for key in want:
        assert (got[key] - want[key]).abs().max() <= 1e-5 * want[key].abs().max()


# ---- (e) the card records ------------------------------------------------------

def _card(rec):
    assert "H100" in rec["device"] and rec["torch"]


def test_card_perf_probe_record():
    rec = _artifact("perf", "torch_perf_probe.json")
    _card(rec)
    assert set(pp.IMPLS) <= set(rec["impls"])
    for impl, entry in rec["impls"].items():
        for key in pp.LINES:
            prof = entry[key]["profile"]
            assert prof["device_busy_ms_per_step"] > 0 and 0 <= prof["idle_share"] < 1
            assert prof["kernels_per_step"] > 0
        for key in ("full_chunked_step", "step_flat_adam"):
            assert entry[key]["launches_per_step"]["adam"] == 1.0
        if pp.builds_tiles(impl):
            for key in pp.LINES:
                assert entry[key]["launches_per_step"]["spmm_tiled"] > 0


def test_card_perf_probe2_record():
    rec = _artifact("perf", "torch_perf_probe2.json")
    _card(rec)
    assert rec["full_chunked_step_launches_per_step"]["adam"] == 1.0
    for det in (False, True):
        assert rec[f"encoder_fwd_det_{det}_launches_per_step"]["spmm_tiled"] > 0


def test_card_adam_probe_record():
    rec = _artifact("perf", "torch_adam_probe.json")
    _card(rec)
    assert set(_artifact("perf", "adam_probe.json")) <= set(rec)
    launches = rec["launches_per_call"]
    for name in ("adam_flatten", "adam_fused"):
        assert launches[name] == {"adam": 1.0} and launches[f"step_{name}"]["adam"] == 1.0
    assert "adam" not in launches["adam_plain"] and "adam" not in launches["step_adam_plain"]


def test_card_adam_bf16_record():
    rec = _artifact("quality", "torch_adam_bf16_moments.json")
    _card(rec)
    assert set(_artifact("quality", "adam_bf16_moments.json")) <= set(rec)
    for dtype in pab.DTYPES:
        assert len(rec[f"poly50_val_auroc_{dtype}"]) == pab.EPOCHS
        for epoch in rec[f"poly50_epochs_{dtype}"]:
            assert epoch["adam_launches_per_opt_step"] == 1.0
            assert epoch["eval_launches"].get("sddmm", 0) > 0
        assert rec[f"fullscale_factored_{dtype}"]["launches_per_step"]["adam"] == 1.0


def test_card_dense_layout_record():
    rec = _artifact("perf", "torch_dense_layout_probe.json")
    _card(rec)
    # (0,0) holds the PPI relation and its transpose.
    assert rec["1,1"]["shape"] == [1926, 645, 645] and rec["0,0"]["shape"] == [2, 19081, 19081]
    for key in pdl.KEYS:
        line = rec[key]
        # Half a bf16 step of the largest output against the f32 product,
        # one step between the forms.
        for err in ("einsum_max_rel_err", "mm2d_max_rel_err"):
            assert line[err] <= 2 ** -8, (key, err)
        assert line["forms_max_rel_diff"] <= 2 ** -7
        assert line["mm2d_ms"] > 0 and line["mm2d_ms_bf16_reductions"] > 0
