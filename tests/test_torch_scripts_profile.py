"""The paper-scale profilers: the port's ``decagon_tpu_torch/scripts/``
``profile_epoch``, ``bench_scale``, ``probe_fullscale``, ``bench_paired``,
``profile_fullscale_step``, ``profile_factored_ops`` and ``profile_sddmm``
against the JAX package's scripts of the same names.

(a) Configuration: each script's graph, split, device graph, model and
training settings equal the JAX script's, read from its source with ``ast``
(importing most of them would set the JAX compilation cache).
(b) Fields: each record, at a small size on the CPU, holds every field of
the JAX artifact (``artifacts/perf/*.json``; for the two scripts that only
print, the fields of their printed lines).
(c) The step ablation: ``fwd`` and ``fwd_bwd`` (loss and gradients) of
``profile_fullscale_step`` against the JAX script's functions on a small
factored graph, the weights carried across with ``params_from_numpy``, the
JAX package's dropout bits and negative uniforms injected into the port.
Tolerances: 1e-5 of the largest magnitude for the f32 forward and the loss,
1e-4 of each leaf's largest for the gradients.
(d) The A/B sanity check of ``bench_paired``: each form (paired at
"paired_ref", factored) against the JAX package's on the same operands at
1e-5 of the largest output.  The two forms round at different points (the
paired form casts its operand to bf16 before the column scale, the factored
one after), so they differ from each other by ~2e-3 of the largest output in
both packages (the JAX script's own record: 1.8e-3 and 2.9e-3); the port's
sanity number is held to the JAX package's on the same inputs.
(e) Flat scoring: ``profile_sddmm``'s stream through the evaluator's
``_probs_flat`` against the JAX evaluator's at 1e-5; the evaluation split's
checks (``split_checks``) catch parts that do not add up to a call and
clocks that change the whole, and the split adds up on the CPU.
(f) Per-op aggregation: ``bench.device_profile`` on a CPU ``torch.profiler``
trace of a small chunk, reshaped by ``profile_factored_ops.planes``: shares
in [0, 1] summing to at most 1, sorted by time.
(g) The checked-in card records hold their JAX fields, name the card and
carry the kernels' launches.
"""

import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decagon_tpu_torch import bench
from decagon_tpu_torch.scripts import bench_paired as b_paired
from decagon_tpu_torch.scripts import bench_scale as b_scale
from decagon_tpu_torch.scripts import probe_fullscale as p_full
from decagon_tpu_torch.scripts import profile_epoch as p_epoch
from decagon_tpu_torch.scripts import profile_factored_ops as p_ops
from decagon_tpu_torch.scripts import profile_fullscale_step as p_step
from decagon_tpu_torch.scripts import profile_sddmm as p_sddmm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERF = os.path.join(ROOT, "artifacts", "perf")
SMALL = dict(n_proteins=200, n_drugs=40, n_side_effects=4, min_edges_per_relation=20,
             total_drugdrug_edges=800, ppi_attachment=5, seed=7)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(name):
    with open(os.path.join(ROOT, "scripts", f"{name}.py")) as f:
        return ast.parse(f.read())


def _calls(tree, name):
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)
            and (getattr(n.func, "id", None) == name or getattr(n.func, "attr", None) == name)]


def _kw(call):
    """A call's keyword arguments: literals where they are, else source."""
    out = {}
    for k in call.keywords:
        text = ast.unparse(k.value)
        try:
            out[k.arg] = ast.literal_eval(text)
        except ValueError:
            out[k.arg] = text
    return out


def _one(tree, name):
    (call,) = _calls(tree, name)
    return _kw(call)


def _dtype(kw):
    """The JAX ``dense_dtype`` source as the port's dtype."""
    kw = dict(kw)
    if "dense_dtype" in kw:
        kw["dense_dtype"] = {"jnp.bfloat16": torch.bfloat16}[kw["dense_dtype"]]
    return kw


def _defaults(tree):
    return {c.args[0].value: _kw(c).get("default") for c in _calls(tree, "add_argument")}


# ---- (a) configuration ---------------------------------------------------

def test_profile_epoch_config():
    tree = _tree("profile_epoch")
    assert _one(tree, "make_polypharmacy_like_graph") == p_epoch.GRAPH
    assert _one(tree, "split_graph") == p_epoch.SPLIT
    assert _dtype(_one(tree, "build_device_graph")) == p_epoch.DEVICE_GRAPH
    assert _one(tree, "ModelConfig") == p_epoch.MODEL
    assert _one(tree, "TrainConfig") == p_epoch.TRAIN
    assert _one(tree, "Trainer")["seed"] == 0
    consts = {t.id: ast.literal_eval(n.value) for n in ast.walk(tree)
              if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Name) and t.id in ("n_sync", "n_pipe")}
    assert consts == {"n_sync": p_epoch.N_SYNC, "n_pipe": p_epoch.N_PIPE}


def test_bench_scale_config():
    tree = _tree("bench_scale")
    graph = _one(tree, "make_polypharmacy_like_graph")
    assert graph.pop("n_side_effects") == "n_se" and graph == b_scale.GRAPH
    assert _one(tree, "split_graph") == b_scale.SPLIT
    assert _one(tree, "build_device_graph") == {
        "tile_for_pallas": "'pallas' in impl or impl == 'auto'"}
    model = _one(tree, "ModelConfig")
    assert model.pop("spmm_impl") == "impl" and model == b_scale.MODEL
    train = _one(tree, "TrainConfig")
    assert train.pop("scan_chunk") == "chunk" and train == b_scale.TRAIN
    src = ast.unparse(tree)
    assert f"chunk = {b_scale.CHUNK}" in src and "else 50" in src and b_scale.N_SE == 50
    assert "else ['xla', 'pallas']" in src and b_scale.IMPLS == ["xla", "pallas"]


def test_probe_fullscale_config():
    tree = _tree("probe_fullscale")
    want = _defaults(tree)
    args = p_full.parse_args([])
    for flag, default in want.items():
        assert getattr(args, flag[2:].replace("-", "_")) == (default or False), flag
    graph = _one(tree, "make_polypharmacy_like_graph")
    assert {k: v for k, v in graph.items() if k in p_full.GRAPH} == p_full.GRAPH
    assert _one(tree, "split_graph") == p_full.SPLIT
    model = _one(tree, "ModelConfig")
    assert (model["hidden1"], model["hidden2"], model["dropout"]) == (64, 32, 0.1)
    train = _one(tree, "TrainConfig")
    assert (train["batch_size"], train["learning_rate"]) == (512, 1e-3)


def test_bench_paired_config():
    tree = _tree("bench_paired")
    assert _one(tree, "make_polypharmacy_like_graph") == b_paired.GRAPH
    assert _one(tree, "split_graph") == b_paired.SPLIT
    dg = _dtype(_one(tree, "build_device_graph"))
    assert (dg.pop("dense_factored"), dg.pop("dense_paired")) == (True, True)
    assert dg == b_paired.DEVICE_GRAPH
    assert _one(tree, "TrainConfig") == {"batch_size": 512, "scan_chunk": b_paired.CHUNK}
    (timed,) = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
                and n.name == "timed_chunks"]
    assert timed.args.defaults[-1].value == b_paired.WINDOWS
    assert f"nnz = {b_paired.NNZ_JAX_SCRIPT}" in ast.unparse(tree)
    assert f"(adj.num_rel, adj.n_rows, {b_paired.H})" in ast.unparse(tree)


def test_profile_fullscale_step_config():
    tree = _tree("profile_fullscale_step")
    graph = _one(tree, "make_polypharmacy_like_graph")
    assert graph.pop("n_side_effects") == "args.relations" and graph == p_step.GRAPH
    assert _one(tree, "split_graph") == p_step.SPLIT
    assert _dtype(_one(tree, "build_device_graph")) == p_step.DEVICE_GRAPH
    assert _one(tree, "ModelConfig") == {"spmm_impl": "auto"}
    assert _one(tree, "TrainConfig") == {"batch_size": 512}
    src = ast.unparse(tree)
    for seed in (0, 1):
        assert f"np.random.default_rng({seed}).integers(0, 645, size=512)" in src
    assert "et = (1, 1)" in src and "k = jnp.int32(0)" in src
    assert p_step.EDGE_TYPE == (1, 1) and p_step.RELATION == 0


def test_profile_factored_ops_config():
    tree = _tree("profile_factored_ops")
    graph = _one(tree, "make_polypharmacy_like_graph")
    assert graph.pop("n_side_effects") == "args.relations" and graph == p_ops.GRAPH
    assert _one(tree, "split_graph") == p_ops.SPLIT
    dg = _dtype(_one(tree, "build_device_graph"))
    assert (dg.pop("dense_factored"), dg.pop("dense_paired")) == (True, True)
    assert dg == p_ops.DEVICE_GRAPH
    defaults = _defaults(tree)
    assert defaults["--spmm"] == "dense_factored" and defaults["--chunk"] == 20
    assert defaults["--out"] == "factored_op_profile.json"
    (parse,) = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
                and n.name == "parse_xplane"]
    assert parse.args.defaults[-1].value == p_ops.TOP_N


def test_profile_sddmm_config():
    tree = _tree("profile_sddmm")
    assert _one(tree, "make_polypharmacy_like_graph") == p_sddmm.GRAPH
    assert _one(tree, "split_graph") == p_sddmm.SPLIT
    assert _dtype(_one(tree, "build_device_graph")) == p_sddmm.DEVICE_GRAPH
    assert f"reshape(-1, {p_sddmm.GATHER_CHUNK})" in ast.unparse(tree)


@pytest.mark.parametrize("main,args", [
    (p_epoch.main, []), (b_scale.main, []), (p_full.main, []), (b_paired.main, []),
    (p_step.main, []), (p_ops.main, []), (p_sddmm.main, []),
], ids=["profile_epoch", "bench_scale", "probe_fullscale", "bench_paired",
        "profile_fullscale_step", "profile_factored_ops", "profile_sddmm"])
def test_scripts_need_the_card_unless_told_otherwise(main, args, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "record.json")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(args + ["--out", out])
    assert not os.listdir(tmp_path)


# ---- (b) fields at a small size -----------------------------------------------

def _jax_record(name):
    with open(os.path.join(PERF, f"{name}.json")) as f:
        return json.load(f)


def _missing(want, got, path=""):
    """The JAX record's fields the port's record lacks (nested dicts
    compared key by key; ``planes`` by the fields of each plane)."""
    out = []
    for key, value in want.items():
        if key == "planes":
            (plane,) = [p for p in value.values() if "ops" in p][:1]
            for p in got["planes"].values():
                out += [f"planes/{k}" for k in plane if k not in p]
                out += [f"planes/ops/{k}" for k in plane["ops"][0] if k not in p["ops"][0]]
            continue
        if key not in got:
            out.append(path + key)
        elif isinstance(value, dict) and isinstance(got[key], dict) and "status" not in got[key]:
            out += _missing(value, got[key], f"{path}{key}/")
    return out


def _printed_fields(name):
    """The keys of the JSON line the JAX script prints."""
    tree = _tree(name)
    (dumps,) = [c for c in _calls(tree, "dumps") if isinstance(c.args[0], ast.Dict)]
    return {k.value for k in dumps.args[0].keys}


def _small_records():
    return {
        "epoch_profile": lambda: p_epoch.profile_epoch(
            "cpu", graph_kw=dict(SMALL, planted_rank=4), chunk=2, n_sync=2, n_pipe=2,
            log=lambda m: None),
        "paired_bench": lambda: b_paired.bench_paired("cpu", graph_kw=SMALL, chunk=2,
                                                      windows=2, reps=1),
        "fullscale_step_profile": lambda: p_step.profile_step(device="cpu", graph_kw=SMALL,
                                                              reps=1, batch_size=64),
        "factored_op_profile": lambda: p_ops.profile_ops("dense_factored", chunk=2,
                                                         device="cpu", graph_kw=SMALL,
                                                         batch_size=64),
        "paired_op_profile": lambda: p_ops.profile_ops("paired", chunk=2, device="cpu",
                                                       graph_kw=SMALL, batch_size=64),
        "sddmm_profile": lambda: p_sddmm.profile_sddmm("cpu", graph_kw=SMALL,
                                                       log=lambda m: None),
    }


@pytest.mark.parametrize("name", list(_small_records()))
def test_small_record_holds_the_jax_fields(name):
    record = _small_records()[name]()
    assert _missing(_jax_record(name), record) == []
    assert record["torch"] == torch.__version__ and record["device"] == "cpu"
    json.dumps(record)


def test_bench_scale_lines_hold_the_printed_fields():
    lines = b_scale.bench_scale(4, ["xla", "pallas"], "cpu",
                                graph_kw=dict(n_proteins=200, n_drugs=40, seed=7), chunk=2)
    fields = _printed_fields("bench_scale")
    assert fields == {"impl", "n_side_effects", "nnz", "step_ms", "edges_per_s",
                      "graph_build_s"}
    for line in lines:
        assert fields <= set(line)
    xla, pallas = lines
    assert xla["step_ms"] > 0 and xla["edges_per_s"] == xla["nnz"] / xla["step_ms"] * 1e3
    # The JAX package's "pallas" raises on this graph's dense edge types too.
    assert pallas["step_ms"] is None and "no tilings" in pallas["error"]


def test_probe_fullscale_record_holds_the_printed_items(monkeypatch):
    """The JAX script's stages, memory lines, per-edge-type lines and steady
    state; the CSR's statistics where the layouts are built (forced on the
    CPU here, as the card builds them)."""
    real_build = p_full.build_device_graph
    monkeypatch.setattr(p_full, "build_device_graph",
                        lambda *a, **kw: real_build(*a, **dict(kw, tile_for_pallas=True)))
    args = p_full.parse_args(["--relations", "4", "--proteins", "200", "--drugs", "40",
                              "--edges", "800", "--chunk", "2", "--steps", "2",
                              "--device", "cpu", "--impl", "pallas",
                              "--densify-max-cells", "0"])
    rec = p_full.probe(args, log=lambda m: None)
    tree = _tree("probe_fullscale")
    stages = {c.args[0].value for c in _calls(tree, "stage") if isinstance(c.args[0], ast.Constant)}
    assert stages <= set(rec["stages_s"]) and any(s.startswith("sampled") for s in rec["stages_s"])
    for key in ("hbm_after_graph", "hbm_after_params", "hbm_after_first_step", "relations",
                "edges_raw", "ms_per_step", "edges_per_s", "times_s", "nnz"):
        assert key in rec
    assert sorted(rec["adj"]) == ["0,0", "0,1", "1,0", "1,1"]
    for line in rec["adj"].values():
        assert {"K", "n_rows", "n_cols", "nnz", "pad", "dense"} <= set(line)
        assert line["csr_fwd"]["nnz"] == line["csr_bwd"]["nnz"] == line["nnz"]
    assert rec["ms_per_step"] > 0 and rec["edges_per_s"] == rec["nnz"] / (rec["ms_per_step"] / 1e3)


# ---- (c) the step ablation -------------------------------------------------

@pytest.fixture(scope="module")
def factored_pair():
    from decagon_tpu.graph.device import build_device_graph as jax_build
    from decagon_tpu.graph.split import split_graph as jax_split
    from decagon_tpu.graph.synthetic import make_polypharmacy_like_graph as jax_graph
    from decagon_tpu.models.model import DecagonModel as JaxModel
    from decagon_tpu.models.model import ModelConfig as JaxConfig
    from decagon_tpu_torch.graph.device import build_device_graph
    from decagon_tpu_torch.graph.split import split_graph
    from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
    from decagon_tpu_torch.models.convert import params_from_numpy
    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig

    kw = dict(SMALL)
    dg_kw = dict(densify_max_cells=1_000_000_000, build_fused=False, dense_factored=True)
    g_ref = jax_graph(**kw)
    s_ref = jax_split(g_ref, **p_step.SPLIT)
    dg_ref = jax_build(g_ref, s_ref, dense_dtype=jnp.bfloat16, **dg_kw)
    model_ref = JaxModel(JaxConfig(spmm_impl="auto"), dg_ref)
    params_ref = model_ref.init_params(jax.random.PRNGKey(0), dg_ref)
    g = make_polypharmacy_like_graph(**kw)
    s = split_graph(g, **p_step.SPLIT)
    dg = build_device_graph(g, s, dense_dtype=torch.bfloat16, device="cpu", **dg_kw)
    model = DecagonModel(ModelConfig(spmm_impl="auto"), dg)
    params = params_from_numpy(jax.device_get(params_ref), device="cpu")
    return (dict(dg=dg_ref, model=model_ref, params=params_ref),
            dict(dg=dg, model=model, params=params, n_drugs=g.num_nodes[1]))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key in tree:
            out.update(_flat(tree[key], f"{prefix}/{key}"))
        return out
    return {prefix: np.asarray(tree, np.float64)}


def _hold_max(got, want, tol):
    """The largest error within ``tol`` of the largest magnitude."""
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), err / max(np.abs(want).max(), 1e-30)


def _factored_f32(p_stack, mask, mask_t, row_scale, col_scale):
    """The port's factored aggregation without its bf16 cast points."""
    kih = torch.bmm(mask.float(), p_stack * col_scale[:, :, None])
    return torch.einsum("ki,kih->ih", row_scale, kih)


def _jax_factored_f32(p_stack, mask, mask_t, row_scale, col_scale):
    """The JAX package's factored aggregation without its bf16 cast points."""
    kih = jnp.einsum("kij,kjh->kih", mask.astype(jnp.float32), p_stack * col_scale[:, :, None],
                     precision=jax.lax.Precision.HIGHEST)
    return jnp.einsum("ki,kih->ih", row_scale, kih, precision=jax.lax.Precision.HIGHEST)


@pytest.mark.parametrize("casts", [True, False], ids=["bf16-cast-points", "f32"])
def test_step_ablation_holds_the_jax_functions(factored_pair, monkeypatch, casts):
    """With the cast points taken out of both packages (the same factored
    aggregation in f32): forward and loss at 1e-5, every gradient at 1e-4
    of its leaf's largest magnitude.  With the bf16 cast points (the
    production path: ``(P * b).bf16`` forward, ``(a * ct).bf16`` backward),
    an f32 input that the two packages' sums (in another order) put on
    either side of a rounding boundary moves by one bf16 ulp, 2^-8 of it,
    and every row it reaches moves with it: the loss holds at 1e-5, the
    forward at 1e-3 and the gradients (downstream of those rows, and the
    encoder's past the backward's cast point in every layer) at the repo's
    whole-step tolerance of 2^-6 (``chip_smoke.STEP_GRAD_TOL``)."""
    from decagon_tpu.models.losses import LOSSES as JAX_LOSSES
    from decagon_tpu.ops import segment as jax_segment
    from decagon_tpu.train.negatives import sample_unigram as jax_sample_unigram
    from decagon_tpu_torch.ops import segment as port_segment
    from decagon_tpu_torch.train.step import TrainConfig
    from tests.test_torch_train import _jax_draws

    # The JAX script's "auto" on the accelerator: the factored masks.
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    if not casts:
        monkeypatch.setattr(port_segment, "spmm_dense_factored", _factored_f32)
        monkeypatch.setattr(jax_segment, "spmm_dense_factored", _jax_factored_f32)
    ref, port = factored_pair
    batch_size = 64
    cfg = TrainConfig(batch_size=batch_size)
    rows, cols = p_step.batch(port["n_drugs"], batch_size, "cpu")
    fns = p_step.ablation(port["model"], port["dg"], cfg, rows, cols)
    et, k = p_step.EDGE_TYPE, p_step.RELATION
    model_ref, dg_ref = ref["model"], ref["dg"]
    jrows, jcols = jnp.asarray(rows.numpy()), jnp.asarray(cols.numpy())

    # fwd: the deterministic forward.
    want = model_ref.embeddings(ref["params"], dg_ref, deterministic=True)
    got = fns["fwd"](port["params"])
    for key in want:
        _hold_max(got[key].numpy(), np.asarray(want[key]), 1e-3 if casts else 1e-5)

    # fwd_bwd: the JAX script's loss_fn body, its draws injected into the port.
    def loss_fn(params, g, rng):
        enc_rng, sample_rng = jax.random.split(rng)
        emb = model_ref.embeddings(params, g, enc_rng, deterministic=False)
        pos = model_ref.score_edges(params, g, emb, et, k, jrows, jcols)
        neg_rows = jax_sample_unigram(sample_rng, g.neg_cdf["1,1"][k], batch_size)
        neg = model_ref.score_edges(params, g, emb, et, k, neg_rows, jcols)
        return JAX_LOSSES["hinge"](pos, neg, cfg.margin)

    rng = jax.random.PRNGKey(1)
    want_loss, want_grads = jax.value_and_grad(loss_fn)(ref["params"], dg_ref, rng)
    bits, u = _jax_draws(port, rng, cfg)
    got_loss, got_grads = fns["fwd_bwd"](port["params"], torch.Generator().manual_seed(0),
                                         layer_bits=bits, neg_u=u)
    assert float(want_loss) > 0
    assert abs(float(got_loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    flat_got, flat_want = _flat(got_grads), _flat(jax.device_get(want_grads))
    assert sorted(flat_got) == sorted(flat_want)
    nonzero = 0
    for name, w in flat_want.items():
        tol = 2.0 ** -6 if casts else 1e-4
        assert np.abs(flat_got[name] - w).max() <= tol * max(np.abs(w).max(), 1e-30), name
        nonzero += bool(np.abs(w).max() > 0)
    assert nonzero >= 4
    # adam_only: one call of the optimizer's apply, a new state.
    opt_state = fns["optimizer"].init(port["params"])
    new_params, new_state = fns["adam_only"](port["params"], opt_state, got_grads)
    assert new_state["t"] == 1 and set(new_params) == set(port["params"])


# ---- (d) the A/B sanity check ------------------------------------------------

@pytest.fixture(scope="module")
def ab_graphs():
    from decagon_tpu.graph.device import build_device_graph as jax_build
    from decagon_tpu.graph.split import split_graph as jax_split
    from decagon_tpu.graph.synthetic import make_polypharmacy_like_graph as jax_graph
    from decagon_tpu_torch.graph.split import split_graph
    from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph

    g_ref = jax_graph(**SMALL)
    s_ref = jax_split(g_ref, **b_paired.SPLIT)
    dg_ref = jax_build(g_ref, s_ref, densify_max_cells=1_000_000_000, dense_dtype=jnp.bfloat16,
                       build_fused=False, dense_factored=True, dense_paired=True)
    g = make_polypharmacy_like_graph(**SMALL)
    s = split_graph(g, **b_paired.SPLIT)
    return dg_ref, b_paired.device_graphs(g, s, "cpu")


@pytest.mark.parametrize("key", b_paired.KEYS)
def test_ab_sanity_holds_the_jax_forms(key, ab_graphs):
    from decagon_tpu.ops import spmm_paired as jax_sp
    from decagon_tpu.ops.segment import spmm_dense_factored as jax_factored

    dg_ref, (dg, dg_f) = ab_graphs
    adj, fadj, jadj = dg.adj[key], dg_f.adj[key], dg_ref.adj[key]
    assert adj.pair_mask is not None and adj.dense_mask is None and fadj.dense_mask is not None
    p_t, p_s, _ = b_paired.operands(adj.num_rel // 2, adj.n_rows, b_paired.H, 0, "cpu")
    with torch.no_grad():
        pair = b_paired.fwd_pair(p_t, adj, impl="paired_ref")
        fact = b_paired.fwd_fact(p_s, fadj)
    jpair = np.asarray(jax_sp.spmm_paired(jnp.asarray(p_t.numpy()), jadj, impl="paired_ref"))
    jfact = np.asarray(jax_factored(jnp.asarray(p_s.numpy()), jadj.dense_mask, jadj.dense_mask_t,
                                    jadj.row_scale, jadj.col_scale))
    assert b_paired.rel_err(pair, torch.from_numpy(jpair)) <= 1e-5
    assert b_paired.rel_err(fact, torch.from_numpy(jfact)) <= 1e-5
    port_err = b_paired.rel_err(pair, fact)
    jax_err = b_paired.rel_err(torch.from_numpy(jpair), torch.from_numpy(jfact))
    assert 0 < jax_err < 1e-2 and abs(port_err - jax_err) <= 2e-5
    # The script's own sanity number on the CPU ("paired" runs the plain
    # version there) is the same comparison.
    line = b_paired.microbench(adj, fadj, 0, "cpu", reps=1)
    assert line["fwd_max_rel_err"] == port_err


# ---- (e) flat scoring ------------------------------------------------------

def test_flat_scoring_holds_the_jax_evaluator(factored_pair, monkeypatch):
    from decagon_tpu.graph.split import split_graph as jax_split
    from decagon_tpu.graph.synthetic import make_polypharmacy_like_graph as jax_graph
    from decagon_tpu.models.model import DecagonModel as JaxModel
    from decagon_tpu.models.model import ModelConfig as JaxConfig
    from decagon_tpu.train.evaluate import AccuracyEvaluator as JaxEvaluator
    from decagon_tpu_torch.graph.split import split_graph
    from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
    from decagon_tpu_torch.train.evaluate import AccuracyEvaluator

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    ref, port = factored_pair
    g_ref, g = jax_graph(**SMALL), make_polypharmacy_like_graph(**SMALL)
    s_ref, s = jax_split(g_ref, **p_sddmm.SPLIT), split_graph(g, **p_sddmm.SPLIT)
    ev_ref = JaxEvaluator(JaxModel(JaxConfig(spmm_impl="auto", sddmm_impl="jnp"), ref["dg"]),
                          g_ref, s_ref)
    ev = AccuracyEvaluator(DecagonModel(ModelConfig(spmm_impl="auto", sddmm_impl="jnp"),
                                        port["dg"]), g, s, device="cpu")
    dd = (1, 1)
    batches = [(key[2], sp.val) for key, sp in s.items() if key[:2] == dd]
    batches_ref = [(key[2], sp.val) for key, sp in s_ref.items() if key[:2] == dd]
    for (k, e), (k_ref, e_ref) in zip(batches, batches_ref):
        assert k == k_ref and np.array_equal(e, e_ref)
    emb_ref = ev_ref._embed(ref["params"], ref["dg"])
    emb = ev._embed(port["params"], port["dg"])
    want = np.concatenate(ev_ref._probs_flat(ref["params"], emb_ref, dd, batches_ref,
                                             cache_key=("prof", "val")))
    got = np.concatenate(ev._probs_flat(port["params"], emb, dd, batches,
                                        cache_key=("prof", "val")))
    assert got.shape == want.shape and got.size > 0
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _split_call(total, parts=(1.0, 2.0, 3.0, 90.0), other=4.0):
    return dict(zip(p_sddmm.FOUR, parts), other_ms=other, total_ms=total)


WHOLE = [95.0, 100.0, 105.0, 98.0, 102.0]


@pytest.mark.parametrize("runs,in_call,in_whole", [
    ([_split_call(100.0)] * 5, True, True),
    ([_split_call(100.0, parts=(1.0, 2.0, 3.0, 80.0))] * 5, False, True),
    ([_split_call(100.0, parts=(0.0, 0.0, 0.0, 0.0), other=0.0)] * 5, False, True),
    ([_split_call(140.0, parts=(1.0, 2.0, 3.0, 130.0))] * 5, True, False),
], ids=["adds-up", "parts-10pct-short", "parts-zero", "clocks-add-40pct"])
def test_split_checks_hold_the_parts_to_the_whole(runs, in_call, in_whole):
    got = p_sddmm.split_checks(runs, WHOLE)
    assert got["parts_add_up_in_each_call"] == in_call
    assert got["clocked_within_whole_iqr"] == in_whole
    assert got["parts_add_up"] == (in_call and in_whole)


def test_split_evaluation_adds_up_on_the_cpu(factored_pair):
    from decagon_tpu_torch.graph.split import split_graph
    from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
    from decagon_tpu_torch.train.evaluate import AccuracyEvaluator

    _, port = factored_pair
    g = make_polypharmacy_like_graph(**SMALL)
    ev = AccuracyEvaluator(DecagonModel(ModelConfig(spmm_impl="auto", sddmm_impl="jnp"),
                                        port["dg"]), g, split_graph(g, **p_sddmm.SPLIT),
                           device="cpu")
    emb = ev._embed(port["params"], port["dg"])
    want = ev.evaluate_all_drug_drug(port["params"], port["dg"], embeddings=emb)
    split = p_sddmm.split_evaluation(ev, port["params"], port["dg"], emb, reps=3)
    assert split["auroc"] == want.auroc and split["edges"] > 0
    assert len(split["clocked_runs"]) == len(split["whole_ms_runs"]) == 3
    # Off the card the scorer's device ms is its host ms: each call adds up exactly.
    assert split["parts_add_up_in_each_call"] and split["call_residual_share_max"] < 1e-9
    assert all(split[k] >= 0 for k in split["parts"])


# ---- (f) per-op aggregation ----------------------------------------------------

def test_aggregation_of_a_cpu_trace():
    from decagon_tpu_torch.graph.device import build_device_graph
    from decagon_tpu_torch.graph.split import split_graph
    from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
    from decagon_tpu_torch.train.step import TrainConfig
    from decagon_tpu_torch.train.trainer import Trainer

    g = make_polypharmacy_like_graph(**SMALL)
    s = split_graph(g, **p_ops.SPLIT)
    dg = build_device_graph(g, s, device="cpu", **p_ops.DEVICE_GRAPH, **p_ops.MASKS["paired"])
    trainer = Trainer(DecagonModel(ModelConfig(spmm_impl="paired"), dg), g, s, dg,
                      TrainConfig(batch_size=64, scan_chunk=2), seed=0)
    prof = bench.device_profile(trainer, 2, 1.0, top=None, on_card=False)
    (plane,) = p_ops.planes(prof, torch.device("cpu")).values()
    shares = [o["share"] for o in plane["ops"]]
    assert plane["total_ms"] > 0 and len(shares) == min(p_ops.TOP_N, len(prof["top"])) > 5
    assert all(0 <= x <= 1 for x in shares) and sum(shares) <= 1 + 1e-9
    assert [o["ms"] for o in plane["ops"]] == sorted((o["ms"] for o in plane["ops"]),
                                                     reverse=True)
    assert prof["kernels_per_step"] * prof["steps"] >= sum(o["n"] for o in plane["ops"])
    # Every row of the one reduction is kept: the shares of all of them add to 1.
    assert sum(r["ms_per_step"] for r in prof["top"]) == pytest.approx(
        prof["device_busy_ms_per_step"], rel=1e-9)


# ---- (g) the card records ------------------------------------------------------

CARD_RECORDS = {
    "torch_epoch_profile": ("epoch_profile", {"adam"}),
    "torch_paired_bench": ("paired_bench", {"paired_fwd", "paired_bwd", "adam"}),
    "torch_fullscale_step_profile": ("fullscale_step_profile", {"adam"}),
    "torch_factored_op_profile": ("factored_op_profile", {"adam"}),
    "torch_paired_op_profile": ("paired_op_profile", {"paired_fwd", "paired_bwd", "adam"}),
    "torch_sddmm_profile": ("sddmm_profile", {"sddmm", "sddmm_bf16"}),
}


def _launched(tree, counting=False):
    """Every kernel with a non-zero count anywhere under a ``launches``
    field of the record (its counts may be grouped by call)."""
    found = set()
    if isinstance(tree, dict):
        for key, value in tree.items():
            inside = counting or "launches" in key
            if inside and isinstance(value, (int, float)) and value:
                found.add(key)
            found |= _launched(value, inside)
    elif isinstance(tree, list):
        for value in tree:
            found |= _launched(value, counting)
    return found


@pytest.mark.parametrize("name", list(CARD_RECORDS))
def test_card_record_holds_the_jax_fields(name):
    jax_name, kernels = CARD_RECORDS[name]
    record = _jax_record(name)
    assert _missing(_jax_record(jax_name), record) == []
    assert "H100" in record["device"] and record["torch"]
    assert kernels <= _launched(record), _launched(record)


def test_card_scale_and_probe_records():
    lines = _jax_record("torch_scale_bench")
    fields = _printed_fields("bench_scale")
    assert [line["impl"] for line in lines][:2] == ["xla", "pallas"]
    for line in lines:
        assert fields <= set(line) and "H100" in line["device"]
    assert any(line.get("launches_per_step", {}).get("spmm_tiled") for line in lines)
    probe = _jax_record("torch_fullscale_probe")
    assert "H100" in probe["device"] and probe["launches_per_step"]["spmm_tiled"] > 0
    assert all(line["aggregation"] == "pallas" for line in probe["adj"].values())


def test_card_evaluation_split_adds_up():
    split = _jax_record("torch_sddmm_profile")["evaluation_split"]
    assert split["parts"] == list(p_sddmm.FOUR) and split["reps"] == p_sddmm.SPLIT_REPS
    runs, whole = split["clocked_runs"], split["whole_ms_runs"]
    assert len(runs) == len(whole) == split["reps"]
    # The verdict the record carries is the one its own runs give.
    checks = p_sddmm.split_checks(runs, whole)
    assert {k: split[k] for k in checks} == checks
    assert split["parts_add_up"] and split["scoring_launches"]["sddmm_bf16"] > 0
