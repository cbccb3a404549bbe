"""The sparse regime beyond the paper's scale: the port's
``decagon_tpu_torch/scripts/bench_sparse_regime.py`` and
``quality_sparse_regime.py`` against the JAX package's scripts.

(a) Configuration: the port's ``CONFIGS`` equal the JAX script's, and the
quality script's graph, split, device graph, model and training settings
equal ``scripts/quality_sparse_regime.py``'s, both read from the JAX
scripts' source with ``ast`` (importing them would set the JAX compilation
cache).
(b) ``run_config`` at a small size (300 proteins, 40 drugs, 4 side
effects) on the CPU for every config: each implementation runs, all start
from one state, and the record carries the JAX fields and the port's; an
out-of-memory error of the "xla" comparator is a result, any other error
ends the run, and a config's process that fails ends the script.
(c) The degree-renumbered graph's CSR layouts against the JAX package's
tiles: the same ``(dst, src, val)`` multiset, bitwise.
(d) One grouped chunk at the quality script's ``TrainConfig`` (balanced, 8
batches an optimization step, lr 3e-3, bf16 moments and gradients),
"pallas" at "default", with and without ``remat``, against the JAX
package's "pallas_interpret" from the same parameters and the same random
draws, held as ``tests/test_torch_quality_full.py`` holds the paired
config's chunk (which holds it as ``tests/test_torch_trainer.py`` does).
(e) The K6 wrapper's int32 bound.
(f) The checked-in card artifacts: the bench's record holds every config
and implementation, every ``pallas*`` one timed through K6; the quality
trajectory meets ``tests/test_quality.py::test_sparse_regime_1600drugs_learns``'s
conditions, and its sidecar matches the JAX sidecar.
"""

import ast
import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decagon_tpu.graph.device import build_device_graph as jax_build
from decagon_tpu.graph.renumber import renumber_by_degree as jax_renumber
from decagon_tpu.graph.split import split_graph as jax_split
from decagon_tpu.graph.synthetic import make_polypharmacy_like_graph as jax_graph
from decagon_tpu.models.model import DecagonModel as JaxModel
from decagon_tpu.models.model import ModelConfig as JaxConfig
from decagon_tpu.train import step as jax_step
from decagon_tpu_torch.graph.renumber import renumber_by_degree
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.models.convert import params_from_numpy
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.ops import spmm_pallas
from decagon_tpu_torch.ops.tiling import INT32_MAX, build_tiles
from decagon_tpu_torch.scripts import bench_sparse_regime as bench_sr
from decagon_tpu_torch.scripts import quality_sparse_regime as quality_sr
from decagon_tpu_torch.train import step as step_mod
from decagon_tpu_torch.train.sampler import MinibatchScheduler
from tests.test_torch_quality_full import _hold, _kink_elements
from tests.test_torch_tiling import _decode, _triples
from tests.test_torch_train import _jax_draws
from tests.test_torch_trainer import BF16_ULP, _copy_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "artifacts")
# The small size of the CPU runs: run_config's own size keywords.
SMALL_SIZE = dict(n_proteins=300, n_side_effects=4)
SMALL_DRUGS = dict(n_drugs=40, dd_edges=2400)


@pytest.fixture(autouse=True)
def one_thread():
    """The port's side of these tests runs tiny CPU ops, which many
    threads slow down when the test run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- (a) configuration ---------------------------------------------------

def _module(path):
    with open(os.path.join(ROOT, path)) as f:
        return ast.parse(f.read())


def _call_kwargs(tree, name):
    """The keyword arguments (source text) of the one call of ``name``."""
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and (getattr(n.func, "id", None) == name or getattr(n.func, "attr", None) == name)]
    assert len(calls) == 1, (name, len(calls))
    return {k.arg: ast.unparse(k.value) for k in calls[0].keywords}


def _literal(text):
    return ast.literal_eval(text)


def test_configs_equal_the_jax_script():
    tree = _module("scripts/bench_sparse_regime.py")
    (node,) = [n for n in tree.body if isinstance(n, ast.Assign)
               and any(getattr(t, "id", None) == "CONFIGS" for t in n.targets)]
    want = eval(compile(ast.Expression(node.value), "CONFIGS", "eval"),
                {"__builtins__": {}, "dict": dict})
    assert bench_sr.CONFIGS == want
    assert list(bench_sr.CONFIGS) == list(want)
    for name, cfg in want.items():
        assert [spec[:3] for spec in bench_sr.CONFIGS[name]["impls"]] == [
            spec[:3] for spec in cfg["impls"]]
    # run_config's graph, split and device graph.
    graph = _call_kwargs(tree, "make_polypharmacy_like_graph")
    assert {k: _literal(v) for k, v in graph.items()
            if k in bench_sr.GRAPH} == bench_sr.GRAPH
    assert (graph["n_proteins"], graph["n_side_effects"]) == ("19081", "963")
    split = _call_kwargs(tree, "split_graph")
    assert {k: _literal(v) for k, v in split.items()} == bench_sr.SPLIT
    dg = _call_kwargs(tree, "build_device_graph")
    assert {k: _literal(v) for k, v in dg.items()} == bench_sr.DEVICE_GRAPH
    trainer_cfg = _call_kwargs(tree, "TrainConfig")
    assert (trainer_cfg["batch_size"], trainer_cfg["learning_rate"]) == ("512", "0.001")
    model = _call_kwargs(tree, "ModelConfig")
    assert (model["hidden1"], model["hidden2"], model["dropout"]) == ("64", "32", "0.1")


def test_quality_settings_equal_the_jax_script():
    tree = _module("scripts/quality_sparse_regime.py")
    graph = _call_kwargs(tree, "make_polypharmacy_like_graph")
    assert graph.pop("planted_noise") == "args.noise"
    assert {k: _literal(v) for k, v in graph.items()} == dict(
        quality_sr.GRAPH, **quality_sr.GRAPH_REST)
    split = _call_kwargs(tree, "split_graph")
    assert {k: _literal(v) for k, v in split.items()} == dict(
        val_frac=0.05, test_frac=0.05, seed=quality_sr.SPLIT_SEED)
    dg = _call_kwargs(tree, "build_device_graph")
    assert {k: _literal(v) for k, v in dg.items()} == bench_sr.DEVICE_GRAPH
    model = _call_kwargs(tree, "ModelConfig")
    assert {k: _literal(v) for k, v in model.items()} == quality_sr.MODEL
    assert ModelConfig(**quality_sr.MODEL).sddmm_precision == "highest"
    train = {k: _literal(v) for k, v in _call_kwargs(tree, "TrainConfig").items()}
    assert train.pop("scan_chunk") == quality_sr.SCAN_CHUNK
    assert train == quality_sr.TRAIN
    trainer = _call_kwargs(tree, "Trainer")
    assert _literal(trainer["seed"]) == quality_sr.TRAINER_SEED
    defaults = {
        call.args[0].value: {k.arg: _literal(ast.unparse(k.value)) for k in call.keywords
                             if k.arg == "default"}
        for call in ast.walk(tree) if isinstance(call, ast.Call)
        and getattr(call.func, "attr", None) == "add_argument"
    }
    args = quality_sr.parse_args([])
    for flag in ("--epochs", "--noise"):
        assert getattr(args, flag[2:]) == defaults[flag]["default"]
    cfg = quality_sr.train_config(quality_sr.TRAIN)
    assert (cfg.loss, cfg.lr_schedule, cfg.adam_moments_dtype, cfg.grad_dtype) == (
        jax_step.TrainConfig().loss, "constant", "bfloat16", "bfloat16")


def test_scripts_run_on_the_card_unless_told_otherwise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_sr.main(["--only", "paper_cap", "--out", str(tmp_path / "x.json")])
    with pytest.raises(RuntimeError, match="CUDA"):
        quality_sr.run(quality_sr.parse_args(["--artifact-dir", str(tmp_path)]))
    assert not os.listdir(tmp_path)


# ---- (b) run_config at a small size --------------------------------------

class RecordingTrainer(bench_sr.Trainer):
    """Keeps a copy of each trainer's starting parameters."""

    starts = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        RecordingTrainer.starts.append(
            {k: v.detach().clone() for k, v in _flat_params(self.params).items()})


def _flat_params(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_flat_params(value, f"{prefix}/{key}"))
        return out
    return {prefix: tree}


@pytest.fixture
def recording(monkeypatch):
    RecordingTrainer.starts = []
    monkeypatch.setattr(bench_sr, "Trainer", RecordingTrainer)
    return RecordingTrainer


@pytest.mark.parametrize("name", list(bench_sr.CONFIGS))
def test_run_config_at_a_small_size(name, recording):
    cfg = dict(bench_sr.CONFIGS[name], **SMALL_DRUGS)
    out = bench_sr.run_config(**cfg, **SMALL_SIZE, device="cpu", chunk=2, windows=1)
    tags = [spec[0] for spec in cfg["impls"]]
    assert set(out) == {"workload", "host_build_s", "host_build_stages_s", "renumbered", "nnz",
                        "dd_stack_gib", "card_memory_gib", "graph_memory_gib", "layouts", *tags}
    assert out["renumbered"] == cfg.get("renumber", False)
    stages = {"graph_s", "split_s", "device_graph_s"} | (
        {"renumber_s"} if cfg.get("renumber") else set())
    assert set(out["host_build_stages_s"]) == stages
    assert out["host_build_s"] >= sum(out["host_build_stages_s"].values()) > 0
    assert f"nnz={out['nnz']}" in out["workload"] and "densify_max_cells=0" in out["workload"]
    assert out["dd_stack_gib"] == 8 * 40 * 40 * 2 / 2**30
    assert sorted(out["layouts"]) == ["0,0", "0,1", "1,0", "1,1"]
    for stats in out["layouts"].values():
        assert stats["fwd"]["nnz"] == stats["bwd"]["nnz"] > 0
    for tag in tags:
        r = out[tag]
        assert r["ms_per_step_min"] == r["ms_per_step_median"] == r["window_ms"][0] > 0
        assert r["edges_per_s"] == out["nnz"] / (r["ms_per_step_min"] / 1e3)
        assert r["peak_gib"] is None and set(r["launches_per_step"]) == {"spmm_tiled", "adam"}
        assert r["spmm_plans"] == []  # the plain versions ran (CPU tensors)
    # Every implementation from one state.
    assert len(recording.starts) == len(tags)
    for start in recording.starts[1:]:
        for key, value in recording.starts[0].items():
            assert torch.equal(start[key], value), key


def _oom(*args, **kwargs):
    raise torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.50 GiB. GPU 0 has a total capacity of 79.19 GiB")


def test_only_an_xla_out_of_memory_error_is_a_result(monkeypatch):
    cfg = dict(bench_sr.CONFIGS["beyond_paper"], **SMALL_DRUGS)
    calls = []

    def steady(trainer, **kw):
        calls.append(trainer.model.config.spmm_impl)
        if trainer.model.config.spmm_impl == "xla":
            _oom()
        return {"min_ms": 1.0, "median_ms": 1.0, "window_ms": [1.0], "steps": 2}

    monkeypatch.setattr(bench_sr, "steady_ms", steady)
    out = bench_sr.run_config(**cfg, **SMALL_SIZE, device="cpu", chunk=2, windows=1)
    assert calls == ["pallas", "pallas", "xla"]
    assert out["xla"] == {"failed": "CUDA out of memory. Tried to allocate 2.50 GiB. GPU 0 has "
                                    "a total capacity of 79.19 GiB",
                          "bytes_asked": int(2.5 * 2**30)}
    assert "ms_per_step_min" in out["pallas_bf16"] and "ms_per_step_min" in out["pallas_f32"]


@pytest.mark.parametrize("impl,error", [
    ("pallas", torch.cuda.OutOfMemoryError), ("xla", RuntimeError)], ids=["pallas-oom", "xla-other"])
def test_other_errors_end_the_run(monkeypatch, impl, error):
    cfg = dict(bench_sr.CONFIGS["paper_cap"], **SMALL_DRUGS)

    def steady(trainer, **kw):
        if trainer.model.config.spmm_impl == impl:
            raise error("boom")
        return {"min_ms": 1.0, "median_ms": 1.0, "window_ms": [1.0], "steps": 2}

    monkeypatch.setattr(bench_sr, "steady_ms", steady)
    with pytest.raises(error, match="boom"):
        bench_sr.run_config(**cfg, **SMALL_SIZE, device="cpu", chunk=2, windows=1)


def test_a_failed_config_process_ends_the_script(monkeypatch, tmp_path):
    runs = []

    class Done:
        def __init__(self, rc):
            self.returncode = rc

    def fake_run(cmd, **kw):
        runs.append(cmd)
        return Done(3)

    monkeypatch.setattr(bench_sr.subprocess, "run", fake_run)
    out = tmp_path / "record.json"
    with pytest.raises(RuntimeError, match="paper_cap"):
        bench_sr.main(["--device", "cpu", "--out", str(out)])
    assert len(runs) == 1 and runs[0][-4:] == ["--out", f"{out}.paper_cap.part", "--device",
                                               "cpu"]
    assert not out.exists()


def test_summary_fields_come_from_paper_cap():
    out = {"paper_cap": {"workload": "w", "xla": {"ms_per_step_min": 30.0},
                         "pallas_bf16": {"ms_per_step_min": 12.0}}}
    bench_sr.summarize(out)
    assert out["pallas_vs_xla"] == out["paper_cap"]["pallas_vs_xla"] == 2.5
    assert (out["workload"], out["xla"], out["pallas_bf16"]) == (
        "w", {"ms_per_step_min": 30.0}, {"ms_per_step_min": 12.0})
    failed = {"paper_cap": {"workload": "w", "xla": {"failed": "oom", "bytes_asked": 1},
                            "pallas_bf16": {"ms_per_step_min": 12.0}}}
    assert bench_sr.summarize(failed)["pallas_vs_xla"] is None


def test_device_graph_moves_whole(tmp_path):
    """``DeviceGraph.to``, which phase 21 of ``chip_smoke.py`` moves its
    host-built graph to the card with: every tensor and CSR layout moves,
    nothing else changes, and a saved graph loads back equal."""
    graph, splits, _ = bench_sr.host_graph(**SMALL_DRUGS, **SMALL_SIZE)
    dg = bench_sr.sparse_device_graph(graph, splits, "cpu")
    torch.save(dg, tmp_path / "dg.pt", pickle_protocol=5)
    moved = torch.load(tmp_path / "dg.pt", weights_only=False).to("cpu")
    assert moved is not dg and moved.device == dg.device and moved.decoders == dg.decoders
    for key, a in dg.adj.items():
        b = moved.adj[key]
        for name in ("senders", "receivers", "rel", "vals"):
            assert torch.equal(getattr(b, name), getattr(a, name))
        assert _triples(b.tiles_fwd).tolist() == _triples(a.tiles_fwd).tolist()
        assert b.tiles_bwd.num_slots == a.tiles_bwd.num_slots
    for key, c in dg.neg_cdf.items():
        assert torch.equal(moved.neg_cdf[key], c)


# ---- (c) the renumbered graph's CSR against the JAX tiles -----------------

def test_renumbered_csr_holds_the_jax_tiles_edges():
    kw = dict(n_proteins=300, n_drugs=40, n_side_effects=4, min_edges_per_relation=500,
              total_drugdrug_edges=2400, ppi_attachment=37, seed=7)
    g_ref, _ = jax_renumber(jax_graph(**kw))
    s_ref = jax_split(g_ref, **bench_sr.SPLIT)
    dg_ref = jax_build(g_ref, s_ref, **bench_sr.DEVICE_GRAPH)
    graph, splits, _ = bench_sr.host_graph(40, 2400, renumber=True, **SMALL_SIZE)
    g, _ = renumber_by_degree(make_polypharmacy_like_graph(**kw))
    for et, rels in g.relations.items():
        for a, b in zip(rels, graph.relations[et]):
            np.testing.assert_array_equal(a.rows, b.rows)
    dg = bench_sr.sparse_device_graph(graph, splits, "cpu")
    assert sorted(dg.adj) == sorted(dg_ref.adj)
    for key, adj in dg.adj.items():
        ref = dg_ref.adj[key]
        assert ref.dense is None and adj.dense is None
        for direction in ("fwd", "bwd"):
            got = _triples(getattr(adj, f"tiles_{direction}"))
            want = _decode(getattr(ref, f"tiles_{direction}"))
            np.testing.assert_array_equal(got, want, err_msg=f"({key}) {direction}")


# ---- (d) the quality config's grouped chunk against the JAX package ------

QUALITY_SMALL = dict(
    n_proteins=300, n_drugs=60, n_side_effects=10, min_edges_per_relation=20,
    total_drugdrug_edges=None, ppi_attachment=5, seed=7, planted_rank=4, planted_noise=0.15,
)
HIDDEN = dict(hidden1=16, hidden2=8)
BATCH = 64
GROUP = quality_sr.TRAIN["relation_group"]
LR = quality_sr.TRAIN["learning_rate"]


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_grouped_quality_chunk_matches_reference(remat, monkeypatch):
    """Two chunks of 2 slots of 8 sub-batches, the last slot 5 valid, at
    the quality script's config (hidden and batch cut), "pallas" at
    "default" against the JAX "pallas_interpret" (K6's plain version
    against the interpret-mode TPU kernel).  Held as
    ``tests/test_torch_quality_full.py`` holds the paired config's chunk,
    with the weights a ReLU-kink unit's cotangent reaches left out."""
    model_kw = dict(quality_sr.MODEL, remat=remat, **HIDDEN)
    g_ref = jax_graph(**QUALITY_SMALL)
    s_ref = jax_split(g_ref, val_frac=0.05, test_frac=0.05, seed=quality_sr.SPLIT_SEED)
    dg_ref = jax_build(g_ref, s_ref, tile_block=64, edge_pad_multiple=256,
                       **bench_sr.DEVICE_GRAPH)
    model_ref = JaxModel(JaxConfig(**dict(model_kw, spmm_impl="pallas_interpret")), dg_ref)
    params_ref = model_ref.init_params(jax.random.PRNGKey(0), dg_ref)
    g = make_polypharmacy_like_graph(**QUALITY_SMALL)
    s = split_graph(g, val_frac=0.05, test_frac=0.05, seed=quality_sr.SPLIT_SEED)
    dg = bench_sr.sparse_device_graph(g, s, "cpu")
    model = DecagonModel(ModelConfig(**model_kw), dg)
    port = dict(params=params_from_numpy(jax.device_get(params_ref), device="cpu"), dg=dg,
                model=model)
    common = dict(quality_sr.TRAIN, batch_size=BATCH, scan_chunk=2)
    jcfg, cfg = jax_step.TrainConfig(**common), step_mod.TrainConfig(**common)
    assert (cfg.adam_moments_dtype, cfg.grad_dtype, cfg.lr_schedule) == (
        "bfloat16", "bfloat16", "constant")

    epoch = MinibatchScheduler(g, s, batch_size=BATCH, seed=0, schedule="balanced").epoch()
    batches = [next(epoch) for _ in range(3 * GROUP + 5)]
    index = {et: i for i, et in enumerate(dg.edge_types)}
    assert list(dg_ref.edge_types) == list(dg.edge_types)
    base = jax.random.PRNGKey(5)
    jopt, opt = jax_step.make_optimizer(jcfg), step_mod.make_optimizer(cfg)
    jchunk = jax_step.make_grouped_chunked_train_step(model_ref, dg_ref, jcfg, jopt)
    chunk = step_mod.make_grouped_chunked_train_step(model, dg, cfg, opt)
    jp, js = _copy_jax(params_ref), jopt.init(params_ref)
    pp, ps = port["params"], opt.init(port["params"])
    pre_acts = []
    relu = torch.relu

    def recording_relu(x):
        if x.dim() == 2 and x.shape[1] == HIDDEN["hidden1"]:
            pre_acts.append(x.detach().clone())
        return relu(x)

    steps = 0
    for c in range(2):
        part = batches[c * 2 * GROUP:(c + 1) * 2 * GROUP]
        branch = np.zeros((2, GROUP), np.int32)
        ks = np.zeros((2, GROUP), np.int32)
        rows = np.zeros((2, GROUP, BATCH), np.int32)
        cols = np.zeros((2, GROUP, BATCH), np.int32)
        valid = np.zeros((2, GROUP), bool)
        for j, b in enumerate(part):
            slot, sub = divmod(j, GROUP)
            branch[slot, sub], ks[slot, sub] = index[b.edge_type], b.k
            rows[slot, sub], cols[slot, sub], valid[slot, sub] = b.rows, b.cols, True
        step_no = np.array([2 * c, 2 * c + 1], np.int32)
        jp, js, losses_j = jchunk(
            jp, js, dg_ref, base, jnp.asarray(branch), jnp.asarray(ks), jnp.asarray(rows),
            jnp.asarray(cols), jnp.asarray(step_no), jnp.asarray(valid),
        )
        bits, neg_u = [], []
        for sn in step_no:
            rng = jax.random.fold_in(base, int(sn))
            b, _ = _jax_draws(port, rng, cfg)
            _, sample_rng = jax.random.split(rng)
            bits.append(b)
            neg_u.append([
                torch.from_numpy(np.asarray(jax.random.uniform(
                    jax.random.fold_in(sample_rng, sub), (BATCH,))))
                for sub in range(GROUP)
            ])
        monkeypatch.setattr(torch, "relu", recording_relu)
        pp, ps, losses_p = chunk(
            pp, ps, dg, 0, branch, ks, torch.from_numpy(rows), torch.from_numpy(cols),
            step_no, valid, layer_bits=bits, neg_u=neg_u,
        )
        monkeypatch.setattr(torch, "relu", relu)
        steps += 2
        np.testing.assert_allclose(losses_p.numpy(), np.asarray(losses_j), rtol=1e-4)
        assert ps["t"] == int(js["t"]) == steps
        skip = _kink_elements(pre_acts, dg, pp)
        for name, mask in skip.items():
            assert mask.sum() <= 0.01 * mask.size, f"{name}: {mask.sum()} kink-reached elements"
        _hold(pp, jax.device_get(jp),
              lambda w: 1e-6 * np.abs(w).max() + steps * LR * 2.0 ** -6, skip)
        for kind in "mv":
            _hold(ps[kind], jax.device_get(js[kind]),
                  lambda w: BF16_ULP * (np.abs(w) + np.abs(w).max()), skip)
    # remat runs each layer's forward again in the backward pass.
    assert len(pre_acts) == (2 if remat else 1) * 4 * len(dg.num_nodes)
    assert valid.sum() == GROUP + 5


# ---- (e) the K6 wrapper's int32 bound ------------------------------------

def _layout(**sizes):
    tiles = build_tiles(np.array([0, 1]), np.array([1, 0]), np.ones(2, np.float32), 2, 2)
    for name, value in sizes.items():
        setattr(tiles, name, value)
    return tiles


class _Sized:
    """A layout's counts without its tensors: what the bound reads."""

    def __init__(self, n_src=2, n_dst=2, nnz=2, num_slots=0, num_segments=0):
        self.n_src, self.n_dst, self.nnz = n_src, n_dst, nnz
        self.num_slots, self.num_segments = num_slots, num_segments


def test_k6_wrapper_bounds_its_int32_indices():
    # 2,500 drugs' drug-drug layer 1: a [1926 * 2500, 64] table (1.23 GB in
    # f32, element offsets past 2^28) is within the bound: offsets are
    # 64-bit in the kernel.
    n_src = 1926 * 2500
    assert n_src * 64 * 4 > 2**30
    spmm_pallas.check_index_range(_Sized(n_src=n_src, n_dst=2500, nnz=16_000_000,
                                         num_slots=70_000, num_segments=100_000), 64)
    for field, value in (("n_src", INT32_MAX + 1), ("n_dst", INT32_MAX + 1),
                         ("nnz", INT32_MAX + 1), ("num_slots", INT32_MAX + 1),
                         ("num_segments", (INT32_MAX - 255) // 32 + 1)):
        with pytest.raises(ValueError, match="int32"):
            spmm_pallas.check_index_range(_Sized(**{field: value}), 64)
    spmm_pallas.check_index_range(_Sized(num_segments=(INT32_MAX - 255) // 32), 64)
    with pytest.raises(ValueError, match="2\\^31"):
        build_tiles(np.array([0]), np.array([0]), np.ones(1, np.float32), INT32_MAX + 1, 1)


def test_k6_wrapper_checks_the_bound_before_it_launches(monkeypatch):
    """On a CUDA tensor the wrapper checks the layout's bound first (the
    check is reached here through a stand-in CUDA device: it raises before
    anything touches the card)."""
    tiles = _layout(n_src=INT32_MAX + 1)
    p = torch.zeros((2, 4))

    class FakeCuda:
        type = "cuda"

    class Table:
        device = FakeCuda()
        shape = (INT32_MAX + 1, 4)

        def dim(self):
            return 2

    with pytest.raises(ValueError, match="n_src"):
        spmm_pallas.spmm_tiled(Table(), tiles)
    assert torch.equal(spmm_pallas.spmm_tiled(p, _layout()), spmm_pallas.spmm_tiled_ref(p, _layout()))


# ---- the quality script on the CPU ---------------------------------------

def test_quality_script_writes_the_jax_columns_and_sidecar(tmp_path):
    args = quality_sr.parse_args(["--device", "cpu", "--epochs", "1",
                                  "--artifact-dir", str(tmp_path)])
    graph_kw = {k: v for k, v in QUALITY_SMALL.items() if k != "planted_noise"}
    out = quality_sr.run(args, graph_kw=graph_kw, model_kw=dict(quality_sr.MODEL, **HIDDEN),
                         train_kw=dict(quality_sr.TRAIN, batch_size=BATCH), log=lambda m: None)
    with open(out["csv"], newline="") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == quality_sr.COLUMNS == [
        "Epoch", "ValAUROC", "ValAUPRC", "TestAUROC", "TestAUPRC", "Seconds"]
    assert [r["Epoch"] for r in rows] == ["1"]
    assert all(0.0 <= float(rows[0][c]) <= 1.0 for c in quality_sr.COLUMNS[1:5])
    with open(out["meta"]) as f:
        meta = json.load(f)
    assert meta["graph"] == {k: QUALITY_SMALL[k] for k in (*quality_sr.GRAPH, "planted_noise")}
    assert (meta["split_seed"], meta["trainer_seed"], meta["device"]) == (8, 0, "cpu")
    assert meta["epochs"] == 1 and meta["seconds"] > 0 and meta["host_build_s"] > 0
    (t,) = meta["timing"]
    assert t["opt_steps"] == out["trainer"].opt_step > 0 and t["peak_gib"] is None
    assert set(t["train_launches"]) == set(quality_sr.KERNELS)


# ---- (f) the card artifacts ----------------------------------------------

def _nvidia(device):
    name, _, limit = device.partition(",")
    return name.strip().startswith("NVIDIA") and limit.strip().endswith("W")


def test_card_bench_record_holds_every_config_timed_through_k6():
    path = os.path.join(ART, "perf", "torch_sparse_regime_bench.json")
    assert os.path.exists(path), "missing torch_sparse_regime_bench.json"
    with open(path) as f:
        record = json.load(f)
    assert _nvidia(record["device"]), record["device"]
    assert record["torch"]
    for name, cfg in bench_sr.CONFIGS.items():
        got = record[name]
        assert got["renumbered"] == cfg.get("renumber", False)
        assert got["card_memory_gib"] > got["dd_stack_gib"] > 0
        for spec in cfg["impls"]:
            r = got[spec[0]]
            if spec[1] == "xla" and "failed" in r:
                assert r["failed"] and "bytes_asked" in r, (name, spec[0])
                continue
            assert r["ms_per_step_min"] > 0 and r["peak_gib"] > 0, (name, spec[0])
            assert r["launches_per_step"]["adam"] == 1, (name, spec[0])
            assert (r["launches_per_step"]["spmm_tiled"] > 0) == (spec[1] == "pallas"), (
                name, spec[0])
    remat = record["xla_infeasible"]
    assert remat["pallas_bf16_remat"]["peak_gib"] > 0 and remat["pallas_bf16"]["peak_gib"] > 0
    for key in ("workload", "xla", "pallas_bf16", "pallas_vs_xla"):
        assert record[key] == record["paper_cap"].get(key)


def _quality_rows():
    path = os.path.join(ART, "quality", f"{quality_sr.NAME}.csv")
    assert os.path.exists(path), f"missing {quality_sr.NAME}.csv"
    with open(path) as f:
        return list(csv.DictReader(f))


def test_card_trajectory_meets_the_jax_gate():
    """``tests/test_quality.py::test_sparse_regime_1600drugs_learns``'s
    conditions on the port's card trajectory."""
    rows = _quality_rows()
    assert len(rows) >= 2, "trajectory too short"
    assert [int(r["Epoch"]) for r in rows] == list(range(1, len(rows) + 1))
    aurocs = [float(r["TestAUROC"]) for r in rows]
    assert aurocs[0] > 0.6, "epoch-1 at chance"
    assert aurocs[-1] >= 0.75, f"final {aurocs[-1]:.4f} below 0.75"
    assert aurocs[-1] >= aurocs[0] - 0.01, "regressed"


def test_card_trajectory_provenance_matches_the_jax_sidecar():
    with open(os.path.join(ART, "quality", "poly963_1600drugs_metrics.meta.json")) as f:
        want = json.load(f)
    with open(os.path.join(ART, "quality", f"{quality_sr.NAME}.meta.json")) as f:
        got = json.load(f)
    for key in ("graph", "split_seed", "model", "train", "trainer_seed"):
        assert got[key] == want[key], key
    assert _nvidia(got["device"]), got["device"]
    assert got["epochs"] == len(_quality_rows()) == len(got["timing"])
    assert got["seconds"] > 0 and got["torch"]
    for t in got["timing"]:
        assert t["train_launches"]["spmm_tiled"] > 0 and t["eval_launches"]["sddmm"] > 0
        assert t["train_launches"]["adam"] == t["opt_steps"]
        assert not any(t[part][k] for part in ("train_launches", "eval_launches")
                       for k in ("paired_fwd", "paired_bwd"))
