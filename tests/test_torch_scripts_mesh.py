"""The mesh scripts: the port's ``decagon_tpu_torch/scripts/`` ``scaling_model``,
``multihost_sim``, ``multihost_bench``, ``multihost_overlap``,
``bench_sharded``, ``diag_sharded`` and ``hlo_collectives`` against the JAX
package's scripts of the same names.

(a) Configuration: each port's graph, split, meshes, steps, batch, learning
rate, reduction dtypes, ``comm_overlap`` flags and densify budgets equal
the JAX script's, read from its source with ``ast`` (importing most of them
would start JAX's distributed runtime or set its flags).
(b) ``scaling_model``: the JAX script (it imports no JAX), loaded by path,
and the port give equal ``ring_*`` and ``step_comm`` results for every
mesh, both designs and f32 / bf16 gradients; the port's ``project`` with
the JAX inputs equals the JAX ``project`` (only the inputs changed); the
checked-in record holds no TPU number and is what the port's records give.
(c) ``multihost_sim``: its CLI's two CPU ranks both print
``MULTIHOST_OK`` with one loss; with weights carried from the JAX package
(``models/convert.py``) the port's sharded embedding equals the JAX
single-device ``model.embeddings`` at rtol 2e-5, atol 1e-6.
(d) ``multihost_bench``: a 4-rank gloo world on a small poly graph (200
proteins, 40 drugs, 4 side effects), 3 steps: every rank has the same
trace, the (2, 2) trace equals the single process's on the same injected
draws at the JAX bound (1e-4 on every loss), the bf16 drift is finite, and
the mesh's loss at each of the single process's saved points equals the
single process's there (``--teacher``).
(e) ``multihost_overlap``: ``comm_overlap`` on and off give equal loss
heads (and equal traces).
(f) ``bench_sharded`` and ``diag_sharded``: a (1, 1) gloo world: the first
step's loss at dropout 0 equals the single process's (1e-5 of its size);
``diag_sharded``'s record holds the keys of the JAX script's printed
``res``.
(g) The inventory: on a (2, 2) mesh of 4 ranks its activation terms equal
the scaling model's formulas on the tables the step exchanges, and the
port's copy of the formulas is the JAX script's.
(h) Records: each checked-in card record holds the JAX artifact's keys (and
an entry's keys), names the card and its power limit, and shows K7 once an
optimization step in every rank and every trainer.
(i) The teacher-forced rule (``multihost_bench.judge``): on the (2, 2) mesh
at the single process's saved points it holds; the bf16 control fails its
part (b); each fault injected into the gradient reduction by the test's rank
code (``tests/torch_mesh_ranks.FAULTS``: one rank's partial of the replicated
leaves dropped, the row-axis reduce-scatter of ``gather_rows``' backward
skipped on one rank) fails it.  The card record carries the rule's verdict
for the three f32 meshes and the control.
(j) ``hlo_overlap_schedule``: its configuration is the JAX script's; in the
4-rank CPU gloo world (asynchronous there) overlap on gives the predicted
pairs (per layer, one edge sum per edge type, all but the last with compute
between, and as many row gathers, none with compute between), overlap off
none, and both the same loss; a staged call is never a pair.
"""

import ast
import importlib.util
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from decagon_tpu_torch.scripts import bench_sharded as bs
from decagon_tpu_torch.scripts import diag_sharded as ds
from decagon_tpu_torch.scripts import hlo_collectives as hc
from decagon_tpu_torch.scripts import hlo_overlap_schedule as hos
from decagon_tpu_torch.scripts import multihost_bench as mb
from decagon_tpu_torch.scripts import multihost_overlap as mo
from decagon_tpu_torch.scripts import multihost_sim as ms
from decagon_tpu_torch.scripts import scaling_model as sm
from tests import torch_mesh_ranks as ranks
from tests.test_torch_scripts_profile import _calls, _kw, _one, _tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERF = os.path.join(ROOT, "artifacts", "perf")
POLY = dict(n_proteins=200, n_drugs=40, n_side_effects=4, seed=7, planted_rank=4)
STEPS, BATCH = 3, 64


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _artifact(name):
    with open(os.path.join(PERF, name)) as f:
        return json.load(f)


def _value(node):
    """A constant expression's value (literals and arithmetic, ``2**20``)."""
    return eval(compile(ast.Expression(node), "<ast>", "eval"), {"__builtins__": {}})


def _assigned(tree, name):
    """The value a module-level ``name = ...`` (or ``a, name = ...``)
    assigns."""
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        (target,) = node.targets
        if getattr(target, "id", None) == name:
            return _value(node.value)
        if isinstance(target, ast.Tuple):
            names = [getattr(e, "id", None) for e in target.elts]
            if name in names:
                return _value(node.value)[names.index(name)]
    raise KeyError(name)


def _defaults(tree, fn):
    (f,) = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == fn]
    return [ast.literal_eval(d) for d in f.args.defaults]


def _literal_dicts(tree, first_key):
    return [ast.literal_eval(n) for n in ast.walk(tree) if isinstance(n, ast.Dict)
            and n.keys and isinstance(n.keys[0], ast.Constant) and n.keys[0].value == first_key]


# ---- (a) configuration ---------------------------------------------------

def test_scaling_model_config():
    tree = _tree("scaling_model")
    for name in ("N_PROT", "N_DRUG", "H1", "H2", "K_DD", "DEC_BYTES", "F32"):
        assert _assigned(tree, name) == getattr(sm, name), name
    (meshes,) = [ast.literal_eval(n.value) for n in ast.walk(tree) if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "meshes"]
    assert meshes == sm.MESHES


def test_multihost_sim_config():
    tree = _tree("multihost_sim")
    assert _one(tree, "make_synthetic_graph") == ms.GRAPH
    assert _one(tree, "split_graph") == ms.SPLIT
    assert _one(tree, "build_device_graph") == ms.DEVICE_GRAPH
    assert _one(tree, "ModelConfig") == ms.MODEL
    train = _one(tree, "TrainConfig")
    assert train.pop("batch_size") == "batch" and "batch = 16" in ast.unparse(tree)
    assert dict(train, batch_size=16) == ms.TRAIN
    assert _one(tree, "assert_allclose") == {"rtol": ms.RTOL, "atol": ms.ATOL}
    assert "reshape(nproc, 1)" in ast.unparse(tree)


def _poly_world(tree, module, split_seed):
    assert _one(tree, "make_polypharmacy_like_graph") == module.GRAPH
    assert _one(tree, "split_graph") == dict(val_frac=0.05, test_frac=0.05, seed=split_seed)


def test_multihost_bench_config():
    tree = _tree("multihost_bench")
    _poly_world(tree, mb, 8)
    assert mb.SPLIT["seed"] == 8
    assert _one(tree, "ModelConfig") == mb.MODEL
    train = _one(tree, "TrainConfig")
    assert train.pop("grad_reduce_dtype") == "dtype" and train == mb.TRAIN
    assert _assigned(tree, "STEPS") == mb.STEPS
    (configs,) = _literal_dicts(tree, "1proc_4dev_2x2")
    assert {k: tuple(v) for k, v in configs.items()} == mb.CONFIGS
    assert "< 0.0001" in ast.unparse(tree) and mb.EXACT_TOL == 1e-4
    assert _kw(_calls(tree, "make_sharded_train_step")[0]) == {"shard_weights": True}
    assert "rng.integers(0, len(train), 512)" in ast.unparse(tree)


def test_multihost_overlap_config():
    tree = _tree("multihost_overlap")
    _poly_world(tree, mb, 8)
    assert _one(tree, "ModelConfig") == mb.MODEL
    train = _one(tree, "TrainConfig")
    assert train.pop("comm_overlap") == "bool(overlap)" and train == mb.TRAIN
    assert _assigned(tree, "STEPS") == mo.STEPS
    assert f"reshape{mo.SHAPE}" in ast.unparse(tree).replace(" ", "").replace(",)", ")") or \
        "reshape(2, 1)" in ast.unparse(tree)
    assert mo.SHAPE == (2, 1)
    assert "overlap=True" in ast.unparse(tree) and "overlap=False" in ast.unparse(tree)


def test_bench_sharded_config():
    tree = _tree("bench_sharded")
    graphs = [_kw(c) for c in _calls(tree, "make_polypharmacy_like_graph")]
    assert sorted(graphs, key=len) == [bs.GRAPH, bs.PAPER]
    assert all(_kw(c) == bs.SPLIT for c in _calls(tree, "split_graph"))
    devs = sorted((_kw(c) for c in _calls(tree, "build_device_graph")), key=len)
    assert devs == [dict(densify_max_cells=bs.DENSIFY, build_fused=False),
                    dict(densify_max_cells=bs.FULL_DENSIFY, dense_dtype="jnp.bfloat16",
                         build_fused=False)]
    sharded = sorted((_kw(c) for c in _calls(tree, "build_sharded_device_graph")), key=len)
    assert sharded == [dict(densify_max_cells_per_device=bs.DENSIFY),
                       dict(densify_max_cells_per_device=bs.FULL_DENSIFY,
                            dense_dtype="jnp.bfloat16")]
    trains = [_kw(c) for c in _calls(tree, "TrainConfig")]
    assert all(dict(t, scan_chunk=0) == dict(bs.TRAIN, scan_chunk=0) for t in trains)
    assert {t.get("scan_chunk") for t in trains} == {None, bs.CHUNK}
    assert _defaults(tree, "pipelined_ms") == list(bs.TIMING["pipelined"])
    assert _defaults(tree, "synced_ms") == list(bs.TIMING["synced"])
    assert _defaults(tree, "chunked_ms") == list(bs.TIMING["chunked"])
    assert f"n_chunks={bs.FULL_CHUNKS}" in ast.unparse(tree)
    assert str(bs.CPU_SHAPES) in ast.unparse(tree)
    assert all(_kw(c) == {"spmm_impl": "auto"} for c in _calls(tree, "ModelConfig"))


def test_diag_sharded_config():
    tree = _tree("diag_sharded")
    assert _one(tree, "make_polypharmacy_like_graph") == bs.GRAPH
    assert _one(tree, "split_graph") == bs.SPLIT
    assert _one(tree, "build_device_graph") == dict(densify_max_cells=bs.DENSIFY,
                                                     build_fused=False)
    assert _one(tree, "TrainConfig") == bs.TRAIN
    (f,) = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "timeit"]
    assert [d.value for d in f.args.kw_defaults] == [ds.N, ds.WARMUP]


def test_hlo_collectives_config():
    tree = _tree("hlo_collectives")
    _poly_world(tree, mb, 8)
    assert _one(tree, "ModelConfig") == mb.MODEL
    assert _one(tree, "TrainConfig") == mb.TRAIN
    assert "[(1, 8), (2, 4), (4, 2)]" in ast.unparse(tree) and hc.MESHES == [(1, 8), (2, 4),
                                                                             (4, 2)]
    assert _kw(_calls(tree, "make_sharded_train_step")[0]) == {"shard_weights": True}


def test_hlo_overlap_schedule_config():
    tree = _tree("hlo_overlap_schedule")
    assert _one(tree, "make_polypharmacy_like_graph") == hos.GRAPH
    assert _one(tree, "split_graph") == hos.SPLIT
    assert _one(tree, "ModelConfig") == hos.MODEL
    train = _one(tree, "TrainConfig")
    assert train.pop("comm_overlap") == "overlap" and train == {"batch_size": hos.BATCH}
    assert _kw(_calls(tree, "make_sharded_train_step")[0]) == {"shard_weights": True}
    assert f"reshape{hos.SHAPE}".replace(" ", "") in ast.unparse(tree).replace(" ", "")
    assert "analyze(True)" in ast.unparse(tree) and "analyze(False)" in ast.unparse(tree)
    assert "make_sharded_train_step(model, (1, 1)" in ast.unparse(tree)


# ---- (b) the scaling model -------------------------------------------------

@pytest.fixture(scope="module")
def jax_scaling():
    spec = importlib.util.spec_from_file_location(
        "jax_scaling_model", os.path.join(ROOT, "scripts", "scaling_model.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_overlap():
    """The measured overlap the JAX ``project`` applies (a constant in its
    body)."""
    (node,) = [n for n in ast.walk(_tree("scaling_model")) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "MEASURED_ACT_OVERLAP"]
    return ast.literal_eval(node.value)


def test_scaling_model_formulas_equal_the_jax_script(jax_scaling):
    for size in (0, 1, 4096, 333 * 2**20, 10**9 + 7):
        for n in (1, 2, 3, 4, 8, 32):
            assert sm.ring_allreduce_bytes(size, n) == jax_scaling.ring_allreduce_bytes(size, n)
            assert sm.ring_allgather_bytes(size, n) == jax_scaling.ring_allgather_bytes(size, n)
    inputs = dict(t1_ms=jax_scaling.T1_MS, param_bytes=jax_scaling.PARAM_BYTES_TOTAL,
                  act_overlap=_jax_overlap(), edge_gbps=jax_scaling.ICI_GBPS,
                  row_gbps=jax_scaling.DCN_GBPS)
    for nr, ne in sm.MESHES + [(1, 1), (4, 1)]:
        for sw in (False, True):
            for el in (4, 2):
                assert sm.step_comm(nr, ne, sw, el, jax_scaling.PARAM_BYTES_TOTAL) == \
                    jax_scaling.step_comm(nr, ne, sw, el)
                for dcn in (False, True):
                    assert sm.project(nr, ne, sw, dcn, el, **inputs) == \
                        jax_scaling.project(nr, ne, sw, dcn, el)


def test_scaling_model_record_holds_no_tpu_number_and_is_reproduced(jax_scaling):
    rec = _artifact("torch_scaling_model.json")
    jax_rec = _artifact("scaling_model.json")
    assert set(jax_rec) <= set(rec) and set(jax_rec["assumptions"]) <= set(rec["assumptions"])
    assert set(rec["meshes"]) == set(jax_rec["meshes"])
    for key, entry in jax_rec["meshes"].items():
        for design, fields in entry.items():
            assert set(fields) <= set(rec["meshes"][key][design])
    tpu = {jax_scaling.ICI_GBPS, jax_scaling.DCN_GBPS, jax_scaling.T1_MS, _jax_overlap()}
    numbers = []

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (int, float)) and not isinstance(x, bool):
            numbers.append(x)

    walk(rec)
    assert not tpu & set(numbers)
    probe = _artifact("torch_adam_probe.json")
    assert rec["assumptions"]["t1_ms"] == probe["step_adam_fused_ms"]
    assert rec["device"] == probe["device"] and "NVIDIA" in rec["device"] and "W" in rec["device"]
    assert rec["t1_launches_per_step"] == {"adam": 1.0}
    assert sm.scaling_model() == rec


def test_scaling_model_without_a_step_record_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="probe_adam"):
        sm.scaling_model(adam_probe=str(tmp_path / "none.json"))
    out = sm.scaling_model(overlap=str(tmp_path / "none.json"))
    assert out["assumptions"]["measured_act_overlap"] is None
    assert "does not exist" in out["assumptions"]["measured_act_overlap_reason"]
    assert out["meshes"]["2x4"]["weight_sharded"]["t_step_measured_overlap_ms"] is None


@pytest.mark.parametrize("backend, cards, applied", [
    ("gloo", 1, False), ("nccl", 1, False), ("nccl", 4, True), (None, None, False)])
def test_scaling_model_applies_an_overlap_only_from_nccl_across_cards(tmp_path, backend, cards,
                                                                     applied):
    rec = _artifact("torch_multihost_overlap.json")
    rec["derived"]["overlap_factor"] = 0.25
    for key, value in (("backend", backend), ("cards", cards)):
        rec["config"].pop(key, None)
        if value is not None:
            rec["config"][key] = value
    path = tmp_path / "overlap.json"
    path.write_text(json.dumps(rec))
    out = sm.scaling_model(overlap=str(path))
    got = out["assumptions"]["measured_act_overlap"]
    entry = out["meshes"]["2x4"]["weight_sharded"]
    if applied:
        assert got == 0.25 and out["assumptions"]["measured_act_overlap_reason"] is None
        assert entry["t_step_measured_overlap_ms"] <= entry["t_step_grad_overlap_ms"]
    else:
        reason = out["assumptions"]["measured_act_overlap_reason"]
        assert got is None and "not NCCL across cards" in reason
        assert entry["t_step_measured_overlap_ms"] is None


# ---- the worlds -----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_sim():
    """The JAX single-device forward of ``multihost_sim``'s configuration,
    with its weights."""
    from decagon_tpu.graph.device import build_device_graph
    from decagon_tpu.graph.split import split_graph
    from decagon_tpu.graph.synthetic import make_synthetic_graph
    from decagon_tpu.models.model import DecagonModel, ModelConfig

    graph = make_synthetic_graph(**ms.GRAPH)
    splits = split_graph(graph, **ms.SPLIT)
    dg = build_device_graph(graph, splits, **ms.DEVICE_GRAPH)
    model = DecagonModel(ModelConfig(**ms.MODEL), dg)
    params = model.init_params(jax.random.PRNGKey(0), dg)
    want = model.embeddings(params, dg, deterministic=True)
    return jax.device_get(params), {k: np.asarray(v) for k, v in want.items()}


@pytest.fixture(scope="module")
def world2(jax_sim):
    return ranks.run_world(ranks.mesh_scripts_world2, 2, jax_sim[0], POLY, STEPS, BATCH,
                           env={"LOCAL_WORLD_SIZE": "1"})


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The 4-rank world, after the single process's trace with its
    parameters saved at every step (``single``)."""
    tmp = str(tmp_path_factory.mktemp("teacher"))
    single = mb.single_trace(STEPS, "cpu", POLY, batch_size=BATCH, save_dir=tmp)
    out = ranks.run_world(ranks.mesh_scripts_world4, 4, POLY, STEPS, BATCH, tmp)
    out["single"] = single
    return out


# ---- (c) multihost_sim ------------------------------------------------------

def test_multihost_sim_cli_prints_ok_on_both_ranks(capsys):
    results = ms.main(["--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("MULTIHOST_OK")]
    assert sorted(lines) == [f"MULTIHOST_OK pid={r} loss={results[0]['loss']:.5f}"
                             for r in (0, 1)]
    assert results[0]["loss"] == results[1]["loss"] and math.isfinite(results[0]["loss"])
    assert all(r["emb_max_abs_err"] < 1e-5 for r in results.values())


def test_multihost_sim_in_a_world_and_with_jax_weights(world2, jax_sim):
    assert world2[0]["sim"]["line"].startswith("MULTIHOST_OK pid=0")
    assert world2[1]["sim"]["line"].startswith("MULTIHOST_OK pid=1")
    assert world2[0]["sim"]["loss"] == world2[1]["sim"]["loss"]
    for r in (0, 1):
        for key, want in jax_sim[1].items():
            np.testing.assert_allclose(world2[r]["sim_carried"][key], want, rtol=ms.RTOL,
                                       atol=ms.ATOL)


# ---- (d) multihost_bench ----------------------------------------------------

def test_multihost_bench_ranks_agree_and_equal_the_single_process(world4):
    f32 = mb.summarize({r: world4[r]["float32"] for r in range(4)})
    bf16 = mb.summarize({r: world4[r]["bfloat16"] for r in range(4)})
    single = mb.summarize({0: world4["single"]})
    out = {"configs": {"1proc_4dev_2x2": single, "4proc_2x2": f32, "4proc_2x2_bf16": bf16}}
    mb.derive(out)
    assert len(f32["losses"]) == STEPS and all(map(math.isfinite, f32["losses"]))
    assert out["cross_process_equals_single_process"] is True
    assert out["max_abs_vs_single_process"]["4proc_2x2"] < mb.EXACT_TOL
    drift = out["bf16_reduce_drift"]
    assert math.isfinite(drift["max_abs"]) and math.isfinite(drift["final_rel"])
    # The bf16 row reduction really rounds: its trace is not the f32 one.
    assert bf16["losses"][0] == f32["losses"][0] and bf16["losses"] != f32["losses"]


def test_multihost_bench_mesh_at_the_single_process_points(world4):
    """``teacher_forced``: at each saved point of the single process's
    trajectory the (2, 2) mesh's loss equals the single process's, its
    reduced gradients equal the single process's to f32 rounding (1.4e-6 of
    the worst leaf's largest magnitude here), and its update lands within
    1% of the single step's largest change of each leaf (2.8e-3 here: an
    Adam update divides by the gradient's own size, so an element whose
    gradient is rounding noise moves by a share of ``lr`` either way); the
    mesh's update of the single process's own gradients lands on its next
    point."""
    entry = mb.teacher_entry(world4["single"]["losses"],
                             {r: world4[r]["teacher"] for r in range(4)})
    assert len(entry["mesh_losses"]) == STEPS
    assert entry["max_abs"] < mb.EXACT_TOL
    assert len(entry["grads_by_step"]) == len(entry["params_by_step"]) == STEPS
    assert entry["grads_worst"]["rel"] < 1e-5, entry["grads_worst"]
    assert entry["params_worst"]["rel"] < 1e-2, entry["params_worst"]
    assert entry["params_worst"]["max_abs"] > 0 and entry["grads_worst"]["leaf"]
    # The mesh's update of the single process's gradients: its next point,
    # bit for bit since the single process saves on one CPU thread (a unit
    # in the parameters' last place, 1.5e-5 of the step's change, before).
    assert entry["update_only_worst"]["rel"] < 1e-4, entry["update_only_worst"]


def test_multihost_bench_ranks_disagreeing_raise():
    results = {0: {"losses": [1.0, 2.0]}, 1: {"losses": [1.0, 2.5]}}
    with pytest.raises(AssertionError, match="disagree"):
        mb.summarize(results)


# ---- (e) multihost_overlap --------------------------------------------------

def test_overlap_on_and_off_give_equal_loss_heads(world2):
    on = mo.entry({r: world2[r]["overlap_True"] for r in (0, 1)})
    off = mo.entry({r: world2[r]["overlap_False"] for r in (0, 1)})
    assert on["loss_head"] == off["loss_head"] and len(on["loss_head"]) == 3
    assert world2[0]["overlap_True"]["losses"] == world2[0]["overlap_False"]["losses"]
    out = {"overlap_on": on, "overlap_off": dict(off, steady_ms_per_step=2.0),
           "inprocess_2dev": dict(on, steady_ms_per_step=1.0)}
    out["overlap_on"]["steady_ms_per_step"] = 1.5
    mo.derive(out)
    assert out["derived"]["overlap_factor"] == 0.5 and out["on_off_loss_head_equal"]


# ---- (f) bench_sharded and diag_sharded --------------------------------------

TINY = {"pipelined": (2, 1), "synced": (2, 1), "chunked": (2, 1)}


def test_bench_sharded_first_step_equals_the_single_process():
    graph = dict(n_proteins=200, n_drugs=40, n_side_effects=4, seed=7)
    rec = bs.bench("cpu", graph_kw=graph, model_kw={"dropout": 0.0}, timing=TINY,
                   shapes=[(1, 1)], log=lambda msg: None)
    loss = rec["first_step_loss"]
    assert abs(loss["sharded_1x1"] - loss["single"]) <= 1e-5 * abs(loss["single"])
    jax_keys = ("single_ms_per_step", "single_ms_per_step_synced", "single_chunk16_ms_per_step",
                "sharded_1x1_ms_per_step", "sharded_1x1_vs_single",
                "sharded_1x1_ms_per_step_synced", "sharded_1x1_chunk16_ms_per_step",
                "sharded_1x1_chunk16_vs_single")
    assert all(math.isfinite(rec[k]) for k in jax_keys)


def _diag_printed_keys():
    tree = _tree("diag_sharded")
    keys = {"backend"}
    for n in ast.walk(tree):
        if isinstance(n, ast.Subscript) and getattr(n.value, "id", None) == "res" and \
                isinstance(n.slice, ast.Constant):
            keys.add(n.slice.value)
    return keys | {"single_cost", "sharded_cost"}


def test_diag_sharded_record_holds_the_printed_keys():
    import torch.distributed as dist

    rec = ds.diag("cpu", graph_kw=dict(n_proteins=200, n_drugs=40, n_side_effects=4, seed=7),
                  n=1, warmup=1)
    assert not dist.is_initialized()
    assert _diag_printed_keys() <= set(rec)
    for key in ("single_cost", "sharded_cost"):
        assert {"flops", "bytes accessed", "transcendentals"} <= set(rec[key])
        assert rec[key]["flops"] > 0 and rec[key]["bytes accessed"] is None


# ---- (g) the inventory --------------------------------------------------------

def test_inventory_activation_terms_equal_the_formulas(world4):
    entry = hc.mesh_entry(2, 2, {r: world4[r]["inventory"] for r in range(4)})
    counted, want = entry["counted_wire_mib"], entry["model_wire_prediction_per_edge_type"]
    assert counted["act_edge_mib"] == want["act_edge_mib"] > 0
    assert counted["act_row_mib"] == want["act_row_mib"] > 0
    assert counted["grad_mesh_mib"] == entry["model_wire_prediction"]["grad_mesh_mib"]
    assert counted["grad_row_mib"] >= entry["model_wire_prediction"]["grad_row_mib"] > 0
    kinds = entry["hlo_collectives"]
    assert set(kinds) == {"all-reduce", "all-gather", "reduce-scatter"}
    assert entry["hlo_total_tensor_mib"] == round(
        sum(k["tensor_bytes"] for k in kinds.values()) / 2**20, 3)


def test_inventory_formulas_are_the_jax_scripts():
    """``ring_*_wire`` and ``model_prediction``, taken from the JAX script's
    source (it starts JAX's CPU devices when imported), equal the port's."""
    tree = _tree("hlo_collectives")
    names = ("ring_allreduce_wire", "ring_allgather_wire", "model_prediction")
    ns = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in names:
            exec(compile(ast.Module([node], []), "hlo_collectives", "exec"), ns)
    for nr, ne in hc.MESHES + [(1, 1), (2, 2)]:
        args = (nr, ne, 2000, 400, 64, 32, 3_000_000, 70_000)
        assert hc.model_prediction(*args) == ns["model_prediction"](*args)
    assert hc.ring_allreduce_wire(1000, 4) == ns["ring_allreduce_wire"](1000, 4)
    assert hc.ring_allgather_wire(1000, 4) == ns["ring_allgather_wire"](1000, 4)


# ---- (h) the checked-in card records -----------------------------------------

def _on_card(rec):
    assert "NVIDIA" in rec["device"] and rec["device"].rstrip().endswith("W"), rec["device"]


def test_card_multihost_bench_record():
    rec = _artifact("torch_multihost_bench.json")
    jax_rec = _artifact("multihost_bench.json")
    assert set(jax_rec) <= set(rec) and set(jax_rec["configs"]) == set(rec["configs"])
    for tag, entry in jax_rec["configs"].items():
        assert set(entry) <= set(rec["configs"][tag])
        assert all(a == 1.0 for a in rec["configs"][tag]["adam_launches_per_step"]), tag
        assert len(rec["configs"][tag]["losses"]) == len(entry["losses"])
    assert len(rec["configs"]["4proc_2x2"]["adam_launches_per_step"]) == 4
    _on_card(rec)


def test_card_multihost_overlap_record():
    rec = _artifact("torch_multihost_overlap.json")
    jax_rec = _artifact("multihost_overlap.json")
    assert set(jax_rec) <= set(rec)
    for key in ("overlap_on", "overlap_off", "inprocess_2dev", "derived", "config"):
        assert set(jax_rec[key]) <= set(rec[key]), key
    for key in ("overlap_on", "overlap_off", "inprocess_2dev"):
        assert all(a == 1.0 for a in rec[key]["adam_launches_per_step"]), key
    assert rec["overlap_on"]["loss_head"] == rec["overlap_off"]["loss_head"]
    assert "nccl_two_ranks_one_card" in rec
    _on_card(rec)


def test_card_sharded_bench_record():
    rec = _artifact("torch_sharded_bench_cuda.json")
    jax_rec = _artifact("sharded_bench_tpu.json")
    assert set(jax_rec) - {"fullscale_963rel"} <= set(rec)
    assert set(jax_rec["fullscale_963rel"]) <= set(rec["fullscale_963rel"])
    for name, launches in rec["launches_per_step"].items():
        assert launches.get("adam") == 1.0, name
    full = rec["fullscale_963rel"]
    assert full["single_launches_per_step"]["adam"] == 1.0
    assert full["sharded_launches_per_step"]["adam"] == 1.0
    loss = rec["first_step_loss"]
    assert loss["max_abs_diff"] <= 1e-4 * abs(loss["single"])
    _on_card(rec)
    _on_card(full)


def test_card_hlo_collectives_record():
    rec = _artifact("torch_hlo_collectives.json")
    jax_rec = _artifact("hlo_collectives.json")
    assert set(jax_rec) <= set(rec) and set(jax_rec["meshes"]) == set(rec["meshes"])
    for key, entry in jax_rec["meshes"].items():
        got = rec["meshes"][key]
        assert set(entry) <= set(got)
        assert set(entry["model_wire_prediction"]) <= set(got["model_wire_prediction"])
        for t in ("act_edge_mib", "act_row_mib"):
            assert got["counted_wire_mib"][t] == got["model_wire_prediction_per_edge_type"][t]
        assert got["adam_launches_per_step"] == [1] * 8
    _on_card(rec)


def test_card_diag_sharded_record():
    rec = _artifact("torch_diag_sharded.json")
    assert _diag_printed_keys() <= set(rec)
    for name, launches in rec["launches_per_call"].items():
        assert launches.get("adam", 0.0) == (1.0 if name.endswith("_step") else 0.0), name
    for key in ("single_cost", "sharded_cost"):
        assert rec[key]["device_busy_ms"] > 0 and rec[key]["kernels"] > 0
    _on_card(rec)


def test_card_multihost_bench_record_judges_the_rule():
    rec = _artifact("torch_multihost_bench.json")
    rule = rec["teacher_forced_rule"]
    assert set(rule["meshes"]) == {"4proc_2x2", "4proc_4x1", "4proc_1x4"}
    limits = {"a_loss_abs": mb.RULE_LOSS_ABS, "b_grads_rel": mb.RULE_GRADS_REL,
              "c_update_only_rel": mb.RULE_UPDATE_ONLY_REL}
    for verdict in list(rule["meshes"].values()) + list(rule["control"].values()):
        assert {k: verdict[k]["limit"] for k in limits} == limits
        assert verdict["holds"] == all(verdict[k]["holds"] for k in limits)
    assert set(rule["control"]) == {"4proc_2x2_bf16"}
    assert rule["control_rejected"] is not rule["control"]["4proc_2x2_bf16"]["holds"]
    assert rule["holds_on_every_f32_mesh"] == all(m["holds"] for m in rule["meshes"].values())
    # The trace's verdicts keep their keys, meaning and bound.
    assert isinstance(rec["cross_process_equals_single_process"], bool)
    assert rec["cross_process_equals_single_process"] == (
        rec["max_abs_vs_single_process"]["4proc_2x2"] < mb.EXACT_TOL == 1e-4)


def test_card_hlo_overlap_schedule_record():
    rec = _artifact("torch_hlo_overlap_schedule.json")
    jax_rec = _artifact("hlo_overlap_schedule.json")
    assert {"config", "note"} <= set(jax_rec) <= set(rec) | {"finding"}
    keys = {"async_collective_pairs", "pairs_with_compute_between",
            "total_compute_ops_inside_spans", "by_kind", "ops_issued_in_step"}
    assert set(rec["worlds"]) == {"gloo_cuda_4x2", "gloo_cpu_4x2", "nccl_cuda_1x1"}
    for key in ("overlap_on", "overlap_off"):
        assert keys <= set(rec[key])
        for tag, w in rec["worlds"].items():
            assert keys <= set(w[key]), tag
            # K7 on the card; a world of CPU ranks launches no kernel.
            assert w[key]["launches"] == ({"adam": 1} if "cuda" in tag else {}), tag
            ranks = w["mesh"][0] * w["mesh"][1]
            assert w[key]["adam_launches_per_rank"] == [int("cuda" in tag)] * ranks, tag
            assert w[key]["async_never_waited"] == {}, tag
    for tag, w in rec["worlds"].items():
        assert w["on_off_loss_equal"], tag
        assert w["overlap_off"]["async_collective_pairs"] == 0, tag
    staged = rec["worlds"]["gloo_cuda_4x2"]
    assert staged["overlap_on"]["async_collective_pairs"] == 0
    assert rec["worlds"]["nccl_cuda_1x1"]["overlap_on"]["async_collective_pairs"] > 0
    assert rec["counted_by"] == hos.COUNTED_BY
    _on_card(rec)


# ---- (i) the teacher-forced rule ----------------------------------------------

def _teacher(world4, key):
    return mb.teacher_entry(world4["single"]["losses"], {r: world4[r][key] for r in range(4)})


def test_rule_holds_on_the_f32_mesh(world4):
    verdict = mb.judge(_teacher(world4, "teacher"))
    assert verdict["holds"], verdict
    assert verdict["c_update_only_rel"]["worst"] == 0.0


def test_rule_rejects_the_bf16_control(world4):
    verdict = mb.judge(_teacher(world4, "teacher_bf16"))
    assert not verdict["b_grads_rel"]["holds"] and not verdict["holds"], verdict
    # A bf16 sum rounds at 2^-9 of the value: far beyond the rule's 1e-5.
    assert verdict["b_grads_rel"]["worst"] > 100 * mb.RULE_GRADS_REL
    record = mb.rule_record({"4proc_2x2": _teacher(world4, "teacher"),
                             "4proc_2x2_bf16": _teacher(world4, "teacher_bf16")})
    assert record["holds_on_every_f32_mesh"] and record["control_rejected"]


@pytest.mark.parametrize("fault", sorted(ranks.FAULTS))
def test_rule_rejects_an_injected_reduction_fault(world4, fault):
    verdict = mb.judge(_teacher(world4, f"teacher_{fault}"))
    assert not verdict["holds"], verdict
    assert not verdict["b_grads_rel"]["holds"], verdict


# ---- (j) hlo_overlap_schedule ---------------------------------------------------

def test_overlap_schedule_gives_the_predicted_pairs(world4):
    on, off = (hos.variant({r: world4[r]["schedule"][o] for r in range(4)}) for o in (True, False))
    n_types = len(on["edge_types"])
    assert n_types == 4
    # Per layer: an edge sum per edge type, all but the last with compute
    # between, and as many row gathers, none with compute between.
    assert on["async_collective_pairs"] == 2 * 2 * n_types
    assert on["by_kind"] == {"all-reduce": 2 * n_types, "all-gather": 2 * n_types}
    assert on["pairs_with_compute_between"] == 2 * (n_types - 1)
    sums = [s for s in on["spans"] if s["kind"] == "all-reduce"]
    assert [s["ops_between"] > 0 for s in sums] == ([True] * (n_types - 1) + [False]) * 2
    assert all(s["group"] == "edge" for s in sums)
    assert all(s["ops_between"] == 0 for s in on["spans"] if s["kind"] == "all-gather")
    assert on["total_compute_ops_inside_spans"] >= 18
    assert off["async_collective_pairs"] == 0 and off["by_kind"] == {}
    assert on["loss"] == off["loss"] and math.isfinite(on["loss"])
    assert on["ops_issued_in_step"] == off["ops_issued_in_step"] > 0
    # Every start of every rank is ended by a wait (``variant`` raises
    # otherwise); a CPU rank launches no kernel.
    assert on["adam_launches_per_rank"] == [0] * 4 == off["adam_launches_per_rank"]


def test_staged_and_synchronous_calls_are_no_pairs():
    calls = [
        {"kind": "all-reduce", "group": "edge", "async": True, "issued_at": 2, "waited_at": 5},
        {"kind": "all-gather", "group": "row", "async": False, "issued_at": 5},
        {"kind": "all-reduce", "group": "edge", "async": True, "issued_at": 7},
    ]
    out = hos.schedule(calls)
    assert out["async_collective_pairs"] == 1 and out["total_compute_ops_inside_spans"] == 3
    assert out["synchronous_collectives"] == {"all-gather": 1}
    # An asynchronous start that no wait ended is no pair, and is reported.
    assert out["async_never_waited"] == {"all-reduce": 1}


def test_a_start_left_unwaited_fails_the_world():
    ok = {"loss": 1.0, "async_never_waited": {}, "launches": {"adam": 1}}
    assert hos.variant({0: ok, 1: ok})["adam_launches_per_rank"] == [1, 1]
    with pytest.raises(RuntimeError, match="rank"):
        hos.variant({0: ok, 1: dict(ok, async_never_waited={"all-gather": 1})})
