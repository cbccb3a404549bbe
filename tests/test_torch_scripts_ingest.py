"""The public-data ingest at full size: the port's
``decagon_tpu_torch/scripts/ingest_fullsize.py`` against the JAX package's
``scripts/ingest_fullsize.py``.

(a) Configuration: the split, the device graph, the model, the training
settings, the trainer's seed and the fixture's seed equal the JAX script's,
read from its source with ``ast``.
(b) The fixture: the port's ``draws`` at ``scale=1`` equal the JAX
``synthesize``'s draws array for array (the JAX script loaded by path, its
writer replaced by one that keeps the arrays, so nothing is written), with
the same headers and formats, and the row counts of the JAX record
(``artifacts/perf/ingest_fullsize.json``).
(c) At a small scale (``SCALE``, ~10,500 combo rows): the port writes the
bytes the JAX writer writes; every CSV parses equal natively and in Python;
the port's ``load_public_dataset`` equals the JAX package's on the same
files, with relations on both sides of the 500-row filter; the first
``"xla"`` step's loss of the port's ``Trainer`` equals the JAX ``Trainer``'s
on the JAX weights (``params_from_numpy``) and the JAX step's dropout bits
and negative uniforms (``layer_bits``, ``neg_u``), to 1e-5 of the loss (the
COO sums run in another order); and ``ingest`` runs both legs at that scale.
(d) The checked-in card record holds the JAX record's fields, the fixture's
row counts, equal parses, 963 relations, 645 drugs and 19,081 proteins,
finite losses on both legs, K7 once a step, K1-K4, K5 and K5-bf16 on the
paired leg, and the card's name and power limit.
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

from decagon_tpu import native as jax_native
from decagon_tpu.data import public as jax_public
from decagon_tpu_torch import native
from decagon_tpu_torch.data import public
from decagon_tpu_torch.scripts import ingest_fullsize as ing
from tests.test_torch_data import _assert_datasets_equal
from tests.test_torch_scripts_profile import _calls, _kw, _one, _tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERF = os.path.join(ROOT, "artifacts", "perf")
SCALE = 0.002


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _artifact(name):
    with open(os.path.join(PERF, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_ingest_fullsize", os.path.join(ROOT, "scripts", "ingest_fullsize.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---- (a) configuration ---------------------------------------------------

def test_ingest_config():
    tree = _tree("ingest_fullsize")
    assert _one(tree, "split_graph") == ing.SPLIT
    assert _one(tree, "build_device_graph") == ing.DEVICE_GRAPH
    assert _one(tree, "ModelConfig") == ing.MODEL
    assert _one(tree, "TrainConfig") == ing.TRAIN
    assert _kw(_calls(tree, "Trainer")[0]) == {"seed": ing.TRAINER_SEED}
    assert f"default_rng({ing.SEED})" in ast.unparse(tree)
    assert f"len(losses) >= {ing.STEPS}" in ast.unparse(tree)
    (call,) = _calls(tree, "parse_edge_csv")
    assert ast.unparse(call.args[1]) == "3"


# ---- (b) the fixture at full size ----------------------------------------

def test_fixture_draws_equal_the_jax_synthesize(jax_script, tmp_path, monkeypatch):
    written = {}

    def keep(path, header, fmt, arrays, chunk=200_000):
        written[os.path.basename(path)] = (header, fmt, arrays)
        open(path, "w").close()

    monkeypatch.setattr(jax_script, "_write_csv", keep)
    monkeypatch.setattr(jax_script, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(jax_script, "log", lambda msg: None)
    fixture = jax_script.synthesize(np.random.default_rng(11))
    got = ing.draws(np.random.default_rng(ing.SEED), 1.0)
    for key, (name, header, fmt) in ing.FILES.items():
        want_header, want_fmt, want = written[name]
        assert (header, fmt) == (want_header, want_fmt), key
        assert len(got[key]) == len(want)
        for a, b in zip(got[key], want):
            np.testing.assert_array_equal(a, b)
    record = _artifact("ingest_fullsize.json")["fixture"]
    rows = {f"{key}_rows": len(got[key][0]) for key in ing.FILES}
    assert rows == {k: v for k, v in fixture.items() if k != "combo_bytes"}
    assert rows == {k: v for k, v in record.items() if k != "combo_bytes"}
    assert ing.counts(1.0) == dict(ing.FIXTURE, big_rows=float(ing.FIXTURE["big_rows"]))


# ---- (c) at a small scale -------------------------------------------------

@pytest.fixture(scope="module")
def small(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("ingest"))
    columns = ing.draws(np.random.default_rng(ing.SEED), SCALE)
    return columns, ing.write_fixture(columns, out_dir)


@pytest.fixture
def both_native(monkeypatch, tmp_path):
    """Both packages' native libraries on (the JAX one built in a directory
    of this test's own); restored after the test."""
    monkeypatch.setenv("DECAGON_TPU_NATIVE_CACHE", str(tmp_path))
    for module, env in ((native, native.DISABLE_ENV),
                        (jax_native, "DECAGON_TPU_DISABLE_NATIVE")):
        monkeypatch.setattr(module, "_TRIED", False)
        monkeypatch.setattr(module, "_LIB", None)
        monkeypatch.delenv(env, raising=False)
    assert native.get_library() is not None and jax_native.get_library() is not None


def test_small_fixture_writes_the_jax_bytes(small, jax_script, tmp_path):
    columns, paths = small
    for key, (name, header, fmt) in ing.FILES.items():
        want = tmp_path / name
        jax_script._write_csv(str(want), header, fmt, columns[key])
        assert open(paths[key], "rb").read() == want.read_bytes(), key


@pytest.mark.parametrize("key", sorted(ing.FILES))
def test_small_fixture_parses_equal_natively_and_in_python(small, key, monkeypatch):
    _, paths = small
    n_fields = 3 if key == "combo" else 2
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.delenv(native.DISABLE_ENV, raising=False)
    fast = native.parse_edge_csv(paths[key], n_fields)
    assert fast is not None and fast.shape[0] == len(small[0][key][0])
    monkeypatch.setenv(native.DISABLE_ENV, "1")
    monkeypatch.setattr(native, "_TRIED", False)
    np.testing.assert_array_equal(public._parse_int_csv(paths[key], n_fields), fast)


def test_small_parse_fields_toggle_the_library_and_restore_it(small, monkeypatch):
    _, paths = small
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.delenv(native.DISABLE_ENV, raising=False)
    out = ing.parse_fields(paths["combo"])
    assert out["native_vs_python_equal"] is True
    assert out["native_parse"]["rows"] == out["python_parse"]["rows"] == len(small[0]["combo"][0])
    assert native.DISABLE_ENV not in os.environ and native.get_library() is not None


def test_small_public_dataset_equals_jax(small, both_native):
    _, paths = small
    args = [paths[k] for k in ("combo", "ppi", "targets", "mono")]
    got = public.load_public_dataset(*args)
    want = jax_public.load_public_dataset(*args)
    _assert_datasets_equal(got, want)
    # The filter straddled: relations on both sides of 500 rows.
    combo = small[0]["combo"][2]
    _, rows = np.unique(combo, return_counts=True)
    kept = [r for r in got.graph.relations[(1, 1)] if not r.name.endswith("_T")]
    assert 0 < len(kept) == int((rows >= 500).sum()) < len(rows)


@pytest.fixture(scope="module")
def small_graphs(small):
    _, paths = small
    args = [paths[k] for k in ("combo", "ppi", "targets", "mono")]
    return public.load_public_dataset(*args).graph, jax_public.load_public_dataset(*args).graph


def test_first_xla_step_equals_the_jax_trainer(small_graphs):
    from decagon_tpu.graph.device import build_device_graph as jax_build
    from decagon_tpu.graph.split import split_graph as jax_split
    from decagon_tpu.models.model import DecagonModel as JaxModel
    from decagon_tpu.models.model import ModelConfig as JaxConfig
    from decagon_tpu.train.step import TrainConfig as JaxTrainConfig
    from decagon_tpu.train.trainer import Trainer as JaxTrainer
    from decagon_tpu_torch.graph.device import build_device_graph
    from decagon_tpu_torch.graph.split import split_graph
    from decagon_tpu_torch.models.convert import params_from_numpy
    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
    from decagon_tpu_torch.train.step import TrainConfig, step_generator
    from decagon_tpu_torch.train.trainer import Trainer
    from tests.test_torch_train import _jax_draws

    graph, g_ref = small_graphs
    s_ref = jax_split(g_ref, **ing.SPLIT)
    dg_ref = jax_build(g_ref, s_ref, **ing.DEVICE_GRAPH)
    jt = JaxTrainer(JaxModel(JaxConfig(**ing.MODEL), dg_ref), g_ref, s_ref, dg_ref,
                    JaxTrainConfig(**ing.TRAIN), seed=ing.TRAINER_SEED)
    params0 = jax.device_get(jt.params)
    batch = next(iter(jt.scheduler.epoch()))
    want = float(jt.train_batch(batch))

    splits = split_graph(graph, **ing.SPLIT)
    dg = build_device_graph(graph, splits, device="cpu", **ing.DEVICE_GRAPH)
    model = DecagonModel(ModelConfig(**ing.MODEL), dg)
    cfg = TrainConfig(**ing.TRAIN)
    trainer = Trainer(model, graph, splits, dg, cfg, seed=ing.TRAINER_SEED)
    params = params_from_numpy(params0, device="cpu")
    bits, u = _jax_draws(dict(params=params, dg=dg, model=model),
                         jax.random.fold_in(jt.step_rng, 0), cfg)
    _, _, loss = trainer.steps[batch.edge_type](
        params, trainer.opt_state, dg, int(batch.k),
        torch.from_numpy(np.asarray(batch.rows)), torch.from_numpy(np.asarray(batch.cols)),
        step_generator(trainer.step_seed, 0, dg.device), layer_bits=bits, neg_u=u)
    assert math.isfinite(want) and abs(float(loss) - want) <= 1e-5 * abs(want), (float(loss), want)


def test_ingest_runs_both_legs_at_a_small_scale():
    out = ing.ingest("cpu", SCALE, log=lambda msg: None)
    assert out["native_vs_python_equal"] and out["losses_finite"]
    assert out["fixture"]["combo_rows"] == out["native_parse"]["rows"]
    assert out["relations_after_filter"] == 3 and out["n_drugs"] == 150
    assert out["paired"]["forms"]["1,1"] == "paired" and out["paired"]["losses_finite"]
    assert 0.0 <= out["paired"]["eval"]["auroc"] <= 1.0
    assert 0.0 <= out["paired"]["eval_bf16_tables"]["auroc"] <= 1.0
    assert len(out["xla_steps"]["losses"]) == ing.STEPS
    # Off the card no kernel launches.
    assert out["xla_steps"]["launches"] == {} == out["paired"]["launches"]


# ---- (d) the card record --------------------------------------------------

def test_card_ingest_record():
    rec = _artifact("torch_ingest_fullsize.json")
    jax_rec = _artifact("ingest_fullsize.json")
    assert set(jax_rec) <= set(rec)
    for key in ("fixture", "native_parse", "python_parse"):
        assert set(jax_rec[key]) <= set(rec[key]), key
    assert {k: v for k, v in rec["fixture"].items() if k != "combo_bytes"} == \
        {k: v for k, v in jax_rec["fixture"].items() if k != "combo_bytes"}
    assert rec["native_vs_python_equal"] is True and rec["scale"] == 1.0
    assert rec["native_parse"]["rows"] == rec["python_parse"]["rows"] == 4_943_515
    assert (rec["relations_after_filter"], rec["n_drugs"], rec["n_proteins"]) == (963, 645, 19081)
    assert rec["losses_finite"] and rec["paired"]["losses_finite"]
    assert rec["two_train_steps_device"] == "cuda"
    assert rec["xla_steps"]["launches"] == {"adam": ing.STEPS}
    paired = rec["paired"]["launches"]
    assert paired["adam"] == ing.STEPS and paired["paired_fwd"] > 0 and paired["paired_bwd"] > 0
    assert rec["paired"]["eval"]["launches"].get("sddmm", 0) > 0
    assert rec["paired"]["eval_bf16_tables"]["launches"].get("sddmm_bf16", 0) > 0
    assert rec["paired"]["forms"]["1,1"] == "paired"
    assert "NVIDIA" in rec["device"] and rec["device"].rstrip().endswith("W"), rec["device"]
