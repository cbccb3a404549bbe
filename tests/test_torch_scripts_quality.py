"""The dummy config's quality tools and the schedule ablation: the port's
``decagon_tpu_torch/scripts/`` ``quality_ablation``, ``quality_probe``,
``oracle_ceiling`` and ``schedule_ablation`` against the JAX package's
scripts of the same names.

(a) Configuration: each script's graph, split, device graph, model,
training settings and variants equal the JAX script's, read from its
source with ``ast`` (``schedule_ablation.py`` sets the JAX compilation
cache when imported).
(b) Each script needs the card unless told ``--device cpu``
(``oracle_ceiling`` is numpy on the host and takes no device).
(c) A small CPU run of each writes a record that holds the JAX record's
fields (``artifacts/quality/*.json``; ``quality_probe`` prints only: its
printed fields).
(d) Parity: ``ceiling_for`` on a small planted graph equals the JAX
function's (sklearn's scores) to 1e-6, and the checked-in paper-scale
``torch_oracle_ceiling.json`` equals ``oracle_ceiling.json`` in every
number to 1e-5.
(e) The checked-in card records name the card, hold the JAX fields and
carry K7's launches on every trainer and K5's on every evaluation.
"""

import ast
import functools
import importlib.util
import inspect
import json
import os

import pytest
import torch

from decagon_tpu_torch.scripts import oracle_ceiling as oracle
from decagon_tpu_torch.scripts import quality_ablation as ablation
from decagon_tpu_torch.scripts import quality_probe as probe
from decagon_tpu_torch.scripts import schedule_ablation as schedule
from tests.test_torch_scripts_profile import _calls, _kw, _one, _tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUALITY = os.path.join(ROOT, "artifacts", "quality")
DUMMY = dict(n_genes=60, n_drugs=40, n_drugdrug_types=2, seed=0)
POLY = dict(n_proteins=200, n_drugs=40, n_side_effects=4, seed=7, planted_rank=4)
PLANTED = dict(n_proteins=200, n_drugs=40, n_side_effects=4, min_edges_per_relation=20,
               total_drugdrug_edges=800, ppi_attachment=5, seed=7, planted_rank=4)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _assigned(tree, name):
    """The value assigned to ``name``: a literal, or ``dict(...)`` calls of
    literals."""
    (node,) = [n for n in ast.walk(tree) if isinstance(n, ast.Assign)
               and any(getattr(t, "id", None) == name for t in n.targets)]
    return eval(compile(ast.Expression(node.value), name, "eval"),
                {"__builtins__": {}, "dict": dict})


def _json(name):
    with open(os.path.join(QUALITY, f"{name}.json")) as f:
        return json.load(f)


# ---- (a) configuration ---------------------------------------------------

def test_quality_ablation_config():
    tree = _tree("quality_ablation")
    assert _one(tree, "make_synthetic_graph") == ablation.GRAPH
    split = _one(tree, "split_graph")
    assert split.pop("seed") == "seed + 1" and split == ablation.SPLIT
    assert _one(tree, "build_device_graph") == ablation.DEVICE_GRAPH
    assert _one(tree, "ModelConfig") == ablation.MODEL
    (train,) = [c for c in _calls(tree, "dict") if "batch_size" in _kw(c)]
    assert _kw(train) == ablation.TRAIN
    assert (_assigned(tree, "VARIANTS")) == ablation.VARIANTS
    (run,) = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "run_variant"]
    defaults = dict(zip([a.arg for a in run.args.args[-3:]],
                        [ast.literal_eval(d) for d in run.args.defaults]))
    assert defaults == {"max_epochs": ablation.MAX_EPOCHS, "eval_every": ablation.EVAL_EVERY,
                        "seed": 0}
    assert _one(tree, "Trainer") == {"seed": "seed"}


def test_quality_probe_config():
    tree = _tree("quality_probe")
    assert _one(tree, "make_synthetic_graph") == probe.GRAPH
    assert _one(tree, "split_graph")["seed"] == probe.SPLIT_SEED
    assert _one(tree, "build_device_graph") == probe.DEVICE_GRAPH
    assert (_assigned(tree, "variants")) == probe.VARIANTS
    train = _one(tree, "TrainConfig")
    assert (train["batch_size"], train["scan_chunk"], train["num_epochs"]) == (512, 50, 1)
    model = _one(tree, "ModelConfig")
    assert (model["hidden1"], model["hidden2"]) == (64, 32) and "spmm_impl" not in model
    assert f"% {probe.EVAL_EVERY} == 0" in ast.unparse(tree)
    jax_run = _load("quality_probe").run
    port_run = probe.run
    want = {k: p.default for k, p in inspect.signature(jax_run).parameters.items()}
    got = {k: p.default for k, p in inspect.signature(port_run).parameters.items()}
    assert {k: got[k] for k in want} == want


def test_oracle_ceiling_config():
    tree = _tree("oracle_ceiling")
    graph = _one(tree, "make_polypharmacy_like_graph")
    assert (graph.pop("planted_out"), graph.pop("planted_noise")) == ("planted", "noise")
    assert graph == oracle.GRAPH
    assert _one(tree, "split_graph") == oracle.SPLIT
    src = ast.unparse(tree)
    assert f"noises = {oracle.NOISES}" in src
    (note,) = [n for n in ast.walk(tree) if isinstance(n, ast.Assign)
               and ast.unparse(n.targets[0]) == "out['note']"]
    assert ast.literal_eval(note.value) == oracle.NOTE


def test_schedule_ablation_config():
    tree = _tree("schedule_ablation")
    assert _one(tree, "make_polypharmacy_like_graph") == schedule.GRAPH
    assert _one(tree, "split_graph") == schedule.SPLIT
    assert _one(tree, "build_device_graph") == schedule.DEVICE_GRAPH
    assert _one(tree, "ModelConfig") == schedule.MODEL
    train = _one(tree, "TrainConfig")
    assert train.pop(None) == "kw" and train == schedule.TRAIN
    assert (_assigned(tree, "CONFIGS")) == schedule.CONFIGS
    assert _one(tree, "Trainer") == {"seed": 0}
    (epochs,) = [c for c in _calls(tree, "add_argument") if c.args[0].value == "--epochs"]
    assert _kw(epochs)["default"] == schedule.EPOCHS


# ---- (b) the card ------------------------------------------------------------

@pytest.mark.parametrize("main,args", [
    (ablation.main, ["base"]), (probe.main, ["refproto"]), (schedule.main, []),
], ids=["quality_ablation", "quality_probe", "schedule_ablation"])
def test_scripts_need_the_card_unless_told_otherwise(main, args, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(args + ["--out", str(tmp_path / "record.json")])
    assert not os.listdir(tmp_path)


def test_oracle_ceiling_runs_on_the_host(tmp_path, monkeypatch):
    """Numpy only: no card is asked for, and the record is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(oracle, "GRAPH", PLANTED)
    out = str(tmp_path / "ceiling.json")
    oracle.main(["0.15", "--out", out])
    with open(out) as f:
        rec = json.load(f)
    assert set(rec) >= {"noise_0.15", "note"}
    for tag in ("val", "test"):
        assert set(rec["noise_0.15"][tag]) == {"oracle_auroc", "oracle_auprc", "n_scored"}


# ---- (c) small records ---------------------------------------------------

KEPT = {"best_test_auroc": 0.5, "test_auroc_at_50": 0.5, "test_auroc_at_100": 0.5}


def test_quality_ablation_small_record_merges_and_holds_the_jax_fields(tmp_path, monkeypatch):
    monkeypatch.setattr(ablation, "run_variant", functools.partial(
        ablation.run_variant, max_epochs=2, eval_every=1, graph_kw=DUMMY,
        log=lambda m: None))
    out = str(tmp_path / "ablation.json")
    with open(out, "w") as f:
        json.dump({"xent": KEPT}, f)
    ablation.main(["base", "lazy_adam", "--device", "cpu", "--out", out])
    with open(out) as f:
        rec = json.load(f)
    assert rec["xent"] == KEPT
    jax_rec = _json("ablation")
    for name in ("base", "lazy_adam"):
        entry = rec[name]
        assert set(jax_rec[name]) <= set(entry)
        assert [t["epoch"] for t in entry["trajectory"]] == [1, 2]
        assert set(entry["trajectory"][0]) == set(jax_rec[name]["trajectory"][0])
        assert entry["best_test_auroc"] == max(t["test_auroc"] for t in entry["trajectory"])
        assert entry["device"] == "cpu" and entry["config"]["split"]["seed"] == 1
    assert rec["lazy_adam"]["config"]["train"]["lazy_decoder_adam"] is True


def test_quality_probe_small_record_holds_the_printed_fields(tmp_path, monkeypatch):
    monkeypatch.setattr(probe, "GRAPH", DUMMY)
    monkeypatch.setattr(probe, "VARIANTS", dict(probe.VARIANTS,
                                                refproto=dict(probe.VARIANTS["refproto"],
                                                              epochs=2)))
    out = str(tmp_path / "probe.json")
    probe.main(["refproto", "--device", "cpu", "--out", out])
    with open(out) as f:
        rec = json.load(f)
    (row,) = rec["refproto"]["evaluations"]
    # The JAX script prints val auroc, test auroc and auprc at each evaluation.
    assert {"epoch", "val_auroc", "test_auroc", "test_auprc", "seconds"} <= set(row)
    assert row["epoch"] == 2 and rec["refproto"]["config"]["val_frac"] == 0.05
    assert rec["refproto"]["device"] == "cpu"


def test_schedule_ablation_small_record_holds_the_jax_fields(tmp_path, monkeypatch):
    monkeypatch.setattr(schedule, "GRAPH", POLY)
    out = str(tmp_path / "schedule.json")
    schedule.main(["--epochs", "1", "--configs", "ref_g1,bal_g8", "--device", "cpu",
                   "--out", out])
    with open(out) as f:
        rec = json.load(f)
    jax_rec = _json("schedule_ablation")
    for tag in ("ref_g1", "bal_g8"):
        assert set(jax_rec[tag]) <= set(rec[tag])
        assert set(rec[tag]["trajectory"][0]) == set(jax_rec[tag]["trajectory"][0])
        assert rec[tag]["batches_per_epoch"] > 0 and rec[tag]["device"] == "cpu"
    # Grouping takes 8 batches an optimization step.
    (epoch,) = rec["bal_g8"]["epochs"]
    assert epoch["opt_steps"] == -(-epoch["steps"] // 8)


# ---- (d) the oracle's parity ----------------------------------------------------

def test_ceiling_for_equals_the_jax_function(monkeypatch):
    jax_oracle = _load("oracle_ceiling")
    real = jax_oracle.make_polypharmacy_like_graph
    monkeypatch.setattr(jax_oracle, "make_polypharmacy_like_graph",
                        lambda **kw: real(**dict(kw, **PLANTED)))
    for noise in (0.3, 0.1):
        want = jax_oracle.ceiling_for(noise)
        got = oracle.ceiling_for(noise, graph_kw=PLANTED)
        assert set(got) == set(want) == {"val", "test"}
        for tag in want:
            assert got[tag]["n_scored"] == want[tag]["n_scored"] > 0
            for key in ("oracle_auroc", "oracle_auprc"):
                assert abs(got[tag][key] - want[tag][key]) <= 1e-6, (noise, tag, key)


def test_paper_scale_ceiling_equals_the_jax_record():
    want, got = _json("oracle_ceiling"), _json("torch_oracle_ceiling")
    noises = [k for k in want if k.startswith("noise_")]
    assert noises == [f"noise_{n}" for n in oracle.NOISES] and got["note"] == want["note"]
    for noise in noises:
        for tag in ("val", "test"):
            assert got[noise][tag]["n_scored"] == want[noise][tag]["n_scored"]
            for key in ("oracle_auroc", "oracle_auprc"):
                assert abs(got[noise][tag][key] - want[noise][tag][key]) <= 1e-5


# ---- (e) the card records ------------------------------------------------------

def _card(entry):
    assert "H100" in entry["device"] and entry["torch"]


def _trainers_and_evaluations(rows):
    for row in rows:
        assert row["adam_launches_per_opt_step"] == 1.0
        assert row["eval_launches"].get("sddmm", 0) > 0


def test_card_ablation_record():
    rec, jax_rec = _json("torch_ablation"), _json("ablation")
    assert sorted(rec) == sorted(ablation.VARIANTS)
    for name, entry in rec.items():
        _card(entry)
        assert set(jax_rec[name]) <= set(entry)
        assert [t["epoch"] for t in entry["trajectory"]] == list(range(10, 151, 10))
        assert entry["config"]["max_epochs"] == 150 and entry["config"]["split"]["seed"] == 1
        assert entry["config"]["train"] == dict(ablation.TRAIN, **ablation.VARIANTS[name])
        _trainers_and_evaluations(entry["evaluations"])
        tests = [t["test_auroc"] for t in entry["trajectory"]]
        assert entry["best_test_auroc"] == max(tests)
        assert entry["test_auroc_at_100"] == max(tests[:10])


@pytest.fixture(scope="module")
def jax_batches_per_epoch():
    """The JAX package's scheduler on the schedule ablation's graph, as it
    stands: batches an epoch by schedule."""
    from decagon_tpu.graph.split import split_graph as jax_split
    from decagon_tpu.graph.synthetic import make_polypharmacy_like_graph as jax_graph
    from decagon_tpu.train.sampler import MinibatchScheduler

    g = jax_graph(**schedule.GRAPH)
    s = jax_split(g, **schedule.SPLIT)
    return {name: MinibatchScheduler(g, s, batch_size=512, seed=0,
                                     schedule=name).num_batches_per_epoch()
            for name in ("reference", "balanced")}


def test_card_schedule_ablation_record(jax_batches_per_epoch):
    """Each config's epoch is the JAX package's: 3,700 reference batches
    (as the JAX record), 1,044 balanced ones.  The JAX record's 968
    balanced batches predate its package's present scheduler, which gives
    1,044 on this graph too."""
    rec, jax_rec = _json("torch_schedule_ablation"), _json("schedule_ablation")
    assert sorted(rec) == sorted(schedule.CONFIGS)
    assert jax_rec["ref_g1"]["batches_per_epoch"] == jax_batches_per_epoch["reference"]
    for tag, entry in rec.items():
        _card(entry)
        assert set(jax_rec[tag]) <= set(entry)
        want = jax_batches_per_epoch[schedule.CONFIGS[tag]["schedule"]]
        assert entry["batches_per_epoch"] == want
        assert [t["epoch"] for t in entry["trajectory"]] == list(range(1, 11))
        for epoch in entry["epochs"]:
            assert epoch["adam_launches_per_opt_step"] == 1.0
            assert epoch["eval_launches"].get("sddmm", 0) > 0


def test_card_quality_probe_record():
    rec = _json("torch_quality_probe")
    entry = rec["refproto"]
    _card(entry)
    assert [r["epoch"] for r in entry["evaluations"]] == [20, 40, 60]
    assert entry["config"]["val_frac"] == 0.05 and entry["config"]["test_frac"] == 0.0
    _trainers_and_evaluations(entry["evaluations"])
