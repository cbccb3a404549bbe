"""The converged quality runs: the port's
``decagon_tpu_torch/scripts/quality_run.py`` against ``scripts/quality_run.py``.

(a) Configuration: the port's configs, split, device graph, model, training
and plateau settings equal the JAX script's (read from its source with
``ast`` and from its ``train_to_plateau``'s signature; the JAX script is
loaded by path: it sets no compilation cache).
(b) The plateau rule: both packages' ``train_to_plateau`` run on the same
small graph with the ``Trainer`` stubbed and an evaluator that returns one
scripted sequence of metrics; they stop at the same epoch and write the
same rows, bar ``Seconds``.
(c) A real run at a small size on the CPU: the CSV's columns and the
sidecar's fields.
(d) The checked-in card trajectories (seed 0 of both configs, and the
dummy config's seeds 1-7): each sidecar names the card and says
why the run stopped, the CSV's validation column reproduces that stop, K7
launched once a step and K5 in every evaluation; the 50-relation run ends
at a final test AUROC of at least the JAX gate's 0.74.  The dummy run does
not: it reached its plateau at epoch 140 at 0.71098 (its validation AUROC
above the JAX run's at every one of its 28 evaluations, on the same edges),
and ``quality_run.py``'s own assertion of the gate failed on the card; no
test here claims that gate for it.
(e) The CPU seed runs of ``tests/torch_quality_seeds.py`` (the JAX
reference's dummy config over eight seeds, and its 50-relation graph for
10 epochs): each record's rows, stops and summary agree; the harness runs either package at
a small size and merges a run into its record by seed.
"""

import ast
import csv
import importlib.util
import inspect
import json
import os

import pytest
import torch

from decagon_tpu_torch.scripts import quality_run as port_q

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(ROOT, "scripts", "quality_run.py")
ART = os.path.join(ROOT, "artifacts", "quality")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_q():
    spec = importlib.util.spec_from_file_location("_jax_quality_run", JAX_SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tree():
    with open(JAX_SCRIPT) as f:
        return ast.parse(f.read())


def _calls(tree, name):
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)
            and (getattr(n.func, "id", None) == name or getattr(n.func, "attr", None) == name)]


def _kwargs(call):
    return {k.arg: ast.unparse(k.value) for k in call.keywords}


def _literals(call):
    out = {}
    for k, text in _kwargs(call).items():
        try:
            out[k] = ast.literal_eval(text)
        except ValueError:
            out[k] = text
    return out


# ---- (a) configuration ---------------------------------------------------

def test_configs_equal_the_jax_script(jax_q):
    tree = _tree()
    (dummy,) = _calls(tree, "make_synthetic_graph")
    assert _literals(dummy) == port_q.CONFIGS["dummy"]["graph_kw"]
    (poly,) = _calls(tree, "make_polypharmacy_like_graph")
    assert _literals(poly) == port_q.CONFIGS["poly50"]["graph_kw"]
    runs = {ast.literal_eval(c.args[0]): _literals(c)["max_epochs"]
            for c in _calls(tree, "train_to_plateau")}
    assert runs == {name: cfg["max_epochs"] for name, cfg in port_q.CONFIGS.items()}
    (split,) = _calls(tree, "split_graph")
    assert _kwargs(split) == {"val_frac": str(port_q.VAL_FRAC), "test_frac": "test_frac",
                              "seed": "seed + 1"}
    (build,) = _calls(tree, "build_device_graph")
    kw = _literals(build)
    assert kw.pop("tile_for_pallas") == "on_accel"
    assert kw == port_q.DEVICE_GRAPH
    (model,) = _calls(tree, "ModelConfig")
    assert _literals(model) == port_q.MODEL
    (train,) = _calls(tree, "TrainConfig")
    assert _literals(train) == port_q.TRAIN
    (header,) = [c for c in _calls(tree, "writerow") if isinstance(c.args[0], ast.List)
                 and all(isinstance(e, ast.Constant) for e in c.args[0].elts)]
    assert ast.literal_eval(header.args[0]) == port_q.COLUMNS
    gates = {ast.literal_eval(n.comparators[0]) for n in ast.walk(tree)
             if isinstance(n, ast.Compare) and isinstance(n.ops[0], ast.GtE)
             and isinstance(n.comparators[0], ast.Constant)}
    assert gates == {port_q.GATE}
    want = inspect.signature(jax_q.train_to_plateau).parameters
    got = inspect.signature(port_q.train_to_plateau).parameters
    for name, p in want.items():
        assert got[name].default == p.default, name


def test_the_run_needs_the_card_unless_told_otherwise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_q.main(["dummy", "--artifact-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("seed,tag", [(0, "dummy"), (4, "dummy_seed4")])
def test_a_seed_keeps_its_own_files(seed, tag, monkeypatch):
    """Seeds run side by side into one directory write files of their own
    (``torch_dummy_seed4_metrics.*``); seed 0 keeps the JAX script's name."""
    class Metrics:
        auroc = auprc = apk = 0.9

    tags = []
    monkeypatch.setattr(port_q, "make_graph", lambda name: None)
    monkeypatch.setattr(port_q, "train_to_plateau",
                        lambda t, graph, **kw: tags.append((t, kw["seed"]))
                        or (f"torch_{t}_metrics.csv", (1, Metrics, Metrics)))
    port_q.run("dummy", device="cpu", seed=seed)
    assert tags == [(tag, seed)]


# ---- (b) the plateau rule --------------------------------------------------

# Scripted validation AUROCs, one an evaluation (the test AUROC follows
# them): a rise then a plateau; a rise to the last epoch; rises smaller
# than min_delta.
SEQUENCES = {
    "plateau": [0.60, 0.65, 0.70, 0.72, 0.7205, 0.719, 0.71, 0.72, 0.7209, 0.7, 0.71, 0.715,
                0.72, 0.69, 0.7],
    "rising": [0.5 + 0.01 * i for i in range(30)],
    "small_rises": [0.7 + 0.0009 * i for i in range(30)],
}


class _Trainer:
    def __init__(self, *args, **kwargs):
        self.params, self.global_step = {}, 0

    def train(self, num_epochs=None):
        self.global_step += 3


def _evaluator(values, scores_cls):
    """An evaluator class whose pooled evaluations return ``values`` in
    turn: each evaluation's validation, then its test scores."""
    state = {"i": 0}

    class Evaluator:
        def __init__(self, *args, **kwargs):
            pass

        def embeddings(self, params, dg):
            return {}

        def evaluate_all_drug_drug(self, params, dg, use_test=False, embeddings=None):
            v = values[state["i"] // 2]
            state["i"] += 1
            base = v - 0.02 if use_test else v
            return scores_cls(auroc=base, auprc=base - 0.05, apk=base / 2)

    return Evaluator


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_plateau_rule_matches_the_jax_script(name, jax_q, tmp_path, monkeypatch):
    from decagon_tpu.graph.synthetic import make_synthetic_graph as jax_graph
    from decagon_tpu.train.evaluate import AccuracyScores as JaxScores
    from decagon_tpu_torch.train.evaluate import AccuracyScores

    values = SEQUENCES[name]
    kw = dict(n_genes=60, n_drugs=40, n_drugdrug_types=2, seed=0)
    max_epochs = 5 * len(values)
    monkeypatch.setattr(jax_q, "Trainer", _Trainer)
    monkeypatch.setattr(jax_q, "AccuracyEvaluator", _evaluator(values, JaxScores))
    monkeypatch.setattr(jax_q, "ART_DIR", str(tmp_path / "jax"))
    want_path, want = jax_q.train_to_plateau("seq", jax_graph(**kw), max_epochs=max_epochs)
    monkeypatch.setattr(port_q, "Trainer", _Trainer)
    monkeypatch.setattr(port_q, "AccuracyEvaluator", _evaluator(values, AccuracyScores))
    got_path, got = port_q.train_to_plateau(
        "seq", port_q.make_synthetic_graph(**kw), max_epochs=max_epochs, device="cpu",
        artifact_dir=str(tmp_path / "port"))
    assert os.path.basename(want_path) == "seq_metrics.csv"
    assert os.path.basename(got_path) == "torch_seq_metrics.csv"
    assert got[0] == want[0]
    want_rows, got_rows = _rows(want_path), _rows(got_path)
    assert len(got_rows) == len(want_rows) > 1
    for a, b in zip(got_rows, want_rows):
        assert {k: v for k, v in a.items() if k != "Seconds"} == {
            k: v for k, v in b.items() if k != "Seconds"}
    with open(got_path.replace(".csv", ".meta.json")) as f:
        meta = json.load(f)
    assert meta["epochs"] == got[0] == int(got_rows[-1]["Epoch"])
    assert meta["stopped"].startswith("plateau" if got[0] < max_epochs else "max_epochs")
    if name == "plateau":
        assert got[0] < max_epochs


# ---- (c) a small real run ------------------------------------------------------

def test_a_small_run_writes_the_jax_columns_and_the_sidecar(tmp_path):
    graph = port_q.make_synthetic_graph(n_genes=60, n_drugs=40, n_drugdrug_types=2, seed=0)
    path, (epoch, val, test) = port_q.train_to_plateau(
        "small", graph, max_epochs=2, eval_every=1, device="cpu", artifact_dir=str(tmp_path))
    rows = _rows(path)
    assert list(rows[0]) == port_q.COLUMNS and [r["Epoch"] for r in rows] == ["1", "2"]
    assert epoch == 2 and 0.0 <= test.auroc <= 1.0
    with open(path.replace(".csv", ".meta.json")) as f:
        meta = json.load(f)
    assert meta["stopped"] == "max_epochs (2) reached before a plateau"
    assert meta["config"]["model"] == port_q.MODEL and meta["device"] == "cpu"
    assert set(meta["aggregation"]) == {"0,0", "0,1", "1,0", "1,1"}
    assert len(meta["evaluations"]) == 2
    for e in meta["evaluations"]:
        assert e["steps"] > 0 and e["ms_per_step"] > 0 and e["eval_s"] > 0


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_the_seed_harness_runs_either_package_at_a_small_size(package):
    from tests import torch_quality_seeds as seeds

    run = seeds.run_seed(0, package=package, config="dummy", max_epochs=2, eval_every=1,
                         graph_kw=dict(n_genes=60, n_drugs=40, n_drugdrug_types=2, seed=0),
                         threads=1)
    assert [r["Epoch"] for r in run["rows"]] == [1.0, 2.0]
    assert list(run["rows"][0]) == port_q.COLUMNS
    assert run["stopped"] == "max_epochs reached" and run["epochs"] == 2
    assert run["final_test_auroc"] == pytest.approx(run["rows"][-1]["TestAUROC"], abs=1e-5)
    assert run["meets_gate"] == (run["final_test_auroc"] >= port_q.GATE)


def _seed_run(seed, final):
    return dict(seed=seed, rows=[], epochs=1, stopped="max_epochs reached",
                final_test_auroc=final, meets_gate=final >= port_q.GATE, seconds=1.0)


def test_the_seed_harness_merges_by_seed(tmp_path):
    """A seed run again replaces its own entry, the others stay, runs are
    in seed order and the summary is over all of them; a record of other
    settings is refused."""
    from tests import torch_quality_seeds as seeds

    config = dict(package="jax", config="dummy", graph=seeds.GRAPHS["dummy"], max_epochs=200,
                  gate=port_q.GATE, threads=2, script="s")
    path = str(tmp_path / "seeds.json")
    first = seeds.merge_record(dict(config=config, runs=[_seed_run(2, 0.70), _seed_run(0, 0.80)]),
                               path)
    assert [r["seed"] for r in first["runs"]] == [0, 2]
    with open(path, "w") as f:
        json.dump(first, f)
    merged = seeds.merge_record(
        dict(config=dict(config, threads=1), runs=[_seed_run(5, 0.76), _seed_run(2, 0.72)]), path)
    assert [(r["seed"], r["final_test_auroc"]) for r in merged["runs"]] == [
        (0, 0.80), (2, 0.72), (5, 0.76)]
    assert merged["final_test_auroc"] == dict(min=0.72, max=0.80, mean=pytest.approx(0.76),
                                              meeting_gate=2, seeds=3)
    with pytest.raises(ValueError, match="max_epochs"):
        seeds.merge_record(dict(config=dict(config, max_epochs=10), runs=[_seed_run(1, 0.7)]),
                           path)


def test_the_gate_rule_over_eight_seeds():
    """``--rule`` over the checked-in records of seeds 0-7: each seed's
    validation AUROC at epoch 100 (or the last epoch both packages
    evaluated), and the two parts' statistics, computed here again with
    numpy."""
    import numpy as np

    from tests import torch_quality_seeds as seeds

    rule = seeds.gate_rule(range(8))
    table = rule["table"]
    assert [r["seed"] for r in table] == list(range(8))
    for r in table:
        assert r["epoch"] <= 100 and (r["epoch"] == 100 or r["epoch"] == min(r["port_stop"],
                                                                              r["jax_stop"]))
        assert r["val_diff"] == pytest.approx(r["val_port"] - r["val_jax"])
    d = np.array([r["val_diff"] for r in table])
    a = rule["a_validation"]
    assert a["mean_diff"] == pytest.approx(d.mean())
    assert a["se"] == pytest.approx(d.std(ddof=1) / np.sqrt(8))
    assert a["holds"] == (abs(d.mean()) <= 2 * a["se"])
    p = np.array([r["test_port"] for r in table])
    j = np.array([r["test_jax"] for r in table])
    b = rule["b_final_test"]
    assert b["diff"] == pytest.approx(p.mean() - j.mean())
    assert b["se_welch"] == pytest.approx(np.sqrt(p.var(ddof=1) / 8 + j.var(ddof=1) / 8))
    assert b["holds"] == (abs(b["diff"]) <= 2 * b["se_welch"])
    assert (b["meeting_gate_port"], b["meeting_gate_jax"]) == (int((p >= port_q.GATE).sum()),
                                                               int((j >= port_q.GATE).sum()))
    assert rule["verdict"] == ("not a fault" if a["holds"] and b["holds"] else
                               "fault" if not a["holds"] else "open")


# ---- (d) the card trajectories ---------------------------------------------------

def _plateau_stop(rows, min_delta, patience):
    """The epoch at which the plateau rule stops a run with these rows, or
    None."""
    best, since = -1.0, 0
    for r in rows:
        v = float(r["ValAUROC"])
        if v > best + min_delta:
            best, since = v, 0
        else:
            since += 1
            if since >= patience:
                return int(float(r["Epoch"]))
    return None


def _card(tag):
    rows = _rows(os.path.join(ART, f"torch_{tag}_metrics.csv"))
    with open(os.path.join(ART, f"torch_{tag}_metrics.meta.json")) as f:
        return rows, json.load(f)


@pytest.mark.parametrize("tag", list(port_q.CONFIGS) + [f"dummy_seed{n}" for n in range(1, 8)])
def test_card_trajectories_are_whole(tag):
    rows, meta = _card(tag)
    name, _, seed = tag.partition("_seed")
    assert list(rows[0]) == port_q.COLUMNS
    assert "H100" in meta["device"] and meta["config"]["model"] == port_q.MODEL
    assert meta["config"]["train"] == port_q.TRAIN
    assert meta["config"]["max_epochs"] == port_q.CONFIGS[name]["max_epochs"]
    assert meta["config"]["seed"] == int(seed or 0)
    assert meta["config"]["split_seed"] == meta["config"]["seed"] + 1
    assert meta["epochs"] == int(rows[-1]["Epoch"]) and len(meta["evaluations"]) == len(rows)
    # The plateau rule over the CSV's validation column stops where the run did.
    stop = _plateau_stop(rows, meta["config"]["min_delta"], meta["config"]["patience"])
    if meta["stopped"].startswith("plateau"):
        assert stop == meta["epochs"]
    else:
        assert stop is None and meta["stopped"].startswith(("max_epochs", "wall budget"))
    for e in meta["evaluations"]:
        assert e["adam_launches_per_step"] == 1.0 and e["eval_launches"]["sddmm"] > 0


def test_poly50_card_trajectory_meets_the_jax_gate():
    rows, _ = _card("poly50")
    assert float(rows[-1]["TestAUROC"]) >= port_q.GATE


# ---- (e) the CPU seed runs ----------------------------------------------------

@pytest.mark.parametrize("name", ["jax_cpu_dummy_seeds", "jax_cpu_poly50_seeds"])
def test_cpu_seed_records_are_whole(name):
    """``tests/torch_quality_seeds.py``'s records: each seed's rows end where
    the plateau rule or the epoch limit stopped it, at its final test
    AUROC, and the summary is the runs'."""
    with open(os.path.join(ART, f"{name}.json")) as f:
        rec = json.load(f)
    assert rec["platform"] == "cpu" and rec["config"]["gate"] == port_q.GATE
    for run in rec["runs"]:
        rows = run["rows"]
        assert list(rows[0]) == port_q.COLUMNS and run["epochs"] == int(rows[-1]["Epoch"])
        assert run["final_test_auroc"] == pytest.approx(rows[-1]["TestAUROC"], abs=1e-5)
        assert run["meets_gate"] == (run["final_test_auroc"] >= port_q.GATE)
        stop = _plateau_stop(rows, 0.001, 8)
        if run["stopped"].startswith("plateau"):
            assert stop == run["epochs"]
        else:
            assert stop is None and run["epochs"] == rec["config"]["max_epochs"]
    finals = [run["final_test_auroc"] for run in rec["runs"]]
    summary = rec["final_test_auroc"]
    assert (summary["min"], summary["max"], summary["seeds"]) == (min(finals), max(finals),
                                                                  len(finals))
    assert summary["meeting_gate"] == sum(run["meets_gate"] for run in rec["runs"])
