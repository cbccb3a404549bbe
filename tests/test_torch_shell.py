"""The port's framework shell against the JAX package's: config, registry,
active learners, the numpy predictor, the checkpoint export, the
evaluator's per-relation scorer and the CLI.

The learners' masks and holdouts are numpy draws and must be equal bit
for bit; so must the CLI's held-out-edge CSV, row for row.  The predictor
is numpy on both sides (the port's metrics without sklearn), held to
1e-9.  Model outputs (the export's arrays, the evaluator's
probabilities) come from JAX parameters carried across with
``params_from_numpy`` and are held to ``rtol=atol=1e-4``, the tolerance of
``tests/test_torch_slice.py`` (same cast points, f32 sums in another
order), with the JAX package's accelerator dispatch (``jax.default_backend``
patched), which the port takes on every device.  The CLI runs on
``Device=cpu`` at the JAX shell test's size (60 proteins, 30 drugs, one
side effect, hidden 8/4, one epoch).
"""

import csv
import dataclasses
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from decagon_tpu import cli as jax_cli
from decagon_tpu import registry as jax_registry
from decagon_tpu.config import Config as JaxConfig
from decagon_tpu.graph.device import build_device_graph as jax_build
from decagon_tpu.graph.split import split_graph as jax_split
from decagon_tpu.graph.synthetic import make_polypharmacy_like_graph as jax_poly
from decagon_tpu.graph.synthetic import make_synthetic_graph as jax_synthetic
from decagon_tpu.models.model import DecagonModel as JaxModel
from decagon_tpu.models.model import ModelConfig as JaxModelConfig
from decagon_tpu.predict import predictor as jax_predictor
from decagon_tpu.train import active as jax_active
from decagon_tpu.train.checkpoint import export_ndarrays as jax_export_ndarrays
from decagon_tpu.train.evaluate import AccuracyEvaluator as JaxEvaluator
from decagon_tpu.train.step import make_eval_scores as jax_eval_scores
from decagon_tpu_torch import cli, registry
from decagon_tpu_torch.config import Config
from decagon_tpu_torch.data.record import write_heldout_edges_csv
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph, make_synthetic_graph
from decagon_tpu_torch.models.convert import params_from_numpy
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.predict import predictor
from decagon_tpu_torch.predict.export import export_from_checkpoint
from decagon_tpu_torch.predict.export import main as export_main
from decagon_tpu_torch.train import active, layout
from decagon_tpu_torch.train.checkpoint import Checkpointer
from decagon_tpu_torch.train.evaluate import AccuracyEvaluator
from decagon_tpu_torch.train.step import make_generator

SMALL = dict(
    n_proteins=300, n_drugs=60, n_side_effects=6, min_edges_per_relation=20,
    ppi_attachment=5, seed=7,
)
HIDDEN = dict(hidden1=16, hidden2=8)
# The JAX shell test's CLI size.
CLI_CONF = {
    "DataSetType": "DecagonDummyData",
    "ActiveLearnerType": "NoopActiveLearner",
    "NumProteins": 60,
    "NumDrugs": 30,
    "NumDrugDrugRelationTypes": 1,
    "hidden1": 8,
    "hidden2": 4,
    "batch_size": 16,
    "NumEpochs": 1,
    "NumIterationsPerLog": 50,
    "ValFraction": 0.1,
    "TestFraction": 0.05,
}


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.fixture
def accelerator_dispatch(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


@pytest.fixture(scope="module")
def world():
    """The serving slice's small graph in both packages, the paired layout,
    JAX parameters and their port copy."""
    g_ref = jax_poly(**SMALL)
    s_ref = jax_split(g_ref, val_frac=0.05, test_frac=0.05, seed=1)
    dg_ref = jax_build(g_ref, s_ref, dense_factored=True, dense_paired=True, build_fused=False)
    model_ref = JaxModel(JaxModelConfig(**HIDDEN), dg_ref)
    params_ref = model_ref.init_params(jax.random.PRNGKey(0), dg_ref)
    g = make_polypharmacy_like_graph(**SMALL)
    s = split_graph(g, val_frac=0.05, test_frac=0.05, seed=1)
    dg = build_device_graph(g, s, dense_factored=True, dense_paired=True, device="cpu")
    model = DecagonModel(ModelConfig(**HIDDEN), dg)
    params = params_from_numpy(jax.device_get(params_ref), device="cpu")
    return dict(g=g_ref, s=s_ref, dg=dg_ref, model=model_ref, params=params_ref), dict(
        g=g, s=s, dg=dg, model=model, params=params
    )


# ---- config and registry ---------------------------------------------


SETTINGS = {
    "hidden1": 16, "hidden2": 8, "dropout": 0.2, "SpmmImpl": "pallas",
    "SpmmPrecision": "default", "SddmmImpl": "jnp", "Remat": True, "batch_size": 64,
    "learning_rate": 0.01, "Loss": "xent", "max_margin": 0.2, "neg_sample_size": 2,
    "neg_sample_weights": 0.5, "epochs": 3, "ScanChunk": 8, "TrainSchedule": "balanced",
    "RelationGroup": 2, "LazyDecoderAdam": True, "ShardWeights": False,
    "GradReduceDtype": "bfloat16", "AdamMomentsDtype": "bfloat16",
}


@pytest.mark.parametrize("settings", [{}, SETTINGS, {"NumEpochs": 7, "epochs": 3}],
                         ids=["defaults", "every_key", "num_epochs_first"])
def test_config_typed_views_equal_jax(settings):
    got, want = Config(settings), JaxConfig(settings)
    for view in ("model_config", "train_config"):
        a, b = getattr(got, view)(), getattr(want, view)()
        for field in dataclasses.fields(b):
            assert getattr(a, field.name) == getattr(b, field.name), (view, field.name)


def test_config_file_and_argv_equal_jax(tmp_path):
    path = tmp_path / "conf.json"
    path.write_text(json.dumps({"batch_size": 64, "hidden1": 16}))
    argv = ["--config", str(path), "--set", "learning_rate=0.01", "--set", "CustomName=foo",
            "--set", "NumEpochs=7", "--set", "Device=cpu"]
    got, want = Config.from_argv(argv), JaxConfig.from_argv(argv)
    assert got.settings == want.settings and got.overrides == want.overrides
    assert got.get("CustomName") == "foo" and got.get("missing", 1) == 1
    with pytest.raises(KeyError):
        got.get("missing")
    assert got.train_config().num_epochs == 7 and got.model_config().hidden1 == 16
    assert got.device() == torch.device("cpu")


def test_config_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="Device=cpu"):
        Config({}).device()


def test_registry_behaves_as_jax():
    assert sorted(registry.known(active.BaseActiveLearner)) == sorted(
        jax_registry.known(jax_active.BaseActiveLearner))
    graph = make_synthetic_graph(n_genes=50, n_drugs=20, seed=0, with_transposes=False)
    learner = registry.build(active.BaseActiveLearner, "NoopActiveLearner", graph=graph)
    assert isinstance(learner, active.NoopActiveLearner)
    with pytest.raises(KeyError, match="no BaseActiveLearner registered"):
        registry.build(active.BaseActiveLearner, "NotAThing")

    class FakeBase(registry.Factorizable):
        pass

    class FakeImpl(FakeBase, functionality="FakeImpl"):
        def __init__(self, x):
            self.x = x

    class NotRegistered(FakeBase):
        pass

    assert registry.build(FakeBase, "FakeImpl", x=3).x == 3
    assert list(registry.known(FakeBase)) == ["FakeImpl"]
    with pytest.raises(ValueError, match="already registered"):
        registry.register(FakeBase, "FakeImpl", NotRegistered)
    assert registry.register(FakeBase, "Other")(NotRegistered) is NotRegistered


# ---- active learners --------------------------------------------------


def _learner_graphs():
    kw = dict(n_genes=60, n_drugs=30, n_drugdrug_types=3, seed=0, with_transposes=False)
    return jax_synthetic(**kw), make_synthetic_graph(**kw)


def _assert_learners_equal(got, want):
    assert got.masks.keys() == want.masks.keys()
    for k in want.masks:
        np.testing.assert_array_equal(got.masks[k], want.masks[k])
    np.testing.assert_array_equal(got.possibilities, want.possibilities)


def _assert_updates_equal(got, want):
    (g_graph, g_hold), (w_graph, w_hold) = got, want
    assert g_hold.keys() == w_hold.keys()
    for k in w_hold:
        for tag in ("positive", "negative"):
            np.testing.assert_array_equal(g_hold[k][tag], w_hold[k][tag])
    for et in w_graph.relations:
        for a, b in zip(g_graph.relations[et], w_graph.relations[et]):
            np.testing.assert_array_equal(a.rows, b.rows)
            np.testing.assert_array_equal(a.cols, b.cols)


@pytest.mark.parametrize(
    "name,kwargs",
    [("RandomMaskingActiveLearner", {}),
     ("RelationFullMaskingLearner", {"invalid_relations": {1}})],
)
def test_masking_learners_equal_jax_at_every_iteration(name, kwargs):
    g_ref, g = _learner_graphs()
    kw = dict(test_set_proportion=0.3, init_train_proportion=0.5, seed=4, **kwargs)
    want = jax_registry.build(jax_active.BaseActiveLearner, name, graph=g_ref, **kw)
    got = registry.build(active.BaseActiveLearner, name, graph=g, **kw)
    _assert_learners_equal(got, want)
    iters = 0
    while want.has_update():
        assert got.has_update()
        _assert_updates_equal(got.get_update(), want.get_update())
        _assert_learners_equal(got, want)
        iters += 1
    assert iters == 7 and not got.has_update()


def test_noop_learner_equals_jax():
    g_ref, g = _learner_graphs()
    got, want = active.NoopActiveLearner(g), jax_active.NoopActiveLearner(g_ref)
    out, hold = got.get_update()
    assert out is g and hold == want.get_update()[1] == {}
    assert not got.has_update() and not want.has_update()


@pytest.mark.parametrize("hook", ["scorer", "batch_scorer"])
def test_greedy_learner_selects_as_jax(hook):
    """The same injected scorer (favouring high row + col, ties broken by a
    seeded jitter) selects the same cells in both packages."""
    g_ref, g = _learner_graphs()
    jitter = np.random.default_rng(0).random(30 * 30) * 1e-3

    def score(k, edges):
        return (edges[:, 0] + edges[:, 1] + k + jitter[edges[:, 0] * 30 + edges[:, 1]]).astype(
            np.float64)

    hooks = {"scorer": score} if hook == "scorer" else {
        "batch_scorer": lambda batches: [score(k, e) for k, e in batches]}
    kw = dict(test_set_proportion=0.3, init_train_proportion=0.2, seed=0, **hooks)
    want = jax_active.GreedyActiveLearner(g_ref, **kw)
    got = active.GreedyActiveLearner(g, **kw)
    for _ in range(3):
        _assert_updates_equal(got.get_update(), want.get_update())
        _assert_learners_equal(got, want)


def test_pretrained_greedy_learner_scores_as_jax(world, accelerator_dispatch, tmp_path):
    """Restored through the port's ``Checkpointer``; its scorer gives the
    JAX package's ``make_eval_scores`` probabilities, and it selects
    greedily from the first iteration."""
    ref, port = world
    Checkpointer(str(tmp_path / "ck")).save(0, {"params": port["params"]})
    base = make_polypharmacy_like_graph(**SMALL, with_transposes=False)
    template = port["model"].init_params(make_generator(5, "cpu"), port["dg"])
    learner = active.PretrainedGreedyActiveLearner(
        base, test_set_proportion=0.3, init_train_proportion=0.9, seed=0,
        checkpoint_dir=str(tmp_path / "ck"), model=port["model"],
        device_graph=port["dg"], params_template=template,
    )
    edges = np.array([[0, 1], [2, 3], [59, 7], [10, 10]], dtype=np.int32)
    for k in (0, 4):
        want = jax_eval_scores(ref["model"], (1, 1))(
            ref["params"], ref["dg"], k, edges[:, 0], edges[:, 1])
        _close(learner.scorer(k, edges), np.asarray(want))
    before = learner.possibilities.copy()
    learner.get_update()
    chosen = np.setdiff1d(
        before[:, 0] * 10**6 + before[:, 1],
        learner.possibilities[:, 0] * 10**6 + learner.possibilities[:, 1])
    assert chosen.size > 0


def test_pretrained_greedy_learner_needs_a_checkpoint(world, tmp_path):
    _, port = world
    with pytest.raises(FileNotFoundError):
        active.PretrainedGreedyActiveLearner(
            make_polypharmacy_like_graph(**SMALL, with_transposes=False),
            checkpoint_dir=str(tmp_path / "none"), model=port["model"],
            device_graph=port["dg"], params_template=port["params"],
        )


# ---- evaluator, export, predictor -----------------------------------


@pytest.mark.parametrize("key", [(1, 1, 0), (1, 1, 5), (0, 0, 0), (0, 1, 0)])
def test_evaluator_probs_equal_jax(world, accelerator_dispatch, key):
    ref, port = world
    edges = port["s"][key].val
    want = JaxEvaluator(ref["model"], ref["g"], ref["s"])._probs(
        ref["params"], ref["dg"], key, edges)
    got = AccuracyEvaluator(port["model"], port["g"], port["s"], device="cpu")._probs(
        port["params"], port["dg"], key, edges)
    assert got.shape == (edges.shape[0],) and got.dtype == np.float32
    _close(got, np.asarray(want))
    empty = AccuracyEvaluator(port["model"], port["g"], port["s"], device="cpu")._probs(
        port["params"], port["dg"], key, np.empty((0, 2), np.int32))
    assert empty.shape == (0,)


def test_export_from_checkpoint_equals_jax(world, accelerator_dispatch, tmp_path):
    ref, port = world
    names = [f"C{k:07d}" for k in range(port["dg"].adj["1,1"].num_rel)]
    Checkpointer(str(tmp_path / "ck")).save(3, {"params": port["params"]})
    template = port["model"].init_params(make_generator(9, "cpu"), port["dg"])
    export_from_checkpoint(port["model"], port["dg"], str(tmp_path / "ck"),
                           str(tmp_path / "port"), template, relation_names=names)
    emb_ref = ref["model"].embeddings(ref["params"], ref["dg"], deterministic=True)
    jax_export_ndarrays(ref["params"], emb_ref, ref["dg"], str(tmp_path / "jax"),
                        relation_names=names)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) and len(files) > 3
    for name in files:
        if name.endswith(".npz"):
            a, b = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
            assert a.files == b.files
            pairs = [(a[f], b[f]) for f in b.files]
        else:
            pairs = [(np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name))]
        for got, want in pairs:
            assert got.shape == want.shape and got.dtype == want.dtype, name
            _close(got, want)


def test_export_refuses_another_layout(world, tmp_path):
    """A paired checkpoint does not restore into a non-paired template."""
    _, port = world
    Checkpointer(str(tmp_path / "ck")).save(1, {"params": port["params"]})
    dg = build_device_graph(port["g"], port["s"], device="cpu")
    model = DecagonModel(ModelConfig(**HIDDEN), dg)
    template = model.init_params(make_generator(0, "cpu"), dg)
    with pytest.raises(ValueError, match="does not match the template"):
        export_from_checkpoint(model, dg, str(tmp_path / "ck"), str(tmp_path / "out"), template)
    with pytest.raises(FileNotFoundError):
        export_from_checkpoint(model, dg, str(tmp_path / "none"), str(tmp_path / "out"), template)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """One artifact set and held-out CSV (random tables, a real split)."""
    tmp = tmp_path_factory.mktemp("artifacts")
    g = make_synthetic_graph(n_genes=60, n_drugs=30, n_drugdrug_types=2, seed=0)
    s = split_graph(g, val_frac=0.15, test_frac=0.1, seed=1)
    rng = np.random.default_rng(2)
    np.save(tmp / "embeddings.npy", rng.normal(size=(30, 8)).astype(np.float32))
    np.save(tmp / "GlobalRelations.npy", rng.normal(size=(8, 8)).astype(np.float32))
    names = ["C0000001", "C0000002"]
    for name in names:
        np.save(tmp / f"EmbeddingImportance-{name}.npy",
                np.diag(rng.normal(size=8)).astype(np.float32))
    drug_ids = [int(x) for x in rng.choice(10**6, 30, replace=False)]
    csv_path = write_heldout_edges_csv(g, s, str(tmp / "edges.csv"), drug_ids=drug_ids,
                                       relation_names=names)
    return str(tmp), csv_path, drug_ids, g, names


@pytest.mark.parametrize("importance", ["default", "identity"])
@pytest.mark.parametrize("relation", [0, 1])
def test_np_predictor_equals_jax(artifacts, relation, importance):
    root, csv_path, drug_ids, g, names = artifacts
    got_info = predictor.PredictionsInfo(root, csv_path, drug_ids)
    want_info = jax_predictor.PredictionsInfo(root, csv_path, drug_ids)
    assert got_info.test_edges.keys() == want_info.test_edges.keys()
    imp = None if importance == "default" else np.eye(8, dtype=np.float32)
    got = predictor.NpPredictor(got_info, names[relation]).predict(importance_matrix=imp)
    want = jax_predictor.NpPredictor(want_info, names[relation]).predict(importance_matrix=imp)
    np.testing.assert_array_equal(got.probabilities, want.probabilities)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert abs(got.auroc - want.auroc) <= 1e-9 and abs(got.auprc - want.auprc) <= 1e-9
    assert got.confusion_matrix.shape == want.confusion_matrix.shape
    np.testing.assert_allclose(got.confusion_matrix, want.confusion_matrix, rtol=0, atol=1e-9)


@pytest.mark.parametrize(
    "labels,predicted",
    [([0, 1, 1, 0, 1], [0.0, 1.0, 0.0, 0.0, 1.0]), ([1, 1, 1], [1.0, 1.0, 1.0]),
     ([0, 0, 1], [1.0, 1.0, 1.0]), ([2, 0, 1, 2], [1.0, 0.0, 2.0, 2.0])],
)
def test_confusion_matrix_equals_sklearn(labels, predicted):
    from sklearn.metrics import confusion_matrix

    got = predictor.confusion_matrix(np.array(labels), np.array(predicted))
    np.testing.assert_array_equal(got, confusion_matrix(labels, predicted))


def test_training_edge_iterator_equals_jax(artifacts):
    root, csv_path, drug_ids, g, names = artifacts
    got_info = predictor.PredictionsInfo(root, csv_path, drug_ids, graph=g)
    want_info = jax_predictor.PredictionsInfo(
        root, csv_path, drug_ids,
        graph=jax_synthetic(n_genes=60, n_drugs=30, n_drugdrug_types=2, seed=0))
    rel = g.relations[(1, 1)][0]
    got = predictor.TrainingEdgeIterator(got_info, names[0], rel.rows, rel.cols)
    want = jax_predictor.TrainingEdgeIterator(want_info, names[0], rel.rows, rel.cols)
    np.testing.assert_array_equal(got.get_train_edges(), want.get_train_edges())
    # The JAX stack leaves all but the written entries uninitialised.
    a, b = got.get_train_edges_as_embeddings(), want.get_train_edges_as_embeddings()
    assert a.shape == b.shape
    for view in (np.s_[:, 0, :, 0], np.s_[:, :, 0, 0]):
        np.testing.assert_array_equal(a[view], b[view])
    assert not a[:, 1:, 1:].any()
    assert got.get_train_edges_as_dataframe().equals(want.get_train_edges_as_dataframe())
    np.testing.assert_array_equal(got_info.train_edges(rel.name), want_info.train_edges(rel.name))
    with pytest.raises(ValueError, match="no adjacency"):
        predictor.PredictionsInfo(root, csv_path, drug_ids).train_edges(rel.name)


# ---- the CLI ----------------------------------------------------------


def _write_conf(path, **extra):
    path.write_text(json.dumps(dict(CLI_CONF, **extra)))
    return str(path)


def _heldout_rows(pattern):
    (path,) = glob.glob(pattern)
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("renumber", [False, True], ids=["plain", "renumbered"])
def test_cli_end_to_end_on_the_cpu(tmp_path, renumber, capsys):
    """One epoch through ``python -m decagon_tpu_torch.cli`` on
    ``Device=cpu``: the iteration CSV has finite metrics, the checkpoint,
    the npy export and the profiler trace are written, and the held-out
    CSV equals the JAX CLI's for the same config row for row (the JAX run
    takes ``NumEpochs=0``: the CSV is written before training)."""
    out = {
        name: str(tmp_path / name)
        for name in ("results", "ck", "nd", "prof", "edges.csv", "jax_edges.csv")
    }
    conf = _write_conf(
        tmp_path / "conf.json", RenumberNodes=renumber, TrainIterationResultDir=out["results"],
        ShouldCheckpoint=True, CheckpointDirectory=out["ck"], WriteNdarrays=True,
        NdarrayWriteDir=out["nd"], TestEdgeFilename=out["edges.csv"], ProfileDir=out["prof"],
    )
    cli.main(["--config", conf, "--set", "Device=cpu"])
    (log,) = glob.glob(os.path.join(out["results"], "decagon_iteration_results_*.csv"))
    with open(log) as f:
        rows = list(csv.DictReader(f))
    assert rows and rows[-1]["EvaluateAll"] == "True"
    for row in rows:
        for name in ("AUROC", "AUPRC", "APK"):
            assert 0.0 <= float(row[name]) <= 1.0
    assert Checkpointer(out["ck"]).latest_step() > 0
    assert glob.glob(os.path.join(out["prof"], "*.json"))
    emb = np.load(os.path.join(out["nd"], "embeddings.npy"))
    assert emb.shape == (30, 4) and np.isfinite(emb).all()

    jax_cli.main(["--config", conf, "--set", "NumEpochs=0", "--set",
                  f"TestEdgeFilename={out['jax_edges.csv']}", "--set", "ShouldCheckpoint=false",
                  "--set", "WriteNdarrays=false", "--set", "ProfileDir=null",
                  "--set", f"TrainIterationResultDir={tmp_path / 'jax_results'}"])
    got = _heldout_rows(os.path.join(tmp_path, "edges-*.csv"))
    want = _heldout_rows(os.path.join(tmp_path, "jax_edges-*.csv"))
    assert len(got) > 5 and got == want

    # The export rebuilds the trained layout (and numbering) and restores
    # the CLI's checkpoint: the same embeddings as the logger's export.
    export_main(["--config", conf, "--set", "Device=cpu", "--set",
                 f"NpSaveDir={tmp_path / 'exported'}"])
    np.testing.assert_allclose(np.load(tmp_path / "exported" / "embeddings.npy"), emb,
                               rtol=1e-5, atol=1e-6)
    capsys.readouterr()


def test_cli_paired_checkpoint_exports_in_its_layout(tmp_path):
    """``DensePaired`` (the card's default) on the CPU: the export restores
    the paired checkpoint, the predictor scores relation 0's recorded
    edges as the evaluator does, and a non-paired template is refused."""
    conf = _write_conf(
        tmp_path / "conf.json", DensePaired=True, DenseFactored=True,
        TrainIterationResultDir=str(tmp_path / "results"), ShouldCheckpoint=True,
        CheckpointDirectory=str(tmp_path / "ck"), TestEdgeFilename=str(tmp_path / "edges.csv"),
    )
    cli.main(["--config", conf, "--set", "Device=cpu"])
    export_main(["--config", conf, "--set", "Device=cpu", "--set",
                 f"NpSaveDir={tmp_path / 'nd'}"])
    config = Config.from_argv(["--config", conf, "--set", "Device=cpu"])
    graph, protein_ids, drug_ids, names = layout.build_dataset(config)
    tg = layout.training_graph(config, graph, protein_ids, drug_ids)
    dg = layout.build_training_device_graph(config, tg, torch.device("cpu"))
    assert any(a.pair_mask is not None for a in dg.adj.values())
    model = DecagonModel(config.model_config(), dg)
    params = Checkpointer(str(tmp_path / "ck")).restore_latest(
        {"params": model.init_params(make_generator(0, "cpu"), dg)}, partial=True)["params"]
    want = AccuracyEvaluator(model, tg.full, tg.splits, device="cpu").evaluate(
        params, dg, (1, 1, 0)).auroc
    (csv_path,) = glob.glob(str(tmp_path / "edges-*.csv"))
    info = predictor.PredictionsInfo(str(tmp_path / "nd"), csv_path, drug_ids)
    assert abs(predictor.NpPredictor(info, names[0]).predict().auroc - want) <= 1e-6
    with pytest.raises(ValueError, match="does not match the template"):
        export_main(["--config", conf, "--set", "Device=cpu", "--set", "DensePaired=false",
                     "--set", f"NpSaveDir={tmp_path / 'nd2'}"])


def test_cli_wires_the_greedy_scorer(tmp_path):
    """``train_once`` hands a greedy learner the live model's scorers: one
    batch-scorer call a selection round, and the cells it unmasks are the
    highest-scoring ones."""
    config = Config.from_argv(["--config", _write_conf(
        tmp_path / "conf.json", TrainIterationResultDir=str(tmp_path / "results")),
        "--set", "Device=cpu"])
    graph, protein_ids, drug_ids, names = layout.build_dataset(config)
    learner = active.GreedyActiveLearner(graph, test_set_proportion=0.3,
                                         init_train_proportion=0.5, seed=0)
    masked, holdout = learner.get_update()
    cli.train_once(config, masked, holdout, "greedy", protein_ids, drug_ids, names,
                   learner=learner)
    calls = []
    wired = learner.batch_scorer

    def batch_scorer(batches):
        calls.append(wired(batches))
        return calls[-1]

    learner.batch_scorer = batch_scorer
    before = learner.possibilities.copy()
    count = int(np.floor(learner.dataset_size * (2 - 1) / 100))
    learner.get_update()
    assert len(calls) == 1
    scores = np.concatenate(calls[0])
    (k0,) = np.unique(before[:, 0])
    np.testing.assert_allclose(
        learner.scorer(int(k0), np.stack([before[:, 1] // 30, before[:, 1] % 30], 1)),
        scores, rtol=1e-6, atol=1e-7)
    kept = {tuple(r) for r in learner.possibilities}
    chosen = np.array([tuple(r) not in kept for r in before])
    assert chosen.sum() == count
    assert scores[chosen].min() >= scores[~chosen].max()


def test_cli_refuses_a_mesh(tmp_path, monkeypatch):
    """A mesh needs a process group: without one, or without the torchrun
    environment that ``DistributedInit`` reads, the CLI raises rather than
    train in one process."""
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    for extra, match in (({"MeshShape": [2, 1]}, "process group"),
                         ({"MeshShape": [2, 1], "DistributedInit": True}, "torchrun")):
        conf = _write_conf(tmp_path / "conf.json", TrainIterationResultDir=str(tmp_path), **extra)
        with pytest.raises(RuntimeError, match=match):
            cli.main(["--config", conf, "--set", "Device=cpu"])


def test_cli_side_effect_subset_equals_jax():
    for raw in (None, "neutropenia", ["Anosmia", 123, "456"]):
        settings = {} if raw is None else {"SideEffectSubset": raw}
        assert layout._side_effect_subset(Config(settings)) == jax_cli._side_effect_subset(
            JaxConfig(settings))
    with pytest.raises(ValueError, match="unknown side-effect name"):
        layout._side_effect_subset(Config({"SideEffectSubset": "bogus"}))


def test_np_predictor_example_runs(capsys):
    from decagon_tpu_torch.scripts import np_predictor_example

    np_predictor_example.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "default importance: AUROC=" in out and "train edges: (" in out
