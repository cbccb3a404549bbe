"""The port's training loop against the JAX package's on the CPU: the
minibatch scheduler, the chunked and grouped steps, the ``Trainer``'s
bookkeeping, checkpoints, the npy export and the metrics log.

The chunked steps are compared with the JAX package's from the same
parameters (JAX's, carried across with ``params_from_numpy``) and the same
random draws: per step ``s`` the JAX chunk derives ``fold_in(base_rng,
step_no[s])``; its dropout bits and negative uniforms, computed here as
``tests/test_torch_train.py::_jax_draws`` computes them (and, in grouped
slots, ``uniform(fold_in(sample_rng, g))`` per sub-batch), go into the port
through ``layer_bits`` and ``neg_u``.  The JAX side reports an accelerator
backend, so its rectangular edge types take the int8 factored stack as the
port's do.

Tolerances.  Losses: ``rtol=1e-4``, as ``tests/test_torch_train.py``.
Parameters and bf16 moments after several steps: the paired layer-1
weight gradients of the two packages differ by up to one bf16 ulp (2^-7)
in some elements (the keep-scale backward rounds at another point,
``tests/test_torch_train.py``), and Adam turns a gradient difference into
an update difference that does not shrink with the gradient: the first
step's update is +-lr whatever the gradient's size, later ones move by up
to a few bf16 roundings of their direction.  Once the parameters differ,
every leaf's gradient does.  So after ``s`` steps each parameter is held
to ``1e-6 max|p| + s * lr * 2^-6`` (measured: up to 0.0042 lr after three
steps) and each bf16 moment to ``2^-7 (|m| + max|m|)``, one bf16 ulp of
the element and of the leaf's largest (measured: up to 0.0028 of the
leaf's largest).  A single step stays at 1e-6 of each leaf's largest
(``tests/test_torch_train.py::test_full_step_matches_reference``).  Where
the port is compared with itself on the CPU (chunk against single steps,
a state round trip) the results must be equal bit for bit.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decagon_tpu.graph.device import build_device_graph as jax_build
from decagon_tpu.graph.split import split_graph as jax_split
from decagon_tpu.graph.synthetic import make_polypharmacy_like_graph as jax_graph
from decagon_tpu.graph.synthetic import make_synthetic_graph as jax_synthetic
from decagon_tpu.models.model import DecagonModel as JaxModel
from decagon_tpu.models.model import ModelConfig as JaxConfig
from decagon_tpu.train import checkpoint as jax_checkpoint
from decagon_tpu.train import logger as jax_logger
from decagon_tpu.train import step as jax_step
from decagon_tpu.train.sampler import MinibatchScheduler as JaxScheduler
from decagon_tpu.train.trainer import Trainer as JaxTrainer
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph, make_synthetic_graph
from decagon_tpu_torch.models.convert import adam_state_from_numpy, params_from_numpy
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.train import step as step_mod
from decagon_tpu_torch.train.checkpoint import Checkpointer, export_ndarrays
from decagon_tpu_torch.train.evaluate import AccuracyEvaluator
from decagon_tpu_torch.train.logger import FIELDS, MetricsLogger
from decagon_tpu_torch.train.sampler import MinibatchScheduler
from decagon_tpu_torch.train.trainer import Trainer
from tests.test_torch_train import _jax_draws

SMALL = dict(
    n_proteins=300, n_drugs=60, n_side_effects=6, min_edges_per_relation=20,
    ppi_attachment=5, seed=7,
)
HIDDEN = dict(hidden1=16, hidden2=8)
BATCH = 64
BF16_ULP = 2.0 ** -7


@pytest.fixture
def accelerator_dispatch(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


@pytest.fixture(scope="module")
def world():
    g_ref = jax_graph(**SMALL)
    s_ref = jax_split(g_ref, val_frac=0.05, test_frac=0.05, seed=1)
    dg_ref = jax_build(g_ref, s_ref, dense_factored=True, dense_paired=True, build_fused=False)
    model_ref = JaxModel(JaxConfig(**HIDDEN), dg_ref)
    params_ref = model_ref.init_params(jax.random.PRNGKey(0), dg_ref)
    g = make_polypharmacy_like_graph(**SMALL)
    s = split_graph(g, val_frac=0.05, test_frac=0.05, seed=1)
    dg = build_device_graph(g, s, dense_factored=True, dense_paired=True, device="cpu")
    model = DecagonModel(ModelConfig(**HIDDEN), dg)
    params = params_from_numpy(jax.device_get(params_ref), device="cpu")
    return dict(g=g_ref, s=s_ref, dg=dg_ref, model=model_ref, params=params_ref), dict(
        g=g, s=s, dg=dg, model=model, params=params
    )


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key in tree:
            out.update(_flat(tree[key], f"{prefix}/{key}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.float().numpy().astype(np.float64)}
    return {prefix: np.asarray(jnp.asarray(tree, jnp.float32), np.float64)}


def _hold_params(got, want, steps, lr=1e-3):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        bound = 1e-6 * np.abs(w).max() + steps * lr * 2.0 ** -6
        np.testing.assert_allclose(got[name], w, rtol=0, atol=bound, err_msg=name)


def _hold_bf16(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        bound = BF16_ULP * (np.abs(w) + np.abs(w).max())
        assert (np.abs(got[name] - w) <= bound).all(), name


def _batch(splits, key, seed):
    edges = splits[key].train
    idx = np.random.default_rng(seed).integers(0, edges.shape[0], BATCH)
    return edges[idx, 0].astype(np.int32), edges[idx, 1].astype(np.int32)


def _copy_jax(tree):
    return jax.tree_util.tree_map(jnp.copy, tree)


# ---- scheduler -------------------------------------------------------


@pytest.fixture(scope="module")
def toy_pair():
    g_ref = jax_synthetic(n_genes=120, n_drugs=60, n_drugdrug_types=3, seed=0)
    s_ref = jax_split(g_ref, val_frac=0.05, test_frac=0.0, seed=1)
    g = make_synthetic_graph(n_genes=120, n_drugs=60, n_drugdrug_types=3, seed=0)
    s = split_graph(g, val_frac=0.05, test_frac=0.0, seed=1)
    return (g_ref, s_ref), (g, s)


@pytest.mark.parametrize("schedule", ["reference", "balanced"])
def test_scheduler_yields_reference_batches(toy_pair, schedule):
    (g_ref, s_ref), (g, s) = toy_pair
    want = JaxScheduler(g_ref, s_ref, batch_size=32, seed=5, schedule=schedule)
    got = MinibatchScheduler(g, s, batch_size=32, seed=5, schedule=schedule)
    assert got.num_batches_per_epoch() == want.num_batches_per_epoch()
    for _ in range(2):
        a, b = list(want.epoch()), list(got.epoch())
        assert len(a) == len(b) > 10
        for x, y in zip(a, b):
            assert (x.edge_type, x.k, x.global_idx) == (y.edge_type, y.k, y.global_idx)
            np.testing.assert_array_equal(x.rows, y.rows)
            np.testing.assert_array_equal(x.cols, y.cols)
            assert y.rows.dtype == np.int32


# ---- chunked steps against the JAX package ---------------------------


def _chunk_inputs(port, dg, plan):
    """(branch, k, rows, cols) per step of ``plan`` [(edge_type, k)]."""
    branch = [dg.edge_types.index(et) for et, _ in plan]
    ks = [k for _, k in plan]
    rows, cols = zip(*(_batch(port["s"], et + (k,), seed=i) for i, (et, k) in enumerate(plan)))
    return np.array(branch, np.int32), np.array(ks, np.int32), np.stack(rows), np.stack(cols)


def test_chunked_step_matches_reference(world, accelerator_dispatch):
    """Four steps over three edge types, the last one padding: the loss
    trace (NaN where padding) and every parameter and moment after it."""
    ref, port = world
    plan = [((1, 1), 2), ((0, 0), 0), ((0, 1), 0), ((1, 1), 4)]
    valid = np.array([True, True, True, False])
    step_no = np.arange(4, dtype=np.int32) + 10
    branch, ks, rows, cols = _chunk_inputs(port, port["dg"], plan)
    jcfg = jax_step.TrainConfig(batch_size=BATCH)
    cfg = step_mod.TrainConfig(batch_size=BATCH)
    jopt = jax_step.make_optimizer(jcfg)
    jstate = jopt.init(ref["params"])
    base = jax.random.PRNGKey(9)
    jchunk = jax_step.make_chunked_train_step(ref["model"], ref["dg"], jcfg, jopt)
    new_j, state_j, losses_j = jchunk(
        _copy_jax(ref["params"]), _copy_jax(jstate), ref["dg"], base, jnp.asarray(branch),
        jnp.asarray(ks), jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(step_no),
        jnp.asarray(valid),
    )
    draws = [_jax_draws(port, jax.random.fold_in(base, int(sn)), cfg) for sn in step_no]
    opt = step_mod.make_optimizer(cfg)
    chunk = step_mod.make_chunked_train_step(port["model"], port["dg"], cfg, opt)
    new_p, state_p, losses_p = chunk(
        port["params"], adam_state_from_numpy(jax.device_get(jstate), device="cpu"),
        port["dg"], 0, branch, ks, torch.from_numpy(rows), torch.from_numpy(cols), step_no,
        valid, layer_bits=[b for b, _ in draws], neg_u=[u for _, u in draws],
    )
    losses_j = np.asarray(losses_j)
    assert losses_p.shape == (4,) and np.isnan(losses_j[3]) and torch.isnan(losses_p[3])
    np.testing.assert_allclose(losses_p[:3].numpy(), losses_j[:3], rtol=1e-4)
    assert state_p["t"] == int(state_j["t"]) == 3
    _hold_params(new_p, jax.device_get(new_j), steps=3)
    _hold_bf16(state_p["m"], jax.device_get(state_j["m"]))


def test_grouped_chunked_step_matches_reference(world, accelerator_dispatch):
    """G = 2 sub-batches per slot, C = 2 slots, one sub-batch padding."""
    ref, port = world
    plan = [((1, 1), 1), ((0, 1), 0), ((0, 0), 0), ((1, 1), 3)]
    branch, ks, rows, cols = _chunk_inputs(port, port["dg"], plan)
    branch, ks = branch.reshape(2, 2), ks.reshape(2, 2)
    rows, cols = rows.reshape(2, 2, BATCH), cols.reshape(2, 2, BATCH)
    valid = np.array([[True, True], [True, False]])
    step_no = np.array([3, 4], np.int32)
    jcfg = jax_step.TrainConfig(batch_size=BATCH, relation_group=2, scan_chunk=2)
    cfg = step_mod.TrainConfig(batch_size=BATCH, relation_group=2, scan_chunk=2)
    jopt = jax_step.make_optimizer(jcfg)
    jstate = jopt.init(ref["params"])
    base = jax.random.PRNGKey(4)
    jchunk = jax_step.make_grouped_chunked_train_step(ref["model"], ref["dg"], jcfg, jopt)
    new_j, state_j, losses_j = jchunk(
        _copy_jax(ref["params"]), _copy_jax(jstate), ref["dg"], base, jnp.asarray(branch),
        jnp.asarray(ks), jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(step_no),
        jnp.asarray(valid),
    )
    bits, neg_u = [], []
    for sn in step_no:
        rng = jax.random.fold_in(base, int(sn))
        b, _ = _jax_draws(port, rng, cfg)
        _, sample_rng = jax.random.split(rng)
        bits.append(b)
        neg_u.append([
            torch.from_numpy(np.asarray(jax.random.uniform(jax.random.fold_in(sample_rng, g),
                                                           (BATCH,))))
            for g in range(2)
        ])
    opt = step_mod.make_optimizer(cfg)
    chunk = step_mod.make_grouped_chunked_train_step(port["model"], port["dg"], cfg, opt)
    new_p, state_p, losses_p = chunk(
        port["params"], opt.init(port["params"]), port["dg"], 0, branch, ks,
        torch.from_numpy(rows), torch.from_numpy(cols), step_no, valid,
        layer_bits=bits, neg_u=neg_u,
    )
    np.testing.assert_allclose(losses_p.numpy(), np.asarray(losses_j), rtol=1e-4)
    assert state_p["t"] == int(state_j["t"]) == 2
    _hold_params(new_p, jax.device_get(new_j), steps=2)
    _hold_bf16(state_p["v"], jax.device_get(state_j["v"]))


# ---- the Trainer -----------------------------------------------------


@pytest.fixture(scope="module")
def toy_world(toy_pair):
    _, (g, s) = toy_pair
    dg = build_device_graph(g, s, device="cpu")
    model = DecagonModel(ModelConfig(**HIDDEN), dg)
    return g, s, dg, model


@pytest.fixture
def deterministic():
    """Deterministic CPU kernels for a bitwise comparison: with several
    threads PyTorch's CPU scatter-adds (the embedding gather's backward)
    add in a varying order."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _trainer(toy_world, **cfg):
    g, s, dg, model = toy_world
    return Trainer(model, g, s, dg, step_mod.TrainConfig(batch_size=32, **cfg), seed=3)


def test_train_chunk_equals_train_batch(toy_world, deterministic):
    """Same seed, same batches: chunks of 4 (the last one short) give the
    loss trace and parameters of the same steps taken one by one."""
    one, chunked = _trainer(toy_world), _trainer(toy_world, scan_chunk=4)
    batches = list(one.scheduler.epoch())[:10]
    want = torch.stack([one.train_batch(b) for b in batches])
    got = torch.cat([chunked.train_chunk(batches[i:i + 4], 4) for i in range(0, 10, 4)])
    assert torch.equal(got, want) and torch.isfinite(got).all()
    assert one.global_step == chunked.global_step == one.opt_step == chunked.opt_step == 10
    for name, w in _flat(one.params).items():
        np.testing.assert_array_equal(_flat(chunked.params)[name], w)


def test_grouped_trainer_counts_optimization_steps(toy_world):
    """G = 2 over an epoch of an odd number of batches: one step number
    per slot, none repeated, and ``opt_step`` counts slots."""
    tr = _trainer(toy_world, scan_chunk=3, relation_group=2)
    n = len(list(_trainer(toy_world).scheduler.epoch()))
    assert n % 2 == 1
    losses = []
    tr.iteration_hook = lambda t, r: losses.append(r.loss)
    tr.train(num_epochs=1)
    per_call = 3 * 2
    want_steps = sum(-(-min(per_call, n - i) // 2) for i in range(0, n, per_call))
    assert tr.global_step == n and tr.opt_step == want_steps == -(-n // 2)
    assert tr.opt_state["t"] == want_steps and len(losses) == want_steps
    assert np.isfinite(losses).all()


def test_state_dict_round_trip(toy_world, deterministic, tmp_path):
    """``state_dict`` -> ``Checkpointer`` -> a fresh ``Trainer``: equal
    state, and the next chunk equal on both."""
    tr = _trainer(toy_world, scan_chunk=2)
    batches = list(tr.scheduler.epoch())
    tr.train_chunk(batches[:2], 2)
    ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    for step in (1, 2, 3):
        ck.save(step, tr.state_dict())
    assert ck.all_steps() == [2, 3]
    fresh = _trainer(toy_world, scan_chunk=2)
    assert fresh.try_resume(ck)
    assert (fresh.global_step, fresh.opt_step) == (tr.global_step, tr.opt_step) == (2, 2)
    for a, b in ((fresh.params, tr.params), (fresh.opt_state, tr.opt_state)):
        fa, fb = _flat({"x": a}), _flat({"x": b})
        assert sorted(fa) == sorted(fb)
        for name in fa:
            np.testing.assert_array_equal(fa[name], fb[name])
    assert fresh.opt_state["m"]["enc1"]["0,0"].dtype == torch.bfloat16
    other = _trainer(toy_world, scan_chunk=2)
    other.load_state_dict(tr.state_dict())
    assert torch.equal(other.train_chunk(batches[2:4], 2), fresh.train_chunk(batches[2:4], 2))
    partial = ck.restore_latest(template={"params": tr.params}, partial=True)
    assert set(partial) == {"params"}
    assert Checkpointer(str(tmp_path / "empty")).restore_latest() is None


def test_trainer_refuses_what_the_reference_refuses(toy_world):
    with pytest.raises(ValueError):
        _trainer(toy_world, relation_group=2)
    g, s, dg, model = toy_world
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(model, g, s, dg, step_mod.TrainConfig(), mesh=object())


def test_trainer_runs_every_optimizer_option(toy_world):
    """A chunk with each optimizer option of ``TrainConfig``: finite losses
    and moved parameters."""
    for kw in (dict(lr_schedule="cosine", lr_schedule_steps=3),
               dict(lr_schedule="step", lr_schedule_steps=2),
               dict(lazy_decoder_adam=True), dict(pallas_adam=True, adam_moments_dtype="float32",
                                                 grad_dtype="float32")):
        tr = _trainer(toy_world, scan_chunk=3, **kw)
        before = _flat(tr.params)
        losses = tr.train_chunk(list(tr.scheduler.epoch())[:3], 3)
        assert torch.isfinite(losses).all(), kw
        after = _flat(tr.params)
        assert any(not np.array_equal(after[n], before[n]) for n in before), kw


# ---- export, checkpoint files, metrics log ---------------------------


def test_export_ndarrays_matches_reference(world, accelerator_dispatch, tmp_path):
    ref, port = world
    emb_ref = ref["model"].embeddings(ref["params"], ref["dg"])
    emb = port["model"].embeddings(port["params"], port["dg"])
    names = [f"se{k}" for k in range(ref["dg"].adj["1,1"].num_rel)]
    jax_checkpoint.export_ndarrays(ref["params"], emb_ref, ref["dg"], str(tmp_path / "jax"),
                                   relation_names=names)
    export_ndarrays(port["params"], emb, port["dg"], str(tmp_path / "port"),
                    relation_names=names)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) and len(files) > 3
    for name in files:
        if name.endswith(".npz"):
            a, b = np.load(tmp_path / "jax" / name), np.load(tmp_path / "port" / name)
            assert sorted(a.files) == sorted(b.files)
            pairs = [(a[f], b[f]) for f in a.files]
        else:
            pairs = [(np.load(tmp_path / "jax" / name), np.load(tmp_path / "port" / name))]
        for want, got in pairs:
            assert got.shape == want.shape and got.dtype == want.dtype, name
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_metrics_logger_writes_reference_columns(toy_world, tmp_path):
    """The CSV header and file name of the JAX package's logger; one epoch
    of hooks with a checkpointer and the npy export."""
    assert FIELDS == jax_logger.FIELDS
    g, s, dg, model = toy_world
    tr = _trainer(toy_world, scan_chunk=8)
    ev = AccuracyEvaluator(model, g, s, device="cpu")
    ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=1, every_n_iterations=1000)
    log = MetricsLogger(ev, str(tmp_path / "log"), every_n_iterations=50, checkpointer=ck,
                        ndarray_dir=str(tmp_path / "npy"), quiet=True)
    tr.iteration_hook, tr.epoch_hook = log.on_iteration, log.on_epoch_end
    tr.train(num_epochs=1)
    log.close()
    assert os.path.basename(log.path) == jax_logger.LOG_FILE_FORMAT % 0
    with open(log.path) as f:
        rows = list(csv.reader(f))
    assert rows[0] == jax_logger.FIELDS
    assert rows[-1][FIELDS.index("EvaluateAll")] == "True" and len(rows) >= 3
    assert ck.latest_step() == tr.global_step
    assert (tmp_path / "npy" / "embeddings.npy").exists()


def test_step_generators_are_pure_functions_of_their_seeds():
    """The per-step generator depends on (seed, step) only, and its split
    and fold children are distinct streams; no device work is needed to
    derive them."""
    draw = lambda gen: torch.rand(4, generator=gen)  # noqa: E731
    a, b = step_mod.step_generator(7, 3, "cpu"), step_mod.step_generator(7, 3, "cpu")
    assert torch.equal(draw(a), draw(b))
    assert not torch.equal(draw(step_mod.step_generator(7, 3, "cpu")),
                           draw(step_mod.step_generator(7, 4, "cpu")))
    enc, sample = step_mod.split_generator(step_mod.step_generator(7, 3, "cpu"))
    again = step_mod.split_generator(step_mod.step_generator(7, 3, "cpu"))
    assert torch.equal(draw(enc), draw(again[0])) and torch.equal(draw(sample), draw(again[1]))
    children = [draw(enc), draw(step_mod.fold_generator(sample, 0)),
                draw(step_mod.fold_generator(sample, 1))]
    assert len({tuple(c.tolist()) for c in children}) == 3
    assert 0 <= step_mod.fold_in(2**63 + 5, -1) < 2**63


@pytest.mark.parametrize("edge_type,k", [((1, 1), 3), ((0, 1), 0)])
def test_eval_scores_match_reference(world, accelerator_dispatch, edge_type, k):
    """``make_eval_scores`` (full forward, then sigmoid scores): the
    slice's 1e-4 (``tests/test_torch_slice.py``)."""
    ref, port = world
    rows, cols = _batch(port["s"], edge_type + (k,), seed=k)
    want = jax_step.make_eval_scores(ref["model"], edge_type)(
        ref["params"], ref["dg"], k, jnp.asarray(rows), jnp.asarray(cols))
    got = step_mod.make_eval_scores(port["model"], edge_type)(
        port["params"], port["dg"], k, torch.from_numpy(rows), torch.from_numpy(cols))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("options", [dict(adam_moments_dtype="float32"),
                                     dict(lazy_decoder_adam=True)], ids=["f32", "lazy"])
def test_jax_trainer_state_loads_into_the_port(toy_pair, toy_world, options):
    """A JAX ``Trainer``'s ``state_dict()``, converted with
    ``params_from_numpy`` and ``adam_state_from_numpy``, starts the port's
    ``Trainer``: the same parameters and moments, and a chunk trains."""
    (g_ref, s_ref), _ = toy_pair
    g, s, dg, model = toy_world
    dg_ref = jax_build(g_ref, s_ref)
    model_ref = JaxModel(JaxConfig(**HIDDEN), dg_ref)
    jt = JaxTrainer(model_ref, g_ref, s_ref, dg_ref,
                    jax_step.TrainConfig(batch_size=32, **options), seed=1)
    state = jax.device_get(jt.state_dict())
    init = dict(params=params_from_numpy(state["params"], device="cpu"),
                opt_state=adam_state_from_numpy(state["opt_state"], device="cpu"),
                global_step=state["global_step"], opt_step=state["opt_step"])
    tr = Trainer(model, g, s, dg, step_mod.TrainConfig(batch_size=32, scan_chunk=2, **options),
                 init_state=init)
    assert set(tr.opt_state) == set(tr.optimizer.init(tr.params))
    for name, w in _flat(state["params"]).items():
        np.testing.assert_array_equal(_flat(tr.params)[name], w)
    losses = tr.train_chunk(list(tr.scheduler.epoch())[:2], 2)
    assert torch.isfinite(losses).all()
