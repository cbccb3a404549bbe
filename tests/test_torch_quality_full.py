"""The port's paper-scale quality run (``decagon_tpu_torch/scripts/
quality_full.py``) against the JAX package's (``scripts/quality_full.py``).

(a) Resume: the script on a small planted graph, two epochs in one run
against one epoch, a checkpoint, a resume and one more epoch, must give the
same CSV metrics, parameters, Adam moments and step counts bit for bit
(deterministic CPU kernels).
(b) The learning-rate horizon: the script's ``lr_schedule_steps`` equals the
JAX script's formula applied to the JAX package's own split of the same graph.
(c) The grouped step at the quality config (balanced schedule, G = 8,
cosine rate, lr 3e-3, hinge with margin 0.1, bf16 moments and gradients):
two chunks against the JAX package's ``make_grouped_chunked_train_step``
from the same parameters and the same random draws, held as
``tests/test_torch_trainer.py`` holds the G = 2 chunk (losses to
``rtol=1e-4``, parameters to ``1e-6 max|p| + s * lr * 2^-6`` after ``s``
steps, bf16 moments to one bf16 ulp of the element and of the leaf's
largest), apart from the few weights that a unit at the ReLU's kink reaches
(see the test).
(d) The checked-in card trajectory ``artifacts/quality/
torch_poly963_noise0.15_metrics.csv`` under the JAX gate's own conditions
(``tests/test_quality.py``: final test AUROC >= 0.87, best - final <
0.005), and its sidecar against the JAX sidecar.
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decagon_tpu.graph.device import build_device_graph as jax_build
from decagon_tpu.graph.split import split_graph as jax_split
from decagon_tpu.graph.synthetic import make_polypharmacy_like_graph as jax_graph
from decagon_tpu.models.model import DecagonModel as JaxModel
from decagon_tpu.models.model import ModelConfig as JaxConfig
from decagon_tpu.train import step as jax_step
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.models.convert import params_from_numpy
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.scripts import quality_full
from decagon_tpu_torch.train import step as step_mod
from decagon_tpu_torch.train.sampler import MinibatchScheduler
from tests.test_torch_train import _jax_draws
from tests.test_torch_trainer import BF16_ULP, _copy_jax, _flat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "artifacts", "quality")
# A planted graph of a few hundred nodes whose 10 side effects fill groups
# of 8 batches.
SMALL = dict(
    n_proteins=300, n_drugs=60, n_side_effects=10, min_edges_per_relation=20,
    ppi_attachment=5, seed=7, planted_rank=4,
)
NOISE = 0.15
MODEL = dict(hidden1=16, hidden2=8, dropout=0.1, spmm_impl="auto")
BATCH = 64
GROUP = 8
LR = 3e-3


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _run(tmp_path, max_epochs):
    args = quality_full.parse_args([
        "--device", "cpu", "--noise", str(NOISE), "--max-epochs", str(max_epochs),
        "--ckpt-every", "1", "--ckpt-dir", str(tmp_path / "ckpt"),
        "--artifact-dir", str(tmp_path / "art"),
    ])
    return quality_full.run(args, graph_kw=SMALL, model_kw=MODEL, batch=BATCH,
                            log=lambda msg: None)


def _metrics(path):
    with open(path, newline="") as f:
        return [{k: v for k, v in row.items() if k != "Seconds"} for row in csv.DictReader(f)]


def test_resume_equals_an_uninterrupted_run(tmp_path, deterministic):
    whole = _run(tmp_path / "whole", 2)
    first = _run(tmp_path / "split", 1)
    assert not first["resumed"] and os.listdir(first["ckpt_dir"])
    second = _run(tmp_path / "split", 2)
    assert second["resumed"] and second["stop"] == "max_epochs"
    want, got = _metrics(whole["csv"]), _metrics(second["csv"])
    assert [r["Epoch"] for r in want] == ["1", "2"]
    assert got == want
    assert (second["global_step"], second["opt_step"]) == (whole["global_step"],
                                                           whole["opt_step"])
    assert whole["opt_step"] == 2 * quality_full.opt_steps_per_epoch(
        whole["trainer"].graph, whole["trainer"].splits, BATCH, GROUP)
    a, b = whole["trainer"], second["trainer"]
    for tree_a, tree_b in ((a.params, b.params), (a.opt_state["m"], b.opt_state["m"]),
                           (a.opt_state["v"], b.opt_state["v"])):
        fa, fb = _flat(tree_a), _flat(tree_b)
        assert sorted(fa) == sorted(fb)
        for name in fa:
            np.testing.assert_array_equal(fb[name], fa[name], err_msg=name)
    assert a.opt_state["t"] == b.opt_state["t"] == whole["opt_step"]
    with open(second["meta"]) as f:
        meta = json.load(f)
    assert meta["epochs"] == 2 and [t["epoch"] for t in meta["timing"]] == [1, 2]
    assert meta["device"] == "cpu" and meta["train"]["relation_group"] == GROUP


def test_schedule_horizon_matches_the_jax_script():
    g_ref = jax_graph(**SMALL, planted_noise=NOISE)
    s_ref = jax_split(g_ref, val_frac=0.05, test_frac=0.05, seed=quality_full.SPLIT_SEED)
    # scripts/quality_full.py:123-128, applied to the JAX package's split.
    n_batches = sum(
        -(-s_ref[k].train.shape[0] // BATCH)
        for k in g_ref.relation_keys()
        if s_ref[k].train.shape[0] > 0
    )
    want = 10 * -(-n_batches // GROUP)
    g = make_polypharmacy_like_graph(**SMALL, planted_noise=NOISE)
    s = split_graph(g, val_frac=0.05, test_frac=0.05, seed=quality_full.SPLIT_SEED)
    args = quality_full.parse_args(["--noise", str(NOISE)])
    cfg = quality_full.train_config(args, g, s, BATCH)
    assert cfg.lr_schedule_steps == want
    assert (cfg.schedule, cfg.relation_group, cfg.lr_schedule, cfg.lr_min_frac) == (
        "balanced", GROUP, "cosine", 0.1)
    assert MinibatchScheduler(g, s, batch_size=BATCH, schedule="balanced") \
        .num_batches_per_epoch() == n_batches


@pytest.fixture
def accelerator_dispatch(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


# A layer-1 pre-activation within this distance of 0 is at the ReLU's kink:
# the two packages sum it in other orders and may put it on either side
# (seen: exactly 0.0 in the port, 3.3e-10 in the JAX package's compiled
# chunk), so one passes that unit's cotangent and the other does not.
KINK = 1e-6


def _kink_elements(pre_acts, dg, params):
    """The enc1 elements a kink unit's cotangent reaches: for a unit h of
    node n (of type t) whose pre-activation lies within ``KINK`` of 0, the
    column h of every source row j with an edge n <- j, in each edge type
    into t.  Returns ``{leaf name: bool mask}`` in ``_flat``'s names."""
    by_rows = {int(dg.num_nodes[t]): t for t in range(len(dg.num_nodes))}
    assert len(by_rows) == len(dg.num_nodes)
    kinks = set()
    for pre in pre_acts:
        t = by_rows[pre.shape[0]]
        for n, h in torch.nonzero(pre.abs() <= KINK).tolist():
            kinks.add((t, n, h))
    masks = {}
    for key, leaf in params["enc1"].items():
        t = int(key.split(",")[0])
        adj = dg.adj[key]
        live = adj.vals != 0
        recv, send = adj.receivers[live].long(), adj.senders[live].long()
        mask = np.zeros(tuple(leaf.shape), bool)
        for kt, n, h in kinks:
            if kt != t:
                continue
            for j in send[recv == n].unique().tolist():
                if leaf.dim() == 4:  # paired [2, K/2, H, F]
                    mask[:, :, h, j] = True
                else:  # [K, F, H]
                    mask[:, j, h] = True
        masks[f"/enc1/{key}"] = mask
    return masks


def _hold(got, want, bound, skip):
    """Each element of every leaf within ``bound(w, leaf)``, apart from the
    ``skip`` elements (kink-reached)."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        ok = np.abs(got[name] - w) <= bound(w)
        if name in skip:
            ok |= skip[name]
        assert ok.all(), (name, np.argwhere(~ok)[:8].tolist())


def test_grouped_quality_chunks_match_reference(accelerator_dispatch, monkeypatch):
    """Two chunks of 2 slots of 8 sub-batches, the last slot 5 valid.

    Held as ``tests/test_torch_trainer.py`` holds the G = 2 chunk, with one
    exception: a layer-1 unit whose pre-activation lies at the ReLU's kink
    (``KINK``) can pass its cotangent in one package and not in the other,
    a difference of sum order that no tolerance on roundings covers.  The
    enc1 elements such a unit's cotangent reaches (``_kink_elements``, from
    the port's pre-activations of each slot) are left out of the parameter
    and moment checks from that step on; there must be few (this chunk has
    one such unit, in its second slot: 24 weights of PPI's layer 1), and
    every other element is held."""
    kw = dict(SMALL, planted_noise=NOISE)
    g_ref = jax_graph(**kw)
    s_ref = jax_split(g_ref, val_frac=0.05, test_frac=0.05, seed=quality_full.SPLIT_SEED)
    dg_ref = jax_build(g_ref, s_ref, dense_factored=True, dense_paired=True, build_fused=False)
    model_ref = JaxModel(JaxConfig(**MODEL), dg_ref)
    params_ref = model_ref.init_params(jax.random.PRNGKey(0), dg_ref)
    g = make_polypharmacy_like_graph(**kw)
    s = split_graph(g, val_frac=0.05, test_frac=0.05, seed=quality_full.SPLIT_SEED)
    dg = build_device_graph(g, s, dense_factored=True, dense_paired=True, build_fused=False,
                            device="cpu")
    model = DecagonModel(ModelConfig(**MODEL), dg)
    port = dict(params=params_from_numpy(jax.device_get(params_ref), device="cpu"), dg=dg,
                model=model)
    common = dict(batch_size=BATCH, learning_rate=LR, loss="hinge", margin=0.1,
                  scan_chunk=2, schedule="balanced", relation_group=GROUP,
                  lr_schedule="cosine", lr_schedule_steps=5, lr_min_frac=0.1)
    jcfg, cfg = jax_step.TrainConfig(**common), step_mod.TrainConfig(**common)
    assert (cfg.adam_moments_dtype, cfg.grad_dtype) == ("bfloat16", "bfloat16")

    epoch = MinibatchScheduler(g, s, batch_size=BATCH, seed=0, schedule="balanced").epoch()
    batches = [next(epoch) for _ in range(3 * GROUP + 5)]
    index = {et: i for i, et in enumerate(dg.edge_types)}
    assert [et for et in dg_ref.edge_types] == list(dg.edge_types)
    base = jax.random.PRNGKey(5)
    jopt, opt = jax_step.make_optimizer(jcfg), step_mod.make_optimizer(cfg)
    jchunk = jax_step.make_grouped_chunked_train_step(model_ref, dg_ref, jcfg, jopt)
    chunk = step_mod.make_grouped_chunked_train_step(model, dg, cfg, opt)
    jp, js = _copy_jax(params_ref), jopt.init(params_ref)
    pp, ps = port["params"], opt.init(port["params"])
    pre_acts = []
    relu = torch.relu

    def recording_relu(x):
        if x.dim() == 2 and x.shape[1] == MODEL["hidden1"]:
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
    assert len(pre_acts) == 4 * len(dg.num_nodes) and valid.sum() == GROUP + 5


def _rows(name):
    path = os.path.join(ART, name)
    assert os.path.exists(path), f"missing {name}"
    with open(path) as f:
        rows = list(csv.DictReader(f))
    assert rows, "no epochs recorded"
    return rows


def test_card_trajectory_meets_the_jax_gate():
    """``tests/test_quality.py::test_poly963_reduced_noise_meets_north_star_at_convergence``'s
    conditions on the port's trajectory, which learns from its first epoch."""
    rows = _rows("torch_poly963_noise0.15_metrics.csv")
    aurocs = [float(r["TestAUROC"]) for r in rows]
    assert [int(r["Epoch"]) for r in rows] == list(range(1, len(rows) + 1))
    assert all(0.0 <= a <= 1.0 for a in aurocs)
    assert aurocs[0] > 0.55, f"epoch-1 test AUROC {aurocs[0]} at chance"
    assert aurocs[-1] >= 0.87, f"FINAL test AUROC {aurocs[-1]:.4f} below 0.87"
    assert max(aurocs) - aurocs[-1] < 0.005, "trajectory regressed from its best"


def test_card_trajectory_provenance_matches_the_jax_sidecar():
    with open(os.path.join(ART, "poly963_noise0.15_metrics.meta.json")) as f:
        want = json.load(f)
    with open(os.path.join(ART, "torch_poly963_noise0.15_metrics.meta.json")) as f:
        got = json.load(f)
    for key in ("graph", "split_seed", "model", "train", "trainer_seed"):
        assert got[key] == want[key], key
    name, _, limit = got["device"].partition(",")
    assert name.strip().startswith("NVIDIA") and limit.strip().endswith("W"), got["device"]
    assert got["epochs"] == len(_rows("torch_poly963_noise0.15_metrics.csv"))
    assert got["seconds"] > 0 and got["torch"]
