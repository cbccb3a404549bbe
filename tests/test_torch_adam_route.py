"""The optimizer route of the port's steps against the JAX package on the
CPU: ``ops/optim.adam_apply_ref`` (the plain version of the multi-tensor
one-pass Adam K7, which ``fused_adam``'s ``apply`` runs on CPU tensors)
against ``decagon_tpu/ops/optim.py::fused_adam`` and
``optax.apply_updates``; ``train/step.apply_optimizer``'s default branch
against the eager chain; three default-config steps of
``make_train_step`` against the JAX step; and the route's dtype gate.

The kernel itself runs only on a card (``tests/test_torch_cuda.py``).
Where a test needs the route that CUDA leaves take, it treats CPU leaves
as the card's (``optim._on_card``) and stands the launch in with the
plain chain, leaf by leaf (``_emulated_launch``), so that the leaves the
route hands to the kernel can be seen.

Tolerances, as ``tests/test_torch_adam.py``: parameters within 1e-6 of
each leaf's largest magnitude (f32 chains whose order may differ in XLA's
fusion), bf16 moments within one bf16 ulp (2^-7 of the value), f32
moments within 1e-6 of each leaf's largest magnitude.  The three steps of
``make_train_step`` start from gradients that agree with the JAX step's
to 1e-4 of each leaf's largest magnitude, not bit for bit
(``tests/test_torch_train.py``): their moments are held by that file's
rule for values rounded to bf16 after such sums (one bf16 ulp plus 1e-4
of the largest), their parameters as ``_hold_params_after_steps`` says.
Where the port is compared with itself the results must be equal bit for
bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from decagon_tpu.ops.optim import fused_adam as jax_fused_adam
from decagon_tpu.train import step as jax_step
from decagon_tpu_torch.models.convert import params_from_numpy
from decagon_tpu_torch.ops import cuda_build, optim
from decagon_tpu_torch.train import step as step_mod
from tests.test_torch_adam import _flat, _hold_moments, _hold_params, _tree
from tests.test_torch_train import (  # noqa: F401  (pair, accelerator_dispatch: fixtures)
    BATCH,
    _batch,
    _hold,
    _jax_draws,
    accelerator_dispatch,
    pair,
)

# A tree shaped like the main path's: a 4-D paired leaf, 3-D leaves, 2-D
# decoder leaves.
SHAPES = {
    "enc1": {"1,1": (2, 3, 8, 20), "1,0": (1, 20, 8)},
    "enc2": {"1,1": (2, 3, 4, 8)},
    "dec": {"1,1": {"global": (4, 4), "local_diag": (6, 4)}},
}
BF16, F32 = torch.bfloat16, torch.float32
LR = 1e-2


def _world(seed, shapes=SHAPES, steps=3):
    rng = np.random.default_rng(seed)
    params = _tree(lambda s: rng.standard_normal(s).astype(np.float32), shapes)
    grads = [_tree(lambda s: rng.standard_normal(s).astype(np.float32), shapes)
             for _ in range(steps)]
    return params, grads


def _bf16_exact(tree):
    """f32 numpy values that bf16 holds exactly (rounded once, here)."""
    return _tree(lambda x: torch.from_numpy(x).to(BF16).float().numpy(), tree)


def _torch_tree(tree, dtype):
    return step_mod.tree_map(lambda x: x.to(dtype), params_from_numpy(tree, device="cpu"))


@pytest.mark.parametrize("moments", [F32, BF16], ids=["m-f32", "m-bf16"])
@pytest.mark.parametrize("gdt", [F32, BF16], ids=["g-f32", "g-bf16"])
def test_adam_apply_ref_matches_reference(gdt, moments):
    """Three steps of ``adam_apply_ref`` against the JAX ``fused_adam``
    plus ``optax.apply_updates``, for each gradient dtype and moment
    dtype (bf16 gradients hold the same bf16 values on both sides)."""
    params, grads = _world(0)
    if gdt == BF16:
        grads = [_bf16_exact(g) for g in grads]
    jdt = {F32: jnp.float32, BF16: jnp.bfloat16}
    jopt = jax_fused_adam(LR, moments_dtype=jdt[moments])
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = params_from_numpy(params, device="cpu")
    state = optim.fused_adam(LR, moments_dtype=moments).init(tp)
    for g in grads:
        upd, jstate = jopt.update(jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt[gdt]), g),
                                  jstate)
        jp = optax.apply_updates(jp, upd)
        tp, state = optim.adam_apply_ref(_torch_tree(g, gdt), state, tp, LR)
    assert state["t"] == int(jstate["t"]) == 3
    jp, jstate = jax.device_get((jp, jstate))
    _hold_params(tp, jp)
    assert state["m"]["enc1"]["1,1"].dtype == moments
    for moment in ("m", "v"):
        _hold_moments(state[moment], jstate[moment], bf16=moments == BF16)


@pytest.mark.parametrize("kind", ["cosine", "step"])
def test_scheduled_apply_matches_reference(kind):
    """The default config's optimizer with a learning-rate schedule: its
    ``apply`` (the plain version on the CPU) against the JAX optimizer,
    three steps across the schedule's turns."""
    params, grads = _world(1)
    kw = dict(learning_rate=LR, lr_schedule=kind, lr_schedule_steps=2)
    jopt = jax_step.make_optimizer(jax_step.TrainConfig(**kw))
    cfg = step_mod.TrainConfig(**kw)
    opt = step_mod.make_optimizer(cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = params_from_numpy(params, device="cpu")
    state = opt.init(tp)
    for g in grads:
        upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tp, state = step_mod.apply_optimizer(opt, cfg, params_from_numpy(g, device="cpu"),
                                             state, tp, cast=True)
    jp, jstate = jax.device_get((jp, jstate))
    _hold_params(tp, jp)
    for moment in ("m", "v"):
        _hold_moments(state[moment], jstate[moment], bf16=True)


# One leaf of at least 2^20 elements, so that the default config rounds
# its gradient to bf16.
BIG = dict(SHAPES, big=(2, 2, 16, 16400))


def _clone(tree):
    if isinstance(tree, dict):
        return {key: _clone(value) for key, value in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone(value) for value in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _flat_tree(tree, prefix=""):
    """``{"a/b": leaf}`` of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_flat_tree(value, f"{prefix}/{key}" if prefix else key))
        return out
    return {prefix: tree}


def _equal_trees(a, b):
    """Equal keys, dtypes and bits (ints equal)."""
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for key in b:
            _equal_trees(a[key], b[key])
        return
    if isinstance(b, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
        return
    if isinstance(b, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("schedule", [{}, dict(lr_schedule="cosine", lr_schedule_steps=3),
                                      dict(lazy_decoder_adam=True)],
                         ids=["constant", "cosine", "lazy"])
def test_apply_optimizer_default_branch_equals_the_eager_chain(schedule):
    """``apply_optimizer``'s default branch (the optimizer's ``apply``;
    with ``lazy_decoder_adam``, the fused Adam's over the encoder's
    leaves) on CPU tensors: three steps bit for bit equal to
    ``cast_grads``, the optimizer's ``update`` and ``p + u``, out of place
    (the inputs keep their values, the outputs are new tensors)."""
    params, grads = _world(2, BIG)
    cfg = step_mod.TrainConfig(**schedule)
    opt = step_mod.make_optimizer(cfg)
    assert opt.apply is not None
    got_p = params_from_numpy(params, device="cpu")
    got_s = opt.init(got_p)
    want_p, want_s = _clone(got_p), _clone(got_s)
    for g in grads:
        g = params_from_numpy(g, device="cpu")
        before = _clone((g, got_s, got_p))
        new_p, new_s = step_mod.apply_optimizer(opt, cfg, g, got_s, got_p, cast=True)
        _equal_trees((g, got_s, got_p), before)
        assert new_p["big"] is not got_p["big"]
        assert _fused(new_s)["m"]["big"] is not _fused(got_s)["m"]["big"]
        got_p, got_s = new_p, new_s
        upd, want_s = opt.update(step_mod.cast_grads(cfg, g), want_s)
        want_p = step_mod.tree_map(lambda p, u: (p + u).to(p.dtype), want_p, upd)
    _equal_trees((got_p, got_s), (want_p, want_s))
    assert _fused(got_s)["m"]["big"].dtype == BF16


def _fused(state):
    """The fused Adam's ``{"m", "v", "t"}`` in an optimizer state (the
    encoder's half of the lazy decoder Adam's)."""
    return state["enc"] if "enc" in state else state


def _emulated_launch(record):
    """A stand-in for ``optim._launch`` on CPU tensors: each leaf through
    the plain chain into its outputs (in place where they are the
    inputs), one count a ``MAX_LEAVES`` of non-empty leaves, as the
    kernel counts; ``record`` gets every leaf handed to it."""

    def launch(leaves, lr, s1, s2, b1, b2, eps, block_threads=256):
        leaves = [leaf for leaf in leaves if leaf[3].numel() > 0]
        record.extend(leaves)
        for g, m, v, p, m_out, v_out, p_out, rounds in leaves:
            upd, m_new, v_new = optim._chain(g.to(BF16) if rounds else g, m, v, lr, s1, s2,
                                             b1, b2, eps)
            p_new = p + upd
            m_out.copy_(m_new)
            v_out.copy_(v_new)
            p_out.copy_(p_new)
        cuda_build.LAUNCHES["adam"] += -(-len(leaves) // optim.MAX_LEAVES)

    return launch


@pytest.fixture
def route(monkeypatch):
    """CPU leaves take the card's route, with ``_emulated_launch``; the
    list of the leaves handed to the launch."""
    record = []
    monkeypatch.setattr(optim, "_on_card", lambda p: True)
    monkeypatch.setattr(optim, "_launch", _emulated_launch(record))
    return record


def test_route_sends_every_card_leaf_to_the_kernel(route):
    """Every leaf on the card's route goes to the kernel, in one launch,
    with the default config's gradient rounding flagged on the leaf of
    2^20 elements; every result equals ``adam_apply_ref``'s bit for
    bit."""
    params, grads = _world(3, BIG, steps=1)
    tp = params_from_numpy(params, device="cpu")
    cfg = step_mod.TrainConfig()
    state = step_mod.make_optimizer(cfg).init(tp)
    g = params_from_numpy(grads[0], device="cpu")
    rounds = step_mod.grad_rounding(cfg)
    launches = cuda_build.LAUNCHES["adam"]
    got = optim.adam_apply(g, state, tp, LR, round_grad=rounds)
    assert cuda_build.LAUNCHES["adam"] == launches + 1
    launched = {leaf[3].data_ptr(): leaf for leaf in route}
    flat = _flat_tree(tp)
    assert len(route) == len(flat) == 6
    for name, p in flat.items():
        assert p.data_ptr() in launched, name
        assert launched[p.data_ptr()][-1] == (name == "big"), name
    _equal_trees(got, optim.adam_apply_ref(g, state, tp, LR, round_grad=rounds))


@pytest.mark.parametrize("dtype", [BF16, torch.float64], ids=["bf16", "f64"])
def test_route_raises_for_parameters_that_are_not_f32(route, dtype):
    """The dtype gate on the card's route: a leaf whose parameters are not
    f32 raises before anything is launched."""
    params, grads = _world(3, BIG, steps=1)
    tp = params_from_numpy(params, device="cpu")
    tp["enc2"]["1,1"] = tp["enc2"]["1,1"].to(dtype)
    state = step_mod.make_optimizer(step_mod.TrainConfig()).init(tp)
    g = params_from_numpy(grads[0], device="cpu")
    launches = cuda_build.LAUNCHES["adam"]
    with pytest.raises(TypeError):
        optim.adam_apply(g, state, tp, LR)
    assert cuda_build.LAUNCHES["adam"] == launches and not route


def test_cpu_leaves_of_any_dtype_take_the_chain():
    """On the CPU every leaf takes the chain, whatever its dtypes: bf16
    and f64 parameters keep their dtype and equal ``adam_apply_ref``'s
    bit for bit, with no launch."""
    params, grads = _world(3, BIG, steps=1)
    tp = params_from_numpy(params, device="cpu")
    tp["dec"]["1,1"]["global"] = tp["dec"]["1,1"]["global"].to(BF16)
    tp["enc2"]["1,1"] = tp["enc2"]["1,1"].double()
    cfg = step_mod.TrainConfig()
    state = step_mod.make_optimizer(cfg).init(tp)
    g = params_from_numpy(grads[0], device="cpu")
    g["enc2"]["1,1"] = g["enc2"]["1,1"].double()
    rounds = step_mod.grad_rounding(cfg)
    launches = cuda_build.LAUNCHES["adam"]
    got = optim.adam_apply(g, state, tp, LR, round_grad=rounds)
    assert cuda_build.LAUNCHES["adam"] == launches
    assert got[0]["enc2"]["1,1"].dtype == torch.float64
    assert got[0]["dec"]["1,1"]["global"].dtype == BF16
    _equal_trees(got, optim.adam_apply_ref(g, state, tp, LR, round_grad=rounds))


def test_launch_rejects_leaves_on_two_devices():
    """One launch runs on one device: leaves on two raise before the
    library is loaded."""
    a = torch.zeros(4)
    b = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="one device"):
        optim._launch([(a,) * 7 + (False,), (b,) * 7 + (False,)], LR, 1.0, 1.0, 0.9, 0.999, 1e-8)


def test_lazy_decoder_adam_sends_the_encoder_leaves_to_the_kernel(route):
    """``lazy_decoder_adam``'s ``apply`` on the card's route: the encoder's
    leaves in one launch, the decoder's through the lazy row Adam;
    three steps bit for bit equal to ``cast_grads``, ``update`` and
    ``p + u``."""
    params, grads = _world(6, BIG)
    cfg = step_mod.TrainConfig(lazy_decoder_adam=True)
    opt = step_mod.make_optimizer(cfg)
    got_p = params_from_numpy(params, device="cpu")
    got_s = opt.init(got_p)
    want_p, want_s = _clone(got_p), _clone(got_s)
    launches = cuda_build.LAUNCHES["adam"]
    for g in grads:
        g = params_from_numpy(g, device="cpu")
        g["dec"]["1,1"]["global"][1] = 0.0  # a row the lazy Adam leaves as it is
        got_p, got_s = step_mod.apply_optimizer(opt, cfg, g, got_s, got_p, cast=True)
        upd, want_s = opt.update(step_mod.cast_grads(cfg, g), want_s)
        want_p = step_mod.tree_map(lambda p, u: (p + u).to(p.dtype), want_p, upd)
    assert cuda_build.LAUNCHES["adam"] == launches + 3
    enc = {id(x) for name, x in _flat_tree(got_p).items() if not name.startswith("dec")}
    assert len(route) == 3 * 4 and {id(leaf[6]) for leaf in route[-4:]} == enc
    _equal_trees((got_p, got_s), (want_p, want_s))
    assert got_s["enc"]["m"]["big"].dtype == BF16 and got_s["dec"]["t"] == 3


def test_route_takes_one_launch_a_max_leaves(route):
    """More leaves than a launch's table take one launch a
    ``MAX_LEAVES``; an empty leaf takes none."""
    n = optim.MAX_LEAVES + 3
    shapes = {str(i): (1 + i,) for i in range(n)}
    shapes["empty"] = (0, 4)
    params, grads = _world(4, shapes, steps=1)
    tp = params_from_numpy(params, device="cpu")
    state = optim.fused_adam(LR).init(tp)
    g = params_from_numpy(grads[0], device="cpu")
    launches = cuda_build.LAUNCHES["adam"]
    got = optim.adam_apply(g, state, tp, LR)
    assert cuda_build.LAUNCHES["adam"] == launches + 2 and len(route) == n
    _equal_trees(got, optim.adam_apply_ref(g, state, tp, LR))


def test_fused_adam_apply_updates_the_gate_leaves_in_place(route):
    """``pallas_adam``'s entry on the card's route: the leaves of the JAX
    gate (3-D, f32 gradient and moments, at least ``min_pallas_size``
    elements) are updated in their own tensors, the others into new
    ones, all in one launch; the values equal the chain's."""
    params, grads = _world(5, steps=1)
    tp = params_from_numpy(params, device="cpu")
    state = optim.fused_adam(LR).init(tp)
    g = params_from_numpy(grads[0], device="cpu")
    want = optim.adam_apply_ref(g, state, tp, LR)
    gate = tp["enc1"]["1,0"]
    launches = cuda_build.LAUNCHES["adam"]
    got = optim.fused_adam_apply(g, state, tp, LR, min_pallas_size=64)
    assert cuda_build.LAUNCHES["adam"] == launches + 1
    assert got[0]["enc1"]["1,0"] is gate and got[1]["m"]["enc1"]["1,0"] is state["m"]["enc1"]["1,0"]
    assert got[0]["enc1"]["1,1"] is not tp["enc1"]["1,1"]
    _equal_trees(got, want)


def test_three_default_steps_match_reference(pair, accelerator_dispatch):  # noqa: F811
    """Three steps of ``make_train_step`` at the default ``TrainConfig``
    (bf16 moments; the optimizer's ``apply``) against the JAX step from
    the same parameters and draws: losses, every parameter, and the
    moments."""
    ref, port = pair
    edge_type = (1, 1)
    jcfg = jax_step.TrainConfig(batch_size=BATCH)
    cfg = step_mod.TrainConfig(batch_size=BATCH)
    jopt = jax_step.make_optimizer(jcfg)
    jstep = jax_step.make_train_step(ref["model"], edge_type, jcfg, jopt)
    jparams = jax.tree_util.tree_map(jnp.copy, ref["params"])
    jstate = jopt.init(jparams)
    opt = step_mod.make_optimizer(cfg)
    step = step_mod.make_train_step(port["model"], edge_type, cfg, opt)
    params, state = port["params"], opt.init(port["params"])
    base = jax.random.PRNGKey(7)
    moved = None
    for step_no, k in enumerate((2, 4, 1)):
        rows, cols = _batch(port["s"], edge_type, k, seed=10 + step_no)
        before = _flat(jax.device_get(jparams))
        jparams, jstate, loss_j = jstep(
            jparams, jstate, ref["dg"], k, jnp.asarray(rows), jnp.asarray(cols), base, step_no
        )
        if step_no:
            after = _flat(jax.device_get(jparams))
            step_moved = {n: np.abs(after[n] - before[n]) for n in after}
            moved = step_moved if moved is None else {n: moved[n] + step_moved[n] for n in after}
        bits, u = _jax_draws(port, jax.random.fold_in(base, step_no), cfg)
        params, state, loss_p = step(
            params, state, port["dg"], k, torch.from_numpy(rows), torch.from_numpy(cols),
            torch.Generator().manual_seed(step_no), layer_bits=bits, neg_u=u,
        )
        np.testing.assert_allclose(float(loss_p), float(loss_j), rtol=1e-4)
    assert state["t"] == int(jstate["t"]) == 3
    jparams, jstate = jax.device_get((jparams, jstate))
    _hold_params_after_steps(params, jparams, moved)
    # The moments are rounded to bf16 after sums of gradients that agree
    # to 1e-4 of each leaf's largest magnitude: ``test_torch_train``'s
    # rule for such values (one bf16 ulp plus 1e-4 of the largest).
    for moment in ("m", "v"):
        got, want = _flat(state[moment]), _flat(jstate[moment])
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            _hold(got[name], w, bf16_rounded=True)


def _hold_params_after_steps(got, want, moved):
    """Parameters after several steps with bf16 moments: within 1e-6 of
    each leaf's largest magnitude, but for at most 0.1% of a leaf's
    elements.  The two steps' gradients agree to 1e-4, not bit for bit
    (``tests/test_torch_train.py``), so a stored bf16 moment may round to
    the neighbouring value on the two sides, one bf16 ulp, at most 2^-7 of
    it.  That moves each later update of its element by at most 2^-7 of
    the update (m) plus 2^-8 (v, under the square root), less than 2^-6:
    such an element is held to ``2^-6 * moved`` beyond the 1e-6, ``moved``
    being the sum of its later updates' sizes (on the JAX side)."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        tight = 1e-6 * np.abs(w).max()
        err = np.abs(got[name] - w)
        assert (err <= tight + 2.0 ** -6 * moved[name]).all(), name
        assert (err > tight).sum() <= max(1, 1e-3 * err.size), name
