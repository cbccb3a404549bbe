"""The port's optimizer against the JAX package's on the CPU: learning-rate
schedules, the lazy decoder Adam, and the one-pass Adam (K7) with its plain
chain.

The JAX side's one-pass kernel runs in interpret mode
(``fused_adam_apply(..., interpret=True, min_pallas_size=64)``), as
``tests/test_optim.py`` runs it.  The port's kernel runs only on a card
(``tests/test_torch_cuda.py``); here its plain version
``adam_onepass_ref`` and the chain path of ``fused_adam_apply`` stand for
it.

Tolerances.  Learning rates: ``rtol=1e-6`` (both evaluate the schedule in
f32; ``cos`` may differ in its last bit between the two libraries).
Parameters: within 1e-6 of each leaf's largest magnitude (f32 chains
whose order may differ in XLA's fusion).  bf16 moments: within one bf16
ulp (2^-7 of the value).  f32 moments: within 1e-6 of each leaf's largest
magnitude, as the parameters (``b1 m + (1 - b1) g`` cancels near zero, so
a bound relative to each element would hold XLA's fused multiply-adds to
more than their rounding).  Where the port is
compared with itself (kernel gate off against on, CPU tensors) the
results must be equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from decagon_tpu.ops.optim import fused_adam as jax_fused_adam
from decagon_tpu.ops.optim import fused_adam_apply as jax_fused_adam_apply
from decagon_tpu.train import step as jax_step
from decagon_tpu_torch.models.convert import adam_state_from_numpy, params_from_numpy
from decagon_tpu_torch.ops import optim
from decagon_tpu_torch.train import step as step_mod

BF16_ULP = 2.0 ** -7


def _tree(fn, shapes):
    if isinstance(shapes, dict):
        return {key: _tree(fn, v) for key, v in shapes.items()}
    return fn(shapes)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key in tree:
            out.update(_flat(tree[key], f"{prefix}/{key}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.float().numpy().astype(np.float64)}
    return {prefix: np.asarray(jnp.asarray(tree, jnp.float32), np.float64)}


def _hold_params(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-6 * np.abs(w).max(), err_msg=name)


def _hold_moments(got, want, bf16):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        if bf16:
            assert (np.abs(got[name] - w) <= BF16_ULP * np.abs(w) + 1e-30).all(), name
        else:
            np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-6 * np.abs(w).max(),
                                       err_msg=name)


def _apply(params, updates):
    return step_mod.tree_map(lambda p, u: p + u, params, updates)


@pytest.mark.parametrize("kind", ["cosine", "step"])
def test_lr_schedule_values_match_reference(kind):
    total = 40
    kw = dict(learning_rate=3e-3, lr_schedule=kind, lr_schedule_steps=total,
              lr_min_frac=0.2, lr_decay_rate=0.5)
    want_fn = jax_step._lr_schedule_fn(jax_step.TrainConfig(**kw))
    got_fn = step_mod._lr_schedule_fn(step_mod.TrainConfig(**kw))
    for t in (1, total // 2, total, 2 * total):
        want = float(want_fn(jnp.asarray(t, jnp.int32)))
        np.testing.assert_allclose(got_fn(t), want, rtol=1e-6)
    assert step_mod._lr_schedule_fn(step_mod.TrainConfig(lr_schedule=kind)) is None


@pytest.mark.parametrize("kind", ["cosine", "step"])
def test_scheduled_fused_adam_matches_reference(kind):
    """Three updates of the bf16-moment fused Adam with a schedule."""
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 5, 7), "b": {"c": (11,), "d": (4, 4)}}
    params = _tree(lambda s: rng.standard_normal(s).astype(np.float32), shapes)
    kw = dict(learning_rate=1e-2, lr_schedule=kind, lr_schedule_steps=2)
    jopt = jax_step.make_optimizer(jax_step.TrainConfig(**kw))
    opt = step_mod.make_optimizer(step_mod.TrainConfig(**kw))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = params_from_numpy(params, device="cpu")
    state = opt.init(tp)
    for _ in range(3):
        grads = _tree(lambda s: rng.standard_normal(s).astype(np.float32), shapes)
        upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tu, state = opt.update(params_from_numpy(grads, device="cpu"), state)
        tp = _apply(tp, tu)
    assert state["t"] == int(jstate["t"]) == 3
    _hold_params(tp, jax.device_get(jp))
    _hold_moments(state["m"], jax.device_get(jstate["m"]), bf16=True)
    _hold_moments(state["v"], jax.device_get(jstate["v"]), bf16=True)


LAZY_SHAPES = {
    "enc1": {"0,0": (2, 6, 5)},
    "enc2": {"0,0": (2, 5, 3)},
    "dec": {"0,0": {"relation": (4, 3, 3)}, "1,1": {"global": (3, 3), "local_diag": (4, 3)}},
}


def test_lazy_decoder_adam_matches_reference():
    """Two updates of ``make_optimizer(lazy_decoder_adam=True)`` against the
    JAX ``multi_transform``, with decoder gradient rows that are all zero
    (their moments and parameters must stay as they were)."""
    rng = np.random.default_rng(2)
    params = _tree(lambda s: rng.standard_normal(s).astype(np.float32), LAZY_SHAPES)
    cfg_kw = dict(learning_rate=1e-2, lazy_decoder_adam=True)
    jopt = jax_step.make_optimizer(jax_step.TrainConfig(**cfg_kw))
    opt = step_mod.make_optimizer(step_mod.TrainConfig(**cfg_kw))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = params_from_numpy(params, device="cpu")
    state = opt.init(tp)
    for step in range(2):
        grads = _tree(lambda s: rng.standard_normal(s).astype(np.float32), LAZY_SHAPES)
        grads["dec"]["0,0"]["relation"][1] = 0.0  # every row of relation 1
        grads["dec"]["1,1"]["local_diag"][2 + step] = 0.0
        upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tu, state = opt.update(params_from_numpy(grads, device="cpu"), state)
        assert torch.count_nonzero(tu["dec"]["0,0"]["relation"][1]) == 0
        tp = _apply(tp, tu)
    _hold_params(tp, jax.device_get(jp))
    converted = adam_state_from_numpy(jax.device_get(jstate), device="cpu")
    assert set(converted) == set(state) == {"enc", "dec"}
    for label, bf16 in (("enc", True), ("dec", False)):
        assert converted[label]["t"] == state[label]["t"] == 2
        for moment in ("m", "v"):
            _hold_moments(state[label][moment], converted[label][moment], bf16)
    assert state["enc"]["m"]["enc1"]["0,0"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["dec"]["0,0"]["relation"][1].numpy(), params["dec"]["0,0"]["relation"][1]
    )


def test_lazy_decoder_adam_refuses_a_schedule():
    kw = dict(lazy_decoder_adam=True, lr_schedule="cosine", lr_schedule_steps=10)
    with pytest.raises(ValueError):
        jax_step.make_optimizer(jax_step.TrainConfig(**kw))
    with pytest.raises(ValueError):
        step_mod.make_optimizer(step_mod.TrainConfig(**kw))


ONEPASS_SHAPES = {"big": (5, 70, 130), "flat2d": (70, 130), "small": (7,)}


def _onepass_world(seed):
    rng = np.random.default_rng(seed)
    params = _tree(lambda s: rng.standard_normal(s).astype(np.float32), ONEPASS_SHAPES)
    grads = [_tree(lambda s: rng.standard_normal(s).astype(np.float32), ONEPASS_SHAPES)
             for _ in range(3)]
    return params, grads


def test_fused_adam_apply_matches_reference_interpret_kernel():
    """Three steps of the port's ``fused_adam_apply`` (chain path on CPU
    tensors) and of ``adam_onepass_ref`` on the 3-D leaf, against the JAX
    package's ``fused_adam_apply`` whose 3-D leaf runs the Pallas kernel in
    interpret mode."""
    params, grads = _onepass_world(0)
    lr = 1e-2
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jax_fused_adam(lr).init(jp)
    tp = params_from_numpy(params, device="cpu")
    state = optim.fused_adam(lr).init(tp)
    ref_p = params_from_numpy(params, device="cpu")["big"]
    ref_m, ref_v = torch.zeros_like(ref_p), torch.zeros_like(ref_p)
    ptr = ref_p.data_ptr()
    for t, g in enumerate(grads, start=1):
        jp, jstate = jax_fused_adam_apply(
            jax.tree_util.tree_map(jnp.asarray, g), jstate, jp, lr,
            interpret=True, min_pallas_size=64,
        )
        tp, state = optim.fused_adam_apply(
            params_from_numpy(g, device="cpu"), state, tp, lr, min_pallas_size=64
        )
        s1, s2 = optim.bias_scales(t, 0.9, 0.999)
        optim.adam_onepass_ref(torch.from_numpy(g["big"]), ref_m, ref_v, ref_p,
                               s1, s2, lr, 0.9, 0.999, 1e-8)
    assert ref_p.data_ptr() == ptr
    assert state["t"] == int(jstate["t"]) == 3
    jp, jstate = jax.device_get((jp, jstate))
    _hold_params(tp, jp)
    _hold_params({"big": ref_p}, {"big": jp["big"]})
    for moment in ("m", "v"):
        _hold_moments(state[moment], jstate[moment], bf16=False)
    _hold_moments({"big": ref_m}, {"big": jstate["m"]["big"]}, bf16=False)
    _hold_moments({"big": ref_v}, {"big": jstate["v"]["big"]}, bf16=False)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_pallas_adam_on_cpu_equals_the_chain_exactly(moments):
    """On CPU tensors ``apply_optimizer`` with ``pallas_adam`` takes no
    kernel; the chain of ``fused_adam_apply`` equals ``fused_adam`` plus
    ``p + upd`` bit for bit, and ``adam_onepass`` (plain version on the
    CPU) equals it too, in place."""
    params, grads = _onepass_world(1)
    out = {}
    for pallas in (False, True):
        cfg = step_mod.TrainConfig(pallas_adam=pallas, adam_moments_dtype=moments,
                                   grad_dtype="float32")
        opt = step_mod.make_optimizer(cfg)
        tp = params_from_numpy(params, device="cpu")
        state = opt.init(tp)
        for g in grads:
            tp, state = step_mod.apply_optimizer(opt, cfg, params_from_numpy(g, device="cpu"),
                                                 state, tp)
        out[pallas] = (tp, state)
    (p0, s0), (p1, s1) = out[False], out[True]
    assert s0["t"] == s1["t"] == 3
    for name in ONEPASS_SHAPES:
        for a, b in ((p0[name], p1[name]), (s0["m"][name], s1["m"][name]),
                     (s0["v"][name], s1["v"][name])):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    dt = torch.float32 if moments == "float32" else torch.bfloat16
    p = params_from_numpy(params, device="cpu")["big"]
    m, v = torch.zeros_like(p, dtype=dt), torch.zeros_like(p, dtype=dt)
    for t, g in enumerate(grads, start=1):
        s1_, s2_ = optim.bias_scales(t, 0.9, 0.999)
        optim.adam_onepass(torch.from_numpy(g["big"]).to(dt), m, v, p, s1_, s2_,
                           1e-3, 0.9, 0.999, 1e-8)
    if dt == torch.float32:
        assert torch.equal(p, p0["big"]) and torch.equal(m, s0["m"]["big"])
    assert torch.isfinite(p).all() and m.dtype == dt

