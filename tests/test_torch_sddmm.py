"""Edge scoring of the port against the JAX package: the plain version on
the CPU against ``sddmm_pallas_edges`` in interpret mode and against
``sddmm_pairs``, for all four decoders with per-edge relation indices
(the CUDA kernel is held against the plain version on the card in
``test_torch_cuda.py``).

Tolerance: everything is f32, so only the summation order differs:
``rtol=1e-5`` with an absolute floor of 1e-5 of the largest score (a score
near zero is a difference of larger terms).  At ``precision="default"``
both sides round the same tables (and DEDICOM's ``z_r * d_k``) to bf16 and
the products of bf16 values are exact in f32, so the same bound holds.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decagon_tpu.ops.sddmm import sddmm_pairs as jax_pairs
from decagon_tpu.ops.sddmm_pallas import sddmm_pallas_edges
from decagon_tpu_torch.ops.sddmm import sddmm_pairs
from decagon_tpu_torch.models.model import ModelConfig
from decagon_tpu_torch.ops.sddmm_pallas import sddmm_edges
from decagon_tpu_torch.train.step import make_emb_scores

NAMES = ["innerproduct", "distmult", "dedicom", "bilinear"]


def _world(seed, n_r, n_c, n_rel, d, shape):
    rng = np.random.default_rng(seed)
    w = dict(
        z_r=rng.standard_normal((n_r, d)).astype(np.float32),
        z_c=rng.standard_normal((n_c, d)).astype(np.float32),
        diag=rng.standard_normal((n_rel, d)).astype(np.float32),
        glb=rng.standard_normal((d, d)).astype(np.float32),
        full=rng.standard_normal((n_rel, d, d)).astype(np.float32),
        ks=rng.integers(0, n_rel, shape).astype(np.int32),
        rows=rng.integers(0, n_r, shape).astype(np.int32),
        cols=rng.integers(0, n_c, shape).astype(np.int32),
    )
    return w


def _port(w, name, device="cpu"):
    t = {k: torch.from_numpy(v).to(device) for k, v in w.items()}
    return sddmm_edges(
        t["z_r"], t["z_c"], t["ks"], t["rows"], t["cols"], name=name,
        glb=t["glb"], rel_diag=t["diag"], rel_full=t["full"],
    )


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=1e-5, atol=1e-5 * np.abs(want).max()
    )


WORLDS = [
    pytest.param(dict(n_r=97, n_c=97, n_rel=23, d=32, shape=(1000,)), id="square"),
    pytest.param(dict(n_r=50, n_c=80, n_rel=7, d=16, shape=(3, 256)), id="rect-chunked"),
]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", NAMES)
def test_sddmm_plain_matches_interpret_kernel(name, world):
    w = _world(0, **world)
    want = sddmm_pallas_edges(
        jnp.asarray(w["z_r"]), jnp.asarray(w["z_c"]), jnp.asarray(w["ks"]),
        jnp.asarray(w["rows"]), jnp.asarray(w["cols"]), name=name,
        glb=jnp.asarray(w["glb"]), rel_diag=jnp.asarray(w["diag"]),
        rel_full=jnp.asarray(w["full"]), interpret=True,
    )
    got = _port(w, name)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.numpy(), want)


@pytest.mark.parametrize("name", NAMES)
def test_sddmm_plain_matches_sddmm_pairs(name):
    w = _world(1, n_r=40, n_c=60, n_rel=5, d=32, shape=(500,))
    zr, zc = w["z_r"][w["rows"]], w["z_c"][w["cols"]]
    factors = {
        "innerproduct": {},
        "distmult": {"glb_diag": w["diag"][w["ks"]]},
        "dedicom": {"glb": w["glb"], "loc_diag": w["diag"][w["ks"]]},
        "bilinear": {"glb": w["full"][w["ks"]]},
    }[name]
    want = jax_pairs(
        jnp.asarray(zr), jnp.asarray(zc),
        **{k: jnp.asarray(v) for k, v in factors.items()},
    )
    _close(_port(w, name).numpy(), want)
    # the port's own sddmm_pairs on the same gathered factors
    _close(
        sddmm_pairs(
            torch.from_numpy(zr), torch.from_numpy(zc),
            **{k: torch.from_numpy(v) for k, v in factors.items()},
        ).numpy(),
        want,
    )


@pytest.mark.parametrize("name", NAMES)
def test_sddmm_plain_default_matches_interpret_kernel(name):
    """The bf16 ``"default"`` variant: the JAX kernel in interpret mode
    and the port's plain version (what ``sddmm_edges`` runs for CPU
    tensors), and both within 1e-2 of the largest ``"highest"`` score."""
    w = _world(5, n_r=97, n_c=80, n_rel=23, d=32, shape=(1000,))
    want = sddmm_pallas_edges(
        jnp.asarray(w["z_r"]), jnp.asarray(w["z_c"]), jnp.asarray(w["ks"]),
        jnp.asarray(w["rows"]), jnp.asarray(w["cols"]), name=name,
        glb=jnp.asarray(w["glb"]), rel_diag=jnp.asarray(w["diag"]),
        rel_full=jnp.asarray(w["full"]), interpret=True, precision="default",
    )
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    got = sddmm_edges(
        t["z_r"], t["z_c"], t["ks"], t["rows"], t["cols"], name=name,
        glb=t["glb"], rel_diag=t["diag"], rel_full=t["full"], precision="default",
    )
    _close(got.numpy(), want)
    highest = _port(w, name).numpy()
    assert np.abs(got.numpy() - highest).max() <= 1e-2 * np.abs(highest).max()
    assert np.abs(got.numpy() - highest).max() > 0


def test_sddmm_rejects_unported_options():
    """``sddmm_precision="default"`` is ported now: ``make_emb_scores``
    builds with it; what still raises is an unknown decoder or precision
    and an unported ``sddmm_impl``."""
    w = _world(2, n_r=10, n_c=10, n_rel=2, d=8, shape=(4,))
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    args = (t["z_r"], t["z_c"], t["ks"], t["rows"], t["cols"])
    model = SimpleNamespace(
        config=ModelConfig(sddmm_precision="default"),
        graph_meta=SimpleNamespace(decoder_name=lambda et: "dedicom"),
    )
    assert make_emb_scores(model, (1, 1)) is not None
    model.config = ModelConfig(sddmm_impl="pallas")
    with pytest.raises(NotImplementedError):
        make_emb_scores(model, (1, 1))
    with pytest.raises(ValueError):
        sddmm_edges(*args, name="transe")
    with pytest.raises(ValueError):
        sddmm_edges(*args, name="dedicom", glb=t["glb"], rel_diag=t["diag"], precision="fast")
    with pytest.raises(ValueError):
        ModelConfig(sddmm_precision="fast")
