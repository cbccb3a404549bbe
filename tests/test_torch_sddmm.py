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
    """``sddmm_precision="default"`` is ported: ``make_emb_scores`` builds
    with it; what raises is an unknown decoder or precision, and, as in
    the JAX package off its accelerator, ``sddmm_impl="pallas"`` where the
    embeddings are not on the card (``ValueError``; this test once
    expected ``NotImplementedError``, before "pallas" was ported)."""
    w = _world(2, n_r=10, n_c=10, n_rel=2, d=8, shape=(4,))
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    args = (t["z_r"], t["z_c"], t["ks"], t["rows"], t["cols"])
    model = SimpleNamespace(
        config=ModelConfig(sddmm_precision="default"),
        graph_meta=SimpleNamespace(decoder_name=lambda et: "dedicom"),
    )
    assert make_emb_scores(model, (1, 1)) is not None
    model.config = ModelConfig(sddmm_impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        make_emb_scores(model, (1, 1), device="cpu")
    with pytest.raises(ValueError):
        sddmm_edges(*args, name="transe")
    with pytest.raises(ValueError):
        sddmm_edges(*args, name="dedicom", glb=t["glb"], rel_diag=t["diag"], precision="fast")
    with pytest.raises(ValueError):
        ModelConfig(sddmm_precision="fast")


def _scorer_model(**kw):
    return SimpleNamespace(
        config=ModelConfig(**kw),
        graph_meta=SimpleNamespace(decoder_name=lambda et: "dedicom"),
    )


def _dedicom_params(w):
    return {"dec": {"1,1": {"global": torch.from_numpy(w["glb"]),
                            "local_diag": torch.from_numpy(w["diag"])}}}


def test_sddmm_impl_pallas_raises_off_the_card():
    """"pallas" forces the kernel: with no device named at build time the
    scorer builds and raises ``ValueError`` at its first call on CPU
    tensors, naming "auto" and "jnp", as the JAX package raises off its
    accelerator; "auto" and "jnp" score the same inputs on the CPU."""
    w = _world(6, n_r=12, n_c=12, n_rel=3, d=8, shape=(5,))
    params = _dedicom_params(w)
    emb = {"1": torch.from_numpy(w["z_r"])}
    idx = [torch.from_numpy(w[k]) for k in ("ks", "rows", "cols")]
    scores = make_emb_scores(_scorer_model(sddmm_impl="pallas"), (1, 1))
    with pytest.raises(ValueError, match="'auto' or 'jnp'"):
        scores(params, emb, *idx)
    with pytest.raises(ValueError, match="128"):
        make_emb_scores(_scorer_model(sddmm_impl="pallas", hidden2=129), (1, 1))
    auto = make_emb_scores(_scorer_model(sddmm_impl="auto"), (1, 1))(params, emb, *idx)
    jnp_ = make_emb_scores(_scorer_model(sddmm_impl="jnp"), (1, 1))(params, emb, *idx)
    np.testing.assert_allclose(auto.numpy(), jnp_.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_sddmm_impl_pallas_interpret_names_jnp(device):
    """The JAX package's interpret mode has no counterpart in the port: the
    scorer raises when it is built, on any device, and names "jnp" (as the
    spmm interpret modes name their ``_ref`` impls); an unknown value
    raises too."""
    with pytest.raises(ValueError, match="'jnp'"):
        make_emb_scores(_scorer_model(sddmm_impl="pallas_interpret"), (1, 1), device=device)
    with pytest.raises(ValueError, match="sddmm_impl"):
        make_emb_scores(_scorer_model(sddmm_impl="fast"), (1, 1), device=device)


@pytest.mark.parametrize("name", NAMES)
def test_emb_scores_default_casts_tables_once(name, monkeypatch):
    """At ``sddmm_precision="default"`` the scorer casts its tables to bf16
    once a scoring pass (K5-bf16 reads bf16 tables) and hands the same
    tensors to every chunk; the scores keep their input order and equal,
    bit for bit, the plain version's on the f32 tables, which rounds them
    to the same values."""
    from decagon_tpu_torch.ops.sddmm_pallas import sddmm_plain
    from decagon_tpu_torch.train import step

    w = _world(8, n_r=40, n_c=40, n_rel=5, d=16, shape=(3, 64))
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    params = {"dec": {"1,1": {"global": t["glb"], "local_diag": t["diag"],
                              "relation_diag": t["diag"], "relation": t["full"]}}}
    seen = []

    def recording(*args, **kw):
        seen.append([args[0], args[1]] + [kw[k] for k in ("glb", "rel_diag", "rel_full")])
        return sddmm_edges(*args, **kw)

    monkeypatch.setattr(step, "sddmm_edges", recording)
    model = SimpleNamespace(config=ModelConfig(hidden2=16, sddmm_precision="default"),
                            graph_meta=SimpleNamespace(decoder_name=lambda et: name))
    got = make_emb_scores(model, (1, 1))(params, {"1": t["z_r"]}, t["ks"], t["rows"], t["cols"])
    assert len(seen) == 3
    for call in seen:
        assert all(a is b for a, b in zip(call, seen[0]))
        assert all(x.dtype == torch.bfloat16 for x in call if x is not None)
    want = torch.sigmoid(sddmm_plain(
        t["z_r"], t["z_r"], t["ks"], t["rows"], t["cols"], name=name, glb=t["glb"],
        rel_diag=t["diag"], rel_full=t["full"] if name == "bilinear" else None,
        precision="default"))
    assert torch.equal(got, want)
