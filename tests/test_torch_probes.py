"""The port's paired-kernel probes (P1-P5) against the JAX probes on the CPU.

Each port probe's wrapper, given CPU tensors, runs its plain version; it is
held against the JAX probe's own Pallas kernel in interpret mode, on the
same numpy draws.  The JAX scripts are not a package: they are loaded by
path under a fresh module name per test, their sizes patched with
``monkeypatch`` and their ``timeit`` replaced by a single call, so that
they return their kernels' outputs.  The CUDA kernels are held against the
same plain versions on the card in ``test_torch_cuda.py``.

Tolerances:

- P5 (``probe_int8_bw``): equal bits.  Both sum small integers, exact in
  f32 in any order.
- P3, P2 and P1 (``probe_paired_parts``, ``probe_paired_orient``,
  ``probe_paired_idioms``): max error <= 1e-5 of the largest output.  The
  operands are bf16, the mask converts to bf16 exactly and the products
  are exact in f32; only the order of the f32 sums differs.
- P4 (``probe_paired_bwd_idioms``): elementwise ``2^-7 |want| + 1e-4
  max|want|``.  Both round ``a * ct`` to bf16 before the products and the
  outputs to bf16 after f32 sums taken in other orders, which can flip an
  output to its neighbouring bf16 value (one ulp, at most 2^-7 of it).
"""

import importlib.util
import itertools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts import (
    probe_int8_bw,
    probe_paired_bwd_idioms,
    probe_paired_idioms,
    probe_paired_orient,
    probe_paired_parts,
    probing,
)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
_COUNT = itertools.count()


def _load(monkeypatch, name):
    """The JAX script ``scripts/<name>.py`` as a module of its own.

    Some scripts put a fixed checkout path first on ``sys.path`` and then
    import ``decagon_tpu.timing``: that module is imported from this
    checkout beforehand, so the script's import finds it cached, and
    ``sys.path`` is restored when the test ends.
    """
    importlib.import_module("decagon_tpu.timing")
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(f"_jax_{name}_{next(_COUNT)}",
                                                  SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert Path(sys.modules["decagon_tpu.timing"].__file__).is_relative_to(SCRIPTS.parent)
    return module


def _one_call(f, *a, reps=10):
    return f(*a)


@pytest.fixture
def no_launch():
    """CPU tensors must run the plain versions: no kernel launch."""
    before = dict(cuda_build.LAUNCHES)
    yield
    assert cuda_build.LAUNCHES == before


def _hold_rel(got, want, tol=probing.REL_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err / max(np.abs(want).max(), 1e-30)


# P5 -------------------------------------------------------------------------

P5_CASES = [
    # (stack, kb, conv): K = 9 relations of [37, 45] (no row is a multiple
    # of 16 bytes); kb 2 and 4 leave relations out, 8 leaves one.
    ("int8", 2, False), ("int8", 4, False), ("int8", 8, False),
    ("int8", 8, True), ("int8", 4, True),
    ("bf16", 2, False), ("bf16", 8, False),
    ("int8pad", 2, False), ("int8pad", 8, False),
]


@pytest.mark.parametrize("stack,kb,conv", P5_CASES)
def test_int8_bw_matches_jax_probe(monkeypatch, no_launch, stack, kb, conv):
    mod = _load(monkeypatch, "probe_int8_bw")
    monkeypatch.setattr(mod, "timeit", _one_call)
    rng = np.random.default_rng(kb)
    m8 = (rng.random((9, 37, 45)) < 0.3).astype(np.int8)
    m8[0, 0, :3] = (2, -3, 127)
    x = torch.from_numpy(m8)
    if stack == "bf16":
        x = x.to(torch.bfloat16)
    elif stack == "int8pad":
        x = probe_int8_bw.padded(x, (48, 64))
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) if stack == "bf16" \
        else jnp.asarray(x.numpy())
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(mod.pallas_sum(xj, kb, conv=conv))
    got = probe_int8_bw.pallas_sum(x, kb, conv).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (1, x.shape[2])
    np.testing.assert_array_equal(got, want)


def test_int8_bw_variants_follow_the_tpu_sweep():
    m8 = probe_int8_bw.make_stack("cpu", shape=(9, 37, 45))
    vs = probe_int8_bw.variants(m8, m8.to(torch.bfloat16), probe_int8_bw.padded(m8, (48, 64)))
    assert [v.key for v in vs] == [
        "sum_int8_kb2", "sum_int8_kb8", "sum_int8conv_kb8", "sum_bf16_kb2", "sum_bf16_kb8",
        "sum_int8pad_kb2", "sum_int8pad_kb8"]
    assert all(v.hold == probing.EQUAL for v in vs)
    # kb 8 of K = 9 reads 8 relations; the library call (torch.sum over
    # every relation) stands beside kb 2 only.
    assert vs[1].nbytes == 8 * 37 * 45 + 45 * 4
    assert [v.library is not None for v in vs] == [True, False, False, True, False, False, False]
    for v in vs:
        np.testing.assert_array_equal(v.kernel().numpy(), v.plain().numpy())


# P3 -------------------------------------------------------------------------

P3_SIZES = dict(K=9, N=70, H=16, KPAD=10)


def _p3_inputs(k, n, h, kpad):
    """``probe_paired_parts.run``'s own draws."""
    rng = np.random.default_rng(0)
    mask = (rng.random((kpad, n, n)) < 0.01).astype(np.int8)
    p4 = torch.from_numpy(rng.standard_normal((2, k, h, n)).astype(np.float32))
    return torch.from_numpy(mask), p4.to(torch.bfloat16)


@pytest.mark.parametrize("kb", [2, 4, 8])
@pytest.mark.parametrize("mode", probe_paired_parts.MODES)
def test_paired_parts_matches_jax_probe(monkeypatch, no_launch, mode, kb):
    mod = _load(monkeypatch, "probe_paired_parts")
    monkeypatch.setattr(mod, "timeit", _one_call)
    for name, value in P3_SIZES.items():
        monkeypatch.setattr(mod, name, value)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(mod.run(mode, kb))
    mask, p4 = _p3_inputs(*P3_SIZES.values())
    got = probe_paired_parts.paired_parts(mask, p4, mode, kb).numpy()
    if mode == "dma_only":
        assert not got.any() and not want.any()
    _hold_rel(got, want)


# P2 -------------------------------------------------------------------------


def _p2_call(mod, mode, kb, mask, p4, sc, k):
    """The JAX probe's kernel ``make_kernel(mode, kb)`` through its own
    ``pl.pallas_call`` specs, in interpret mode."""
    n, h = mask.shape[1], p4.shape[2]
    return np.asarray(pl.pallas_call(
        mod.make_kernel(mode, kb),
        grid=(-(-k // kb),),
        in_specs=[
            pl.BlockSpec((kb, n, n), lambda i: (i, 0, 0)),
            pl.BlockSpec((2, kb, h, n), lambda i: (0, i, 0, 0)),
            pl.BlockSpec((kb, 2, n), lambda i: (i, 0, 0)),
        ],
        out_specs=pl.BlockSpec((h, n), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((h, n), jnp.float32),
        interpret=True,
    )(mask, p4, sc))


P2_CASES = [(mode, "int8") for mode in probe_paired_orient.MODES] + \
    [(mode, "bf16") for mode in probe_paired_orient.BF16_MODES]


@pytest.mark.parametrize("kb", [2, 4, 8])
@pytest.mark.parametrize("mode,mask_dtype", P2_CASES)
def test_paired_orient_matches_jax_probe(monkeypatch, no_launch, mode, mask_dtype, kb):
    mod = _load(monkeypatch, "probe_paired_orient")
    k, kpad, n, h = 9, 10, 70, 16
    monkeypatch.setattr(mod, "K", k)
    rng = np.random.default_rng(kb)
    mask = (rng.random((kpad, n, n)) < 0.05).astype(np.int8)
    mask[0, 1, :2] = (2, 3)
    p4 = rng.standard_normal((2, k, h, n)).astype(np.float32)
    sc = rng.random((kpad, 2, n)).astype(np.float32)
    mask_j = jnp.asarray(mask)
    mask_t = torch.from_numpy(mask)
    if mask_dtype == "bf16":
        mask_j, mask_t = mask_j.astype(jnp.bfloat16), mask_t.to(torch.bfloat16)
    want = _p2_call(mod, mode, kb, mask_j, jnp.asarray(p4).astype(jnp.bfloat16),
                    jnp.asarray(sc), k)
    got = probe_paired_orient.paired_orient(
        mask_t, torch.from_numpy(p4).to(torch.bfloat16), torch.from_numpy(sc), mode, kb)
    _hold_rel(got.numpy(), want)


@pytest.mark.parametrize("mode", ["xe_only", "xo_only"])
def test_paired_orient_bf16_mask_takes_whole_modes(mode):
    mask, p4 = _p3_inputs(3, 20, 8, 3)
    sc = probe_paired_orient.make_scales("cpu", kpad=3, n=20)
    with pytest.raises(ValueError, match="bf16 mask"):
        probe_paired_orient.paired_orient(mask.to(torch.bfloat16), p4, sc, mode)


def test_paired_orient_small_t_is_both():
    mask, p4 = _p3_inputs(5, 40, 8, 6)
    sc = probe_paired_orient.make_scales("cpu", kpad=6, n=40)
    both = probe_paired_orient.paired_orient_ref(mask, p4, sc, "both")
    assert torch.equal(probe_paired_orient.paired_orient_ref(mask, p4, sc, "small_t"), both)
    halves = sum(probe_paired_orient.paired_orient_ref(mask, p4, sc, m)
                 for m in ("xe_only", "xo_only"))
    _hold_rel(halves.numpy(), both.numpy())


# P4 -------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_paired_bwd_idioms_matches_jax_probe(monkeypatch, no_launch, seed):
    mod = _load(monkeypatch, "probe_paired_bwd_idioms")
    mask, ct, sc = probe_paired_bwd_idioms.numpy_inputs(seed=seed)
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(w.astype(jnp.float32))
                for w in mod.paired_bwd(jnp.asarray(mask), jnp.asarray(ct.T), jnp.asarray(sc))]
    got = probe_paired_bwd_idioms.paired_bwd(
        torch.from_numpy(mask), torch.from_numpy(ct.T.copy()), torch.from_numpy(sc))
    assert all(g.dtype == torch.bfloat16 and tuple(g.shape) == (4, 64, 645) for g in got)
    got = [g.float().numpy() for g in got]
    for g, w in zip(got, want):
        assert (np.abs(g - w) <= probing.BF16_ULP * np.abs(w)
                + probing.BF16_FLOOR * np.abs(w).max()).all()
    assert probe_paired_bwd_idioms.oracle_error(mask, ct, sc, *got) < 2e-2


# P1 -------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_paired_idioms_matches_jax_probe(monkeypatch, no_launch, seed):
    mod = _load(monkeypatch, "probe_paired_idioms")
    mask, pe, po, ae, ao, pe_aug, po_aug = probe_paired_idioms.numpy_inputs(seed=seed)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(mod.paired(jnp.asarray(mask), jnp.asarray(pe_aug, jnp.bfloat16),
                                     jnp.asarray(po_aug, jnp.bfloat16)))
    got = probe_paired_idioms.paired(
        torch.from_numpy(mask), torch.from_numpy(pe_aug).to(torch.bfloat16),
        torch.from_numpy(po_aug).to(torch.bfloat16)).numpy()
    assert got.shape == (645, 128) and not got[:, 64:].any()
    _hold_rel(got, want)
    assert probe_paired_idioms.oracle_error(mask, pe, po, ae, ao, got) < 2e-2


# The wrappers and entry points ----------------------------------------------


# P5's cut of the stream (``column_sum_plan``): every element of the used
# relations is read once and none past them, on the card's grid (132 SMs x
# 2 or 3 blocks) and on others; the sums emulated in the kernel's order
# (tile positions, folded into columns in order, then the two-level combine
# in block and group order) equal the plain version.

PLAN_CASES = [
    # (shape, kb, element bytes, blocks): the JAX probe's shapes, int8 and
    # bf16, kb 2 and 8, and the padded stack ...
    ((964, 645, 645), 2, 1, 264), ((964, 645, 645), 8, 1, 264),
    ((964, 645, 645), 2, 2, 396), ((964, 645, 645), 8, 2, 396),
    ((964, 672, 768), 2, 1, 264), ((964, 672, 768), 8, 1, 264),
    ((964, 645, 645), 2, 1, 528),
    # ... ragged ones, rows of 768, and streams shorter than a tile a block.
    ((9, 37, 45), 2, 1, 7), ((9, 37, 45), 8, 2, 5), ((9, 37, 45), 1, 1, 264),
    ((11, 71, 131), 3, 1, 16), ((11, 71, 131), 1, 2, 33),
    ((5, 40, 768), 2, 1, 9), ((5, 40, 768), 1, 2, 396),
    ((3, 645, 645), 2, 1, 264), ((3, 672, 768), 1, 2, 17),
    ((2, 3, 20), 1, 1, 264), ((2, 3, 20), 2, 2, 1), ((1, 1, 1), 1, 1, 3),
]


def _plan(shape, kb, elem_bytes, blocks):
    k, n1, n2 = shape
    return probe_int8_bw.column_sum_plan(kb * (k // kb), n1 * n2, n2, elem_bytes, blocks)


@pytest.mark.parametrize("shape,kb,elem_bytes,blocks", PLAN_CASES)
def test_int8_bw_plan_covers_the_used_relations_once(shape, kb, elem_bytes, blocks):
    k, n1, n2 = shape
    plan = _plan(shape, kb, elem_bytes, blocks)
    tiles = plan.whole + (plan.ragged > 0)
    assert plan.vector * elem_bytes == 16 and plan.tile == n2 * plan.vector
    assert plan.total == kb * (k // kb) * n1 * n2
    assert plan.whole * plan.tile + plan.ragged == plan.total and 0 <= plan.ragged < plan.tile
    # The blocks' tiles cut [0, tiles) once, in counts that differ by at
    # most one; the partial tile is its block's last.
    seen = np.zeros(tiles, np.int64)
    counts = []
    for b in range(blocks):
        mine = np.asarray(plan.tiles_of(b), np.int64)
        seen[mine] += 1
        counts.append(mine.size)
    assert (seen == 1).all() and max(counts) - min(counts) <= 1
    if plan.ragged:
        assert list(plan.tiles_of(plan.whole % blocks))[-1] == plan.whole
    # A tile is a whole number of rows, so position m of every tile lies
    # in column m % n2; vector t of a tile holds positions [t V, (t + 1) V).
    assert plan.tile % n2 == 0 and (n1 * n2) % n2 == 0
    starts = np.arange(n2) * plan.vector
    assert starts[0] == 0 and starts[-1] + plan.vector == plan.tile
    # Two levels: groups of ceil(sqrt(blocks)), neither over that many rows.
    assert plan.group ** 2 >= blocks > (plan.group - 1) ** 2
    assert plan.groups == -(-blocks // plan.group) <= plan.group


def _emulate_sums(flat, n2, plan):
    """The kernel's arithmetic on the flat stream: each block's sums at the
    tile's positions (zeros past the end), folded into columns in order,
    then the groups' rows in block order and out in group order."""
    rows = []
    for b in range(plan.blocks):
        pos = np.zeros(plan.tile, np.float32)
        for g in plan.tiles_of(b):
            piece = flat[g * plan.tile:(g + 1) * plan.tile]
            assert g == plan.whole or piece.size == plan.tile
            pos[:piece.size] += piece
        fold = np.zeros(n2, np.float32)
        for r in range(plan.vector):
            fold += pos[r * n2:(r + 1) * n2]
        rows.append(fold)
    group_rows = []
    for j in range(plan.groups):
        acc = np.zeros(n2, np.float32)
        for row in rows[j * plan.group:(j + 1) * plan.group]:
            acc += row
        group_rows.append(acc)
    out = np.zeros(n2, np.float32)
    for row in group_rows:
        out += row
    return out.reshape(1, n2)


@pytest.mark.parametrize("shape,kb,elem_bytes,blocks",
                         [c for c in PLAN_CASES if c[0][0] * c[0][1] * c[0][2] < 2 * 10 ** 6])
def test_int8_bw_plan_sums_equal_the_plain_version(no_launch, shape, kb, elem_bytes, blocks):
    k, n1, n2 = shape
    rng = np.random.default_rng(k * n2 + kb)
    m8 = rng.integers(-128, 128, size=shape, dtype=np.int8)
    x = torch.from_numpy(m8)
    if elem_bytes == 2:
        x = x.to(torch.bfloat16)
    plan = _plan(shape, kb, elem_bytes, blocks)
    flat = x.float().reshape(-1).numpy()
    # Every element of the used relations once, none past them.
    seen = np.zeros(flat.size, np.int64)
    for b in range(blocks):
        for g in plan.tiles_of(b):
            seen[g * plan.tile:min((g + 1) * plan.tile, plan.total)] += 1
    assert (seen[:plan.total] == 1).all() and (seen[plan.total:] == 0).all()
    want = probe_int8_bw.pallas_sum_ref(x, kb).numpy()
    np.testing.assert_array_equal(_emulate_sums(flat[:plan.total], n2, plan), want)


@pytest.mark.parametrize("args", [(0, 45, 45, 1, 8), (2, 46, 45, 1, 8), (2, 900, 900, 1, 8),
                                  (2, 45, 45, 4, 8), (2, 45, 45, 1, 0)])
def test_int8_bw_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        probe_int8_bw.column_sum_plan(*args)


def _meta_calls():
    m = torch.empty((3, 20, 20), dtype=torch.int8, device="meta")
    p4 = torch.empty((2, 3, 8, 20), dtype=torch.bfloat16, device="meta")
    sc = torch.empty((3, 2, 20), device="meta")
    aug = torch.empty((3, 20, 128), dtype=torch.bfloat16, device="meta")
    ct = torch.empty((8, 20), device="meta")
    return {
        "int8_bw": lambda: probe_int8_bw.pallas_sum(m, 2),
        "parts": lambda: probe_paired_parts.paired_parts(m, p4, "two_dots"),
        "orient": lambda: probe_paired_orient.paired_orient(m, p4, sc),
        "bwd_idioms": lambda: probe_paired_bwd_idioms.paired_bwd(m, ct, sc),
        "idioms": lambda: probe_paired_idioms.paired(m, aug, aug),
    }


@pytest.mark.parametrize("probe", sorted(_meta_calls()))
def test_wrappers_take_only_cpu_or_cuda(probe):
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        _meta_calls()[probe]()


@pytest.mark.parametrize("module", [probe_int8_bw, probe_paired_parts, probe_paired_orient,
                                    probe_paired_bwd_idioms, probe_paired_idioms],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_probe_main_needs_a_card(monkeypatch, capsys, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert module.main() != 0
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("mode", probe_paired_parts.MODES)
def test_paired_parts_bytes_and_operations(mode):
    mask = torch.zeros((964, 645, 645), dtype=torch.int8, device="meta")
    p4 = torch.zeros((2, 963, 64, 645), dtype=torch.bfloat16, device="meta")
    nbytes, flops = probe_paired_parts.part_bytes_flops(mask, p4, mode)
    halves = 1 if mode == "one_dot" else 2
    assert nbytes == 963 * 645 ** 2 + halves * 963 * 64 * 645 * 2 + 64 * 645 * 4
    assert flops == {"dma_only": 0, "one_dot": 1}.get(mode, 2) * 2 * 64 * 645 ** 2 * 963
