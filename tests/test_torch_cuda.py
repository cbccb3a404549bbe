"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip without a CUDA device (decided in the fixture,
when a test runs, so every test-runner worker collects the same tests).
This file imports neither JAX nor the JAX package, so it also runs on the
card's machine, which has neither:

    python3 -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances.  Paired forward and backward: kernel and plain version round
the same operands to bf16 and the products are exact, so only the f32 sums
differ (tensor-core accumulation and order): error <= 1e-4 of the largest
output.  A bf16 backward output may then round to the neighbouring bf16
value, one bf16 ulp (at most 2^-7 of the value), so it is held to
``2^-7 |want| + 1e-4 max|want|`` elementwise.  Scorer: f32 throughout,
order only: ``rtol=1e-5`` with an absolute floor of 1e-5 of the largest
score; at ``"default"`` (K5-bf16) kernel and plain version round the same
tables to bf16 and the products of bf16 values are exact, so the same
bound holds.  Tiled SpMM (K6): kernel and plain version apply the same
roundings and both sum in f32, the kernel in segment order and the plain
``index_add_`` in its own, so the error is held to 1e-5 of the largest
output at both precisions; two kernel calls are bitwise equal.  One-pass
Adam: the kernel rounds every operation on its own in the
plain chain's order, so m, v and p must equal ``adam_onepass_ref``'s bit
for bit.  Probes: P5's column sums are small integers, exact in f32, so
equal bits; P3, P2 and P1 sum exact bf16 products in f32 in another order
than their plain versions, so <= 1e-5 of the largest output; P4 rounds
its outputs to bf16 after such sums, so the paired backward's bf16 rule
(``2^-7 |want| + 1e-4 max|want|``); two calls of each are bitwise equal.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.ops.spmm_paired import (
    _PairedApply,
    _PairedApplyDs,
    kernel_info,
    launch_schedule,
    paired_bwd,
    paired_bwd_ref,
    paired_fwd,
    paired_ref,
    paired_ref_ds,
)
from decagon_tpu_torch.ops import optim
from decagon_tpu_torch.ops.optim import adam_onepass, adam_onepass_ref
from decagon_tpu_torch.ops.sddmm_pallas import sddmm_edges, sddmm_plain
from decagon_tpu_torch.ops.spmm_pallas import (
    _SpmmTiled,
    launch_plan,
    spmm_tiled,
    spmm_tiled_ref,
)
from decagon_tpu_torch.ops.tiling import SEGMENT, build_tiles
from tests.torch_k6_order import spmm_tiled_ordered
from decagon_tpu_torch.scripts import (
    probe_int8_bw,
    probe_paired_bwd_idioms,
    probe_paired_idioms,
    probe_paired_orient,
    probe_paired_parts,
    probe_paired_sweep,
    probing,
)

pytestmark = pytest.mark.cuda

NAMES = ["innerproduct", "distmult", "dedicom", "bilinear"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "k,n,h", [(5, 130, 32), (3, 645, 64), (40, 70, 64), (1, 1500, 32)]
)
def test_paired_kernel_matches_plain(cuda_device, dtype, k, n, h):
    g = torch.Generator().manual_seed(k * n + h)
    mask = (torch.rand((k, n, n), generator=g) < 0.05).to(torch.int8)
    mask[0, 0, 0] = 2
    scales = torch.rand((k, 4, n), generator=g)
    p4 = torch.randn((2, k, h, n), generator=g).to(dtype)
    m, s, p = (t.to(cuda_device) for t in (mask, scales, p4))
    before = cuda_build.LAUNCHES["paired_fwd"]
    got = paired_fwd(p, m, s)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["paired_fwd"] == before + 1
    want = paired_ref(p, m, s)
    assert tuple(got.shape) == (h, n)
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err <= 1e-4


def test_paired_kernel_rejects_unsupported_width(cuda_device):
    """Every hidden width runs now (64-column slices, a partial fragment
    zero-padded); what the wrappers still refuse is a shape or dtype the
    kernels do not take."""
    p = torch.zeros((2, 1, 24, 10), device=cuda_device)
    m = torch.zeros((1, 10, 10), dtype=torch.int8, device=cuda_device)
    s = torch.zeros((1, 4, 10), device=cuda_device)
    assert tuple(paired_fwd(p, m, s).shape) == (24, 10)
    with pytest.raises(TypeError):
        paired_fwd(p.half(), m, s)
    with pytest.raises(ValueError):
        paired_fwd(p, m[:, :, :9].contiguous(), s)
    with pytest.raises(ValueError):
        paired_bwd(torch.zeros((24, 10), device=cuda_device), m, s[:, :2].contiguous(),
                   None, torch.float32)


# (K, N, H): N not a multiple of 16, every H a multiple of 16 up to 128 and
# one that is not, K = 1 and K > 1 at N > 4096 (the JAX big-N form).
SHAPES = [
    (5, 130, 16), (3, 645, 32), (40, 70, 48), (2, 100, 64), (3, 77, 128),
    (4, 50, 24), (1, 4500, 64), (2, 4200, 32),
]


def _paired_world(k, n, h, device, seed=0):
    g = torch.Generator().manual_seed(seed + k * n + h)
    mask = (torch.rand((k, n, n), generator=g) < 0.05).to(torch.int8)
    mask[0, 0, 0] = 2
    scales = torch.rand((k, 4, n), generator=g)
    keep = torch.rand((k, 2, n), generator=g) < 0.9
    ds = torch.where(keep, 1.0 / 0.9, 0.0).float()
    p4 = torch.randn((2, k, h, n), generator=g)
    ct = torch.randn((h, n), generator=g)
    return tuple(t.to(device) for t in (mask, scales, ds, p4, ct))


def _hold(got, want, bf16=False):
    got, want = got.float(), want.float()
    top = want.abs().max().item()
    bound = 1e-4 * top + (2.0 ** -7 * want.abs() if bf16 else 0.0)
    assert bool(((got - want).abs() <= bound).all()), (got - want).abs().max().item() / top


@pytest.mark.parametrize("k,n,h", SHAPES)
def test_paired_ds_kernel_matches_plain(cuda_device, k, n, h):
    mask, scales, ds, p4, _ = _paired_world(k, n, h, cuda_device)
    got = paired_fwd(p4, mask, scales, ds)
    want = paired_ref_ds(p4, mask, scales, ds)
    assert tuple(got.shape) == (h, n)
    _hold(got, want)
    _hold(paired_fwd(p4, mask, scales), paired_ref(p4, mask, scales))


@pytest.mark.parametrize("with_ds", [False, True], ids=["no_ds", "ds"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k,n,h", SHAPES)
def test_paired_bwd_kernel_matches_plain(cuda_device, k, n, h, out_dtype, with_ds):
    mask, scales, ds, _, ct = _paired_world(k, n, h, cuda_device)
    ds = ds if with_ds else None
    before = cuda_build.LAUNCHES["paired_bwd"]
    got = paired_bwd(ct, mask, scales, ds, out_dtype)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["paired_bwd"] == before + 1
    want = paired_bwd_ref(ct, mask, scales, ds, torch.float32)
    assert got.dtype == out_dtype and tuple(got.shape) == (2, k, h, n)
    _hold(got, want, bf16=out_dtype == torch.bfloat16)


@pytest.mark.parametrize("k,n,h", [(7, 645, 64), (2, 4200, 32)])
def test_paired_bwd_kernel_is_deterministic(cuda_device, k, n, h):
    mask, scales, ds, _, ct = _paired_world(k, n, h, cuda_device, seed=1)
    for d, dt in ((ds, torch.float32), (None, torch.bfloat16)):
        a = paired_bwd(ct, mask, scales, d, dt)
        b = paired_bwd(ct, mask, scales, d, dt)
        assert torch.equal(a, b)


@pytest.mark.parametrize("with_ds", [False, True], ids=["no_ds", "ds"])
def test_paired_autograd_kernel_matches_plain(cuda_device, with_ds):
    """Through the autograd Functions: the kernel path's gradient against
    the plain formula with the kernel's cast points."""
    mask, scales, ds, p4, ct = _paired_world(6, 200, 32, cuda_device, seed=2)
    p = p4.clone().requires_grad_(True)
    if with_ds:
        out = _PairedApplyDs.apply(p, mask, scales, ds, True)
    else:
        out = _PairedApply.apply(p, mask, scales, True)
    out.backward(ct)
    _hold(p.grad, paired_bwd_ref(ct, mask, scales, ds if with_ds else None, torch.float32))


# The redesigned paired kernels (shared sweep, ``paired_schedule``): N not a
# multiple of 16 and N < 64, H = 16, 48, 64 and 96, K = 1 at N >= 4096
# (the contraction split), K = 963; bf16 and f32 operands, with and
# without keep-scales; two calls bitwise equal.
REDESIGN = [(3, 50, 16), (2, 37, 48), (5, 130, 64), (4, 77, 96), (1, 4500, 64),
            (963, 100, 32), (963, 70, 64)]
FWD_MODES = [(torch.float32, False), (torch.bfloat16, False), (torch.float32, True)]


@pytest.mark.parametrize("dtype,with_ds", FWD_MODES, ids=["f32", "bf16", "f32_ds"])
@pytest.mark.parametrize("k,n,h", REDESIGN)
def test_paired_fwd_redesign_matches_plain_and_repeats(cuda_device, k, n, h, dtype, with_ds):
    mask, scales, ds, p4, _ = _paired_world(k, n, h, cuda_device, seed=3)
    p4 = p4.to(dtype)
    ds = ds if with_ds else None
    got = paired_fwd(p4, mask, scales, ds)
    again = paired_fwd(p4, mask, scales, ds)
    want = paired_ref_ds(p4, mask, scales, ds) if with_ds else paired_ref(p4, mask, scales)
    assert torch.equal(got, again)
    _hold(got, want)


@pytest.mark.parametrize("with_ds", [False, True], ids=["no_ds", "ds"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k,n,h", REDESIGN)
def test_paired_bwd_redesign_matches_plain_and_repeats(cuda_device, k, n, h, out_dtype,
                                                       with_ds):
    mask, scales, ds, _, ct = _paired_world(k, n, h, cuda_device, seed=4)
    ds = ds if with_ds else None
    got = paired_bwd(ct, mask, scales, ds, out_dtype)
    again = paired_bwd(ct, mask, scales, ds, out_dtype)
    assert torch.equal(got, again)
    _hold(got, paired_bwd_ref(ct, mask, scales, ds, torch.float32),
          bf16=out_dtype == torch.bfloat16)


def test_paired_schedule_splits_the_contraction_on_the_card(cuda_device):
    """At K = 1 and N >= 4096 the card's schedule splits the contraction,
    and the kernels report at least two blocks an SM without spills."""
    for which in ("fwd", "bwd"):
        info = kernel_info(which, cuda_device.index or 0)
        assert info["blocks_per_sm"] >= 2 and info["local_bytes"] == 0, info
        assert launch_schedule(which, 1, 4500, 64, cuda_device).con_splits > 1


def test_paired_kernels_take_an_unaligned_mask(cuda_device):
    """A mask view that does not start on a 16-byte boundary: the chunks
    before its first byte are copied byte by byte."""
    k, n, h = 3, 45, 32
    mask, scales, ds, p4, ct = _paired_world(k, n, h, cuda_device, seed=5)
    buf = torch.zeros((k * n * n + 1,), dtype=torch.int8, device=cuda_device)
    view = buf[1:].view(k, n, n)
    view.copy_(mask)
    assert view.data_ptr() % 16
    _hold(paired_fwd(p4, view, scales, ds), paired_ref_ds(p4, mask, scales, ds))
    _hold(paired_bwd(ct, view, scales, ds, torch.float32),
          paired_bwd_ref(ct, mask, scales, ds, torch.float32))


@pytest.mark.parametrize("dtype,with_ds", FWD_MODES, ids=["f32", "bf16", "f32_ds"])
@pytest.mark.parametrize("k,n,h", [(3, 50, 16), (4, 77, 96), (1, 4500, 64)])
def test_probe_paired_sweep_variants_match_plain(cuda_device, k, n, h, dtype, with_ds):
    """The sweep probe's variants: the sweep against ``paired_ref`` (1e-5
    of the largest output, the probes' rule), its parts exactly zero."""
    mask, scales, ds, p4, _ = _paired_world(k, n, h, cuda_device, seed=6)
    p4, ds = p4.to(dtype), ds if with_ds else None
    call, *sweeps = probe_paired_sweep.variants("small", mask, scales, ds, p4)
    assert len(sweeps) == len(probe_paired_sweep.VARIANTS)
    for v in sweeps:
        _probe_check(v, "probe_paired_sweep")


def _world(seed, n_r, n_c, n_rel, d, b, device):
    g = torch.Generator().manual_seed(seed)
    w = dict(
        z_r=torch.randn((n_r, d), generator=g),
        z_c=torch.randn((n_c, d), generator=g),
        rel_diag=torch.randn((n_rel, d), generator=g),
        glb=torch.randn((d, d), generator=g),
        rel_full=torch.randn((n_rel, d, d), generator=g),
        ks=torch.randint(0, n_rel, (b,), generator=g, dtype=torch.int32),
        rows=torch.randint(0, n_r, (b,), generator=g, dtype=torch.int32),
        cols=torch.randint(0, n_c, (b,), generator=g, dtype=torch.int32),
    )
    return {k: v.to(device) for k, v in w.items()}


def _score(fn, w, name):
    return fn(
        w["z_r"], w["z_c"], w["ks"], w["rows"], w["cols"], name=name,
        glb=w["glb"], rel_diag=w["rel_diag"], rel_full=w["rel_full"],
    )


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("d", [32, 16, 100])
@pytest.mark.parametrize("name", NAMES)
def test_sddmm_kernel_matches_plain(cuda_device, name, d, precision):
    w = _world(3, n_r=97, n_c=80, n_rel=23, d=d, b=5000, device=cuda_device)
    counter = "sddmm_bf16" if precision == "default" else "sddmm"
    before = cuda_build.LAUNCHES[counter]
    got = _score(lambda *a, **k: sddmm_edges(*a, **k, precision=precision), w, name)
    assert cuda_build.LAUNCHES[counter] == before + 1
    want = _score(lambda *a, **k: sddmm_plain(*a, **k, precision=precision), w, name)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_sddmm_kernel_scores_nan_out_of_range(cuda_device):
    w = _world(4, n_r=10, n_c=10, n_rel=3, d=32, b=6, device=cuda_device)
    w["rows"][2] = 10
    w["ks"][4] = -1
    got = _score(sddmm_edges, w, "dedicom").cpu().numpy()
    assert np.isnan(got[[2, 4]]).all()
    assert np.isfinite(np.delete(got, [2, 4])).all()


def _sorted_world(seed, n_rel, d, b, device, shuffled):
    """A sweep over ``n_rel`` relations: edges grouped relation by relation
    (as ``AccuracyEvaluator`` stages them) or shuffled."""
    w = _world(seed, n_r=300, n_c=200, n_rel=n_rel, d=d, b=b, device="cpu")
    w["ks"] = torch.sort(w["ks"]).values
    if shuffled:
        w["ks"] = w["ks"][torch.randperm(b, generator=torch.Generator().manual_seed(seed))]
    return {k: v.to(device) for k, v in w.items()}


@pytest.mark.parametrize("shuffled", [False, True], ids=["sorted", "shuffled"])
@pytest.mark.parametrize("n_rel", [2, 963])
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("d", [8, 32, 100])
@pytest.mark.parametrize("name", NAMES)
def test_sddmm_kernel_relation_orders(cuda_device, name, d, precision, n_rel, shuffled):
    """Relation indices sorted (a block stages its few relations) and
    shuffled (a block over many relations reads them from global memory),
    over 2 and 963 relations: each within the scorer's tolerance of the
    plain version, in input order, two calls equal bit for bit."""
    w = _sorted_world(d + n_rel, n_rel, d, 6000, cuda_device, shuffled)
    run = lambda: _score(lambda *a, **k: sddmm_edges(*a, **k, precision=precision), w, name)  # noqa: E731
    got, again = run(), run()
    want = _score(lambda *a, **k: sddmm_plain(*a, **k, precision=precision), w, name)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", NAMES)
def test_sddmm_kernel_takes_unaligned_tables(cuda_device, name):
    """Tables that start off 16-byte alignment take the scalar loads (at
    "default" the wrapper casts them to new bf16 tables first)."""
    w = _world(5, n_r=50, n_c=40, n_rel=7, d=32, b=3000, device=cuda_device)
    for key in ("z_r", "z_c", "rel_diag", "glb", "rel_full"):
        t = w[key]
        buf = torch.empty(t.numel() + 1, device=cuda_device)
        w[key] = buf[1:].view(t.shape).copy_(t)
        assert w[key].data_ptr() % 16 != 0
    for precision in ("highest", "default"):
        got = _score(lambda *a, **k: sddmm_edges(*a, **k, precision=precision), w, name)
        want = _score(lambda *a, **k: sddmm_plain(*a, **k, precision=precision), w, name)
        got, want = got.cpu().numpy(), want.cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("shuffled", [False, True], ids=["sorted", "shuffled"])
@pytest.mark.parametrize("n_rel", [2, 963])
@pytest.mark.parametrize("d", [8, 32, 100])
@pytest.mark.parametrize("name", NAMES)
def test_sddmm_kernel_bf16_tables(cuda_device, name, d, n_rel, shuffled, aligned):
    """K5-bf16 on bf16 tables (16-byte loads of 8 elements where d % 8 == 0
    and the rows are aligned, else one element at a time) gives the scores
    of the plain version on the f32 tables at "default", which rounds them
    to the same values; two calls equal bit for bit."""
    w = _sorted_world(2 * d + n_rel, n_rel, d, 6000, cuda_device, shuffled)
    b = dict(w)
    for key in ("z_r", "z_c", "rel_diag", "glb", "rel_full"):
        t = w[key].to(torch.bfloat16)
        if not aligned:
            buf = torch.empty(t.numel() + 1, dtype=torch.bfloat16, device=cuda_device)
            t = buf[1:].view(t.shape).copy_(t)
            assert t.data_ptr() % 16 != 0
        b[key] = t
    before = cuda_build.LAUNCHES["sddmm_bf16"]
    run = lambda: _score(lambda *a, **k: sddmm_edges(*a, **k, precision="default"), b, name)  # noqa: E731
    got, again = run(), run()
    assert cuda_build.LAUNCHES["sddmm_bf16"] == before + 2
    want = _score(lambda *a, **k: sddmm_plain(*a, **k, precision="default"), w, name)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_sddmm_impl_pallas_launches_the_kernel(cuda_device):
    """``sddmm_impl="pallas"`` on CUDA embeddings scores through K5 (and
    K5-bf16 at "default"), as "auto" does, and builds with the device named."""
    from types import SimpleNamespace

    from decagon_tpu_torch.models.model import ModelConfig
    from decagon_tpu_torch.train.step import make_emb_scores

    w = _world(6, n_r=40, n_c=40, n_rel=3, d=16, b=500, device=cuda_device)
    params = {"dec": {"1,1": {"global": w["glb"], "local_diag": w["rel_diag"]}}}
    emb = {"1": w["z_r"]}
    for precision, counter in (("highest", "sddmm"), ("default", "sddmm_bf16")):
        model = SimpleNamespace(
            config=ModelConfig(hidden2=16, sddmm_impl="pallas", sddmm_precision=precision),
            graph_meta=SimpleNamespace(decoder_name=lambda et: "dedicom"),
        )
        scores = make_emb_scores(model, (1, 1), device=cuda_device)
        before = cuda_build.LAUNCHES[counter]
        got = scores(params, emb, w["ks"], w["rows"], w["cols"])
        assert cuda_build.LAUNCHES[counter] == before + 1
        model.config = ModelConfig(hidden2=16, sddmm_precision=precision)
        want = make_emb_scores(model, (1, 1))(params, emb, w["ks"], w["rows"], w["cols"])
        assert torch.equal(got, want)


ADAM = dict(s1=1.0 / (1 - 0.9 ** 3), s2=1.0 / (1 - 0.999 ** 3), lr=1e-3, b1=0.9, b2=0.999,
            eps=1e-8)


def _adam_world(n, dtype, device, offset=0, seed=0):
    """g, m, v (``dtype``) and f32 p of ``n`` elements, each a view that
    starts ``offset`` elements into its storage."""
    g = torch.Generator().manual_seed(seed + n)
    mk = lambda scale, dt: (scale * torch.randn(n + offset, generator=g)).to(dt)  # noqa: E731
    t = [mk(1.0, dtype), mk(0.1, dtype), mk(0.01, dtype).abs(), mk(1.0, torch.float32)]
    return [x.to(device)[offset:] for x in t]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,offset", [(1, 0), (3, 0), (4, 0), (1001, 0), (4097, 1),
                                      (65536, 2), (1 << 22, 0), ((1 << 20) + 5, 3)])
def test_adam_kernel_matches_plain_bitwise(cuda_device, dtype, n, offset):
    """Lengths that are and are not multiples of the vector width, views
    that start off 16-byte alignment, one element to 2^22; in place."""
    got = _adam_world(n, dtype, cuda_device, offset)
    want = [x.clone() for x in got]
    ptrs = [x.data_ptr() for x in got]
    before = cuda_build.LAUNCHES["adam"]
    adam_onepass(*got, **ADAM)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["adam"] == before + 1
    adam_onepass_ref(*want, **ADAM)
    assert [x.data_ptr() for x in got] == ptrs
    for name, a, b in zip("gmvp", got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("block_threads", [64, 128, 256])
def test_adam_kernel_block_sizes_agree(cuda_device, block_threads):
    got = _adam_world(3 * 4096 + 7, torch.float32, cuda_device, seed=1)
    want = [x.clone() for x in got]
    adam_onepass(*got, **ADAM, block_threads=block_threads)
    adam_onepass_ref(*want, **ADAM)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_adam_kernel_rejects_what_it_does_not_take(cuda_device):
    g, m, v, p = _adam_world(64, torch.float32, cuda_device)
    with pytest.raises(TypeError):
        adam_onepass(g.half(), m.half(), v.half(), p, **ADAM)
    with pytest.raises(TypeError):
        adam_onepass(g, m.to(torch.bfloat16), v, p, **ADAM)
    with pytest.raises(TypeError):
        adam_onepass(g, m, v, p.double(), **ADAM)
    with pytest.raises(ValueError):
        adam_onepass(g[::2], m[::2], v[::2], p[::2], **ADAM)
    with pytest.raises(ValueError):
        adam_onepass(g[:32], m, v, p, **ADAM)


BF16, F32 = torch.bfloat16, torch.float32
# Leaves of a tree shaped like the main path's, each (shape, g dtype,
# moments dtype, rounded, offset, transposed g): a 4-D paired leaf, 3-D
# and 2-D leaves, all four g x moment pairs, f32 gradients rounded to bf16
# in the kernel, views off 16-byte alignment, lengths that are not
# multiples of 8, a non-contiguous gradient, one element, no element.
MIXED = {
    "enc1": {"1,1": ((2, 7, 16, 45), F32, BF16, True, 0, False),
             "0,0": ((2, 1, 16, 301), BF16, BF16, False, 0, False),
             "1,0": ((1, 301, 16), F32, BF16, False, 3, False)},
    "enc2": {"1,1": ((2, 7, 8, 16), F32, F32, False, 0, True),
             "0,1": ((1, 45, 8), BF16, F32, False, 1, False)},
    "dec": {"global": ((8, 8), F32, BF16, False, 0, False),
            "one": ((1,), F32, F32, False, 0, False),
            "empty": ((0, 8), F32, BF16, False, 0, False)},
}


def _adam_tree(spec, device, seed=0):
    """``(grads, state, params, rounded)`` for ``spec``: seeded normals,
    ``v`` positive, each tensor a view ``offset`` elements into its own
    storage; ``rounded`` lists the rounded leaves' gradients (by id)."""
    gen = torch.Generator().manual_seed(seed)
    rounded = set()

    def draw(shape, dtype, offset, scale=1.0, positive=False):
        n = int(np.prod(shape))
        x = scale * torch.randn(n + offset, generator=gen)
        x = x.abs() if positive else x
        return x.to(dtype).to(device)[offset:].view(shape)

    def leaf(shape, gdt, mdt, rounds, offset, transposed):
        g = draw(shape[::-1] if transposed else shape, gdt, offset)
        g = g.permute(*reversed(range(len(shape)))) if transposed else g
        if rounds:
            rounded.add(id(g))
        return (g, draw(shape, mdt, offset, 0.1), draw(shape, mdt, offset, 0.01, True),
                draw(shape, F32, offset))

    leaves = optim.tree_map(lambda s: leaf(*s), spec)
    grads, m, v, params = (optim.tree_map(lambda x, i=i: x[i], leaves) for i in range(4))
    return grads, {"m": m, "v": v, "t": 2}, params, lambda g: id(g) in rounded


def _flat_tensors(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key in tree:
            out.update(_flat_tensors(tree[key], f"{prefix}/{key}"))
        return out
    return {prefix: tree}


def _hold_adam_trees(got, want):
    """Parameters and moments bitwise equal, dtype for dtype."""
    (gp, gs), (wp, ws) = got, want
    assert gs["t"] == ws["t"]
    for kind, a, b in (("p", gp, wp), ("m", gs["m"], ws["m"]), ("v", gs["v"], ws["v"])):
        fa, fb = _flat_tensors(a), _flat_tensors(b)
        assert sorted(fa) == sorted(fb)
        for name in fb:
            assert fa[name].dtype == fb[name].dtype, (kind, name)
            assert fa[name].is_contiguous(), (kind, name)
            assert torch.equal(fa[name], fb[name]), (kind, name)


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {key: _copy_tree(value) for key, value in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


ADAM_TREE = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)


def test_adam_apply_matches_plain_bitwise_on_a_mixed_tree(cuda_device):
    """The main path's kinds of leaf in one tree: one launch, bitwise equal
    to ``adam_apply_ref``, out of place (the inputs keep their values)."""
    grads, state, params, rounds = _adam_tree(MIXED, cuda_device)
    before = [_copy_tree(x) for x in (grads, state, params)]
    launches = cuda_build.LAUNCHES["adam"]
    got = optim.adam_apply(grads, state, params, **ADAM_TREE, round_grad=rounds)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["adam"] == launches + 1
    want = optim.adam_apply_ref(grads, state, params, **ADAM_TREE, round_grad=rounds)
    _hold_adam_trees(got, want)
    assert got[1]["t"] == 3
    for old, now in zip(before, (grads, state, params)):
        fo, fn = _flat_tensors(old), _flat_tensors(now)
        assert all(torch.equal(fo[k], fn[k]) if isinstance(fn[k], torch.Tensor)
                   else fo[k] == fn[k] for k in fn)
    assert got[0]["dec"]["global"].data_ptr() != params["dec"]["global"].data_ptr()


def test_adam_apply_in_place(cuda_device):
    """``in_place``: the leaves it picks are updated in their own tensors
    (the returned trees hold them), the others into new ones; the values
    equal the plain version's either way."""
    grads, state, params, rounds = _adam_tree(MIXED, cuda_device, seed=1)
    want = optim.adam_apply_ref(grads, state, params, **ADAM_TREE, round_grad=rounds)
    ptrs = {k: x.data_ptr() for k, x in _flat_tensors(params).items()}
    pick = lambda g, m, v, p: p.dim() >= 3  # noqa: E731
    got = optim.adam_apply(grads, state, params, **ADAM_TREE, round_grad=rounds, in_place=pick)
    torch.cuda.synchronize()
    _hold_adam_trees(got, want)
    for name, x in _flat_tensors(got[0]).items():
        if x.numel():
            assert (x.data_ptr() == ptrs[name]) == (x.dim() >= 3), name
    assert got[1]["m"]["enc1"]["1,1"] is state["m"]["enc1"]["1,1"]


def test_adam_apply_takes_several_launches_past_max_leaves(cuda_device):
    """More leaves than a launch's table: one launch a ``MAX_LEAVES``."""
    n = 2 * optim.MAX_LEAVES + 5
    spec = {str(i): ((1 + 37 * i,), (F32, BF16)[i % 2], (BF16, F32)[i % 3 == 0], False, i % 4,
                     False) for i in range(n)}
    grads, state, params, _ = _adam_tree(spec, cuda_device, seed=2)
    launches = cuda_build.LAUNCHES["adam"]
    got = optim.adam_apply(grads, state, params, **ADAM_TREE)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["adam"] == launches + 3
    _hold_adam_trees(got, optim.adam_apply_ref(grads, state, params, **ADAM_TREE))


def test_adam_apply_rejects_what_it_does_not_take(cuda_device):
    """Non-contiguous m, v or p, unknown dtypes and parameters that are
    not f32 (the dtype gate) raise, with no launch."""
    g, m, v, p = _adam_world(64, F32, cuda_device)
    tree = lambda x: {"a": x}  # noqa: E731
    state = lambda mm, vv: {"m": tree(mm), "v": tree(vv), "t": 0}  # noqa: E731
    g2, m2, v2, p2 = (x.view(8, 8) for x in (g, m, v, p))
    with pytest.raises(ValueError):
        optim.adam_apply(tree(g2.t()), state(m2.t(), v2.t()), tree(p2.t()), **ADAM_TREE)
    with pytest.raises(ValueError):
        optim.adam_apply(tree(g2), state(m2, v2), tree(p2.t()), **ADAM_TREE)
    with pytest.raises(TypeError):
        optim.adam_apply(tree(g.half()), state(m, v), tree(p), **ADAM_TREE)
    with pytest.raises(TypeError):
        optim.adam_apply(tree(g), state(m.to(BF16), v), tree(p), **ADAM_TREE)
    with pytest.raises(ValueError):
        optim.adam_apply(tree(g[:32]), state(m, v), tree(p), **ADAM_TREE)
    launches = cuda_build.LAUNCHES["adam"]
    dt = torch.float64
    with pytest.raises(TypeError):
        optim.adam_apply(tree(g.to(dt)), state(m.to(dt), v.to(dt)), tree(p.to(dt)), **ADAM_TREE)
    with pytest.raises(TypeError):
        optim.adam_apply(tree(g), state(m, v), tree(p.to(BF16)), **ADAM_TREE)
    assert cuda_build.LAUNCHES["adam"] == launches


def test_apply_optimizer_takes_one_launch_a_step(cuda_device):
    """The default ``TrainConfig``'s optimizer on CUDA: one launch a step
    (the gradient cast inside it), three steps bitwise equal to the same
    steps through ``make_optimizer(one_pass=adam_apply_ref)``; with a
    schedule, and with ``lazy_decoder_adam`` (its encoder's leaves in the
    launch), as well."""
    from decagon_tpu_torch.train import step as step_mod

    big = {"a": ((2, 5, 16, 7000), F32, F32, False, 0, False)}
    spec = dict(MIXED, big=big)
    for kw in ({}, dict(lr_schedule="cosine", lr_schedule_steps=4),
               dict(lazy_decoder_adam=True)):
        cfg = step_mod.TrainConfig(**kw)
        out = []
        for one_pass in (None, optim.adam_apply_ref):
            opt = step_mod.make_optimizer(cfg, one_pass=one_pass)
            grads, _, params, _ = _adam_tree(spec, cuda_device, seed=3)
            state = opt.init(params)
            launches = cuda_build.LAUNCHES["adam"]
            for _ in range(3):
                params, state = step_mod.apply_optimizer(opt, cfg, grads, state, params,
                                                         cast=True)
            torch.cuda.synchronize()
            out.append((params, state, cuda_build.LAUNCHES["adam"] - launches))
        assert out[0][2] == 3 and out[1][2] == 0
        if cfg.lazy_decoder_adam:
            out = [(p, {"m": {**s["enc"]["m"], **s["dec"]["m"]},
                        "v": {**s["enc"]["v"], **s["dec"]["v"]}, "t": s["enc"]["t"]}, n)
                   for p, s, n in out]
        assert out[0][1]["m"]["big"]["a"].dtype == BF16
        _hold_adam_trees(out[0][:2], out[1][:2])


def _csr_world(n_src, n_dst, e, h, device, seed=0, long_row=0):
    """A random edge set (duplicates included, a few zero values that the
    layout drops, the last tenth of the rows empty), one row of
    ``long_row`` extra edges, and a source table."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_src, e + long_row)
    dst = np.concatenate([rng.integers(0, n_dst - n_dst // 10, e), np.full(long_row, n_dst // 2)])
    vals = rng.normal(size=e + long_row).astype(np.float32)
    vals[:: 97] = 0.0
    src[1], dst[1] = src[0], dst[0]
    p = torch.from_numpy(rng.normal(size=(n_src, h)).astype(np.float32)).to(device)
    return build_tiles(src, dst, vals, n_src, n_dst).to(device), p


def _hold_rel(got, want, tol=1e-5):
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err / want.abs().max().item()


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("h", [1, 32, 64, 100])
def test_spmm_tiled_kernel_matches_plain(cuda_device, h, precision):
    """Forward and transposed layouts, rows of one and of many segments
    (a row of more than 10,000 edges), empty rows, duplicate edges."""
    tiles, p = _csr_world(3000, 500, 40_000, h, cuda_device, long_row=12_000)
    assert tiles.num_slots > 0 and tiles.row_chunks.shape[0] > 0
    assert int(tiles.row_ptr.diff().eq(0).sum()) >= 50
    before = cuda_build.LAUNCHES["spmm_tiled"]
    got = spmm_tiled(p, tiles, precision)
    again = spmm_tiled(p, tiles, precision)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["spmm_tiled"] == before + 2
    assert tuple(got.shape) == (500, h) and torch.equal(got, again)
    _hold_rel(got, spmm_tiled_ref(p, tiles, precision))
    src, dst = tiles.col.cpu().numpy(), tiles.dst_index().cpu().numpy()
    t_bwd = build_tiles(dst, src, tiles.val.cpu().numpy(), 500, 3000).to(cuda_device)
    ct = torch.randn((500, h), generator=torch.Generator().manual_seed(h)).to(cuda_device)
    _hold_rel(spmm_tiled(ct, t_bwd, precision), spmm_tiled_ref(ct, t_bwd, precision))


def test_spmm_tiled_kernel_bf16_input_and_views(cuda_device):
    """A bf16 table at "highest" is read as f32 values; a view that starts
    off 8-byte alignment runs with narrower vectors; a layout with no
    edges gives zeros."""
    tiles, p = _csr_world(700, 90, 5000, 64, cuda_device, seed=1)
    pb = p.to(torch.bfloat16)
    _hold_rel(spmm_tiled(pb, tiles), spmm_tiled_ref(pb, tiles))
    view = torch.randn(700 * 64 + 1, device=cuda_device)[1:].view(700, 64)
    assert view.data_ptr() % 8 == 4
    _hold_rel(spmm_tiled(view, tiles), spmm_tiled_ref(view, tiles))
    empty = build_tiles(np.zeros(0), np.zeros(0), np.zeros(0), 700, 90).to(cuda_device)
    assert torch.equal(spmm_tiled(p, empty), torch.zeros((90, 64), device=cuda_device))


def _rows_world(h, device, window, seed=0):
    """Rows of 0, 1, 7, 300 and 5,000 edges (each length four times, and
    200 more rows of 7; the long ones over a ``window``-cut schedule) from
    a 6,000-row table."""
    rng = np.random.default_rng(seed + h)
    lengths = [0, 1, 7, 300, 5000] * 4 + [7] * 200
    dst = np.repeat(np.arange(len(lengths)), lengths)
    src = rng.integers(0, 6000, dst.size)
    vals = rng.normal(size=dst.size).astype(np.float32)
    p = torch.from_numpy(rng.normal(size=(6000, h)).astype(np.float32)).to(device)
    return build_tiles(src, dst, vals, 6000, len(lengths), window=window).to(device), p


@pytest.mark.parametrize("window", [0, 700])
@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("h", [1, 32, 64, 96])
def test_spmm_tiled_kernel_row_lengths(cuda_device, h, precision, p_dtype, window):
    """Short rows (0, 1 and 7 edges: the row pass) and long ones (300 and
    5,000: segments and their partials), every width and table type:
    within ``1e-5`` of the largest plain output, equal bit for bit to the
    plain version in the kernel's own order (``spmm_tiled_ordered``), and
    two calls equal."""
    tiles, p = _rows_world(h, cuda_device, window)
    p = p.to(p_dtype)
    assert tiles.multi_row.numel() == 8 and tiles.num_segments >= 4 * (5000 // SEGMENT)
    got, again = spmm_tiled(p, tiles, precision), spmm_tiled(p, tiles, precision)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _hold_rel(got, spmm_tiled_ref(p, tiles, precision))
    assert torch.equal(got, spmm_tiled_ordered(p, tiles, precision))


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("h", [1, 32, 64, 96])
def test_spmm_tiled_kernel_staged_table(cuda_device, h, precision, p_dtype):
    """A narrow table that the row pass copies into shared memory (rounded
    to bf16 at "default"), with short rows of 0 to 12 edges and one long
    row (through device memory, rounded in registers): the
    same bits as the plain version in the kernel's order, two calls
    equal, within 1e-5 of ``spmm_tiled_ref``."""
    rng = np.random.default_rng(h)
    lengths = np.concatenate([rng.integers(0, 13, 12_000), [3000]])
    dst = np.repeat(np.arange(lengths.size), lengths)
    src = rng.integers(0, 64, dst.size)
    vals = rng.normal(size=dst.size).astype(np.float32)
    tiles = build_tiles(src, dst, vals, 64, lengths.size).to(cuda_device)
    p = torch.from_numpy(rng.normal(size=(64, h)).astype(np.float32)).to(cuda_device).to(p_dtype)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert launch_plan(tiles, h, p.data_ptr(), p_dtype == torch.bfloat16,
                       precision == "default", sms)[2]
    got, again = spmm_tiled(p, tiles, precision), spmm_tiled(p, tiles, precision)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, spmm_tiled_ordered(p, tiles, precision))
    _hold_rel(got, spmm_tiled_ref(p, tiles, precision))


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_spmm_tiled_kernel_unaligned_views(cuda_device, precision):
    """Tables whose rows start off 16-byte alignment (f32 and bf16) take
    narrower loads and give the same bits as the aligned copy."""
    tiles, p = _rows_world(64, cuda_device, 0, seed=1)
    for dtype, shift in ((torch.float32, 1), (torch.float32, 2), (torch.bfloat16, 1),
                         (torch.bfloat16, 4)):
        q = p.to(dtype)
        buf = torch.empty(q.numel() + shift, dtype=dtype, device=cuda_device)
        view = buf[shift:].view(q.shape).copy_(q)
        assert view.data_ptr() % 16 != 0
        assert torch.equal(spmm_tiled(view, tiles, precision), spmm_tiled(q, tiles, precision))


def test_spmm_tiled_kernel_nan_for_a_source_out_of_range(cuda_device):
    """A source index past the table (only a hand-made layout has one)
    makes its row NaN, short or long, and leaves the others."""
    tiles, p = _rows_world(32, cuda_device, 0, seed=2)
    row_ptr = tiles.row_ptr.cpu().numpy()
    col = tiles.col.clone()
    short_row, long_row = 2, 4  # 7 and 5,000 edges
    col[int(row_ptr[short_row])] = 6000
    col[int(row_ptr[long_row]) + 4321] = -1
    bad = dataclasses.replace(tiles, col=col)
    got = spmm_tiled(p, bad).cpu()
    assert torch.isnan(got[[short_row, long_row]]).all()
    others = [d for d in range(tiles.n_dst) if d not in (short_row, long_row)]
    assert torch.isfinite(got[others]).all()


def test_spmm_tiled_autograd_kernel_matches_plain(cuda_device):
    tiles, p = _csr_world(800, 300, 20_000, 64, cuda_device, seed=2, long_row=SEGMENT * 3)
    src, dst = tiles.col.cpu().numpy(), tiles.dst_index().cpu().numpy()
    t_bwd = build_tiles(dst, src, tiles.val.cpu().numpy(), 300, 800).to(cuda_device)
    ct = torch.randn((300, 64), device=cuda_device)
    for precision in ("highest", "default"):
        grads = []
        for ref in (False, True):
            q = p.clone().requires_grad_(True)
            _SpmmTiled.apply(q, tiles, t_bwd, precision, ref).backward(ct)
            grads.append(q.grad)
        _hold_rel(*grads)


def test_spmm_tiled_kernel_rejects_what_it_does_not_take(cuda_device):
    tiles, p = _csr_world(100, 40, 500, 32, cuda_device, seed=3)
    with pytest.raises(ValueError):
        spmm_tiled(p[:99], tiles)
    with pytest.raises(ValueError):
        spmm_tiled(p, tiles, "fast")
    with pytest.raises(ValueError):
        spmm_tiled(p, tiles.to("cpu"))


# The paired-kernel probes (P1-P5): small ragged shapes and the probes' own.


def _probe_check(v, counter):
    """``probing.check`` (two calls bitwise equal, the rule against the
    plain version) and the launch count of the two kernel calls."""
    before = cuda_build.LAUNCHES[counter]
    row = probing.check(v)
    assert cuda_build.LAUNCHES[counter] == before + 2
    return row


@pytest.mark.parametrize("shape,pad,values", [
    ((9, 37, 45), (48, 64), "mask"), ((11, 71, 131), (80, 144), "mask"),
    ((964, 645, 645), probe_int8_bw.PADDED, "mask"),
    ((7, 50, 768), (64, 768), "mask"),
    ((13, 64, 645), (64, 768), "every"),
    ((4, 30, 100), (32, 128), "any"), ((2, 3, 20), (16, 32), "any"),
], ids=["ragged", "wide", "probe", "n768", "every_value", "small", "tiny"])
def test_probe_int8_bw_kernel_matches_plain(cuda_device, shape, pad, values):
    # "mask": 0/1 with a few other values; "every": every int8 value, so
    # conv passes each through s8x4_to_bf16; "any": uniform int8 values in
    # stacks of fewer tiles than the grid has blocks (most blocks read
    # nothing, the partial tile is the whole stream).
    g = torch.Generator(device=cuda_device).manual_seed(shape[1])
    if values == "mask":
        m8 = (torch.rand(shape, generator=g, device=cuda_device) < 0.2).to(torch.int8)
        m8[0, 0, :3] = torch.tensor([2, -3, 127], dtype=torch.int8)
        m8[-1, -1, -2:] = -128
    else:
        m8 = torch.randint(-128, 128, shape, generator=g, device=cuda_device,
                           dtype=torch.int8)
    if values == "every":
        m8.view(-1)[:256] = torch.arange(-128, 128, device=cuda_device).to(torch.int8)
    vs = probe_int8_bw.variants(m8, m8.to(torch.bfloat16), probe_int8_bw.padded(m8, pad),
                                kbs=tuple(kb for kb in (1, 2, 3, 8) if kb <= shape[0]))
    for v in vs:
        _probe_check(v, "probe_int8_bw")


@pytest.mark.parametrize("kind", [0, 1, 2], ids=["int8", "conv", "bf16"])
def test_probe_int8_bw_entry_leaves_its_counters_zero(cuda_device, kind):
    # The C entry's contract: the combine's counters are zero on entry and
    # on exit, so a second launch on the same counters sums the same bits.
    g = torch.Generator(device=cuda_device).manual_seed(kind)
    x = torch.randint(-128, 128, (9, 64, 645), generator=g, device=cuda_device,
                      dtype=torch.int8)
    if kind == 2:
        x = x.to(torch.bfloat16)
    k, n1, n2 = x.shape
    blocks = probe_int8_bw.kernel_info(kind, cuda_device.index or 0)["grid"]
    groups = -(-blocks // probe_int8_bw.combine_group(blocks))
    partial = torch.empty((blocks + groups, n2), dtype=torch.float32, device=cuda_device)
    count = torch.zeros(groups + 1, dtype=torch.int32, device=cuda_device)
    outs = []
    for _ in range(2):
        out = torch.empty((1, n2), dtype=torch.float32, device=cuda_device)
        status = cuda_build.library().dt_probe_column_sum(
            x.data_ptr(), kind, n1 * n2, n2, k // 2, 2, blocks, partial.data_ptr(),
            count.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        cuda_build.check(status, "probe_int8_bw")
        torch.cuda.synchronize()
        assert int(count.abs().sum()) == 0
        outs.append(out)
    want = probe_int8_bw.pallas_sum_ref(x.cpu(), 2, conv=kind == 1)
    assert torch.equal(outs[0].cpu(), want) and torch.equal(outs[1], outs[0])


def test_probe_int8_bw_grid_comes_from_the_card(cuda_device):
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for kind in (0, 1, 2):
        info = probe_int8_bw.kernel_info(kind, cuda_device.index or 0)
        assert info["sms"] == sms and info["blocks_per_sm"] >= 1
        assert info["grid"] == sms * info["blocks_per_sm"]
        assert info["registers"] <= 128


# P2 and P3 run the paired sweep on parts policies: every mode at ragged
# shapes (no row a multiple of 16 bytes at N = 45, 70), at the schedule's
# cut and at kb relations a block.
@pytest.mark.parametrize("kbs", [(1, 4, 8), (None,)], ids=["kb1-4-8", "sched"])
@pytest.mark.parametrize("k,n,h", [(9, 70, 16), (13, 130, 64), (5, 45, 24), (963, 645, 64)])
def test_probe_paired_parts_kernel_matches_plain(cuda_device, k, n, h, kbs):
    if k == 963 and kbs != (None,):
        kbs = (4,)
    mask, p4 = probe_paired_parts.make_inputs(cuda_device, seed=k, k=k, n=n, h=h, kpad=k + 1)
    mask[0, 0, :2] = 2
    for v in probe_paired_parts.variants(mask, p4, kbs=kbs):
        row = _sweep_probe_check(v, "probe_paired_parts")
        assert row["rel_err"] <= probing.REL_TOL
    assert not probe_paired_parts.paired_parts(mask, p4, "dma_only", kbs[0]).any()


@pytest.mark.parametrize("k,n,h", [(9, 70, 16), (13, 130, 64), (5, 45, 24), (963, 645, 64)])
def test_probe_paired_orient_kernel_matches_plain(cuda_device, k, n, h):
    mask, p4 = probe_paired_parts.make_inputs(cuda_device, seed=k, k=k, n=n, h=h, kpad=k + 1)
    mask[0, 0, :2] = 3
    sc = probe_paired_orient.make_scales(cuda_device, kpad=k + 1, n=n)
    kbs = (4, None) if k == 963 else (1, 2, 8, None)
    sweep = [(mode, kbs) for mode in probe_paired_orient.MODES]
    for v in probe_paired_orient.variants(mask, p4, sc, mask.to(torch.bfloat16), sweep=sweep):
        row = _sweep_probe_check(v, "probe_paired_orient")
        assert row["rel_err"] <= probing.REL_TOL


def test_probe_paired_orient_small_t_strip_limit(cuda_device):
    """small_t has no strip in shared memory: N past the former 768 runs,
    each tile staged once, against its plain version."""
    for k, n, h in ((3, 768, 64), (2, 769, 8), (4, 1300, 40)):
        mask, p4 = probe_paired_parts.make_inputs(cuda_device, seed=n, k=k, n=n, h=h, kpad=k)
        sc = probe_paired_orient.make_scales(cuda_device, kpad=k, n=n)
        for v in probe_paired_orient.variants(mask, p4, sc, mask.to(torch.bfloat16),
                                              sweep=[("small_t", (1, None))]):
            _sweep_probe_check(v, "probe_paired_orient")


@pytest.mark.parametrize("k,n,h", [(1, 645, 64), (3, 70, 40), (4, 20, 16), (963, 645, 64)])
def test_probe_paired_both_and_two_dots_equal_k1_k2(cuda_device, k, n, h):
    """P2's ``both`` (int8 mask) is K1/K2 on ``as_forward_scales(sc)`` and
    P3's ``two_dots`` K1/K2 on all-ones scales: the same sweep at the same
    cut, the same bits."""
    mask, p4 = probe_paired_parts.make_inputs(cuda_device, seed=k, k=k, n=n, h=h, kpad=k + 1)
    sc = probe_paired_orient.make_scales(cuda_device, kpad=k + 1, n=n)
    m = mask[:k].contiguous()
    want = paired_fwd(p4, m, probe_paired_orient.as_forward_scales(sc, k))
    assert torch.equal(probe_paired_orient.paired_orient(mask, p4, sc, "both"), want)
    ones = torch.ones((k, 4, n), device=cuda_device)
    want = paired_fwd(p4, m, ones)
    assert torch.equal(probe_paired_parts.paired_parts(mask, p4, "two_dots"), want)


# P1 and P4 run the paired sweep: the ragged shapes of their CPU tests
# (tests/test_torch_probe_sweep.py) and the probes' own.
SWEEP_PROBE_SHAPES = [*itertools.product((1, 3, 4), (20, 70, 645), (16, 40, 64)),
                      (963, 645, 64)]


def _sweep_probe_check(v, counter):
    """``_probe_check`` of a probe on the paired sweep: its launches are
    counted under its own name, never under the main path's kernels."""
    before = {name: cuda_build.LAUNCHES[name] for name in ("paired_fwd", "paired_bwd")}
    row = _probe_check(v, counter)
    assert {name: cuda_build.LAUNCHES[name] for name in before} == before
    return row


@pytest.mark.parametrize("k,n,h", SWEEP_PROBE_SHAPES)
def test_probe_paired_bwd_idioms_kernel_matches_plain(cuda_device, k, n, h):
    mask, ctT, sc = probe_paired_bwd_idioms.device_inputs(cuda_device, k=k, n=n, h=h, seed=k)
    mask[0, 0, :2] = 2
    row = _sweep_probe_check(probe_paired_bwd_idioms.variant(mask, ctT, sc),
                             "probe_paired_bwd_idioms")
    assert row["bitwise_repeat"]


def test_probe_paired_bwd_idioms_kernel_meets_the_numpy_oracle(cuda_device):
    mask, ct, sc = probe_paired_bwd_idioms.numpy_inputs()
    de, do = probe_paired_bwd_idioms.paired_bwd(
        *(torch.from_numpy(a).to(cuda_device) for a in (mask, ct.T.copy(), sc)))
    err = probe_paired_bwd_idioms.oracle_error(mask, ct, sc, de.float().cpu().numpy(),
                                               do.float().cpu().numpy())
    assert err < 2e-2


# P1's cuts: the schedule's, one relation a block and three; the probe's
# shape at its two timed cuts.
P1_CASES = [(*shape, kb) for shape in SWEEP_PROBE_SHAPES[:-1] for kb in (None, 1, 3)] + \
    [(963, 645, 64, None), (963, 645, 64, 1)]


@pytest.mark.parametrize("k,n,h,kb", P1_CASES)
def test_probe_paired_idioms_kernel_matches_plain(cuda_device, k, n, h, kb):
    mask, pe_aug, po_aug = probe_paired_idioms.device_inputs(cuda_device, k=k, n=n, h=h, seed=k)
    mask[0, 0, :2] = 2
    v = probe_paired_idioms.variant(mask, pe_aug, po_aug, h=h, kb=kb)
    _sweep_probe_check(v, "probe_paired_idioms")
    assert not v.kernel()[:, h:].any()


@pytest.mark.parametrize("k,n,h", [(1, 645, 64), (3, 70, 40), (4, 20, 16), (963, 645, 64)])
def test_probe_sweeps_equal_the_paired_kernels_at_unit_column_scales(cuda_device, k, n, h):
    """P1 and P4 run K1/K2's and K3's sweep at the same cut: on the same
    inputs with unit column scales, the same bits."""
    mask, pe_aug, po_aug = probe_paired_idioms.device_inputs(cuda_device, k=k, n=n, h=h, seed=k)
    p4, scales = probe_paired_idioms.as_forward(mask, pe_aug, po_aug, h)
    out = probe_paired_idioms.paired(mask, pe_aug, po_aug, h)
    assert torch.equal(out[:, :h], paired_fwd(p4, mask, scales).t())
    _, ctT, sc = probe_paired_bwd_idioms.device_inputs(cuda_device, k=k, n=n, h=h, seed=k)
    d = paired_bwd(ctT, mask, probe_paired_bwd_idioms.as_backward(sc), None, torch.bfloat16)
    de, do = probe_paired_bwd_idioms.paired_bwd(mask, ctT, sc)
    assert torch.equal(de, d[0]) and torch.equal(do, d[1])


def test_probe_paired_idioms_kernel_meets_the_numpy_oracle(cuda_device):
    mask, pe, po, ae, ao, pe_aug, po_aug = probe_paired_idioms.numpy_inputs()
    out = probe_paired_idioms.paired(
        torch.from_numpy(mask).to(cuda_device),
        torch.from_numpy(pe_aug).to(cuda_device, torch.bfloat16),
        torch.from_numpy(po_aug).to(cuda_device, torch.bfloat16))
    assert probe_paired_idioms.oracle_error(mask, pe, po, ae, ao, out.cpu().numpy()) < 2e-2


def test_probe_kernels_reject_what_they_do_not_take(cuda_device):
    d = cuda_device
    m8 = torch.zeros((4, 20, 20), dtype=torch.int8, device=d)
    p4 = torch.zeros((2, 3, 8, 20), dtype=torch.bfloat16, device=d)
    sc = torch.zeros((4, 2, 20), device=d)
    with pytest.raises(TypeError):
        probe_int8_bw.pallas_sum(m8.float(), 2)
    with pytest.raises(TypeError):
        probe_int8_bw.pallas_sum(m8.to(torch.bfloat16), 2, conv=True)
    with pytest.raises(ValueError):
        probe_int8_bw.pallas_sum(m8.transpose(1, 2), 2)
    with pytest.raises(ValueError):
        probe_int8_bw.pallas_sum(torch.zeros((2, 3, 800), dtype=torch.int8, device=d), 1)
    with pytest.raises(ValueError):
        probe_int8_bw.pallas_sum(m8, 5)
    with pytest.raises(ValueError):
        probe_int8_bw.pallas_sum(torch.zeros(1 + m8.numel(), dtype=torch.int8, device=d)[1:]
                                 .view(m8.shape), 2)
    with pytest.raises(ValueError):
        probe_paired_parts.paired_parts(m8, p4.float(), "two_dots")
    with pytest.raises(ValueError):
        probe_paired_parts.paired_parts(m8[:2], p4, "two_dots")
    with pytest.raises(ValueError):
        probe_paired_parts.paired_parts(m8.to(torch.bfloat16), p4, "m128_dot")
    with pytest.raises(ValueError):
        probe_paired_parts.paired_parts(m8, p4, "three_dots")
    with pytest.raises(ValueError):
        probe_paired_parts.paired_parts(
            m8, torch.zeros((2, 3, 65, 20), dtype=torch.bfloat16, device=d), "two_dots")
    with pytest.raises(ValueError):
        probe_paired_orient.paired_orient(m8, p4, sc[:, :1].contiguous())
    with pytest.raises(ValueError):
        probe_paired_orient.paired_orient(m8, p4.transpose(2, 3).contiguous().transpose(2, 3), sc)
    with pytest.raises(ValueError):
        probe_paired_orient.paired_orient(m8.float(), p4, sc)
    with pytest.raises(ValueError, match="bf16 mask"):
        probe_paired_orient.paired_orient(m8.to(torch.bfloat16), p4, sc, "xo_only")
    with pytest.raises(ValueError, match="bf16 mask"):
        probe_paired_orient.paired_orient(m8.to(torch.bfloat16), p4, sc, "xe_only")
    with pytest.raises(ValueError, match="p4"):
        probe_paired_orient.paired_orient(m8, p4.float(), sc)
    with pytest.raises(ValueError, match="stages"):
        probe_paired_orient.paired_orient(m8, p4, sc, "both", stages=2)
    with pytest.raises(ValueError, match="kb"):
        probe_paired_parts.paired_parts(m8, p4, "two_dots", kb=0)
    ct = torch.zeros((8, 20), device=d)
    with pytest.raises(ValueError):
        probe_paired_bwd_idioms.paired_bwd(m8, ct.double(), sc)
    with pytest.raises(ValueError):
        probe_paired_bwd_idioms.paired_bwd(m8, ct, sc[:3].contiguous())
    with pytest.raises(ValueError):
        probe_paired_bwd_idioms.paired_bwd(m8, torch.zeros((20, 8), device=d).t(), sc)
    aug = torch.zeros((4, 20, 128), dtype=torch.bfloat16, device=d)
    with pytest.raises(ValueError):
        probe_paired_idioms.paired(m8, aug.float(), aug)
    with pytest.raises(ValueError):
        probe_paired_idioms.paired(m8, aug, aug[:, :, :64].contiguous())
    with pytest.raises(ValueError):
        probe_paired_idioms.paired(m8, aug, aug, h=65)
    with pytest.raises(ValueError):
        probe_paired_idioms.paired(m8, aug, aug.cpu())
    with pytest.raises(ValueError, match="kb"):
        probe_paired_idioms.paired(m8, aug, aug, h=8, kb=0)
    off = torch.zeros(1 + aug.numel(), dtype=torch.bfloat16, device=d)[1:].view(aug.shape)
    with pytest.raises(ValueError, match="aligned"):
        probe_paired_idioms.paired(m8, off, aug, h=8)


def test_cli_on_the_card_launches_the_paired_kernels(cuda_device, tmp_path):
    """``decagon_tpu_torch.cli`` at the CPU shell tests' size runs on
    ``cuda`` by default, with the paired stacks and kernels (the JAX CLI's
    accelerator defaults) and K5 for its evaluations; the export restores
    its checkpoint in that layout."""
    import json

    from decagon_tpu_torch import cli
    from decagon_tpu_torch.predict import export

    conf = {
        "DataSetType": "DecagonDummyData", "NumProteins": 60, "NumDrugs": 30,
        "NumDrugDrugRelationTypes": 1, "hidden1": 8, "hidden2": 4, "batch_size": 16,
        "NumEpochs": 1, "NumIterationsPerLog": 50, "ValFraction": 0.1, "TestFraction": 0.05,
        "TrainIterationResultDir": str(tmp_path / "results"), "ShouldCheckpoint": True,
        "CheckpointDirectory": str(tmp_path / "ck"), "NpSaveDir": str(tmp_path / "nd"),
    }
    path = tmp_path / "conf.json"
    path.write_text(json.dumps(conf))
    cuda_build.reset_launches()
    cli.main(["--config", str(path)])
    torch.cuda.synchronize()
    for name in ("paired_fwd", "paired_bwd", "sddmm"):
        assert cuda_build.LAUNCHES[name] > 0, name
    export.main(["--config", str(path)])
    emb = np.load(tmp_path / "nd" / "embeddings.npy")
    assert emb.shape == (30, 4) and np.isfinite(emb).all()


def test_mesh_ranks_on_the_card_match_the_single_process(cuda_device):
    """``chip_smoke.py`` phase 20 (b): four ranks over gloo on this card, a
    (2, 2) mesh, the dummy config at full width, "auto" with weight
    sharding and "pallas" with K6 in every rank, against the single
    process on the card (``chip_smoke.mesh_ranks`` raises past its
    tolerances: loss 1e-5 relative, gradients 2e-4 relative plus 1e-5
    absolute, embeddings 2e-5 relative plus 1e-6 absolute)."""
    import chip_smoke

    summary = chip_smoke.mesh_ranks(cuda_device, 0)
    assert summary["auto"]["shard_weights"]
    assert all(n > 0 for n in summary["pallas"]["spmm_tiled_launches_per_rank"])
    assert all(summary["library_cached"])
