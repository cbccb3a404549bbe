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
from decagon_tpu_torch.ops.optim import adam_onepass, adam_onepass_ref
from decagon_tpu_torch.ops.sddmm_pallas import sddmm_edges, sddmm_plain
from decagon_tpu_torch.ops.spmm_pallas import _SpmmTiled, spmm_tiled, spmm_tiled_ref
from decagon_tpu_torch.ops.tiling import SEGMENT, build_tiles
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
    assert tiles.num_slots > 0 and int(tiles.row_ptr.diff().eq(0).sum()) >= 50
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


@pytest.mark.parametrize("shape", [(9, 37, 45), (11, 71, 131), (964, 645, 645)],
                         ids=["ragged", "wide", "probe"])
def test_probe_int8_bw_kernel_matches_plain(cuda_device, shape):
    g = torch.Generator(device=cuda_device).manual_seed(shape[1])
    m8 = (torch.rand(shape, generator=g, device=cuda_device) < 0.2).to(torch.int8)
    m8[0, 0, :3] = torch.tensor([2, -3, 127], dtype=torch.int8)
    m8[-1, -1, -2:] = -128
    pad = (48, 64) if shape[1] < 48 else (80, 144) if shape[1] < 80 else probe_int8_bw.PADDED
    vs = probe_int8_bw.variants(m8, m8.to(torch.bfloat16), probe_int8_bw.padded(m8, pad),
                                kbs=(1, 2, 3, 8))
    # n1 * n2 is odd at every shape, so the blocks' ranges start at every
    # offset within 16 bytes: the element-by-element head and tail run.
    assert shape[1] * shape[2] % 2 == 1
    for v in vs:
        _probe_check(v, "probe_int8_bw")


@pytest.mark.parametrize("kbs", [(1, 4, 8), (21,)], ids=["kb1-4-8", "kb21"])
@pytest.mark.parametrize("k,n,h", [(9, 70, 16), (13, 130, 64), (5, 45, 24), (963, 645, 64)])
def test_probe_paired_parts_kernel_matches_plain(cuda_device, k, n, h, kbs):
    if k == 963 and kbs != (21,):
        kbs = (4,)
    mask, p4 = probe_paired_parts.make_inputs(cuda_device, seed=k, k=k, n=n, h=h, kpad=k + 1)
    mask[0, 0, :2] = 2
    for v in probe_paired_parts.variants(mask, p4, kbs=kbs):
        row = _probe_check(v, "probe_paired_parts")
        assert row["rel_err"] <= probing.REL_TOL
    assert not probe_paired_parts.paired_parts(mask, p4, "dma_only", kbs[0]).any()


@pytest.mark.parametrize("k,n,h", [(9, 70, 16), (13, 130, 64), (5, 45, 24), (963, 645, 64)])
def test_probe_paired_orient_kernel_matches_plain(cuda_device, k, n, h):
    mask, p4 = probe_paired_parts.make_inputs(cuda_device, seed=k, k=k, n=n, h=h, kpad=k + 1)
    mask[0, 0, :2] = 3
    sc = probe_paired_orient.make_scales(cuda_device, kpad=k + 1, n=n)
    kbs = (4,) if k == 963 else (1, 2, 8)
    sweep = [(mode, kbs) for mode in probe_paired_orient.MODES]
    for v in probe_paired_orient.variants(mask, p4, sc, mask.to(torch.bfloat16), sweep=sweep):
        _probe_check(v, "probe_paired_orient")


def test_probe_paired_orient_small_t_strip_limit(cuda_device):
    mask, p4 = probe_paired_parts.make_inputs(cuda_device, k=3, n=768, h=64, kpad=3)
    sc = probe_paired_orient.make_scales(cuda_device, kpad=3, n=768)
    _probe_check(probe_paired_orient.variants(mask, p4, sc, sweep=[("small_t", (2,))])[0],
                 "probe_paired_orient")
    mask, p4 = probe_paired_parts.make_inputs(cuda_device, k=2, n=769, h=8, kpad=2)
    with pytest.raises(ValueError, match="small_t"):
        probe_paired_orient.paired_orient(
            mask, p4, probe_paired_orient.make_scales(cuda_device, kpad=2, n=769), "small_t")


@pytest.mark.parametrize("k,n,h", [(4, 645, 64), (3, 70, 24), (2, 130, 64), (963, 645, 64)])
def test_probe_paired_bwd_idioms_kernel_matches_plain(cuda_device, k, n, h):
    mask, ctT, sc = probe_paired_bwd_idioms.device_inputs(cuda_device, k=k, n=n, h=h, seed=k)
    mask[0, 0, :2] = 2
    row = _probe_check(probe_paired_bwd_idioms.variant(mask, ctT, sc), "probe_paired_bwd_idioms")
    assert row["bitwise_repeat"]


def test_probe_paired_bwd_idioms_kernel_meets_the_numpy_oracle(cuda_device):
    mask, ct, sc = probe_paired_bwd_idioms.numpy_inputs()
    de, do = probe_paired_bwd_idioms.paired_bwd(
        *(torch.from_numpy(a).to(cuda_device) for a in (mask, ct.T.copy(), sc)))
    err = probe_paired_bwd_idioms.oracle_error(mask, ct, sc, de.float().cpu().numpy(),
                                               do.float().cpu().numpy())
    assert err < 2e-2


@pytest.mark.parametrize("kb", [1, 3])
@pytest.mark.parametrize("k,n,h", [(4, 645, 64), (3, 70, 24), (5, 130, 64), (963, 645, 64)])
def test_probe_paired_idioms_kernel_matches_plain(cuda_device, k, n, h, kb):
    mask, pe_aug, po_aug = probe_paired_idioms.device_inputs(cuda_device, k=k, n=n, h=h, seed=k)
    v = probe_paired_idioms.variant(mask, pe_aug, po_aug, h=h, kb=kb)
    _probe_check(v, "probe_paired_idioms")
    assert not v.kernel()[:, h:].any()


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
