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
score.  One-pass Adam: the kernel rounds every operation on its own in the
plain chain's order, so m, v and p must equal ``adam_onepass_ref``'s bit
for bit.
"""

import numpy as np
import pytest
import torch

from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.ops.spmm_paired import (
    _PairedApply,
    _PairedApplyDs,
    paired_bwd,
    paired_bwd_ref,
    paired_fwd,
    paired_ref,
    paired_ref_ds,
)
from decagon_tpu_torch.ops.optim import adam_onepass, adam_onepass_ref
from decagon_tpu_torch.ops.sddmm_pallas import sddmm_edges, sddmm_plain

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


@pytest.mark.parametrize("d", [32, 16, 100])
@pytest.mark.parametrize("name", NAMES)
def test_sddmm_kernel_matches_plain(cuda_device, name, d):
    w = _world(3, n_r=97, n_c=80, n_rel=23, d=d, b=5000, device=cuda_device)
    got = _score(sddmm_edges, w, name).cpu().numpy()
    want = _score(sddmm_plain, w, name).cpu().numpy()
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
