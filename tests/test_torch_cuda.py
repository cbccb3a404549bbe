"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip without a CUDA device (decided in the fixture,
when a test runs, so every test-runner worker collects the same tests).
This file imports neither JAX nor the JAX package, so it also runs on the
card's machine, which has neither:

    python3 -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances.  Paired forward: kernel and plain version round the same
operands to bf16 and the products are exact, so only the f32 sums differ
(tensor-core accumulation and order): relative error <= 1e-4 of the
largest output.  Scorer: f32 throughout, order only: ``rtol=1e-5`` with an
absolute floor of 1e-5 of the largest score.
"""

import numpy as np
import pytest
import torch

from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.ops.spmm_paired import paired_fwd, paired_ref
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
    p = torch.zeros((2, 1, 24, 10), device=cuda_device)
    m = torch.zeros((1, 10, 10), dtype=torch.int8, device=cuda_device)
    s = torch.zeros((1, 4, 10), device=cuda_device)
    with pytest.raises(ValueError):
        paired_fwd(p, m, s)


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
