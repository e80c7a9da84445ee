"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here needs a CUDA device (a CUDA kernel has no CPU mode) and
skips without one. On a machine with a GPU and nvcc, run them with

    python -m pytest tests/test_torch_kernels.py --noconftest -q

(`--noconftest`: the suite's conftest configures JAX, which these tests
do not use). Tolerance: atomics add a row's duplicates in a run-dependent
order, so each output may move by up to 5e-5 of the sum of the magnitudes
added into it (plus 1e-6).
"""

import pytest
import torch

from mneslam_tpu_torch.kernels.scatter_add_rows import (
    scatter_add_rows, scatter_add_rows_plain)
from mneslam_tpu_torch.ops import interp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(n_rows, nu, width, dtype, idx_dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    idx = torch.randint(0, max(n_rows - 3, 1), (nu,), generator=g,
                        device=device)
    if nu >= 8:
        idx[: nu // 4] = idx[nu // 4: 2 * (nu // 4)]      # duplicates
        idx[nu // 2: nu // 2 + 4] = idx[nu // 2]          # a run of one row
        idx[0], idx[1] = -1, n_rows                       # dropped
    vals = torch.randn((nu, width), generator=g, device=device).to(dtype)
    return idx.to(idx_dtype), vals


@pytest.mark.parametrize("n_rows,nu,width,dtype,idx_dtype", [
    (201, 64, 128, torch.float32, torch.int64),
    (1001, 500, 64, torch.float32, torch.int32),
    (77, 50, 30, torch.float32, torch.int64),
    (300, 40, 200, torch.float32, torch.int64),
    (10, 0, 128, torch.float32, torch.int64),
    (301, 128, 128, torch.bfloat16, torch.int64),
    (400_299, 92_364, 128, torch.float32, torch.int64),   # room0 fine xy
    (100_400, 92_364, 128, torch.bfloat16, torch.int64),  # room0 coarse xy
])
def test_scatter_kernel_matches_plain(cuda, n_rows, nu, width, dtype,
                                      idx_dtype):
    idx, vals = _inputs(n_rows, nu, width, dtype, idx_dtype, cuda)
    before = scatter_add_rows.launches
    got = scatter_add_rows(idx, vals, n_rows)
    assert scatter_add_rows.launches == before + 1
    ref = scatter_add_rows_plain(idx, vals, n_rows)
    mag = scatter_add_rows_plain(idx, vals.float().abs(), n_rows).float()
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (n_rows, width)
    tol = 5e-5 * mag + 1e-6
    if dtype == torch.bfloat16:
        # both round an fp32 sum to bf16: one bf16 ulp apart at most
        tol = tol + 2.0 ** -7 * ref.float().abs()
    assert bool(((got.float() - ref.float()).abs() <= tol).all())
    assert not got[n_rows - 3:].float().any()  # untouched rows stay zero


def test_scatter_kernel_merges_long_runs(cuda):
    """Sorted indices (long runs of one row, the case the warp merges)."""
    idx = torch.arange(1000, device=cuda).repeat_interleave(37)
    vals = torch.randn((idx.numel(), 128), device=cuda)
    got = scatter_add_rows(idx, vals, 1000)
    ref = scatter_add_rows_plain(idx, vals, 1000)
    mag = scatter_add_rows_plain(idx, vals.abs(), 1000)
    assert bool(((got - ref).abs() <= 5e-5 * mag + 1e-6).all())


def test_scatter_kernel_rejects_bad_inputs(cuda):
    idx = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        scatter_add_rows(idx, torch.zeros(4, 8, device=cuda,
                                          dtype=torch.float64), 3)
    with pytest.raises(ValueError):
        scatter_add_rows(idx.cpu(), torch.zeros(4, 8, device=cuda), 3)


def test_sampler_backward_on_gpu_matches_cpu(cuda):
    """The packed sampler's plane gradient (the scatter kernel + the dense
    unpack adjoint) on the GPU equals the CPU plain path."""
    g = torch.Generator().manual_seed(0)
    plane = torch.randn((32, 37, 53), generator=g)
    coords = torch.rand((5000, 2), generator=g) * 2.4 - 1.2
    w = torch.randn((5000, 32), generator=g)
    grads = []
    for dev in ("cpu", cuda):
        p = plane.clone().to(dev).requires_grad_(True)
        c = coords.clone().to(dev).requires_grad_(True)
        (interp.sample_plane_packed(p, c) * w.to(dev)).sum().backward()
        grads.append((p.grad.cpu(), c.grad.cpu()))
    torch.testing.assert_close(grads[1][0], grads[0][0], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(grads[1][1], grads[0][1], rtol=1e-4,
                               atol=1e-4)
