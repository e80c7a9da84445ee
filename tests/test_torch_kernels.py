"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here needs a CUDA device (a CUDA kernel has no CPU mode) and
skips without one. On a machine with a GPU and nvcc, run them with

    python -m pytest tests/test_torch_kernels.py --noconftest -q

(`--noconftest`: the suite's conftest configures JAX, which these tests
do not use). Tolerances: for the scatter, atomics add a row's duplicates
in a run-dependent order, so each output may move by up to 5e-5 of the sum
of the magnitudes added into it (plus 1e-6); for the correlation windows,
kernel and plain version each sum C = 128 fp32 products in their own
order, so they differ by at most 2 * 128 * 2^-24 of the dot of the
magnitudes (plus 1e-7).
"""

import pytest
import torch

from mneslam_tpu_torch.kernels.corr_window import (
    corr_window, corr_window_multilevel, corr_window_multilevel_plain,
    corr_window_plain)
from mneslam_tpu_torch.kernels.scatter_add_rows import (
    scatter_add_rows, scatter_add_rows_plain)
from mneslam_tpu_torch.ops import correlation, interp

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


CORR_RTOL = 2 * 128 * 2.0 ** -24


def _corr_inputs(N, H, W, E, n_masked, device, seed=0, C=128):
    """Feature rows, padded levels, slab starts and mask the way
    `correlation.alt_corr` builds them, with lookup centres inside, near
    and far outside the image."""
    g = torch.Generator().manual_seed(seed)
    fmaps = torch.randn((N, C, H, W), generator=g)
    coords = torch.stack([torch.rand((E, H, W), generator=g) * (W + 40) - 20,
                          torch.rand((E, H, W), generator=g) * (H + 40) - 20],
                         dim=-1)
    pyr = correlation.build_pyramid(fmaps.to(device))
    f1 = pyr[0].permute(0, 2, 3, 1).reshape(N, H * W, C).contiguous()
    levels, w2ps, xs, _ = correlation._padded_levels(pyr, coords.to(device),
                                                     3)
    ii = torch.randint(0, N, (E,), generator=g).int().to(device)
    jj = torch.randint(0, N, (E,), generator=g).int().to(device)
    mask = torch.ones(E, dtype=torch.int32)
    mask[E - n_masked:] = 0
    return f1, levels, ii, jj, xs, w2ps, mask.to(device)


def _assert_corr_close(got, ref, mag):
    assert bool(((got - ref).abs() <= CORR_RTOL * mag + 1e-7).all())


@pytest.mark.parametrize("N,H,W,E,n_masked", [
    (6, 12, 16, 5, 2),
    (26, 40, 80, 91, 16),     # a room0 frontend update: 91 slots, 75 real
    (2, 40, 80, 1, 0),        # the room0 motion filter's lookup
    (3, 13, 21, 4, 1),        # HW not a multiple of the pixel tile
])
def test_corr_window_multilevel_matches_plain(cuda, N, H, W, E, n_masked):
    f1, levels, ii, jj, xs, w2ps, mask = _corr_inputs(N, H, W, E, n_masked,
                                                      cuda)
    before = corr_window_multilevel.launches
    got = corr_window_multilevel(f1, levels, ii, jj, xs, w2ps, mask=mask)
    assert corr_window_multilevel.launches == before + 1
    ref = corr_window_multilevel_plain(f1, levels, ii, jj, xs, w2ps,
                                       mask=mask)
    mag = corr_window_multilevel_plain(f1.abs(), [lv.abs() for lv in levels],
                                       ii, jj, xs, w2ps, mask=mask)
    torch.cuda.synchronize()
    assert got.shape == (E, H * W, 4, 64) and got.dtype == torch.float32
    _assert_corr_close(got, ref, mag)
    assert not got[mask == 0].any()                 # masked: zeros
    if n_masked == 0:
        assert got.abs().max() > 0


def test_corr_window_per_level_matches_plain(cuda):
    f1, levels, ii, jj, xs, w2ps, _ = _corr_inputs(5, 40, 80, 12, 0, cuda)
    for lvl in range(4):
        xl = xs[..., lvl].contiguous()
        before = corr_window.launches
        got = corr_window(f1, levels[lvl], ii, jj, xl, w2ps[lvl])
        assert corr_window.launches == before + 1
        assert got.shape == (12, 3200, 64)
        _assert_corr_close(got, corr_window_plain(f1, levels[lvl], ii, jj,
                                                  xl, w2ps[lvl]),
                           corr_window_plain(f1.abs(), levels[lvl].abs(), ii,
                                             jj, xl, w2ps[lvl]))


def test_corr_window_rejects_bad_inputs(cuda):
    f1, levels, ii, jj, xs, w2ps, mask = _corr_inputs(3, 12, 16, 2, 0, cuda,
                                                      C=48)
    with pytest.raises(ValueError, match="multiple of 32"):
        corr_window_multilevel(f1, levels, ii, jj, xs, w2ps)
    f1, levels, ii, jj, xs, w2ps, mask = _corr_inputs(3, 12, 16, 2, 0, cuda)
    with pytest.raises(TypeError, match="int32"):
        corr_window_multilevel(f1, levels, ii.long(), jj, xs, w2ps)
    with pytest.raises(ValueError, match="f1_rows on"):
        corr_window_multilevel(f1, levels, ii.cpu(), jj, xs, w2ps)


def test_alt_corr_on_gpu_matches_cpu(cuda):
    g = torch.Generator().manual_seed(1)
    fmaps = torch.randn((4, 128, 24, 32), generator=g)
    coords = torch.rand((6, 24, 32, 2), generator=g) * 60 - 14
    ii = torch.tensor([0, 1, 2, 3, 0, 1])
    jj = torch.tensor([1, 2, 3, 0, 2, 1])
    mask = torch.tensor([1, 1, 0, 1, 1, 0])
    out = [correlation.alt_corr(fmaps.to(d), ii.to(d), jj.to(d),
                                coords.to(d), mask=mask.to(d)).cpu()
           for d in ("cpu", cuda)]
    torch.testing.assert_close(out[1], out[0], rtol=1e-4, atol=1e-5)
    assert not out[1][mask == 0].any()
