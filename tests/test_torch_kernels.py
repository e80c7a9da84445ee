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
magnitudes (plus 1e-7). Kernel 2b (tensor cores, 3xTF32) against its plain
version and against kernel 2: MMA_RTOL below, derived there. The blocked
and bucketed scatters add into shared memory with atomics, so they take
the scatter's tolerance; the corr variants with an unrolled pixel loop
keep every output's FMA sequence and must equal kernel 2 bit for bit.
"""

import pytest
import torch

from mneslam_tpu_torch.kernels.corr_window import (
    UNROLLS, corr_window, corr_window_multilevel, corr_window_multilevel_mma,
    corr_window_multilevel_mma_plain, corr_window_multilevel_plain,
    corr_window_multilevel_unrolled, corr_window_plain)
from mneslam_tpu_torch.kernels.scatter_add_rows import (
    scatter_add_rows, scatter_add_rows_per_warp, scatter_add_rows_plain)
from mneslam_tpu_torch.kernels.scatter_rows_blocked import (
    scatter_add_rows_blocked, scatter_add_rows_blocked_plain)
from mneslam_tpu_torch.kernels.scatter_rows_bucketed import (
    bucket_route, scatter_add_rows_bucketed,
    scatter_add_rows_bucketed_plain)
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


@pytest.mark.parametrize("per_warp", [16, 32])
@pytest.mark.parametrize("n_rows,nu,width,dtype", [
    (201, 64, 128, torch.float32),
    (77, 50, 30, torch.float32),
    (10, 0, 128, torch.float32),
    (301, 128, 128, torch.bfloat16),
    (160_801, 23_134, 128, torch.float32),
])
def test_scatter_per_warp_variants_match_plain(cuda, per_warp, n_rows, nu,
                                               width, dtype):
    idx, vals = _inputs(n_rows, nu, width, dtype, torch.int64, cuda)
    before = scatter_add_rows_per_warp.launches
    got = scatter_add_rows_per_warp(idx, vals, n_rows, per_warp)
    assert scatter_add_rows_per_warp.launches == before + 1
    ref = scatter_add_rows_plain(idx, vals, n_rows)
    mag = scatter_add_rows_plain(idx, vals.float().abs(), n_rows).float()
    torch.cuda.synchronize()
    tol = 5e-5 * mag + 1e-6
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * ref.float().abs()
    assert got.dtype == dtype and got.shape == (n_rows, width)
    assert bool(((got.float() - ref.float()).abs() <= tol).all())
    with pytest.raises(ValueError, match="per_warp"):
        scatter_add_rows_per_warp(idx, vals, n_rows, 12)


def _assert_scatter_close(got, idx, vals, n_rows):
    ref = scatter_add_rows_plain(idx, vals, n_rows)
    mag = scatter_add_rows_plain(idx, vals.float().abs(), n_rows).float()
    torch.cuda.synchronize()
    assert got.dtype == vals.dtype and got.shape == (n_rows, vals.shape[1])
    tol = 5e-5 * mag + 1e-6
    if vals.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * ref.float().abs()
    assert bool(((got.float() - ref.float()).abs() <= tol).all())


@pytest.mark.parametrize("n_rows,nu,width,dtype,idx_dtype,tile", [
    (201, 64, 128, torch.float32, torch.int64, 64),
    (1001, 500, 64, torch.float32, torch.int32, 128),   # 1001 % 128 != 0
    (77, 50, 30, torch.float32, torch.int64, 7),
    (300, 40, 200, torch.float32, torch.int64, 256),
    (10, 0, 128, torch.float32, torch.int64, 128),      # nu = 0: all zeros
    (301, 128, 128, torch.bfloat16, torch.int64, 384),
    (301, 128, 128, torch.bfloat16, torch.int32, 100),
    (160_801, 11_567, 128, torch.float32, torch.int32, 384),
    (160_801, 92_536, 128, torch.bfloat16, torch.int64, 128),
])
def test_blocked_and_bucketed_scatters_match_plain(cuda, n_rows, nu, width,
                                                   dtype, idx_dtype, tile):
    """Out-of-range indices (dropped), duplicates, a run of one row, tile
    heights that do not divide n_rows, nu = 0, bf16 values."""
    idx, vals = _inputs(n_rows, nu, width, dtype, idx_dtype, cuda)
    b0, k0 = scatter_add_rows_blocked.launches, \
        scatter_add_rows_bucketed.launches
    got = scatter_add_rows_blocked(idx, vals, n_rows, tile)
    _assert_scatter_close(got, idx, vals, n_rows)
    assert not got[n_rows - 3:].float().any()
    got = scatter_add_rows_bucketed(idx, vals, n_rows, tile)
    _assert_scatter_close(got, idx, vals, n_rows)
    idx_s, vals_s, _ = bucket_route(idx, vals, n_rows, tile)
    got = scatter_add_rows_bucketed(idx_s, vals_s, n_rows, tile,
                                    presorted=True)
    _assert_scatter_close(got, idx, vals, n_rows)
    assert scatter_add_rows_blocked.launches == b0 + 1
    assert scatter_add_rows_bucketed.launches == k0 + 2
    # the plain versions follow the same blocks and agree as well
    _assert_scatter_close(scatter_add_rows_blocked_plain(idx, vals, n_rows,
                                                         tile),
                          idx, vals, n_rows)
    _assert_scatter_close(scatter_add_rows_bucketed_plain(idx, vals, n_rows,
                                                          tile),
                          idx, vals, n_rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocked_and_bucketed_scatters_all_updates_on_one_row(cuda, dtype):
    idx = torch.full((5000,), 123, dtype=torch.int64, device=cuda)
    vals = torch.randn((5000, 128), device=cuda).to(dtype)
    for fn in (scatter_add_rows_blocked, scatter_add_rows_bucketed):
        _assert_scatter_close(fn(idx, vals, 1000, 128), idx, vals, 1000)


def test_blocked_and_bucketed_scatters_reject_bad_inputs(cuda):
    idx = torch.zeros(4, dtype=torch.int64, device=cuda)
    vals = torch.zeros(4, 128, device=cuda)
    for fn in (scatter_add_rows_blocked, scatter_add_rows_bucketed):
        with pytest.raises(ValueError, match="shared memory"):
            fn(idx, vals, 1000, 455)            # 455 x 128 x 4 B > 227 KB
        with pytest.raises(ValueError, match="shared memory"):
            fn(idx, vals, 1000, 0)
        with pytest.raises(TypeError):
            fn(idx, vals.double(), 3)
        with pytest.raises(TypeError):
            fn(idx.float(), vals, 3)
        with pytest.raises(ValueError):
            fn(idx.cpu(), vals, 3)
        with pytest.raises(ValueError):
            fn(idx[:3], vals, 3)
    assert scatter_add_rows_blocked(idx, vals, 1000, 454).shape == (1000, 128)


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
# Kernel 2b takes each product as 3xTF32, a_hi b_hi + a_hi b_lo + a_lo b_hi
# with |a - a_hi - a_lo| <= 2^-22 |a| (two round-to-nearest conversions to
# 10 explicit mantissa bits): each product is off by at most 3 * 2^-22
# |a b|, the dropped a_lo b_lo included. The tensor core adds the 3 C
# products into an fp32 accumulator, each addition counted at one ulp of
# the running sum (2^-23: rounding toward zero, no guard bit assumed), and
# the other side (plain version or kernel 2) sums C products at 2^-24 each.
MMA_RTOL = 3 * 2.0 ** -22 + 3 * 128 * 2.0 ** -23 + 128 * 2.0 ** -24


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


@pytest.mark.parametrize("N,H,W,E,n_masked", [
    (6, 12, 16, 5, 2),
    (26, 40, 80, 91, 16),     # a room0 frontend update: 91 slots, 75 real
    (81, 40, 80, 256, 20),    # one chunk of a room0 global BA's update
    (2, 40, 80, 1, 0),        # the room0 motion filter's lookup
    (3, 13, 21, 4, 1),        # HW not a multiple of the 8 pixels of a warp
])
def test_corr_window_mma_matches_plain_and_kernel2(cuda, N, H, W, E,
                                                   n_masked):
    f1, levels, ii, jj, xs, w2ps, mask = _corr_inputs(N, H, W, E, n_masked,
                                                      cuda)
    before = corr_window_multilevel_mma.launches
    got = corr_window_multilevel_mma(f1, levels, ii, jj, xs, w2ps, mask=mask)
    assert corr_window_multilevel_mma.launches == before + 1
    mag = corr_window_multilevel_plain(f1.abs(), [lv.abs() for lv in levels],
                                       ii, jj, xs, w2ps, mask=mask)
    ref = corr_window_multilevel_mma_plain(f1, levels, ii, jj, xs, w2ps,
                                           mask=mask)
    k2 = corr_window_multilevel(f1, levels, ii, jj, xs, w2ps, mask=mask)
    torch.cuda.synchronize()
    assert got.shape == (E, H * W, 4, 64) and got.dtype == torch.float32
    assert bool(((got - ref).abs() <= MMA_RTOL * mag + 1e-7).all())
    assert bool(((got - k2).abs() <= MMA_RTOL * mag + 1e-7).all())
    assert not got[mask == 0].any()
    if n_masked == 0:
        assert got.abs().max() > 0


@pytest.mark.parametrize("N,H,W,E,n_masked", [
    (26, 40, 80, 91, 16),     # a room0 frontend update: 91 slots, 75 real
    (3, 13, 21, 4, 1),        # HW not a multiple of the pixel tile
])
def test_corr_window_unrolled_equals_kernel2(cuda, N, H, W, E, n_masked):
    f1, levels, ii, jj, xs, w2ps, mask = _corr_inputs(N, H, W, E, n_masked,
                                                      cuda)
    k2 = corr_window_multilevel(f1, levels, ii, jj, xs, w2ps, mask=mask)
    for u in UNROLLS:
        before = corr_window_multilevel_unrolled.launches
        got = corr_window_multilevel_unrolled(f1, levels, ii, jj, xs, w2ps,
                                              mask=mask, unroll=u)
        assert corr_window_multilevel_unrolled.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, k2), u
    with pytest.raises(ValueError, match="unroll"):
        corr_window_multilevel_unrolled(f1, levels, ii, jj, xs, w2ps,
                                        unroll=3)


def test_corr_window_mma_rejects_bad_inputs(cuda):
    f1, levels, ii, jj, xs, w2ps, mask = _corr_inputs(3, 12, 16, 2, 0, cuda,
                                                      C=96)
    with pytest.raises(ValueError, match="32, 64 or 128"):
        corr_window_multilevel_mma(f1, levels, ii, jj, xs, w2ps)
    f1, levels, ii, jj, xs, w2ps, mask = _corr_inputs(3, 12, 16, 2, 0, cuda,
                                                      C=64)
    got = corr_window_multilevel_mma(f1, levels, ii, jj, xs, w2ps)
    mag = corr_window_multilevel_plain(f1.abs(), [lv.abs() for lv in levels],
                                       ii, jj, xs, w2ps)
    ref = corr_window_multilevel_plain(f1, levels, ii, jj, xs, w2ps)
    assert bool(((got - ref).abs() <= MMA_RTOL * mag + 1e-7).all())


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


@pytest.mark.parametrize("impl", ["pallas_mxu", "pallas_per_level", "xla"])
def test_alt_corr_selection_on_gpu_matches_cpu(cuda, impl, monkeypatch):
    """Each `MNESLAM_CORR_IMPL` path on the GPU against the CPU's default
    path; `pallas_mxu` launches kernel 2b only."""
    monkeypatch.setenv("MNESLAM_CORR_IMPL", impl)
    g = torch.Generator().manual_seed(2)
    fmaps = torch.randn((4, 128, 24, 32), generator=g)
    coords = torch.rand((6, 24, 32, 2), generator=g) * 30 - 2
    ii = torch.tensor([0, 1, 2, 3, 0, 1])
    jj = torch.tensor([1, 2, 3, 0, 2, 1])
    mask = torch.tensor([1, 1, 0, 1, 1, 0])
    k2, k2b = corr_window_multilevel.launches, \
        corr_window_multilevel_mma.launches
    got = correlation.alt_corr(fmaps.to(cuda), ii.to(cuda), jj.to(cuda),
                               coords.to(cuda), mask=mask.to(cuda)).cpu()
    if impl == "pallas_mxu":
        assert corr_window_multilevel_mma.launches == k2b + 1
        assert corr_window_multilevel.launches == k2
    monkeypatch.delenv("MNESLAM_CORR_IMPL")
    ref = correlation.alt_corr(fmaps, ii, jj, coords, mask=mask)
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-4)
    assert not got[mask == 0].any()
