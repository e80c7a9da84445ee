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
the scatter's tolerance (both designs: the thread-block cluster design,
and the tile design of the first port, `*_tiles`); the corr variants
with an unrolled pixel loop keep every output's FMA sequence and must
equal the row design they unroll (`corr_window_multilevel_rows`) bit for bit. The box design of the
correlation kernels runs on smooth lookup centres (`smooth_coords`), its
row path on scattered ones; both hold the same tolerances.
"""

import numpy as np

import pytest
import torch

from mneslam_tpu_torch.kernels.corr_window import (
    UNROLLS, box_path_share, corr_window, corr_window_multilevel,
    corr_window_multilevel_mma, corr_window_multilevel_mma_plain,
    corr_window_multilevel_mma_rows, corr_window_multilevel_plain,
    corr_window_multilevel_rows, corr_window_multilevel_unrolled,
    corr_window_plain)
from mneslam_tpu_torch.kernels.scatter_add_rows import (
    bf16_workspace, scatter_add_rows, scatter_add_rows_bf16_staged,
    scatter_add_rows_per_warp, scatter_add_rows_plain)
from mneslam_tpu_torch.kernels import scatter_rows_blocked as srb
from mneslam_tpu_torch.kernels import scatter_rows_bucketed as srk
from mneslam_tpu_torch.kernels.scatter_cluster import CLUSTERS
from mneslam_tpu_torch.kernels.scatter_rows_blocked import (
    scatter_add_rows_blocked, scatter_add_rows_blocked_plain,
    scatter_add_rows_blocked_tiles)
from mneslam_tpu_torch.kernels.scatter_rows_bucketed import (
    bucket_route, cluster_route, scatter_add_rows_bucketed,
    scatter_add_rows_bucketed_plain, scatter_add_rows_bucketed_tiles)
from mneslam_tpu_torch.ops import correlation, interp
from mneslam_tpu_torch.tools.prof_corr import smooth_coords
from mneslam_tpu_torch.tools.prof_scatter import CONFIGS

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


def _scatter_tol(idx, vals, n_rows):
    """-> (plain fp32 sums, per-output tolerance): 5e-5 x the sum of the
    magnitudes added + 1e-6, plus one bf16 ulp for a bf16 result."""
    ref = scatter_add_rows_plain(idx, vals, n_rows)
    mag = scatter_add_rows_plain(idx, vals.float().abs(), n_rows).float()
    tol = 5e-5 * mag + 1e-6
    if vals.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * ref.float().abs()
    return ref, tol


def _assert_scatter_close(got, idx, vals, n_rows):
    ref, tol = _scatter_tol(idx, vals, n_rows)
    torch.cuda.synchronize()
    assert got.dtype == vals.dtype and got.shape == (n_rows, vals.shape[1])
    assert bool(((got.float() - ref.float()).abs() <= tol).all())


# (blocked, bucketed) wrappers of each design
DESIGNS = {"cluster": (scatter_add_rows_blocked, scatter_add_rows_bucketed),
           "tiles": (scatter_add_rows_blocked_tiles,
                     scatter_add_rows_bucketed_tiles)}


@pytest.mark.parametrize("design", list(DESIGNS))
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
def test_blocked_and_bucketed_scatters_match_plain(cuda, design, n_rows, nu,
                                                   width, dtype, idx_dtype,
                                                   tile):
    """Out-of-range indices (dropped), duplicates, a run of one row, tile
    heights that do not divide n_rows, nu = 0, bf16 values; the cluster
    design at its default cluster size."""
    blocked, bucketed = DESIGNS[design]
    idx, vals = _inputs(n_rows, nu, width, dtype, idx_dtype, cuda)
    b0, k0 = blocked.launches, bucketed.launches
    got = blocked(idx, vals, n_rows, tile)
    _assert_scatter_close(got, idx, vals, n_rows)
    assert not got[n_rows - 3:].float().any()
    got = bucketed(idx, vals, n_rows, tile)
    _assert_scatter_close(got, idx, vals, n_rows)
    idx_s, vals_s, _ = bucket_route(idx, vals, n_rows, tile)
    got = bucketed(idx_s, vals_s, n_rows, tile, presorted=True)
    _assert_scatter_close(got, idx, vals, n_rows)
    assert blocked.launches == b0 + 1
    assert bucketed.launches == k0 + 2
    # the plain versions follow the same buckets and agree as well
    _assert_scatter_close(scatter_add_rows_blocked_plain(idx, vals, n_rows,
                                                         tile),
                          idx, vals, n_rows)
    _assert_scatter_close(scatter_add_rows_bucketed_plain(idx, vals, n_rows,
                                                          tile),
                          idx, vals, n_rows)


@pytest.mark.parametrize("design", list(DESIGNS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocked_and_bucketed_scatters_all_updates_on_one_row(cuda, design,
                                                              dtype):
    idx = torch.full((5000,), 123, dtype=torch.int64, device=cuda)
    vals = torch.randn((5000, 128), device=cuda).to(dtype)
    for fn in DESIGNS[design]:
        _assert_scatter_close(fn(idx, vals, 1000, 128), idx, vals, 1000)
    if design == "cluster":       # every cluster size, the row on rank 0
        for cl in CLUSTERS:
            for fn in DESIGNS[design]:
                _assert_scatter_close(fn(idx, vals, 1000, 16, cluster=cl),
                                      idx, vals, 1000)


@pytest.mark.parametrize("design", list(DESIGNS))
def test_blocked_and_bucketed_scatters_reject_bad_inputs(cuda, design):
    idx = torch.zeros(4, dtype=torch.int64, device=cuda)
    vals = torch.zeros(4, 128, device=cuda)
    blocked, bucketed = DESIGNS[design]
    for fn in (blocked, bucketed):
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
    if design == "cluster":
        for fn in (blocked, bucketed):
            with pytest.raises(ValueError, match="cluster"):
                fn(idx, vals, 1000, 64, cluster=3)
    assert blocked(idx, vals, 1000, 454).shape == (1000, 128)


SOURCES = {"scatter_rows_blocked": srb, "scatter_rows_bucketed": srk}


def _cluster_runs(source, t, cl, vals, idx):
    return SOURCES[source].max_active_clusters(
        vals.shape[1], t, cl, vals.dtype, idx.dtype) >= 1


@pytest.mark.parametrize("t,cl", CONFIGS)
@pytest.mark.parametrize("n_rows,nu,dtype,idx_dtype", [
    (160_801, 11_567, torch.float32, torch.int32),
    (100_400, 92_364, torch.bfloat16, torch.int64),
    (7_001, 3_000, torch.float32, torch.int64),   # not a multiple of cl * t
])
def test_cluster_configs_match_plain_and_tile_design(cuda, t, cl, n_rows, nu,
                                                     dtype, idx_dtype):
    """Each (T, CL) that the probe sweeps, routed and presorted, against
    the plain version and against the tile design on the same inputs (each
    within the tolerance of the plain sums, so within twice it of each
    other). A configuration the card cannot hold must raise."""
    idx, vals = _inputs(n_rows, nu, 128, dtype, idx_dtype, cuda)
    idx_s, vals_s, _ = bucket_route(idx, vals, n_rows, t)
    ref, tol = _scatter_tol(idx, vals, n_rows)
    tiles = scatter_add_rows_blocked_tiles(idx, vals, n_rows, 64)
    runs = {
        "scatter_rows_blocked": [
            lambda: scatter_add_rows_blocked(idx, vals, n_rows, t, cl)],
        "scatter_rows_bucketed": [
            lambda: scatter_add_rows_bucketed(idx, vals, n_rows, t,
                                              cluster=cl),
            lambda: scatter_add_rows_bucketed(idx_s, vals_s, n_rows, t,
                                              presorted=True, cluster=cl)]}
    for source, fns in runs.items():
        for fn in fns:
            if not _cluster_runs(source, t, cl, vals, idx):
                with pytest.raises(RuntimeError, match="cudaError"):
                    fn()
                continue
            got = fn()
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == (n_rows, 128)
            assert bool(((got.float() - ref.float()).abs() <= tol).all())
            assert bool(((got.float() - tiles.float()).abs()
                         <= 2 * tol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cluster_design_hot_bucket(cuda, dtype):
    """90% of the updates in one 64-row tile (the mapping path's skew, and
    worse), the rest spread: every configuration the card holds, routed
    and presorted."""
    n_rows, nu = 160_801, 92_536
    g = torch.Generator(device=cuda).manual_seed(3)
    idx = torch.randint(0, n_rows, (nu,), generator=g, device=cuda)
    hot = torch.rand(nu, generator=g, device=cuda) < 0.9
    idx[hot] = 5000 + torch.randint(0, 64, (int(hot.sum()),), generator=g,
                                    device=cuda)
    vals = torch.randn((nu, 128), generator=g, device=cuda).to(dtype)
    for t, cl in CONFIGS:
        if _cluster_runs("scatter_rows_blocked", t, cl, vals, idx):
            _assert_scatter_close(
                scatter_add_rows_blocked(idx, vals, n_rows, t, cl), idx,
                vals, n_rows)
        if _cluster_runs("scatter_rows_bucketed", t, cl, vals, idx):
            _assert_scatter_close(
                scatter_add_rows_bucketed(idx, vals, n_rows, t, cluster=cl),
                idx, vals, n_rows)
            idx_s, perm, _ = cluster_route(idx, n_rows, t * cl)
            _assert_scatter_close(
                scatter_add_rows_bucketed(idx_s, vals[perm], n_rows, t,
                                          presorted=True, cluster=cl),
                idx, vals, n_rows)


def test_cluster_design_launch_counters(cuda):
    """Each entry counts its own launches, and nothing else does."""
    idx, vals = _inputs(5000, 700, 128, torch.float32, torch.int64, cuda)
    fns = [scatter_add_rows_blocked, scatter_add_rows_bucketed,
           scatter_add_rows_blocked_tiles, scatter_add_rows_bucketed_tiles]
    for k, fn in enumerate(fns):
        before = [f.launches for f in fns]
        fn(idx, vals, 5000)
        fn(idx, vals, 5000)
        after = [f.launches for f in fns]
        assert [a - b for a, b in zip(after, before)] == [
            2 if j == k else 0 for j in range(len(fns))]
        # a plain version launches nothing
        scatter_add_rows_blocked_plain(idx, vals, 5000)
        scatter_add_rows_bucketed_plain(idx, vals, 5000)
        assert [f.launches for f in fns] == after


def test_cluster_the_card_cannot_schedule_raises(cuda):
    """32 blocks per cluster (above the non-portable 16): the C entries
    take it, the launch is refused and the wrapper raises; the card works
    on afterwards."""
    idx, vals = _inputs(5000, 700, 128, torch.float32, torch.int64, cuda)
    with pytest.raises(RuntimeError, match="cudaError"):
        srb._launch("scatter_rows_blocked_cluster", idx, vals, 5000, 64, 32)
    idx_s, perm, off = cluster_route(idx, 5000, 64 * 32)
    with pytest.raises(RuntimeError, match="cudaError"):
        srk._launch_cluster(idx_s, perm, off, vals, 5000, 64, 32)
    for module in (srb, srk):
        try:
            assert module.max_active_clusters(128, 64, 32) == 0
        except RuntimeError:
            pass
    _assert_scatter_close(scatter_add_rows_blocked(idx, vals, 5000), idx,
                          vals, 5000)
    _assert_scatter_close(scatter_add_rows_bucketed(idx, vals, 5000), idx,
                          vals, 5000)


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


def _corr_inputs(N, H, W, E, n_masked, device, seed=0, C=128, coords=None):
    """Feature rows, padded levels, slab starts and mask the way
    `correlation.alt_corr` builds them, with lookup centres inside, near
    and far outside the image (scattered: every pixel tile overflows the
    box design's box), or `coords` [E, H, W, 2] given."""
    g = torch.Generator().manual_seed(seed)
    fmaps = torch.randn((N, C, H, W), generator=g)
    scattered = torch.stack(
        [torch.rand((E, H, W), generator=g) * (W + 40) - 20,
         torch.rand((E, H, W), generator=g) * (H + 40) - 20], dim=-1)
    coords = scattered if coords is None else torch.as_tensor(coords)
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
    got = corr_window_multilevel(f1, levels, ii, jj, xs, w2ps, W, mask=mask)
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
    got = corr_window_multilevel_mma(f1, levels, ii, jj, xs, w2ps, W,
                                     mask=mask)
    assert corr_window_multilevel_mma.launches == before + 1
    mag = corr_window_multilevel_plain(f1.abs(), [lv.abs() for lv in levels],
                                       ii, jj, xs, w2ps, mask=mask)
    ref = corr_window_multilevel_mma_plain(f1, levels, ii, jj, xs, w2ps,
                                           mask=mask)
    k2 = corr_window_multilevel(f1, levels, ii, jj, xs, w2ps, W, mask=mask)
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
    """The unrolled variants of the row design against that design's own
    entry (the production kernel 2 of the first port), bit for bit."""
    f1, levels, ii, jj, xs, w2ps, mask = _corr_inputs(N, H, W, E, n_masked,
                                                      cuda)
    k2 = corr_window_multilevel_rows(f1, levels, ii, jj, xs, w2ps,
                                     mask=mask)
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
        corr_window_multilevel_mma(f1, levels, ii, jj, xs, w2ps, 16)
    f1, levels, ii, jj, xs, w2ps, mask = _corr_inputs(3, 12, 16, 2, 0, cuda,
                                                      C=64)
    got = corr_window_multilevel_mma(f1, levels, ii, jj, xs, w2ps, 16)
    mag = corr_window_multilevel_plain(f1.abs(), [lv.abs() for lv in levels],
                                       ii, jj, xs, w2ps)
    ref = corr_window_multilevel_plain(f1, levels, ii, jj, xs, w2ps)
    assert bool(((got - ref).abs() <= MMA_RTOL * mag + 1e-7).all())


def test_corr_window_per_level_matches_plain(cuda):
    f1, levels, ii, jj, xs, w2ps, _ = _corr_inputs(5, 40, 80, 12, 0, cuda)
    for lvl in range(4):
        xl = xs[..., lvl].contiguous()
        before = corr_window.launches
        got = corr_window(f1, levels[lvl], ii, jj, xl, w2ps[lvl], 80)
        assert corr_window.launches == before + 1
        assert got.shape == (12, 3200, 64)
        _assert_corr_close(got, corr_window_plain(f1, levels[lvl], ii, jj,
                                                  xl, w2ps[lvl]),
                           corr_window_plain(f1.abs(), levels[lvl].abs(), ii,
                                             jj, xl, w2ps[lvl]))


def _clamped_and_wrapping(xs, levels, w2ps):
    """xs [4, HW, L] of smooth centres with: edge 0's first 128 pixels moved
    6 padded rows up and edge 1's last 128 moved 8 down (their window rows
    clamp at the level's first / last row), a few starts at +-10^6; edge
    2's pixels 64-191 at column w2p - 3 of their padded row (the window
    rows wrap into the next padded row)."""
    xs = xs.clone()
    for lvl, (lv, w2p) in enumerate(zip(levels, w2ps)):
        xs[0, :128, lvl] -= 6 * w2p
        xs[1, -128:, lvl] += 8 * w2p
        xs[0, 5, lvl], xs[1, 7, lvl] = -10 ** 6, 10 ** 6
        s = xs[2, 64:192, lvl]
        xs[2, 64:192, lvl] = s - s % w2p + w2p - 3
    return xs.contiguous()


# (case, C): the box design's input cases; N, H, W, E, masked edges, centres
BOX_CASES = {
    "smooth": (26, 40, 80, 91, 16, "smooth"),   # a room0 frontend update
    "scattered": (6, 12, 16, 5, 2, None),       # every tile on the row path
    "step": (6, 40, 80, 3, 0, "step"),          # a depth step: both paths
    "clamp_wrap": (6, 24, 32, 4, 1, "smooth"),  # clamped / wrapping starts
    "ragged": (4, 13, 21, 4, 1, "smooth"),      # HW, W not multiples of 4
    "e1": (2, 40, 80, 1, 0, "smooth"),          # the motion filter's edge
}


@pytest.mark.parametrize("case,C", [
    ("smooth", 128), ("smooth", 64), ("smooth", 32), ("scattered", 128),
    ("step", 128), ("clamp_wrap", 128), ("ragged", 128), ("e1", 128)])
def test_corr_box_design_matches_plain(cuda, case, C):
    """Kernels 2, 2b (box design) and 3, and the row design's entries,
    against the plain versions on both paths of the box design; masked
    edges exactly zero; the box-path share as the case makes it."""
    N, H, W, E, n_masked, centres = BOX_CASES[case]
    if case == "smooth" and C < 128:
        N, H, W, E, n_masked = 6, 24, 32, 8, 2
    coords = (None if centres is None else
              smooth_coords(E, H, W, seed=C, step=25.0 * (centres == "step")))
    f1, levels, ii, jj, xs, w2ps, mask = _corr_inputs(
        N, H, W, E, n_masked, cuda, seed=C, C=C, coords=coords)
    if case == "clamp_wrap":
        xs = _clamped_and_wrapping(xs, levels, w2ps)
    share = box_path_share(xs, [lv.shape[1] for lv in levels], w2ps, W, mask)
    if case == "scattered":
        assert max(share) < 0.1, share
    elif case in ("step", "clamp_wrap"):
        assert 0.0 < share[0] < 1.0, share
    else:
        assert min(share) > 0.9, share
    args = (f1, levels, ii, jj, xs, w2ps)
    counts = [w.launches for w in (corr_window_multilevel,
                                   corr_window_multilevel_mma, corr_window)]
    k2 = corr_window_multilevel(*args, W, mask=mask)
    k2b = corr_window_multilevel_mma(*args, W, mask=mask)
    rows = corr_window_multilevel_rows(*args, mask=mask)
    rows_b = corr_window_multilevel_mma_rows(*args, mask=mask)
    ref = corr_window_multilevel_plain(*args, mask=mask)
    ref_b = corr_window_multilevel_mma_plain(*args, mask=mask)
    mag = corr_window_multilevel_plain(f1.abs(), [lv.abs() for lv in levels],
                                       ii, jj, xs, w2ps, mask=mask)
    torch.cuda.synchronize()
    tol, tol_b = CORR_RTOL * mag + 1e-7, MMA_RTOL * mag + 1e-7
    for got, expect, t in ((k2, ref, tol), (rows, ref, tol),
                           (k2b, ref_b, tol_b), (k2b, k2, tol_b),
                           (rows_b, ref_b, tol_b)):
        assert got.shape == (E, H * W, 4, 64)
        assert bool(((got - expect).abs() <= t).all())
        assert not got[mask == 0].any()
    if E > n_masked:
        assert k2.abs().max() > 0
    for lvl in range(4):                  # kernel 3: one level per launch
        xl = xs[..., lvl].contiguous()
        got = corr_window(f1, levels[lvl], ii, jj, xl, w2ps[lvl], W)
        _assert_corr_close(got, corr_window_plain(f1, levels[lvl], ii, jj,
                                                  xl, w2ps[lvl]),
                           corr_window_plain(f1.abs(), levels[lvl].abs(), ii,
                                             jj, xl, w2ps[lvl]))
    assert [w.launches for w in (corr_window_multilevel,
                                 corr_window_multilevel_mma, corr_window)] \
        == [counts[0] + 1, counts[1] + 1, counts[2] + 4]


@pytest.mark.parametrize("E,n_masked", [(91, 16), (1, 0)])
def test_corr_window_multilevel_at_tum_widths(cuda, E, n_masked):
    """Kernel 2 at configs/TUM/fr1_desk.yaml's tracking grid (240 x 320:
    30 x 40 features, ragged for the 4 x 4 pixel tile; levels 15 x 20,
    7 x 10 and 3 x 5) on smooth centres (the box path): a frontend update
    and the motion filter's edge, against the plain version."""
    N, H, W = 26, 30, 40
    coords = smooth_coords(E, H, W, seed=3)
    f1, levels, ii, jj, xs, w2ps, mask = _corr_inputs(
        N, H, W, E, n_masked, cuda, seed=3, coords=coords)
    # each level zero-padded by 7 + 8 rows and columns
    assert [(lv.shape[1] // w - 15, w - 15) for lv, w in zip(levels, w2ps)] \
        == [(30, 40), (15, 20), (7, 10), (3, 5)]
    share = box_path_share(xs, [lv.shape[1] for lv in levels], w2ps, W,
                           mask)
    assert min(share) > 0.5, share
    before = corr_window_multilevel.launches
    got = corr_window_multilevel(f1, levels, ii, jj, xs, w2ps, W, mask=mask)
    assert corr_window_multilevel.launches == before + 1
    ref = corr_window_multilevel_plain(f1, levels, ii, jj, xs, w2ps,
                                       mask=mask)
    mag = corr_window_multilevel_plain(f1.abs(), [lv.abs() for lv in levels],
                                       ii, jj, xs, w2ps, mask=mask)
    torch.cuda.synchronize()
    assert got.shape == (E, H * W, 4, 64)
    _assert_corr_close(got, ref, mag)
    assert not got[mask == 0].any()


def test_scatter_kernel_bf16_at_the_bf16_render_shapes(cuda):
    """Kernel 1 on bf16 values at one bf16 mapping iteration's shapes
    (configs/Replica/room0_fast.yaml: 2048 + 100 rays x (11 + 8) samples
    = 40812 points; room0's fine xy plane, 400299 rows of 4 x 32
    channels),
    counted as a bf16 launch, against the plain version: both round an
    fp32 sum to bf16."""
    n_rows, nu = 400_299, 40_812
    idx, vals = _inputs(n_rows, nu, 128, torch.bfloat16, torch.int64, cuda)
    before = (scatter_add_rows.launches, scatter_add_rows.launches_bf16)
    got = scatter_add_rows(idx, vals, n_rows)
    assert (scatter_add_rows.launches, scatter_add_rows.launches_bf16) == (
        before[0] + 1, before[1] + 1)
    scatter_add_rows(idx, vals.float(), n_rows)
    assert scatter_add_rows.launches_bf16 == before[1] + 1
    ref = scatter_add_rows_plain(idx, vals, n_rows)
    mag = scatter_add_rows_plain(idx, vals.float().abs(), n_rows)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    tol = 5e-5 * mag + 1e-6 + 2.0 ** -7 * ref.float().abs()
    assert bool(((got.float() - ref.float()).abs() <= tol).all())


def _room0_tables():
    """(name, n_rows, width) of kernel 1's tables on the options of
    configs/Replica/room0.yaml's widths that replica.yaml leaves off:
    the colour planes (c_planes_res 0.08 / 0.02) per level and
    orientation, [H*W, 4C], and the merged sampler's two-level table of
    each geometry orientation, [Hf*Wf, 8C]."""
    from mneslam_tpu_torch.config import make_config
    from mneslam_tpu_torch.configs import ROOM0
    from mneslam_tpu_torch.models.scene_rep import SceneRep

    cfg = make_config({**ROOM0, "grid": {"oneGrid": False}})
    scene = SceneRep(cfg, "cpu")
    out = []
    for lvl, shapes in enumerate(scene.c_plane_shapes):
        for name, (C, H, W) in shapes.items():
            out.append((f"c_planes_{name}{lvl}", H * W, 4 * C))
    for name, (C, H, W) in scene.plane_shapes[1].items():
        out.append((f"merged_{name}", H * W, 8 * C))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_kernel_at_the_colour_plane_and_merged_tables(cuda, dtype):
    """Kernel 1 at the colour planes' tables and the merged sampler's
    [8C]-wide tables at room0 widths, with one mapping pass's 2148 rays x
    43 samples = 92364 updates, against its plain version (the scatter's
    tolerance, plus one bf16 ulp on bf16 values)."""
    for name, n_rows, width in _room0_tables():
        idx, vals = _inputs(n_rows, 92_364, width, dtype, torch.int64, cuda)
        got = scatter_add_rows(idx, vals, n_rows)
        ref = scatter_add_rows_plain(idx, vals, n_rows)
        mag = scatter_add_rows_plain(idx, vals.float().abs(), n_rows)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (n_rows, width), name
        tol = 5e-5 * mag + 1e-6
        if dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * ref.float().abs()
        assert bool(((got.float() - ref.float()).abs() <= tol).all()), name
        assert not got[n_rows - 3:].float().any(), name


def _bf16_route_checks(got, idx, vals, n_rows):
    """The bf16 route's result against the plain version (the scatter's
    tolerance plus one bf16 ulp), its untouched rows +0.0 bit for bit, and
    the workspace all zero after the call."""
    _assert_scatter_close(got, idx, vals, n_rows)
    touched = torch.zeros(n_rows, dtype=torch.bool, device=idx.device)
    keep = (idx >= 0) & (idx < n_rows)
    touched[idx[keep].long()] = True
    assert not got[~touched].view(torch.int16).any()
    rows, flags = bf16_workspace(idx.device)
    assert not rows.any() and not flags.any()


# (n_rows, nu, width, idx dtype, pattern): the bf16 render's shapes (room0
# fine xy, 40812 updates), widths that are not a multiple of 8 or of 128
# (100 takes the float4 accumulate, 30 the other), nu = 0, n_rows = 0
# (every index out of range), indices out of range on both sides, every
# update on one row, values not 8-byte aligned (the other accumulate)
BF16_ROUTE_CASES = [
    (400_299, 40_812, 128, torch.int64, "mixed"),
    (400_299, 40_812, 128, torch.int32, "mixed"),
    (1001, 500, 16, torch.int32, "mixed"),
    (1001, 500, 100, torch.int64, "mixed"),
    (77, 50, 30, torch.int32, "mixed"),
    (10, 0, 128, torch.int64, "mixed"),
    (0, 50, 128, torch.int64, "mixed"),
    (301, 256, 128, torch.int32, "out_of_range"),
    (1000, 5000, 128, torch.int64, "one_row"),
    (1000, 5000, 100, torch.int32, "one_row"),
    (1001, 500, 128, torch.int64, "misaligned"),
]


def _bf16_route_inputs(n_rows, nu, width, idx_dtype, pattern, device):
    idx, vals = _inputs(n_rows, nu, width, torch.bfloat16, torch.int64,
                        device)
    if pattern == "out_of_range":
        idx[::3] = -1 - idx[::3]                  # below 0
        idx[1::3] = n_rows + idx[1::3]            # at n_rows and past it
    elif pattern == "one_row":
        idx[:] = 123
    elif pattern == "misaligned":          # values 2 bytes off 8
        flat = torch.empty(nu * width + 1, dtype=vals.dtype, device=device)
        vals = flat[1:].view(nu, width).copy_(vals)
    return idx.to(idx_dtype), vals


@pytest.mark.parametrize("n_rows,nu,width,idx_dtype,pattern",
                         BF16_ROUTE_CASES)
def test_scatter_bf16_route_matches_plain(cuda, n_rows, nu, width, idx_dtype,
                                          pattern):
    """The two-launch bf16 route (workspace, flags, emit) and the staged
    route of the first port, each against the plain version."""
    idx, vals = _bf16_route_inputs(n_rows, nu, width, idx_dtype, pattern,
                                   cuda)
    before = (scatter_add_rows.launches, scatter_add_rows.launches_bf16)
    got = scatter_add_rows(idx, vals, n_rows)
    assert (scatter_add_rows.launches, scatter_add_rows.launches_bf16) == (
        before[0] + 1, before[1] + 1)
    _bf16_route_checks(got, idx, vals, n_rows)
    staged = scatter_add_rows_bf16_staged.launches
    _assert_scatter_close(scatter_add_rows_bf16_staged(idx, vals, n_rows),
                          idx, vals, n_rows)
    assert scatter_add_rows_bf16_staged.launches == staged + 1


def test_scatter_bf16_route_leaves_no_trace(cuda):
    """Calls in a row at other row counts and widths (the workspace's row
    stride changes), one of them with no host synchronisation allowed:
    each result is the plain version's and the workspace is zero after
    each."""
    for n_rows, nu, width, idx_dtype in [(50_000, 20_000, 128, torch.int64),
                                         (7_001, 3_000, 16, torch.int32),
                                         (20_000, 9_000, 100, torch.int64),
                                         (50_000, 20_000, 128, torch.int32)]:
        idx, vals = _inputs(n_rows, nu, width, torch.bfloat16, idx_dtype,
                            cuda, seed=n_rows)
        got = scatter_add_rows(idx, vals, n_rows)
        _bf16_route_checks(got, idx, vals, n_rows)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = scatter_add_rows(idx, vals, n_rows)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _bf16_route_checks(got, idx, vals, n_rows)


def test_scatter_bf16_route_under_graph_capture_and_on_two_streams(cuda):
    """Both launches capture into a CUDA graph once the workspace is big
    enough (growing it inside a capture raises); a call on a second stream
    waits for the first stream's use of the workspace."""
    idx, vals = _inputs(20_000, 9_000, 128, torch.bfloat16, torch.int64,
                        cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        scatter_add_rows(idx, vals, 20_000)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = scatter_add_rows(idx, vals, 20_000)
    graph.replay()
    _bf16_route_checks(got, idx, vals, 20_000)
    rows, _ = bf16_workspace(cuda)
    big_rows = rows.numel() // 128 + 1
    with pytest.raises(RuntimeError, match="before a CUDA-graph capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            scatter_add_rows(idx, vals, big_rows)
    other = torch.cuda.Stream()
    with torch.cuda.stream(other):
        got = scatter_add_rows(idx, vals, 20_000)
    torch.cuda.current_stream().wait_stream(other)
    _bf16_route_checks(got, idx, vals, 20_000)


def test_scatter_bf16_route_rezeroes_after_a_failed_launch(cuda,
                                                           monkeypatch):
    """A launch that reports an error raises (no fallback) and leaves the
    workspace marked dirty: the next call re-zeroes it first."""
    from mneslam_tpu_torch.kernels import build
    from mneslam_tpu_torch.kernels import scatter_add_rows as mod

    idx, vals = _inputs(5_000, 2_000, 128, torch.bfloat16, torch.int64,
                        cuda)
    scatter_add_rows(idx, vals, 5_000)
    rows, flags = bf16_workspace(cuda)

    def failing(*args):
        rows.fill_(1.0)            # what a half-run launch could leave
        flags.fill_(1)
        return 700

    failing.argtypes = ()          # set up, as the loaded entry is
    lib = type("Lib", (), {"scatter_add_rows_bf16_once": failing})
    with monkeypatch.context() as m:
        m.setattr(build, "load", lambda name: lib)
        with pytest.raises(RuntimeError, match="cudaError 700"):
            scatter_add_rows(idx, vals, 5_000)
    assert mod._workspaces[vals.device.index].dirty
    _bf16_route_checks(scatter_add_rows(idx, vals, 5_000), idx, vals, 5_000)


def test_corr_window_rejects_bad_inputs(cuda):
    f1, levels, ii, jj, xs, w2ps, mask = _corr_inputs(3, 12, 16, 2, 0, cuda,
                                                      C=48)
    with pytest.raises(ValueError, match="multiple of 32"):
        corr_window_multilevel(f1, levels, ii, jj, xs, w2ps, 16)
    f1, levels, ii, jj, xs, w2ps, mask = _corr_inputs(3, 12, 16, 2, 0, cuda)
    with pytest.raises(TypeError, match="int32"):
        corr_window_multilevel(f1, levels, ii.long(), jj, xs, w2ps, 16)
    with pytest.raises(ValueError, match="f1_rows on"):
        corr_window_multilevel(f1, levels, ii.cpu(), jj, xs, w2ps, 16)
    with pytest.raises(ValueError, match="width"):
        corr_window_multilevel(f1, levels, ii, jj, xs, w2ps, 10)
    shifted = torch.empty(f1.numel() + 1, device=cuda)[1:].view(f1.shape)
    shifted.copy_(f1)                      # contiguous, 4 bytes off 16
    with pytest.raises(ValueError, match="aligned"):
        corr_window_multilevel(shifted, levels, ii, jj, xs, w2ps, 16)


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
