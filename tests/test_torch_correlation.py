"""Port of the correlation lookup (`mneslam_tpu_torch.ops.correlation` and
the plain versions of `kernels.corr_window`) against the JAX package on
the CPU: the Pallas kernels run in interpret mode.

Tolerance: fp32, rtol 1e-4 / atol 1e-5 unless noted. The dots are sums of
C products taken in another order than XLA's, and the bilinear combine
adds four of them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mneslam_tpu.ops import correlation as jcorr
from mneslam_tpu.ops import pallas_kernels as jpk
from mneslam_tpu_torch.kernels import corr_window as kcw
from mneslam_tpu_torch.ops import correlation as pcorr
from mneslam_tpu_torch.tools.prof_corr import smooth_coords
from test_tracking import brute_force_corr

torch.set_num_threads(1)

HT, WD = 12, 16
RTOL, ATOL = 1e-4, 1e-5


def _inputs(seed, N=3, C=8, E=3):
    rng = np.random.default_rng(seed)
    fmaps = rng.normal(size=(N, C, HT, WD)).astype(np.float32)
    coords = np.stack([
        np.stack([rng.uniform(-2, WD + 1, (HT, WD)),
                  rng.uniform(-2, HT + 1, (HT, WD))], -1)
        for _ in range(E)]).astype(np.float32)
    return fmaps, coords


def _kernel_inputs(seed, N=3, C=8, smooth=False):
    """f1 rows, padded f2 levels, widths and slab starts built by the JAX
    package's own preprocessing (`alt_corr_pallas_ml`'s prologue); with
    `smooth` the lookup centres of `smooth_coords` (the box design's box
    path on a GPU) in place of uniformly drawn ones."""
    fmaps, coords = _inputs(seed, N, C)
    if smooth:
        coords = smooth_coords(3, HT, WD, seed=seed)
    pyr = jcorr.build_pyramid(jnp.asarray(fmaps))
    radius, nx, padl = 3, 8, 7
    f1 = pyr[0].transpose(0, 2, 3, 1).reshape(N, HT * WD, C)
    levels, w2ps, xs = [], [], []
    cflat = jnp.asarray(coords).reshape(3, HT * WD, 2)
    for lvl, f2 in enumerate(pyr):
        H2, W2 = f2.shape[2], f2.shape[3]
        w2p = W2 + padl + nx
        pad = jnp.pad(f2.transpose(0, 2, 3, 1),
                      ((0, 0), (padl, nx), (padl, nx), (0, 0)))
        levels.append(pad.reshape(N, -1, C))
        w2ps.append(w2p)
        c = cflat / 2 ** lvl
        x0 = jnp.clip(jnp.floor(c[..., 0]).astype(jnp.int32), -4, W2 + 3)
        y0 = jnp.clip(jnp.floor(c[..., 1]).astype(jnp.int32), -4, H2 + 3)
        xs.append((y0 - radius + padl) * w2p + (x0 - radius + padl))
    return f1, levels, w2ps, jnp.stack(xs, -1)


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def test_plain_multilevel_kernel_matches_pallas_interpret():
    f1, levels, w2ps, xs = _kernel_inputs(0)
    ii = np.array([0, 1, 0, 2], np.int32)
    jj = np.array([1, 2, 2, 0], np.int32)
    mask = np.array([1, 0, 1, 1], np.int32)
    xs4 = jnp.concatenate([xs, xs[:1]])
    ref = jpk.corr_window_int_multilevel(
        f1, levels, jnp.asarray(ii), jnp.asarray(jj), xs4, 8, tuple(w2ps),
        mask=jnp.asarray(mask), interpret=True)
    got = kcw.corr_window_multilevel(
        _t(f1), [_t(lv) for lv in levels], _t(ii), _t(jj),
        _t(xs4).contiguous(), w2ps, WD, mask=_t(mask))
    assert got.shape == (4, HT * WD, 4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    assert not got[1].any()                       # masked edge: all zero


def test_plain_per_level_kernel_matches_pallas_interpret():
    f1, levels, w2ps, xs = _kernel_inputs(1)
    ii = np.array([0, 1, 2], np.int32)
    jj = np.array([1, 2, 1], np.int32)
    for lvl in (0, 2):
        ref = jpk.corr_window_int(f1, levels[lvl], jnp.asarray(ii),
                                  jnp.asarray(jj), xs[..., lvl], 8,
                                  w2ps[lvl], interpret=True)
        got = kcw.corr_window(_t(f1), _t(levels[lvl]), _t(ii), _t(jj),
                              _t(xs[..., lvl]).contiguous(), w2ps[lvl], WD)
        assert got.shape == (3, HT * WD, 64)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)


def test_plain_mma_kernel_matches_pallas_interpret():
    """Kernel 2b's plain version (the block form) against the Pallas
    `mxu=True` kernel in interpret mode; HW = 192 gives blocks of 16."""
    f1, levels, w2ps, xs = _kernel_inputs(4)
    ii = np.array([0, 1, 0, 2], np.int32)
    jj = np.array([1, 2, 2, 0], np.int32)
    mask = np.array([1, 0, 1, 1], np.int32)
    xs4 = jnp.concatenate([xs, xs[:1]])
    ref = jpk.corr_window_int_multilevel(
        f1, levels, jnp.asarray(ii), jnp.asarray(jj), xs4, 8, tuple(w2ps),
        mask=jnp.asarray(mask), interpret=True, mxu=True)
    args = (_t(f1), [_t(lv) for lv in levels], _t(ii), _t(jj),
            _t(xs4).contiguous(), w2ps)
    before = kcw.corr_window_multilevel_mma.launches
    got = kcw.corr_window_multilevel_mma(*args, WD, mask=_t(mask))
    assert kcw.corr_window_multilevel_mma.launches == before   # CPU: plain
    assert got.shape == (4, HT * WD, 4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    assert not got[1].any()
    # the same function as kernel 2's plain version
    np.testing.assert_allclose(
        got.numpy(),
        kcw.corr_window_multilevel_plain(*args, mask=_t(mask)).numpy(),
        rtol=RTOL, atol=ATOL)
    # 34 pixels: no block of 16, blocks of 2
    sub = (args[0][:, :34].contiguous(), args[1], args[2], args[3],
           args[4][:, :34].contiguous(), w2ps)
    np.testing.assert_allclose(
        kcw.corr_window_multilevel_mma_plain(*sub).numpy(),
        kcw.corr_window_multilevel_plain(*sub).numpy(), rtol=RTOL,
        atol=ATOL)


@pytest.mark.parametrize("kernel", ["multilevel", "per_level", "mma"])
def test_plain_kernels_match_pallas_interpret_on_smooth_centres(kernel):
    """The smooth centres that the box design of kernels 2, 3 and 2b takes
    on its box path on a GPU: the plain versions (the wrappers' CPU path)
    against the Pallas kernels in interpret mode, a masked edge included."""
    f1, levels, w2ps, xs = _kernel_inputs(9, smooth=True)
    ii = np.array([0, 1, 0, 2], np.int32)
    jj = np.array([1, 2, 2, 0], np.int32)
    mask = np.array([1, 1, 0, 1], np.int32)
    xs4 = jnp.concatenate([xs, xs[:1]])
    targs = (_t(f1), [_t(lv) for lv in levels], _t(ii), _t(jj),
             _t(xs4).contiguous(), w2ps, WD)
    share = kcw.box_path_share(targs[4], [lv.shape[1] for lv in levels],
                               w2ps, WD, _t(mask))
    assert min(share) > 0.9, share
    if kernel == "per_level":
        for lvl in range(4):
            ref = jpk.corr_window_int(f1, levels[lvl], jnp.asarray(ii),
                                      jnp.asarray(jj), xs4[..., lvl], 8,
                                      w2ps[lvl], interpret=True)
            got = kcw.corr_window(targs[0], targs[1][lvl], *targs[2:4],
                                  targs[4][..., lvl].contiguous(), w2ps[lvl],
                                  WD)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=RTOL, atol=ATOL)
        return
    mxu = kernel == "mma"
    ref = jpk.corr_window_int_multilevel(
        f1, levels, jnp.asarray(ii), jnp.asarray(jj), xs4, 8, tuple(w2ps),
        mask=jnp.asarray(mask), interpret=True, mxu=mxu)
    fn = kcw.corr_window_multilevel_mma if mxu else kcw.corr_window_multilevel
    got = fn(*targs, mask=_t(mask))
    assert got.shape == (4, HT * WD, 4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    assert not got[2].any()


@pytest.mark.parametrize("mxu", [False, True])
def test_plain_kernels_clamp_window_rows_as_pallas_interpret(mxu):
    """Slab starts whose window rows leave the padded level (above its
    first row, below its last, at +-10^6): the plain versions clamp each
    window row's start to [0, R - 8], as the CUDA kernels do and as the
    Pallas kernels' dynamic slices do in interpret mode."""
    f1, levels, w2ps, xs = _kernel_inputs(10, smooth=True)
    xs = np.array(xs)
    for lvl, w2p in enumerate(w2ps):
        xs[0, :40, lvl] -= 6 * w2p
        xs[1, -40:, lvl] += 8 * w2p
        xs[2, :3, lvl] = [-10 ** 6, 10 ** 6, -1]
    ii = np.array([0, 1, 2], np.int32)
    jj = np.array([1, 2, 0], np.int32)
    ref = jpk.corr_window_int_multilevel(
        f1, levels, jnp.asarray(ii), jnp.asarray(jj), jnp.asarray(xs), 8,
        tuple(w2ps), interpret=True, mxu=mxu)
    fn = kcw.corr_window_multilevel_mma if mxu else kcw.corr_window_multilevel
    got = fn(_t(f1), [_t(lv) for lv in levels], _t(ii), _t(jj), _t(xs),
             w2ps, WD)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def _inside_coords(seed, E=3):
    """Lookup centres within r + 1 pixels of every level (the JAX Pallas
    paths clip centres farther out to the border: ROADMAP Queue 3)."""
    rng = np.random.default_rng(seed)
    return np.stack([np.stack([rng.uniform(0, WD - 1, (HT, WD)),
                               rng.uniform(0, HT - 1, (HT, WD))], -1)
                     for _ in range(E)]).astype(np.float32)


@pytest.mark.parametrize("impl", ["pallas", "pallas_mxu",
                                  "pallas_per_level", "xla", None])
def test_alt_corr_selection_matches_jax(impl, monkeypatch):
    """`MNESLAM_CORR_IMPL` in the port selects the counterpart of the JAX
    package's choice (unset: `pallas`); the mask zeroes padded edges on
    every path. The JAX Pallas kernels run in interpret mode."""
    fmaps, _ = _inputs(6)
    coords = _inside_coords(6)
    ii, jj = np.array([0, 1, 2]), np.array([1, 2, 0])
    mask = np.array([1, 0, 1], np.int32)
    jargs = (jnp.asarray(fmaps), jnp.asarray(ii), jnp.asarray(jj),
             jnp.asarray(coords))
    m = jnp.asarray(mask)
    if impl in (None, "pallas", "pallas_mxu"):
        ref = jcorr.alt_corr_pallas_ml(*jargs, interpret=True, mask=m,
                                       mxu=impl == "pallas_mxu")
    elif impl == "pallas_per_level":
        ref = jcorr.alt_corr_pallas(*jargs, interpret=True) \
            * m[:, None, None, None]
    else:
        monkeypatch.setenv("MNESLAM_CORR_IMPL", "xla")
        ref = jcorr.alt_corr(*jargs, mask=m)
    if impl is None:
        monkeypatch.delenv("MNESLAM_CORR_IMPL", raising=False)
    else:
        monkeypatch.setenv("MNESLAM_CORR_IMPL", impl)
    got = pcorr.alt_corr(_t(fmaps), _t(ii), _t(jj), _t(coords),
                         mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    assert not got[1].any()
    # self_corr goes through the same selection
    np.testing.assert_allclose(
        pcorr.self_corr(_t(fmaps[0]), _t(fmaps[1])).numpy(),
        np.asarray(jcorr.alt_corr_xla(
            jnp.asarray(fmaps[:2]), jnp.asarray([0]), jnp.asarray([1]),
            jnp.asarray(_coords_grid()[None]))), rtol=RTOL, atol=ATOL)


def _coords_grid():
    y, x = np.meshgrid(np.arange(HT), np.arange(WD), indexing="ij")
    return np.stack([x, y], -1).astype(np.float32)


def test_alt_corr_selection_rejects_unknown_value(monkeypatch):
    fmaps, coords = _inputs(0)
    monkeypatch.setenv("MNESLAM_CORR_IMPL", "pallas_fast")
    with pytest.raises(ValueError, match="MNESLAM_CORR_IMPL"):
        pcorr.alt_corr(_t(fmaps), _t(np.array([0])), _t(np.array([1])),
                       _t(coords[:1]))


def test_kernel_wrappers_reject_bad_inputs():
    f1, levels, w2ps, xs = _kernel_inputs(2)
    args = [_t(f1), [_t(lv) for lv in levels], _t(np.zeros(3, np.int32)),
            _t(np.ones(3, np.int32)), _t(xs).contiguous(), w2ps, WD]
    with pytest.raises(TypeError, match="int32"):
        kcw.corr_window_multilevel(*args[:2], args[2].long(), *args[3:])
    with pytest.raises(TypeError, match="float32"):
        kcw.corr_window_multilevel(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="xs"):
        kcw.corr_window_multilevel(*args[:4], args[4][:, :5].contiguous(),
                                   w2ps, WD)
    with pytest.raises(ValueError, match="contiguous"):
        kcw.corr_window_multilevel(
            *args[:4], args[4].transpose(0, 1).contiguous().transpose(0, 1),
            w2ps, WD)
    for bad in (0, 5, HT * WD + 1):               # W must divide HW
        with pytest.raises(ValueError, match="width"):
            kcw.corr_window_multilevel(*args[:6], bad)
        with pytest.raises(ValueError, match="width"):
            kcw.corr_window_multilevel_mma(*args[:6], bad)
    # a CPU call never launches the kernel
    before = kcw.corr_window_multilevel.launches
    kcw.corr_window_multilevel(*args)
    assert kcw.corr_window_multilevel.launches == before


@pytest.mark.parametrize("seed", [0, 3])
def test_alt_corr_matches_jax_paths_and_brute_force(seed):
    fmaps, coords = _inputs(seed)
    ii = np.array([0, 1, 0])
    jj = np.array([1, 2, 2])
    mask = np.array([1, 0, 1], np.int32)
    jargs = (jnp.asarray(fmaps), jnp.asarray(ii), jnp.asarray(jj),
             jnp.asarray(coords))
    targs = (_t(fmaps), _t(ii), _t(jj), _t(coords))

    got = pcorr.alt_corr(*targs, mask=_t(mask)).numpy()
    ref_ml = np.asarray(jcorr.alt_corr_pallas_ml(*jargs, interpret=True,
                                                 mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got, ref_ml, rtol=RTOL, atol=ATOL)
    ref_xla = np.asarray(jcorr.alt_corr_xla(*jargs))
    np.testing.assert_allclose(got[[0, 2]], ref_xla[[0, 2]], rtol=RTOL,
                               atol=ATOL)
    assert not got[1].any()

    pyr = [p.numpy() for p in pcorr.build_pyramid(_t(fmaps))]
    for e in (0, 2):
        ref = brute_force_corr(pyr[0][ii[e]], [p[jj[e]] for p in pyr],
                               coords[e])
        np.testing.assert_allclose(got[e], ref, rtol=1e-3, atol=1e-3)


def test_alt_corr_plain_and_per_level_match_jax():
    fmaps, coords = _inputs(5)
    ii, jj = np.array([2, 0, 1]), np.array([0, 2, 0])
    jargs = (jnp.asarray(fmaps), jnp.asarray(ii), jnp.asarray(jj),
             jnp.asarray(coords))
    targs = (_t(fmaps), _t(ii), _t(jj), _t(coords))
    np.testing.assert_allclose(
        pcorr.alt_corr_plain(*targs, chunk=2).numpy(),
        np.asarray(jcorr.alt_corr_xla(*jargs, chunk=2)), rtol=RTOL,
        atol=ATOL)
    np.testing.assert_allclose(
        pcorr.alt_corr_per_level(*targs).numpy(),
        np.asarray(jcorr.alt_corr_pallas(*jargs, interpret=True)),
        rtol=RTOL, atol=ATOL)


def test_build_pyramid_and_self_corr_match_jax():
    fmaps, _ = _inputs(7, N=2)
    jp = jcorr.build_pyramid(jnp.asarray(fmaps))
    tp = pcorr.build_pyramid(_t(fmaps))
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    ref = jcorr.self_corr(jnp.asarray(fmaps[0]), jnp.asarray(fmaps[1]))
    got = pcorr.self_corr(_t(fmaps[0]), _t(fmaps[1]))
    assert got.shape == (1, 196, HT, WD)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_windows_wholly_outside_a_level_are_zero():
    """Lookup centres far outside the image: the port gives the reference
    sampler's zeros (brute force, `alt_corr_xla`). The JAX Pallas path
    clips the slab start and returns the border's dots there instead."""
    fmaps, _ = _inputs(8, N=2)
    co = np.zeros((1, HT, WD, 2), np.float32)
    co[..., 0] = np.linspace(-40, WD + 40, WD)[None, :]
    co[..., 1] = np.linspace(-30, HT + 30, HT)[:, None]
    ii, jj = np.array([0]), np.array([1])
    got = pcorr.alt_corr(_t(fmaps), _t(ii), _t(jj), _t(co)).numpy()
    pyr = [p.numpy() for p in pcorr.build_pyramid(_t(fmaps))]
    ref = brute_force_corr(pyr[0][0], [p[1] for p in pyr], co[0])
    np.testing.assert_allclose(got[0], ref, rtol=1e-3, atol=1e-3)
    jargs = (jnp.asarray(fmaps), jnp.asarray(ii), jnp.asarray(jj),
             jnp.asarray(co))
    np.testing.assert_allclose(got, np.asarray(jcorr.alt_corr_xla(*jargs)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        pcorr.alt_corr_per_level(_t(fmaps), _t(ii), _t(jj), _t(co)).numpy(),
        got, rtol=RTOL, atol=ATOL)
    pallas = np.asarray(jcorr.alt_corr_pallas_ml(*jargs, interpret=True))
    assert np.abs(pallas - ref).max() > 0.1
