"""Port parity: the tracker's and mapper's remaining pieces against the
JAX package on numpy inputs from a seed.

- the fused ConvGRU (`MNESLAM_GRU_IMPL=fused`, `droid_net.gru_apply_fused`)
  against the port's reference GRU (atol 2e-6 / rtol 1e-5, the JAX test's
  bound for the same identity) and against JAX's fused GRU and update
  (rtol 1e-4 / atol 1e-5), with the JAX-initialised weights carried over;
- `video.depth_filter` (counts equal, except that a reprojected disparity
  within rounding of the threshold may count on one side only: at most
  0.5% of the pixels, by one) and `video.upsample_disps` (rtol 1e-5 /
  atol 1e-6);
- `keyframe.keyframe_selection_overlap` (ratios within 2 points of the
  frame: a point on the image border may round either way);
- the trace hook `utils.metrics.maybe_profile`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mneslam_tpu.mapping import keyframe as jkf
from mneslam_tpu.models import droid_net as jdn
from mneslam_tpu.tracking import video as jvideo
from mneslam_tpu_torch.mapping import keyframe as pkf
from mneslam_tpu_torch.models import droid_net as pdn
from mneslam_tpu_torch.ops import lie as plie
from mneslam_tpu_torch.tracking import video as pvideo
from mneslam_tpu_torch.utils import metrics
from mneslam_tpu_torch.utils.convert import (droid_params_from_jax,
                                             video_state_from_numpy)

torch.set_num_threads(1)

HT, WD = 12, 16
INTR = np.array([12.0, 12.0, WD / 2 - 0.5, HT / 2 - 0.5], np.float32)


@pytest.fixture(scope="module")
def update_params():
    jp = jdn.init_update(jax.random.PRNGKey(3))
    return jp, droid_params_from_jax(jax.tree.map(np.asarray, jp))


def _gru_inputs(seed, E=3, h=6, w=10):
    rng = np.random.default_rng(seed)
    net = (0.1 * rng.normal(size=(E, 128, h, w))).astype(np.float32)
    inp = (0.1 * rng.normal(size=(E, 320, h, w))).astype(np.float32)
    return net, inp


def test_fused_gru_matches_reference_and_jax(update_params):
    jp, tp = update_params
    net, inp = _gru_inputs(0)
    ref = pdn.gru_apply(tp["gru"], torch.tensor(net), torch.tensor(inp))
    fused = pdn.gru_apply_fused(tp["gru"], torch.tensor(net),
                                torch.tensor(inp))
    np.testing.assert_allclose(fused.numpy(), ref.numpy(), rtol=1e-5,
                               atol=2e-6)
    jfused = jdn.gru_apply_fused(jp["gru"], jnp.asarray(net),
                                 jnp.asarray(inp))
    np.testing.assert_allclose(fused.numpy(), np.asarray(jfused), rtol=1e-4,
                               atol=1e-5)


def test_gru_impl_selector_is_read_per_call(update_params, monkeypatch):
    """MNESLAM_GRU_IMPL=fused routes `gru_apply` (and so the update) to
    the fused form at each call; the update then matches JAX's update
    under the same setting."""
    jp, tp = update_params
    seen = []
    real = pdn.gru_apply_fused

    def spy(*a):
        seen.append(1)
        return real(*a)

    monkeypatch.setattr(pdn, "gru_apply_fused", spy)
    rng = np.random.default_rng(1)
    E, h, w = 2, 6, 10
    net = np.tanh(rng.normal(size=(E, 128, h, w))).astype(np.float32)
    inp = np.maximum(rng.normal(size=(E, 128, h, w)), 0).astype(np.float32)
    corr = rng.normal(size=(E, 196, h, w)).astype(np.float32)
    flow = rng.normal(size=(E, 4, h, w)).astype(np.float32)
    args = [torch.tensor(a) for a in (net, inp, corr, flow)]
    ref = pdn.update_apply(tp, *args)
    assert not seen
    monkeypatch.setenv("MNESLAM_GRU_IMPL", "fused")
    got = pdn.update_apply(tp, *args)
    assert len(seen) == 1
    jgot = jdn.update_apply(jp, *(jnp.asarray(a) for a in
                                  (net, inp, corr, flow)))
    for a, b, c in zip(got, ref, jgot):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=2e-6)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-4,
                                   atol=1e-5)


def _video(seed, B=10, motion=0.02):
    """A keyframe buffer of B frames: small motions, disparities around
    0.5 with noise, one frame's disparities far off."""
    rng = np.random.default_rng(seed)
    xi = np.concatenate([motion * rng.normal(size=(B, 3)),
                         0.5 * motion * rng.normal(size=(B, 3))], -1)
    poses = plie.exp(torch.tensor(np.cumsum(xi, 0), dtype=torch.float32))
    disps = (0.5 * (1 + 0.02 * rng.normal(size=(B, HT, WD)))).astype(
        np.float32)
    disps[6] *= 3.0
    arrays = {
        "timestamps": np.arange(B, dtype=np.float32),
        "poses": poses.numpy(),
        "poses_gt": np.tile(np.eye(4, dtype=np.float32), (B, 1, 1)),
        "disps": disps,
        "disps_sens": np.zeros((B, HT, WD), np.float32),
        "fmaps": np.zeros((B, 1, HT, WD), np.float32),
        "nets": np.zeros((B, 1, HT, WD), np.float32),
        "inps": np.zeros((B, 1, HT, WD), np.float32),
        "damping": np.full((B, HT, WD), 1e-6, np.float32),
    }
    return (jvideo.VideoState(**{k: jnp.asarray(v) for k, v in
                                 arrays.items()}),
            video_state_from_numpy(arrays))


def test_depth_filter_matches_jax():
    """Every frame of the buffer (the ends have fewer neighbours in the
    buffer), at two thresholds."""
    js, ts = _video(0)
    inds = np.arange(10)
    for th in (0.02, 0.1):
        thresh = np.full(10, th, np.float32)
        ref = np.asarray(jvideo.depth_filter(js, jnp.asarray(INTR),
                                             jnp.asarray(inds),
                                             jnp.asarray(thresh)))
        got = pvideo.depth_filter(ts, torch.tensor(INTR), torch.tensor(inds),
                                  torch.tensor(thresh)).numpy()
        assert got.shape == (10, HT, WD) and got.dtype == np.float32
        diff = np.abs(got - ref)
        assert diff.max() <= 1.0 and (diff > 0).mean() <= 0.005
        assert got.max() == 6.0 and got[6].mean() < 1.0


def test_depth_filter_consistency_as_jax():
    """tests/test_tracking.py:212's case in the port: identity poses and
    constant disparity give 6 supports inside the border; a corrupted
    frame almost none."""
    js, ts = _video(1, motion=0.0)
    disps = torch.full_like(ts.disps, 0.5)
    ts = ts._replace(disps=disps)
    counts = pvideo.depth_filter(ts, torch.tensor(INTR), torch.tensor([4]),
                                 torch.tensor([0.05]))
    assert counts.shape == (1, HT, WD)
    assert float(counts.mean()) > 4.5
    assert float(counts[0, 2:-2, 2:-2].min()) == 6.0
    disps2 = disps.clone()
    disps2[4] = 5.0
    counts2 = pvideo.depth_filter(ts._replace(disps=disps2),
                                  torch.tensor(INTR), torch.tensor([4]),
                                  torch.tensor([0.05]))
    assert float(counts2.mean()) < 0.5


def test_upsample_disps_matches_jax():
    js, ts = _video(2)
    mask = np.random.default_rng(3).normal(size=(3, 576, HT, WD)).astype(
        np.float32)
    inds = np.array([1, 4, 9])
    ref = np.asarray(jvideo.upsample_disps(js, jnp.asarray(inds),
                                           jnp.asarray(mask)))
    got = pvideo.upsample_disps(ts, torch.tensor(inds), torch.tensor(mask))
    assert got.shape == (3, 8 * HT, 8 * WD)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_keyframe_selection_overlap_matches_jax():
    rng = np.random.default_rng(4)
    K, R = 6, 256
    xi = np.concatenate([0.4 * rng.normal(size=(K, 3)),
                         0.3 * rng.normal(size=(K, 3))], -1)
    poses = plie.matrix(plie.exp(torch.tensor(xi, dtype=torch.float32)))
    poses[1, 0, 3] = 50.0        # sees nothing
    poses[0] = torch.eye(4)      # the current frame's own pose
    rays_o = (0.05 * rng.normal(size=(R, 3))).astype(np.float32)
    rays_d = np.concatenate([0.3 * rng.normal(size=(R, 2)),
                             -np.ones((R, 1))], -1).astype(np.float32)
    depth = rng.uniform(0.5, 4.0, R).astype(np.float32)
    intr = np.array([40.0, 40.0, 31.5, 23.5], np.float32)
    ref = np.asarray(jkf.keyframe_selection_overlap(
        jnp.asarray(poses.numpy()), jnp.asarray(rays_o),
        jnp.asarray(rays_d), jnp.asarray(depth), jnp.asarray(intr),
        H=48, W=64))
    got = pkf.keyframe_selection_overlap(
        poses, torch.tensor(rays_o), torch.tensor(rays_d),
        torch.tensor(depth), torch.tensor(intr), H=48, W=64)
    assert got.shape == (K,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2.0 / R)
    assert float(got[0]) > 0.8 and float(got[1]) == 0.0
    assert len(set(np.round(ref, 4))) > 2        # the poses differ


def test_maybe_profile_writes_a_trace_only_when_asked(tmp_path,
                                                      monkeypatch):
    monkeypatch.delenv("MNESLAM_TRACE_DIR", raising=False)
    with metrics.maybe_profile("map"):
        torch.ones(4).sum()
    assert not os.listdir(tmp_path)
    monkeypatch.setenv("MNESLAM_TRACE_DIR", str(tmp_path))
    with metrics.maybe_profile("map"):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = os.listdir(tmp_path / "map")
    assert len(files) == 1 and files[0].endswith(".json")
    assert os.path.getsize(tmp_path / "map" / files[0]) > 0
