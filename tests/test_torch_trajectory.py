"""Port of the trajectory half of SLAM mode (`mneslam_tpu_torch.tracking.
trajectory_filler`, `eval.ate`) against the JAX package on the CPU.

Tolerances: ATE metrics equal to 1e-9 relative (the same numpy code).
Filled poses (fp32, 6 motion-only updates through the DROID nets) within
1e-4 of the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mneslam_tpu.eval import ate as jate
from mneslam_tpu.models import droid_net as jdn
from mneslam_tpu.tracking import trajectory_filler as jfill
from mneslam_tpu.tracking import video as jvideo
from mneslam_tpu_torch.eval import ate as pate
from mneslam_tpu_torch.ops import lie as plie
from mneslam_tpu_torch.tracking import trajectory_filler as pfill
from mneslam_tpu_torch.utils.convert import (droid_params_from_jax,
                                             video_state_from_numpy)
from test_eval import apply_sim3, random_trajectory

torch.set_num_threads(1)

# ---------------------------------------------------------------------------
# eval/ate (tests/test_eval.py)
# ---------------------------------------------------------------------------


def _rot_z(theta):
    return np.asarray([[np.cos(theta), -np.sin(theta), 0],
                       [np.sin(theta), np.cos(theta), 0], [0, 0, 1]])


def _ate_case(name):
    if name == "rigid":
        gt = random_trajectory()
        return gt, apply_sim3(gt, 1.0, _rot_z(0.7),
                              np.asarray([1.0, -2.0, 0.5]))
    if name == "scale":
        gt = random_trajectory(seed=1)
        return gt, apply_sim3(gt, 2.5, np.eye(3), np.zeros(3))
    gt = random_trajectory(seed=2)
    est = gt.copy()
    est[:, :3, 3] += 0.05 * np.random.default_rng(3).standard_normal(
        (len(gt), 3))
    return gt, est


@pytest.mark.parametrize("name", ["rigid", "scale", "noise"])
@pytest.mark.parametrize("alignment", ["se3", "sim3"])
def test_evaluate_ate_matches_jax(name, alignment):
    gt, est = _ate_case(name)
    ref = jate.evaluate_ate(gt, est, alignment=alignment)
    got = pate.evaluate_ate(gt, est, alignment=alignment)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-9, atol=1e-12)
    if name == "rigid" or (name == "scale" and alignment == "sim3"):
        assert got["rmse"] < 1e-6
    if name == "noise":
        assert 0.02 < got["rmse"] < 0.15


def test_associate_and_metrics_file_match_jax(tmp_path):
    a, b = np.asarray([0.0, 1.0, 2.0, 3.0]), np.asarray([1.01, 2.99, 10.0])
    for ref, got in zip(jate.associate(a, b, 0.1), pate.associate(a, b, 0.1)):
        np.testing.assert_array_equal(got, ref)
    assert list(pate.associate(a, b, 0.1)[0]) == [1, 3]
    gt, est = _ate_case("noise")
    ts = np.arange(len(gt), dtype=float)
    m = pate.evaluate_ate(gt, est[::2], gt_ts=ts, est_ts=ts[::2],
                          alignment="sim3")
    assert m == jate.evaluate_ate(gt, est[::2], gt_ts=ts, est_ts=ts[::2],
                                  alignment="sim3")
    pate.save_trajectory_metrics(str(tmp_path / "p.txt"), m)
    jate.save_trajectory_metrics(str(tmp_path / "j.txt"), m)
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()


# ---------------------------------------------------------------------------
# trajectory filler
# ---------------------------------------------------------------------------

HT, WD = 12, 16
INTR = np.array([12.0, 12.0, WD / 2 - 0.5, HT / 2 - 0.5], np.float32)
BUF = 8
ALL_T = np.arange(17, dtype=np.float64)       # frames 0..16: two chunks


def _twist_pose(t):
    """A constant-twist trajectory: geodesic interpolation is exact."""
    return plie.exp(torch.tensor([0.05 * t, 0.02 * t, 0.0, 0.0, 0.01 * t,
                                  0.0], dtype=torch.float32))


def _filler_arrays(seed, frames):
    """A buffer with a keyframe every 4th frame of `frames`, random
    features, and random images of every frame."""
    rng = np.random.default_rng(seed)
    KF_T = frames[::4]
    N_KF = len(KF_T)
    poses = np.tile(plie.identity().numpy(), (BUF, 1))
    poses[:N_KF] = torch.stack([_twist_pose(t) for t in KF_T]).numpy()
    disps = np.broadcast_to(0.4 + 0.2 * rng.random((1, HT, WD)),
                            (BUF, HT, WD)).astype(np.float32)
    feats = rng.normal(size=(3, BUF, 128, HT, WD)).astype(np.float32)
    ts = np.zeros(BUF, np.float32)
    ts[:N_KF] = KF_T
    arrays = {"timestamps": ts, "poses": poses.astype(np.float32),
              "poses_gt": np.tile(np.eye(4, dtype=np.float32), (BUF, 1, 1)),
              "disps": disps, "disps_sens": disps, "fmaps": feats[0],
              "nets": np.tanh(feats[1]), "inps": np.maximum(feats[2], 0),
              "damping": np.full((BUF, HT, WD), 1e-6, np.float32)}
    images = rng.random((len(frames), 3, 8 * HT, 8 * WD)).astype(np.float32)
    return arrays, images, N_KF


def test_filler_matches_jax():
    """The filler with the DROID nets (the JAX-initialised weights), the
    same keyframe buffer and frames (one chunk) in both packages."""
    frames = ALL_T[:13]
    arrays, images, N_KF = _filler_arrays(0, frames)
    jp = jdn.init_droid_net(jax.random.PRNGKey(1))
    tp = droid_params_from_jax(jax.tree.map(np.asarray, jp))
    jstate = jvideo.VideoState(**{k: jnp.asarray(v)
                                  for k, v in arrays.items()})
    ref = jfill.PoseTrajectoryFiller(jp, jnp.asarray(INTR))(
        jstate, N_KF, ((t, jnp.asarray(im)) for t, im in zip(frames, images)))
    filler = pfill.PoseTrajectoryFiller(tp, torch.tensor(INTR))
    got = filler(video_state_from_numpy(arrays), N_KF,
                 ((t, torch.tensor(im)) for t, im in zip(frames, images)))
    assert got.shape == (len(frames), 7)
    assert filler.lookups == 6                  # 6 updates of one chunk
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_filler_oracle_recovers_interpolated_poses():
    """tests/test_slam.py:72 in the port: with a zero update the filler
    keeps its seeds, which are exact on a constant-twist trajectory."""
    arrays, images, N_KF = _filler_arrays(1, ALL_T)

    def update_fn(p, state, ii, jj, net, corr, motion, coords1):
        return net, torch.zeros_like(coords1), torch.ones_like(coords1)

    def agg_fn(p, net, ii, mask, n):
        return 1e-4 * torch.ones((net.shape[0], HT, WD)), \
            torch.zeros((net.shape[0], 576, HT, WD))

    jp = jdn.init_droid_net(jax.random.PRNGKey(1))
    tp = droid_params_from_jax(jax.tree.map(np.asarray, jp))
    filler = pfill.PoseTrajectoryFiller(tp, torch.tensor(INTR),
                                        update_fn=update_fn, agg_fn=agg_fn)
    filled = filler(video_state_from_numpy(arrays), N_KF,
                    ((t, torch.tensor(im)) for t, im in zip(ALL_T, images)))
    assert filled.shape == (17, 7)
    for t in ALL_T:
        err = float(plie.log(plie.mul(filled[int(t)],
                                      plie.inv(_twist_pose(t)))).norm())
        assert err < 5e-2, (t, err)
