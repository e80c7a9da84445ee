"""The slice as a whole, against the JAX package on the CPU: both
packages' `MNESLAM.run_slam` past the frontend window, with loop BA after
every keyframe, periodic global BA (dense, chunked, sparse-Schur), the
trajectory filler over every frame and the APE, on one tiny synthetic
config with the oracle tracker update (the published DROID weights are not
in the repository).

Tolerances: key poses within 1e-3 m of the JAX package's; both runs' APE
(Sim(3)) under 5 cm, the JAX `tests/test_slam_full.py` limit.

The JAX run goes in a child process (this file run as a script): its many
XLA compiles then stay out of the test worker, where compiler state that
piles up over a run has crashed XLA:CPU before (tests/conftest.py)."""

import os
import subprocess
import sys

import numpy as np
import torch

from mneslam_tpu_torch import config as pconfig
from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
from mneslam_tpu_torch.slam import MNESLAM
from test_torch_slam import _oracle, _slam_overrides

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

N_FRAMES = 16
ATE_LIMIT_M = 0.05          # tests/test_slam_full.py:93
KEY_POSE_TOL_M = 1e-3


def _slice_overrides(tmp_path):
    """Tiny synthetic SLAM past a frontend window of 6: loop BA after every
    keyframe from 7 on (loop window 6), global BA every 5 keyframes; the
    chunked update from 32 edge slots (global BA from 8 keyframes)."""
    ov = _slam_overrides(tmp_path, buffer=16,
                         frontend={"enable_loop": True, "window": 6})
    ov["tracking"]["backend"] = {
        "thresh": 25.0, "radius": 1, "nms": 1, "loop_window": 6,
        "loop_thresh": 25.0, "loop_radius": 1, "loop_nms": 1,
        "corr_chunk": 32}
    ov["mapping"]["global_ba_every"] = 5
    ov["meshing"] = {"resolution": 0.4}      # the JAX terminate's mesh
    ov["loop_detection"] = {"enabled": False}
    return ov


# the sparse-Schur BA from 10 frames (the published 64 is past this run)
SPARSE_THRESHOLD = 10


def test_slam_past_frontend_window_matches_jax(tmp_path):
    cfg = pconfig.make_config(_slice_overrides(tmp_path / "port"))
    ds = SyntheticBoxDataset(cfg, num_frames=N_FRAMES)
    update_fn, agg_fn = _oracle(
        ds, torch.tensor([60.0 / 8, 60.0 / 8, 47.5 / 8, 31.5 / 8]))
    slam = MNESLAM(cfg, ds, device="cpu", update_fn=update_fn,
                   agg_fn=agg_fn)
    slam.tracker.backend.SPARSE_BA_THRESHOLD = SPARSE_THRESHOLD
    res = slam.run_slam()

    jkey, jrmse, jcounter = _jax_run_in_child(tmp_path / "jax")

    be = slam.tracker.backend
    assert slam.tracker.counter == jcounter == N_FRAMES
    assert be.loop_bas > 0 and be.dense_bas > 0
    assert be.sparse_updates > 0 and be.chunked_updates > 0
    for f in ("est_poses.npy", "key_est_poses.npy", "key_timestamps.npy",
              "metrics_traj.txt"):
        assert os.path.exists(os.path.join(slam.out_dir, f)), f
    est = np.load(os.path.join(slam.out_dir, "est_poses.npy"))
    assert est.shape == (N_FRAMES, 4, 4) and np.isfinite(est).all()
    key = np.load(os.path.join(slam.out_dir, "key_est_poses.npy"))
    np.testing.assert_allclose(key[:, :3, 3], jkey[:, :3, 3],
                               atol=KEY_POSE_TOL_M)
    assert res["ate"]["rmse"] < ATE_LIMIT_M
    assert jrmse < ATE_LIMIT_M


def _jax_run(out_dir):
    """The JAX package's run of the same config, in this process ->
    (key poses, APE rmse, keyframes tracked)."""
    import jax.numpy as jnp

    from mneslam_tpu import config as jconfig
    from mneslam_tpu.data.synthetic import SyntheticBoxDataset as JBox
    from mneslam_tpu.slam import MNESLAM as JMNESLAM
    from test_slam_full import gt_tracker_poses, make_oracle

    jcfg = jconfig.make_config(_slice_overrides(out_dir))
    jds = JBox(jcfg, num_frames=N_FRAMES)
    ju, ja = make_oracle(gt_tracker_poses(jds),
                         jnp.asarray([60.0 / 8, 60.0 / 8, 47.5 / 8,
                                      31.5 / 8]))
    jslam = JMNESLAM(jcfg, jds, update_fn=ju, agg_fn=ja)
    jslam.tracker.backend.SPARSE_BA_THRESHOLD = SPARSE_THRESHOLD
    jres = jslam.run_slam()
    key = np.load(os.path.join(jslam.out_dir, "key_est_poses.npy"))
    return key, jres["ate"]["rmse"], jslam.tracker.counter


def _jax_run_in_child(out_dir):
    """`_jax_run` in a child process (this file as a script) -> its
    result."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        str(out_dir)], capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(os.path.join(str(out_dir), "result.npz")) as z:
        return z["key"], float(z["rmse"]), int(z["counter"])


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    key, rmse, counter = _jax_run(sys.argv[1])
    np.savez(os.path.join(sys.argv[1], "result.npz"), key=key, rmse=rmse,
             counter=counter)
