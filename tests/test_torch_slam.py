"""Port of the single-agent pipeline (`mneslam_tpu_torch.slam`, `.cli`,
`.configs`) against the JAX package, on the CPU at a tiny size: mapping-only
mode, and SLAM mode with an oracle tracker update (the published DROID
weights are not in the repository)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from mneslam_tpu import config as jconfig
from mneslam_tpu.data.synthetic import SyntheticBoxDataset as JSyntheticBox
from mneslam_tpu.models.scene_rep import SceneRep as JSceneRep
from mneslam_tpu.slam import MNESLAM as JMNESLAM
from mneslam_tpu_torch import cli
from mneslam_tpu_torch import config as pconfig
from mneslam_tpu_torch.configs import ROOM0
from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
from mneslam_tpu_torch.models.scene_rep import param_items
from mneslam_tpu_torch.slam import MNESLAM

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# last-keyframe PSNR of this config over seeds (agent ranks) 0-7, measured
# on the CPU: JAX 24.0-27.1 dB (std 1.1), port 24.7-27.2 dB (std 0.9). The
# random streams differ, so one run of each may differ by the spread of a
# difference of two such draws: 4 dB is about 3 standard deviations.
PSNR_TOL_DB = 4.0


def _overrides(tmp_path):
    return {
        "mode": "mapping",
        "data": {"output": str(tmp_path), "exp_name": "t"},
        "mapping": {"bound": [[-2.2, 2.2]] * 3, "sample": 384,
                    "min_pixels_cur": 64, "first_iters": 80, "iters": 15,
                    "keyframe_every": 3},
        "planes_res": {"coarse": 0.44, "fine": 0.22,
                       "bound_dividable": 0.22},
        "cam": {"H": 40, "W": 56, "fx": 35.0, "fy": 35.0, "cx": 27.5,
                "cy": 19.5, "near": 0.0, "far": 8.0},
        "training": {"n_range_d": 9, "n_samples_d": 8, "range_d": 0.25,
                     "trunc": 0.15},
        "model": {"c_dim": 16, "input_ch": 32, "input_ch_pos": 48,
                  "truncation": 0.15},
    }


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port")
    cfg = pconfig.make_config(_overrides(tmp))
    ds = SyntheticBoxDataset(cfg, num_frames=9)
    slam = MNESLAM(cfg, ds, rank=0, device="cpu")
    metrics = slam.run_mapping_only(log_every=100)
    return cfg, ds, slam, metrics


def test_synthetic_frames_match_jax(tmp_path):
    """The box-room dataset (camera rays, poses, rgb, depth) equals the JAX
    package's, frame by frame."""
    cfg = pconfig.make_config(_overrides(tmp_path))
    ds = SyntheticBoxDataset(cfg, num_frames=5, half=1.5)
    jds = JSyntheticBox(jconfig.make_config(_overrides(tmp_path)),
                        num_frames=5, half=1.5)
    assert len(ds) == len(jds) and ds.num_rays_to_save == jds.num_rays_to_save
    for i in (0, 3):
        a, b = ds[i], jds[i]
        for k in ("c2w", "rgb", "depth", "direction"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_synthetic_frames_are_rendered_once(tmp_path):
    """The box room keeps each rendered frame: a second read returns the
    same arrays, read-only (a write raises), in a fresh dict each call, and
    the items still equal the JAX package's."""
    cfg = pconfig.make_config(_overrides(tmp_path))
    ds = SyntheticBoxDataset(cfg, num_frames=5)
    jds = JSyntheticBox(jconfig.make_config(_overrides(tmp_path)),
                        num_frames=5)
    first, second = ds[2], ds[2]
    assert first is not second
    second["frame_id"] = 99
    assert ds[2]["frame_id"] == 2
    ref = jds[2]
    for k in ("c2w", "rgb", "depth", "direction"):
        assert second[k] is first[k]
        assert not second[k].flags.writeable
        with pytest.raises(ValueError, match="read-only"):
            second[k][0] = 0
        np.testing.assert_allclose(second[k], ref[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_array_equal(ds[2]["depth"], ds.render_frame(2)[1])


def test_mapping_only_pipeline(port_run):
    cfg, ds, slam, metrics = port_run
    assert len(metrics) == 3  # frames 0, 3, 6
    assert slam.mapped_timestamps == [0.0, 3.0, 6.0]
    assert slam.map_state.db.count == 3
    assert all(np.isfinite(v) for m in metrics for v in m.values())
    assert metrics[-1]["psnr"] > 16.0


def test_checkpoint_keys_and_roundtrip(port_run, tmp_path):
    cfg, ds, slam, metrics = port_run
    ckpt = os.path.join(str(tmp_path), "ck.npz")
    slam.save_checkpoint(ckpt)

    jparams = JSceneRep(jconfig.make_config(_overrides(tmp_path))).init_params(
        jax.random.PRNGKey(0))
    jkeys = {"/".join(str(k) for k in p)
             for p, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    with np.load(ckpt) as data:
        assert set(data.files) == jkeys | {"__kf_poses", "__kf_count"}
        assert int(data["__kf_count"]) == 3
        for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]:
            assert data["/".join(str(k) for k in p)].shape == v.shape

    slam2 = MNESLAM(cfg, ds, rank=1, device="cpu")
    slam2.load_checkpoint(ckpt)
    for (pa, a), (pb, b) in zip(param_items(slam.map_state.params),
                                param_items(slam2.map_state.params)):
        assert pa == pb
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    np.testing.assert_array_equal(slam2.map_state.kf_poses.numpy(),
                                  slam.map_state.kf_poses.numpy())


def test_terminate_writes_checkpoint_and_metrics(tmp_path):
    ov = _overrides(tmp_path)
    ov["mapping"].update(first_iters=5, iters=2)
    cfg = pconfig.make_config(ov)
    slam = MNESLAM(cfg, SyntheticBoxDataset(cfg, num_frames=4), device="cpu")
    slam.run_mapping_only()
    res = slam.terminate()
    assert res["keyframes"] == 2
    assert os.path.exists(os.path.join(slam.out_dir, "final_checkpoint.npz"))
    with open(os.path.join(slam.out_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [ln["step"] for ln in lines] == [0, 3]
    assert {"loss", "psnr", "rgb_loss", "depth_loss"} <= set(lines[0])


def test_last_psnr_close_to_jax(port_run, tmp_path):
    """The same tiny mapping-only run in both packages (each with its own
    random stream): last-keyframe PSNR within PSNR_TOL_DB."""
    _, _, _, metrics = port_run
    jcfg = jconfig.make_config(_overrides(tmp_path))
    jslam = JMNESLAM(jcfg, JSyntheticBox(jcfg, num_frames=9), rank=0)
    jmetrics = jslam.run_mapping_only(log_every=100)
    assert len(jmetrics) == len(metrics) == 3
    assert abs(metrics[-1]["psnr"] - jmetrics[-1]["psnr"]) <= PSNR_TOL_DB, (
        metrics[-1]["psnr"], jmetrics[-1]["psnr"])


def test_entry_points_default_to_cuda_and_raise_without_gpu(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pconfig.make_config(_overrides(tmp_path))
    ds = SyntheticBoxDataset(cfg, num_frames=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MNESLAM(cfg, ds)
    path = tmp_path / "tiny.yaml"
    path.write_text("dataset: synthetic\n")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--config", str(path)])


def test_cli_mapping_run_on_cpu(tmp_path):
    import yaml

    ov = _overrides(tmp_path)
    ov["mapping"].update(first_iters=5, iters=2)
    ov["dataset"] = "synthetic"
    ov["data"]["num_frames"] = 4
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(ov))
    res = cli.main(["--config", str(path), "--mode", "mapping",
                    "--output", str(tmp_path / "out"), "--device", "cpu"])
    assert res["keyframes"] == 2
    assert os.path.exists(res["checkpoint"])
    assert res["checkpoint"].startswith(str(tmp_path / "out"))


def test_unported_dataset_and_mode_raise(tmp_path):
    from mneslam_tpu_torch.data.datasets import get_dataset

    # the five file loaders are ported (tests/test_torch_datasets.py); a
    # dataset no loader reads still raises
    with pytest.raises(ValueError, match="kitti"):
        get_dataset(pconfig.make_config({"dataset": "kitti"}))
    cfg = pconfig.make_config(dict(_overrides(tmp_path), mode="tracking"))
    with pytest.raises(ValueError, match="mapping"):
        MNESLAM(cfg, SyntheticBoxDataset(cfg, num_frames=3), device="cpu")


def _leaves(d, prefix=()):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_room0_matches_the_yaml_files(monkeypatch):
    """ROOM0 == configs/Replica/room0.yaml (with replica.yaml) merged over
    the defaults, for every key the slice reads; and the port's own
    config loader reads the files as the JAX one does."""
    monkeypatch.chdir(REPO)
    path = "configs/Replica/room0.yaml"
    jcfg = jconfig.deep_update(jconfig.default_config(),
                               jconfig.load_config(path))
    for keys, v in _leaves(ROOM0):
        ref = jcfg
        for k in keys:
            ref = ref[k]
        assert v == ref, keys
    assert pconfig.load_config(path) == jconfig.load_config(path)
    # the multi-agent slice's keys (replica.yaml:143-160, room0.yaml:8-10)
    for keys in (("loop_detection", "sim_threshold"),
                 ("loop_detection", "loop_launch_th"),
                 ("loop_closure", "pose_decay_sigma"),
                 ("distillation", "use_bound_overlap"),
                 ("loop_bound", "bound_1"), ("model_name",),
                 ("checkpoints", "VGG16-NetVLAD-Pitts30K"),
                 ("mapping", "loop_iters"), ("mapping", "distill_iters"),
                 ("mapping", "lr_rot"), ("mapping", "lr_trans")):
        assert keys in dict(_leaves(ROOM0)), keys
    merged = pconfig.make_config(ROOM0)
    for keys, v in _leaves(ROOM0):
        got = merged
        for k in keys:
            got = got[k]
        assert got == v, keys


# ---------------------------------------------------------------------------
# SLAM mode
# ---------------------------------------------------------------------------

FLIP = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
# key poses of the tiny oracle run against the dataset's poses (the JAX
# test_slam_full holds its trajectory to 5 cm APE)
KEY_POSE_TOL_M = 0.05


def _slam_overrides(tmp_path, **tracking):
    H, W = 64, 96
    tr = {
        "buffer": 24, "warmup": 5, "upsample": False,
        "motion_filter": {"thresh": -1.0, "batch": 4},   # admit every frame
        "frontend": {"enable_loop": False, "keyframe_thresh": -1.0,
                     "window": 10, "radius": 1, "max_factors": 30,
                     "nms": 0, "thresh": 25.0},
    }
    for k, v in tracking.items():
        if isinstance(v, dict):
            tr[k].update(v)
        else:
            tr[k] = v
    return {
        "mode": "slam",
        "data": {"output": str(tmp_path), "exp_name": "slam"},
        "mapping": {"bound": [[-2.2, 2.2]] * 3, "sample": 128,
                    "min_pixels_cur": 32, "first_iters": 10, "iters": 2,
                    "keyframe_every": 4, "global_ba_every": 1000},
        "planes_res": {"coarse": 0.44, "fine": 0.22,
                       "bound_dividable": 0.22},
        "cam": {"H": H, "W": W, "fx": 60.0, "fy": 60.0, "cx": 47.5,
                "cy": 31.5, "H_out": H, "W_out": W, "near": 0.0, "far": 8.0},
        "training": {"n_range_d": 9, "n_samples_d": 8, "range_d": 0.25,
                     "trunc": 0.15},
        "model": {"c_dim": 16, "input_ch": 32, "input_ch_pos": 48,
                  "truncation": 0.15},
        "tracking": tr,
    }


def _oracle(dataset, intr8):
    """update_fn / agg_fn giving ground-truth reprojection targets (the
    port of tests/test_slam_full.py:25-50)."""
    from mneslam_tpu_torch.ops import lie, projective

    G0 = dataset[0]["c2w"]
    table = []
    for i in range(len(dataset)):
        C = FLIP @ np.linalg.inv(G0) @ dataset[i]["c2w"] @ FLIP
        table.append(lie.from_matrix(torch.tensor(
            np.linalg.inv(C).astype(np.float32))))
    gt_table = torch.stack(table)

    def update_fn(params, state, ii, jj, net, corr, motion, coords1):
        idx = state.timestamps.long().clamp(0, len(gt_table) - 1)
        tgt, valid = projective.projective_transform(
            gt_table[idx], state.disps_sens, intr8, ii, jj)
        return net, tgt - coords1, valid.expand(tgt.shape)

    def agg_fn(params, net, ii, mask, n):
        h, w = net.shape[2:]
        return 1e-4 * torch.ones((net.shape[0], h, w)), \
            torch.zeros((n, 576, h, w))

    return update_fn, agg_fn


def _slam(tmp_path, num_frames, **tracking):
    cfg = pconfig.make_config(_slam_overrides(tmp_path, **tracking))
    ds = SyntheticBoxDataset(cfg, num_frames=num_frames)
    intr8 = torch.tensor([60.0 / 8, 60.0 / 8, 47.5 / 8, 31.5 / 8])
    update_fn, agg_fn = _oracle(ds, intr8)
    slam = MNESLAM(cfg, ds, rank=0, device="cpu", update_fn=update_fn,
                   agg_fn=agg_fn)
    return slam, ds


def test_slam_mode_oracle_recovers_key_poses(tmp_path):
    slam, ds = _slam(tmp_path, num_frames=14)
    res = slam.run_slam()
    assert slam.tracker.counter == 14 and res["tracked_keyframes"] == 14
    assert slam.map_counter == 13                # one keyframe behind
    key_poses = np.load(os.path.join(slam.out_dir, "key_est_poses.npy"))
    key_ts = np.load(os.path.join(slam.out_dir, "key_timestamps.npy"))
    np.testing.assert_array_equal(key_ts, np.arange(14))
    gt = np.stack([ds[int(t)]["c2w"] for t in key_ts])
    err = np.linalg.norm(key_poses[:, :3, 3] - gt[:, :3, 3], axis=-1)
    assert err.max() < KEY_POSE_TOL_M, err
    # the mapper's keyframe poses were refreshed from the tracker
    kf = slam.map_state.kf_poses[:13].numpy()
    np.testing.assert_allclose(kf[:, :3, 3], key_poses[:13, :3, 3],
                               atol=1e-4)
    assert all(np.isfinite(v) for m in slam.metrics_log for v in m.values())
    assert os.path.exists(res["checkpoint"])
    # terminate filled every frame's pose and evaluated it
    est = np.load(os.path.join(slam.out_dir, "est_poses.npy"))
    assert est.shape == (14, 4, 4)
    assert res["ate"]["n"] == 14 and res["ate"]["rmse"] < KEY_POSE_TOL_M
    assert os.path.exists(os.path.join(slam.out_dir, "metrics_traj.txt"))


def test_loop_ba_and_global_ba_raise_when_they_would_run(tmp_path):
    """Past `tracking.frontend.window` the loop BA (with `enable_loop`) and
    the periodic global BA run (they raised before the backend was
    ported), and terminate fills the trajectory and evaluates it."""
    slam, _ = _slam(tmp_path / "a", num_frames=8,
                    frontend={"enable_loop": True, "window": 5})
    res = slam.run_slam()
    assert slam.tracker.counter == 8
    # keyframes 6, 7, 8 run the loop BA in place of the last 2 updates
    assert slam.tracker.backend.loop_bas == 3
    assert slam.tracker.frontend.last_loop_t == 8
    assert res["ate"]["rmse"] < KEY_POSE_TOL_M
    slam, _ = _slam(tmp_path / "b", num_frames=8, frontend={"window": 5})
    slam.global_ba_every = 2
    res = slam.run_slam()
    assert slam.tracker.backend.loop_bas == 0
    assert slam.tracker.backend.dense_bas == 1   # at 8 keyframes
    assert slam.tracker.counter > 5
    assert res["ate"]["rmse"] < KEY_POSE_TOL_M


def test_tracking_resize_matches_jax(tmp_path):
    """_to_tracking_res / _depth_to_tracking_res against the JAX methods,
    with and without an edge band."""
    from types import SimpleNamespace

    rng = np.random.default_rng(0)
    rgb = rng.random((68, 120, 3)).astype(np.float32)
    depth = (0.5 + rng.random((68, 120))).astype(np.float32)
    for edge in (0, 2):
        ov = _slam_overrides(tmp_path)
        ov["cam"].update(H=68, W=120, H_out=32, W_out=64, H_edge=edge,
                         W_edge=edge)
        cfg = pconfig.make_config(ov)
        port = SimpleNamespace(config=cfg, device=torch.device("cpu"))
        jself = SimpleNamespace(config=jconfig.make_config(ov))
        got = MNESLAM._to_tracking_res(port, rgb)
        ref = np.asarray(JMNESLAM._to_tracking_res(jself, rgb))
        assert got.shape == (3, 32, 64)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(
            MNESLAM._depth_to_tracking_res(port, depth).numpy(),
            np.asarray(JMNESLAM._depth_to_tracking_res(jself, depth)))


def test_tracking_intrinsics_and_precision(tmp_path):
    """The edge-aware rescale of slam.py:141-153: focal lengths scale with
    the padded size, the principal point shifts by the crop; stored at
    1/8. No tracking.precision on the CPU: fp32 nets and buffers."""
    ov = _slam_overrides(tmp_path)
    ov["cam"].update(H_out=48, W_out=64, H_edge=4, W_edge=8)
    cfg = pconfig.make_config(ov)
    slam = MNESLAM(cfg, SyntheticBoxDataset(cfg, num_frames=2), device="cpu")
    sx, sy = (64 + 16) / 96, (48 + 8) / 64
    ref = np.array([60 * sx, 60 * sy, 47.5 * sx - 8, 31.5 * sy - 4]) / 8
    np.testing.assert_allclose(slam.tracker.intrinsics.numpy(), ref,
                               rtol=1e-6)
    assert slam.tracker.state.fmaps.dtype == torch.float32
    assert slam.tracker.frontend.graph.net.dtype == torch.float32
    assert slam.tracker.ht == 6 and slam.tracker.wd == 8


def test_cli_slam_run_on_cpu(tmp_path):
    import yaml

    ov = _slam_overrides(tmp_path)
    ov["dataset"] = "synthetic"
    ov["data"]["num_frames"] = 6
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(ov))
    res = cli.main(["--config", str(path), "--mode", "slam",
                    "--output", str(tmp_path / "out"), "--device", "cpu"])
    # random DROID weights, every frame admitted: the frontend initialises
    # at warmup 5 and tracks frame 6
    assert res["tracked_keyframes"] == 6
    assert res["checkpoint"].startswith(str(tmp_path / "out"))
    poses = np.load(os.path.join(os.path.dirname(res["checkpoint"]),
                                 "key_est_poses.npy"))
    assert poses.shape == (6, 4, 4) and np.isfinite(poses).all()
    assert np.isfinite(res["ate"]["rmse"])
