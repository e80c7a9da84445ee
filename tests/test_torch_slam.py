"""Port of the mapping-only pipeline (`mneslam_tpu_torch.slam`, `.cli`,
`.configs`) against the JAX package, on the CPU at a tiny size."""

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

    with pytest.raises(ValueError, match="replica"):
        get_dataset(pconfig.make_config({"dataset": "replica"}))
    cfg = pconfig.make_config(dict(_overrides(tmp_path), mode="slam"))
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
    merged = pconfig.make_config(ROOM0)
    for keys, v in _leaves(ROOM0):
        got = merged
        for k in keys:
            got = got[k]
        assert got == v, keys
