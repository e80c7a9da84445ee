"""The port's full-state checkpoint (`MNESLAM.save_full_state` /
`load_full_state`) and `cli --resume`, on the CPU at a tiny size: a resumed
run matches the uninterrupted one bit for bit (tests/test_slam.py:134 of
the JAX package)."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from mneslam_tpu_torch import cli
from mneslam_tpu_torch.config import make_config
from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
from mneslam_tpu_torch.models.scene_rep import param_items
from mneslam_tpu_torch.slam import MNESLAM

torch.set_num_threads(1)


def _overrides(tmp_path, exp="resume"):
    return {
        "mode": "mapping",
        "dataset": "synthetic",
        "data": {"output": str(tmp_path), "exp_name": exp, "num_frames": 9},
        "mapping": {"bound": [[-2.2, 2.2]] * 3, "sample": 256,
                    "min_pixels_cur": 64, "first_iters": 30, "iters": 8,
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


def _agent(cfg, ds):
    return MNESLAM(cfg, ds, rank=0, device="cpu")


def _map(agent, idx):
    frame, pose = agent._frame_for_mapping(idx)
    agent._map_keyframe(idx, frame, pose,
                        first=not agent.first_frame_mapped)


def _assert_same_map(a, b):
    for (pa, x), (pb, y) in zip(param_items(a.map_state.params),
                                param_items(b.map_state.params)):
        assert pa == pb
        np.testing.assert_array_equal(x.detach().numpy(), y.detach().numpy())
    np.testing.assert_array_equal(a.map_state.db.rays.numpy(),
                                  b.map_state.db.rays.numpy())
    np.testing.assert_array_equal(a.map_state.kf_poses.numpy(),
                                  b.map_state.kf_poses.numpy())


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("full")
    cfg = make_config(_overrides(tmp))
    ds = SyntheticBoxDataset(cfg, num_frames=9)
    a = _agent(cfg, ds)
    a.run_mapping_only(log_every=100)
    return cfg, ds, a


def test_resumed_run_matches_uninterrupted_bit_for_bit(uninterrupted,
                                                       tmp_path):
    """Map keyframes 0 and 3, save, restore into a fresh agent, map 6: the
    map parameters, Adam moments, ray DB and poses equal the uninterrupted
    run's exactly."""
    cfg, ds, a = uninterrupted
    b = _agent(cfg, ds)
    for idx in (0, 3):
        _map(b, idx)
    ck = os.path.join(str(tmp_path), "full_state")
    b.save_full_state(ck)
    assert os.path.exists(ck) and not os.path.exists(ck + ".tmp")

    c = _agent(cfg, ds)
    c.load_full_state(ck)
    assert c.mapped_timestamps == b.mapped_timestamps == [0.0, 3.0]
    assert c.first_frame_mapped and c.map_state.db.count == 2
    _map(c, 6)
    _assert_same_map(a, c)
    opt_a, opt_c = a.map_state.optimizer, c.map_state.optimizer
    for (_, x), (_, y) in zip(param_items(a.map_state.params),
                              param_items(c.map_state.params)):
        sa, sc = opt_a.state[x], opt_c.state[y]
        assert float(sa["step"]) == float(sc["step"]) == 30 + 2 * 8
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(sa[k].numpy(), sc[k].numpy())
    # the resumed agent logs its own keyframe under its frame id
    c._flush_metrics()
    assert c.metrics_log[0] == a.metrics_log[2]


def test_full_state_keys_and_generator(uninterrupted, tmp_path):
    """One .npz: parameters, Adam state per parameter, DB, poses, counters
    and the generator's state (the draws after a restore repeat)."""
    cfg, ds, a = uninterrupted
    ck = str(tmp_path / "s.npz")
    a.save_full_state(ck)
    with np.load(ck) as data:
        keys = set(data.files)
    n_params = len(param_items(a.map_state.params))
    assert sum(k.startswith("params/") for k in keys) == n_params
    assert sum(k.startswith("adam/") for k in keys) == 3 * n_params
    assert {"db/rays", "db/frame_ids", "db/count", "kf_poses",
            "rng/generator", "host/map_counter",
            "host/mapped_timestamps"} <= keys
    assert not any(k.startswith("video/") for k in keys)
    b = _agent(cfg, ds)
    b.load_full_state(ck)
    _assert_same_map(a, b)
    assert torch.equal(torch.rand(5, generator=a.generator),
                       torch.rand(5, generator=b.generator))


def test_cli_resume_continues_the_run(uninterrupted, tmp_path):
    """`cli --resume` restores the state and maps only the keyframes the
    interrupted run had not mapped; the result equals the uninterrupted
    run."""
    cfg, ds, a = uninterrupted
    b = _agent(make_config(_overrides(tmp_path, exp="interrupted")), ds)
    for idx in (0, 3):
        _map(b, idx)
    ck = str(tmp_path / "full_state.npz")
    b.save_full_state(ck)
    ref = str(tmp_path / "ref.npz")
    a.save_checkpoint(ref)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(_overrides(tmp_path, exp="cli")))
    res = cli.main(["--config", str(path), "--device", "cpu", "--resume",
                    ck])
    assert res["keyframes"] == 3
    with np.load(res["checkpoint"]) as got, np.load(ref) as want:
        assert got.files == want.files
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with open(os.path.join(os.path.dirname(res["checkpoint"]),
                           "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [6]


def test_slam_mode_full_state_roundtrip(tmp_path):
    """In SLAM mode the state also holds the tracker's keyframe buffer and
    counters; a fresh agent restores them exactly."""
    from test_torch_slam import _slam

    a, _ = _slam(tmp_path / "a", num_frames=7)
    while a.slam_step():
        pass
    ck = str(tmp_path / "slam_state.npz")
    a.save_full_state(ck)
    b, _ = _slam(tmp_path / "b", num_frames=7)
    b.load_full_state(ck)
    for name, x in a.tracker.state._asdict().items():
        np.testing.assert_array_equal(
            x.numpy(), getattr(b.tracker.state, name).numpy(), err_msg=name)
    assert b.tracker.counter == a.tracker.counter == 7
    assert b.tracker.frontend.t1 == a.tracker.frontend.t1
    assert b.tracker.frontend.is_initialized
    assert (b.map_counter, b._frame_cursor) == (a.map_counter, 7)
    assert not b.slam_step()               # the dataset is exhausted
    _assert_same_map(a, b)
