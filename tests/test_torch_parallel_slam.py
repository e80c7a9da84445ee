"""The row-sharded world through the port's entry points, on the CPU:
`MNESLAM` with `mapping.shard_plane_rows` on 2 ranks (rank 0 leads the
agent, rank 1 follows its map calls; tests/test_parallel.py:420), in
mapping-only mode and in SLAM mode with the oracle tracker update, and
`cli.main` in a world of 2 ranks. The ranks are `tests/_torch_dist.py`'s
(gloo, one thread each, `file://` store, 60 s timeouts). The port alone:
the sharded mapper is held against JAX in test_torch_parallel_optimize.py.
"""

import json

import numpy as np
import torch
import yaml

from tests._torch_dist import run_ranks

torch.set_num_threads(1)


def _mapping_overrides(tmp_path):
    """tests/test_parallel.py:428-446."""
    return {
        "mode": "mapping",
        "data": {"output": str(tmp_path), "exp_name": "rows"},
        "mapping": {"bound": [[-2.2, 2.2]] * 3,
                    "marching_cubes_bound": [[-2.1, 2.1]] * 3,
                    "sample": 384, "min_pixels_cur": 64, "first_iters": 40,
                    "iters": 15, "keyframe_every": 3,
                    "shard_plane_rows": True},
        "planes_res": {"coarse": 0.44, "fine": 0.22,
                       "bound_dividable": 0.22},
        "cam": {"H": 40, "W": 56, "fx": 35.0, "fy": 35.0, "cx": 27.5,
                "cy": 19.5, "near": 0.0, "far": 8.0},
        "training": {"n_range_d": 9, "n_samples_d": 8, "range_d": 0.25,
                     "trunc": 0.15},
        "model": {"c_dim": 16, "input_ch": 32, "input_ch_pos": 48,
                  "truncation": 0.15},
        "meshing": {"resolution": 0.12},
    }


def _assert_follower_holds_the_leaders_map(leader, follower):
    assert leader["shard_rows"] and follower["shard_rows"]
    assert not leader["follower"] and follower["follower"]
    assert leader["group_size"] == follower["group_size"] == 2
    assert not follower["tracker"] and follower["metrics"] == []
    assert follower["db_count"] == leader["db_count"]
    np.testing.assert_array_equal(follower["kf_poses"], leader["kf_poses"])
    for a, b in zip(leader["params"], follower["params"]):
        np.testing.assert_array_equal(a, b)


def test_shard_plane_rows_mapping_only_leader_and_follower(tmp_path):
    """Mapping-only on 2 ranks: 3 keyframes, last PSNR above 14 dB, and
    the follower ends with the leader's map, keyframe DB and poses; it
    wrote no file."""
    ov = _mapping_overrides(tmp_path / "out")
    leader, follower = run_ranks("slam", 2, tmp_path,
                                 {"overrides": ov, "num_frames": 7})
    _assert_follower_holds_the_leaders_map(leader, follower)
    assert len(leader["metrics"]) == 3
    assert leader["metrics"][-1]["psnr"] > 14.0
    files = sorted(p.name for p in (tmp_path / "out" / "rows").rglob("*")
                   if p.is_file())
    assert files == ["metrics.jsonl"], files        # the leader's alone


def test_shard_plane_rows_slam_mode_oracle_leader_and_follower(tmp_path):
    """SLAM mode on 2 ranks with the oracle tracker update on the leader:
    the leader tracks, refreshes the keyframe poses from the tracker
    before each map call and terminates (APE under 5 cm); the follower,
    which has no tracker, maps in lockstep to the same map and poses."""
    H, W = 64, 96
    ov = _mapping_overrides(tmp_path / "out")
    ov.update(mode="slam")
    ov["mapping"].update(sample=128, min_pixels_cur=32, first_iters=10,
                         iters=2, keyframe_every=4, global_ba_every=1000)
    ov["cam"] = {"H": H, "W": W, "fx": 60.0, "fy": 60.0, "cx": 47.5,
                 "cy": 31.5, "H_out": H, "W_out": W, "near": 0.0,
                 "far": 8.0}
    ov["meshing"] = {"resolution": 0.3}
    ov["tracking"] = {
        "buffer": 24, "warmup": 5, "upsample": False,
        "motion_filter": {"thresh": -1.0, "batch": 4},
        "frontend": {"enable_loop": False, "keyframe_thresh": -1.0,
                     "window": 10, "radius": 1, "max_factors": 30,
                     "nms": 0, "thresh": 25.0}}
    leader, follower = run_ranks("slam", 2, tmp_path,
                                 {"overrides": ov, "num_frames": 8})
    _assert_follower_holds_the_leaders_map(leader, follower)
    assert leader["tracker"] and leader["counter"] == 8
    assert leader["mapped"] == 7 and leader["ate"] < 0.05


def test_cli_in_a_world_of_two_ranks(tmp_path):
    """`cli.main` in a world of 2 ranks: the row-sharded run (rank 0
    returns the agent's result and writes the outputs, rank 1 returns
    None); with `--device_mesh` the same agent runs as the composed fleet
    of one slice (rank 0 leads it through `ComposedFleet`, rank 1
    follows), to the same per-keyframe losses."""
    ov = _mapping_overrides(tmp_path / "out")
    ov.update(dataset="synthetic")
    ov["data"].update(num_frames=4)
    ov["mapping"].update(first_iters=10, iters=4)
    ov["meshing"] = {"resolution": 0.3}
    path = tmp_path / "rows.yaml"
    path.write_text(yaml.safe_dump(ov))
    argv = ["--config", str(path), "--device", "cpu"]
    leader, follower = run_ranks("cli", 2, tmp_path, {"argv": argv})
    assert follower == {"result": None}
    assert leader["result"]["keyframes"] == 2
    assert (tmp_path / "out" / "rows" / "agent_0"
            / "final_checkpoint.npz").exists()
    leader_m, follower_m = run_ranks(
        "cli", 2, tmp_path / "mesh",
        {"argv": argv + ["--device_mesh", "--output",
                         str(tmp_path / "mesh_out")]})
    assert follower_m == {"result": None}
    assert leader_m["result"]["keyframes"] == 2

    def losses(root):
        with open(root / "rows" / "agent_0" / "metrics.jsonl") as f:
            return [r["loss"] for r in map(json.loads, f)
                    if r.get("kind") == "metric"]
    ref = losses(tmp_path / "out")
    assert len(ref) == 2
    np.testing.assert_allclose(losses(tmp_path / "mesh_out"), ref,
                               rtol=1e-6)
