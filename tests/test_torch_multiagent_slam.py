"""The port's multi-agent SLAM path on the CPU at a tiny size: two agents
under `MultiAgentRunner.run_slam` with oracle tracker updates, and the
raw-pose / aligned-override contract of `MNESLAM`
(tests/test_multiagent.py:314) in mapping-only and SLAM mode."""

import os

import numpy as np
import torch

from mneslam_tpu_torch.agents.runner import MultiAgentRunner
from mneslam_tpu_torch.config import make_config
from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
from mneslam_tpu_torch.slam import MNESLAM
from test_torch_agents import tiny_overrides
from test_torch_multiagent import Slice, _record_loops
from test_torch_slam import _oracle, _slam_overrides

torch.set_num_threads(1)


def test_two_agent_slam_run_on_cpu(tmp_path):
    """Two agents under `run_slam` (oracle tracker updates, segments 0-8
    and 4-12): both complete with their terminate outputs, publish, and
    the shared frames give cross-agent loops."""
    ov = _slam_overrides(tmp_path)
    ov["loop_detection"] = {"enabled": True, "sim_threshold": 0.9999,
                            "min_time_diff": 100, "loop_launch_th": 2,
                            "min_matches_for_fusion": 1}
    ov["mapping"].update(loop_iters=3, distill_iters=3, keyframe_every=1)
    cfgs = [make_config(ov) for _ in range(2)]
    ds = SyntheticBoxDataset(cfgs[0], num_frames=12)
    intr8 = torch.tensor([60.0 / 8, 60.0 / 8, 47.5 / 8, 31.5 / 8])
    agents = []
    for r in range(2):
        seg = Slice(ds, 4 * r, 8 + 4 * r)
        update_fn, agg_fn = _oracle(seg, intr8)
        agents.append(MNESLAM(cfgs[r], seg, rank=r, world_size=2,
                              device="cpu", update_fn=update_fn,
                              agg_fn=agg_fn))
    runner = MultiAgentRunner(agents)
    loops = _record_loops(runner)
    results = runner.run_slam()
    assert len(results) == 2
    for a, res in zip(agents, results):
        assert res["tracked_keyframes"] == 8
        for name in ("est_poses.npy", "key_est_poses.npy",
                     "final_checkpoint.npz"):
            assert os.path.exists(os.path.join(a.out_dir, name))
        assert np.isfinite(res["ate"]["rmse"])
    assert any(a != m for a, _, m, _ in loops), loops
    assert len(runner.comms.descriptors()) == sum(
        len(a.mapped_timestamps) for a in agents)


def test_set_aligned_kf_poses_overrides_map_slots(tmp_path):
    """The map_aligned contract (tests/test_multiagent.py:314): the override
    replaces exactly the matching mapped slots, survives a pose refresh,
    and kf_poses_raw keeps the raw poses, extended by new keyframes."""
    ov = tiny_overrides(tmp_path)
    ov["mapping"].update(first_iters=10, iters=2)
    cfg = make_config(ov)
    ds = SyntheticBoxDataset(cfg, num_frames=8)
    slam = MNESLAM(cfg, ds, rank=0, device="cpu")
    slam.run_mapping_only(log_every=100)
    assert slam.mapped_timestamps[:3] == [0.0, 2.0, 4.0]
    before = slam.map_state.kf_poses.numpy().copy()

    shift = np.eye(4, dtype=np.float32)
    shift[:3, 3] = [0.5, -0.25, 0.125]
    aligned = np.stack([shift @ before[0], shift @ before[2]])
    slam.set_aligned_kf_poses(np.asarray([0.0, 4.0]), aligned)
    after = slam.map_state.kf_poses.numpy()
    np.testing.assert_allclose(after[0], aligned[0], atol=1e-6)
    np.testing.assert_allclose(after[2], aligned[1], atol=1e-6)
    np.testing.assert_allclose(after[1], before[1], atol=1e-6)

    slam.map_state.kf_poses = torch.tensor(before)
    slam._refresh_mapped_poses()
    again = slam.map_state.kf_poses.numpy()
    np.testing.assert_allclose(again[0], aligned[0], atol=1e-6)
    np.testing.assert_allclose(again[2], aligned[1], atol=1e-6)

    n = len(slam.mapped_timestamps)
    np.testing.assert_allclose(slam.kf_poses_raw(n), before[:n], atol=1e-6)
    frame, pose = slam._frame_for_mapping(7)
    slam._map_keyframe(7, frame, pose, first=False)
    raw2 = slam.kf_poses_raw(len(slam.mapped_timestamps))
    np.testing.assert_allclose(raw2[-1], ds[7]["c2w"], atol=1e-6)
    np.testing.assert_allclose(raw2[:n], before[:n], atol=1e-6)


def test_raw_history_in_slam_mode_ignores_the_override(tmp_path):
    """SLAM mode: after an override, a refresh re-reads the tracker's
    poses for the slots it hits and the raw history holds them, while the
    map slots keep the aligned poses; the collaboration hook gets the raw
    ones."""
    ov = _slam_overrides(tmp_path)
    cfg = make_config(ov)
    ds = SyntheticBoxDataset(cfg, num_frames=12)
    update_fn, agg_fn = _oracle(ds, torch.tensor([7.5, 7.5, 47.5 / 8,
                                                  31.5 / 8]))
    slam = MNESLAM(cfg, ds, device="cpu", update_fn=update_fn,
                   agg_fn=agg_fn)
    for _ in range(2):
        slam.slam_step()
    n = len(slam.mapped_timestamps)
    assert n >= 2
    raw = slam.kf_poses_raw(n)
    shift = np.eye(4, dtype=np.float32)
    shift[0, 3] = 1.0
    slam.set_aligned_kf_poses(np.asarray(slam.mapped_timestamps),
                              shift @ raw)
    seen = []
    slam.collab = type("C", (), {"on_keyframe_mapped": lambda self, *a:
                                 seen.append(a[3])})()
    slam._refresh_mapped_poses()
    np.testing.assert_allclose(slam.map_state.kf_poses[:n].numpy(),
                               shift @ raw, atol=1e-6)
    np.testing.assert_allclose(slam.kf_poses_raw(n), raw, atol=1e-5)
    while slam.slam_step():
        pass
    assert seen, "no keyframe mapped after the override"
    assert not np.allclose(seen[-1][:n], shift @ raw, atol=1e-3)
