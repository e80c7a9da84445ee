"""Whole runs of the composed mesh fleet (`parallel/fleet.ComposedFleet`)
on 4 gloo ranks on the CPU, 2 agents x 2 row ranks (each slice's leader
runs its agent, its follower the row-sharded map calls), against the
one-slice fleet (`MeshAgentFleet` in one process), which
tests/test_torch_fleet.py holds against the JAX package's fleet. The
JAX package's counterparts, tests/test_fleet.py:191 (row_sharded True)
and :312, are marked slow there. The ranks are `tests/_torch_dist.py`'s
(one thread each, 60 s timeouts on every collective and on the join).
"""

import numpy as np
import torch

from mneslam_tpu_torch.agents import fusion
from mneslam_tpu_torch.config import make_config
from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
from mneslam_tpu_torch.parallel import fleet as pfleet
from test_torch_fleet import fleet_overrides
from test_torch_slam import _slam_overrides
from tests._torch_dist import (fleet_agents, fleet_result, record_matches,
                               run_ranks)

torch.set_num_threads(1)

RTOL = 1e-4
# a peer's map fetched across slices and a distillation from it, against
# the one-slice fleet's live map: the row-sharded and the plain mapper
# differ in their sums' order only
MAP_ATOL = 1e-4


def one_slice(p):
    """The one-slice fleet on `p`'s agents in this process ->
    `fleet_result` (with the terminates' results in SLAM mode)."""
    agents = fleet_agents(p)
    fleet = pfleet.MeshAgentFleet(agents)
    loops = [record_matches(c) for c in fleet.collabs]
    if agents[0].mode == "mapping":
        fleet.run_mapping_only()
        res = None
    else:
        res = dict(enumerate(fleet.run_slam()))
    return fleet_result(fleet, agents, sorted(sum(loops, [])), res)


def composed(p, tmp_path):
    """`p` on 4 ranks -> the leaders' results by agent."""
    outs = run_ranks("fleet", 4, tmp_path, p)
    for rank, o in enumerate(outs):
        assert o["mesh"] == {"agent": 2, "ray": 2}
        assert o["agent"] == rank // 2 and o["follower"] == bool(rank % 2)
        assert o["shard_rows"]
    return {r: outs[2 * r] for r in (0, 1)}


def assert_same_decisions(leads, ref):
    """Each agent made the one-slice fleet's decisions: the same mapped
    keyframes, tracker and map counters, loops, closures, alignments and
    distillations; its losses within rtol 1e-4; every leader's
    descriptor DB holds every mapped keyframe of both agents."""
    assert sorted(leads[0]["loops"] + leads[1]["loops"]) == ref["loops"]
    for r, lead in leads.items():
        got, want = lead["agents"][r], ref["agents"][r]
        for key in ("mapped", "counter", "map_counter", "accepted",
                    "rejected", "alignments", "distillations"):
            assert got[key] == want[key], (r, key, got[key], want[key])
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
        assert lead["db"] == ref["db"]


def loop_overrides(tmp_path, exp):
    """tests/test_torch_fleet.py:94's setup, row-sharded, every closure
    applied (loop_closure.mode "reference") and mapped against
    (map_aligned); the renders without a target depth take 32 samples."""
    ov = fleet_overrides(tmp_path, exp, loop=True)
    ov["mapping"]["shard_plane_rows"] = True
    ov["training"]["n_samples"] = 32
    ov["meshing"] = {"resolution": 0.3}
    ov["loop_closure"] = {"mode": "reference", "map_aligned": True,
                          "pose_decay_sigma": 10.0,
                          "pose_decay_min_weight": 0.1}
    return ov


def test_composed_mapping_only_loops_closures_and_fusion(tmp_path):
    """Mapping-only with loop detection on: the one-slice fleet's
    decisions (a loop across slices, a closure accepted, an alignment
    against a peer map fetched across slices, a distillation by each
    agent). The maps after the distillations are the one-slice fleet's
    within 1e-4, and so are the closure's aligned poses. The closure
    does not compound across rounds: the aligned trajectory is the raw
    one (the dataset's poses) deformed once, and the map slots hold it."""
    segs = [(0, 6), (4, 10)]
    p = {"num_frames": 10, "segments": segs}
    leads = composed(dict(p, overrides=loop_overrides(
        tmp_path / "out", "c")), tmp_path)
    ref = one_slice(dict(p, overrides=loop_overrides(tmp_path / "out",
                                                     "ref")))
    assert_same_decisions(leads, ref)
    assert any(a != m for a, _, m, _ in ref["loops"]), ref["loops"]
    assert sum(ref["agents"][r]["accepted"] for r in (0, 1)) >= 1
    cfg = make_config(loop_overrides(tmp_path / "out", "gt"))
    ds = SyntheticBoxDataset(cfg, num_frames=10)
    for r in (0, 1):
        got, want = leads[r]["agents"][r], ref["agents"][r]
        assert got["distillations"] >= 1
        for x, y in zip(got["params"], want["params"]):
            np.testing.assert_allclose(x, y, rtol=0, atol=MAP_ATOL)
        n = len(got["mapped"])
        raw = np.stack([ds[segs[r][0] + int(t)]["c2w"]
                        for t in got["mapped"]]).astype(np.float32)
        np.testing.assert_allclose(got["raw"], raw, atol=1e-6)
        rel, loop_ts = got["closure"]
        if rel is None:
            assert got["aligned"] is None and want["aligned"] is None
            continue
        idx = got["mapped"].index(loop_ts)
        once = fusion.deform_trajectory(
            torch.tensor(raw), idx, torch.tensor(rel, dtype=torch.float32),
            decay_sigma=10.0, min_weight=0.1).numpy()
        np.testing.assert_allclose(got["aligned"], once, atol=1e-5)
        np.testing.assert_allclose(got["kf_poses"][:n], once, atol=1e-5)
        np.testing.assert_allclose(got["aligned"], want["aligned"],
                                   atol=MAP_ATOL)


def test_composed_slam_oracle(tmp_path):
    """SLAM with the oracle tracker update and loop detection on: each
    leader tracks its segment, its follower maps in lockstep; the one-slice
    fleet's decisions (keyframes tracked and mapped, loops, closures,
    distillations), losses within rtol 1e-4, APE as the one-slice
    fleet's and under 5 cm."""
    def overrides(exp):
        ov = _slam_overrides(tmp_path / "out" / exp)
        ov["mapping"].update(first_iters=10, iters=2, keyframe_every=4,
                             shard_plane_rows=True, loop_iters=4,
                             distill_iters=3)
        ov["training"]["n_samples"] = 32
        ov["meshing"] = {"resolution": 0.3}
        ov["loop_detection"] = {"enabled": True, "sim_threshold": 0.9,
                                "min_time_diff": 50, "loop_launch_th": 2,
                                "min_matches_for_fusion": 1}
        return ov

    p = {"num_frames": 8, "segments": [(0, 6), (2, 8)]}
    leads = composed(dict(p, overrides=overrides("c")), tmp_path)
    ref = one_slice(dict(p, overrides=overrides("ref")))
    assert_same_decisions(leads, ref)
    assert ref["loops"] and all(ref["agents"][r]["counter"] == 6
                                for r in (0, 1))
    for r in (0, 1):
        got = leads[r]["agents"][r]
        np.testing.assert_allclose(got["ate"], ref["agents"][r]["ate"],
                                   atol=1e-4)
        assert got["ate"] < 0.05
