"""The mesh fleet in SLAM mode on the CPU (tests/test_fleet.py:191 with
row_sharded False): per-agent tracking with the oracle update, then one
super-step per pass over the agents' pending keyframes, against the
interleaved sequential agents. On one slice the fleet runs the sequential
agents' operations, so the maps are equal bit for bit.
"""

import copy

import torch

from mneslam_tpu_torch.agents.runner import MultiAgentRunner
from mneslam_tpu_torch.config import make_config
from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
from mneslam_tpu_torch.parallel import fleet as pfleet
from mneslam_tpu_torch.tools.validate_dataset import OracleMNESLAM
from test_torch_fleet import assert_same_maps
from test_torch_multiagent import Slice
from test_torch_slam import _slam_overrides

torch.set_num_threads(1)


def test_fleet_slam_matches_sequential(tmp_path):
    """tests/test_fleet.py:191 (row_sharded False): SLAM through the fleet
    (per-agent tracking with the oracle update, one super-step per pass)
    == the interleaved sequential agents: the same tracked keyframes, the
    same mapped keyframes, the same maps."""
    def build(exp):
        ov = _slam_overrides(tmp_path / exp)
        ov["mapping"].update(first_iters=10, iters=2, keyframe_every=4)
        cfg = make_config(ov)
        ds = SyntheticBoxDataset(cfg, num_frames=8)
        return [OracleMNESLAM(copy.deepcopy(cfg), Slice(ds, lo, hi),
                              rank=r, world_size=2, device="cpu")
                for r, (lo, hi) in enumerate(((0, 6), (2, 8)))]

    seq = build("seq")
    MultiAgentRunner(seq)
    alive = [True, True]
    while any(alive):
        alive = [a.slam_step() if ok else False
                 for a, ok in zip(seq, alive)]
    agents = build("mesh")
    fleet = pfleet.MeshAgentFleet(agents)
    alive = [True, True]
    while any(alive):
        alive = [a.track_step() if ok else False
                 for a, ok in zip(agents, alive)]
        fleet._map_pending()
        for a in agents:
            a.maybe_global_ba()
    fleet._map_pending()
    for a, b in zip(seq, agents):
        assert a.tracker.counter == b.tracker.counter == 6
        assert a.map_counter == b.map_counter == 5
    assert_same_maps(seq, agents)
