"""The multi-agent slice as a whole, port against the JAX package, on the
CPU at a tiny size: the two-agent mapping-only run of
tests/test_multiagent.py:395 in both packages
(tests/test_torch_multiagent_slam.py holds the two-agent SLAM run and the
raw-pose contract, tests/test_torch_cli_agents.py the multi-agent CLI).
"""

import os

import pytest
import torch

from mneslam_tpu.agents.runner import MultiAgentRunner as JRunner
from mneslam_tpu.config import make_config as jmake_config
from mneslam_tpu.data.synthetic import SyntheticBoxDataset as JSyntheticBox
from mneslam_tpu.slam import MNESLAM as JMNESLAM
from mneslam_tpu_torch.agents.runner import MultiAgentRunner
from mneslam_tpu_torch.config import make_config
from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
from mneslam_tpu_torch.slam import MNESLAM
from test_torch_agents import tiny_overrides
from test_torch_slam import PSNR_TOL_DB

torch.set_num_threads(1)


class Slice:
    """Trajectory segment view of a dataset (start_index / end_index), as
    tests/test_multiagent.py:405."""

    def __init__(self, ds, lo, hi):
        self.ds, self.lo, self.n = ds, lo, hi - lo
        self.num_rays_to_save = ds.num_rays_to_save

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        item = self.ds[self.lo + i]
        item["frame_id"] = i
        return item


def _record_loops(runner):
    """Wrap each agent's detector: -> the list it appends (agent, kf id,
    match agent, match kf id) to."""
    found = []
    for c in runner.collabs:
        def wrapped(kf, agent, rgb, orig=c.loop_detector.detect_and_add):
            info = orig(kf, agent, rgb)
            if info is not None:
                found.append((agent, kf, int(info["match_agent_id"]),
                              int(info["match_kf_id"])))
            return info
        c.loop_detector.detect_and_add = wrapped
    return found


@pytest.fixture(scope="module")
def two_agent_mapping(tmp_path_factory):
    """Both packages' two-agent mapping-only runs over segments 0-10 and
    6-16 of a 16-frame box room; the renders without a target depth (the
    alignment's and the teacher's) take 32 samples a ray in both, in place
    of the default 256, to keep the CPU time down."""
    out = {}
    for pkg in ("jax", "port"):
        tmp = tmp_path_factory.mktemp(pkg)
        ov = tiny_overrides(tmp)
        ov["training"]["n_samples"] = 32
        if pkg == "jax":
            cfgs = [jmake_config(ov) for _ in range(2)]
            ds = JSyntheticBox(cfgs[0], num_frames=16)
            agents = [JMNESLAM(cfgs[r], Slice(ds, 6 * r, 10 + 6 * r),
                               rank=r, world_size=2) for r in range(2)]
            runner = JRunner(agents)
        else:
            cfgs = [make_config(ov) for _ in range(2)]
            ds = SyntheticBoxDataset(cfgs[0], num_frames=16)
            agents = [MNESLAM(cfgs[r], Slice(ds, 6 * r, 10 + 6 * r),
                              rank=r, world_size=2, device="cpu")
                      for r in range(2)]
            runner = MultiAgentRunner(agents)
        loops = _record_loops(runner)
        metrics = runner.run_mapping_only()
        out[pkg] = (agents, runner, metrics, loops)
    return out


def test_two_agent_mapping_matches_jax(two_agent_mapping):
    """The same descriptor DB (agent, kf) sequence and the same detected
    loops (the descriptors come from identical frames), equal keyframe
    counts, each agent's last PSNR within PSNR_TOL_DB; both packages
    distil and write the fused mesh."""
    jagents, jrun, jmetrics, jloops = two_agent_mapping["jax"]
    agents, run, metrics, loops = two_agent_mapping["port"]
    assert [(e["agent_id"], e["kf_id"]) for e in run.comms.descriptors()] \
        == [(e["agent_id"], e["kf_id"]) for e in jrun.comms.descriptors()]
    assert len(run.comms.descriptors()) == 10
    assert loops == jloops and len(loops) > 0
    for r in range(2):
        assert len(metrics[r]) == len(jmetrics[r]) == 5
        assert abs(metrics[r][-1]["psnr"] - float(jmetrics[r][-1]["psnr"])) \
            <= PSNR_TOL_DB, (r, metrics[r][-1]["psnr"],
                             float(jmetrics[r][-1]["psnr"]))
        assert agents[r].mapped_timestamps == jagents[r].mapped_timestamps
        for a in (agents[r], jagents[r]):
            assert os.path.exists(os.path.join(a.out_dir, "mesh",
                                               "fused_mesh.ply"))
        assert run.collabs[r].distillations >= 1
        assert run.comms.get_keyframes(r) is not None
        assert run.comms.get_checkpoint(r) is not None
    # every detected loop was aligned once per (agent, keyframe)
    assert sum(c.alignments for c in run.collabs) == len(set(
        (a, kf) for a, kf, _, _ in loops))
