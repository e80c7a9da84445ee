"""The port's SLAM tools `mneslam_tpu_torch/tools/eval_slam_synthetic` and
`eval_multiagent_synthetic` against the repository's
`tools/eval_slam_synthetic.py` and `tools/eval_multiagent_synthetic.py`,
on the CPU.

Both packages' tools run their `main` with `MNESLAM` (and the multi-agent
tools `MultiAgentRunner`) replaced by recorders whose run returns fixed
results: the same config overrides, the same datasets (agent 1's segment
biased), the same oracle targets on the same state, the same report
(closure keyframe errors included). One real run of each port tool on a
tiny config (`make_config` shrunk) checks the path end to end. The JAX
tools' own runs cost a minute or more of compiles on the CPU; the SLAM and
two-agent paths themselves are held against the JAX package in
tests/test_torch_slam.py, tests/test_torch_slam_backend.py and
tests/test_torch_multiagent_slam.py.
"""

import copy
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mneslam_tpu import config as jconfig
from mneslam_tpu_torch import config as pconfig
from mneslam_tpu_torch import slam as pslam
from mneslam_tpu_torch.agents import runner as prunner
from mneslam_tpu_torch.tools import eval_multiagent_synthetic as pma
from mneslam_tpu_torch.tools import eval_slam_synthetic as pslam_tool
from test_torch_eval_tools import load_jax_tool, run_jax_main

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def printed_json(text: str) -> dict:
    """The last JSON object a tool printed (one line, or indented)."""
    start = max(text.rfind("\n{\n") + 1, text.rfind("\n{\"") + 1)
    return json.loads(text[start:])


# the tiny shrink of the tools' configs: a short warmup, a small frontend
# window and edge cap, a few rays and iterations, coarse planes
TINY_SLAM = {
    "tracking": {"warmup": 3, "frontend": {"window": 6, "max_factors": 12}},
    "mapping": {"sample": 128, "min_pixels_cur": 32, "first_iters": 10,
                "iters": 2},
    "planes_res": {"coarse": 0.44, "fine": 0.22, "bound_dividable": 0.22},
    "model": {"c_dim": 16, "input_ch": 32},
    "meshing": {"resolution": 0.2},
}
# the oracle's targets (1/8-res pixels): the JAX tool builds its pose table
# from the items' float32 c2w, the port from the dataset's float64 poses
ORACLE_TOL_PX = 1e-4
# key poses of the tiny oracle runs (tests/test_torch_slam.py's bound)
APE_TOL_M = 0.05


def _recorder(poses, disps, as_array):
    """A stand-in for MNESLAM: records what the tool hands it; its run
    returns fixed results. `as_array` gives the package's array type."""

    class Recorder:
        made = []

        def __init__(self, cfg, ds, rank=0, update_fn=None, agg_fn=None,
                     world_size=1, device=None):
            self.cfg, self.ds, self.rank = cfg, ds, rank
            self.update_fn, self.agg_fn = update_fn, agg_fn
            self.world_size = world_size
            self.tracker = types.SimpleNamespace(
                counter=len(poses),
                state=types.SimpleNamespace(poses=as_array(poses),
                                            disps=as_array(disps)))
            self.map_counter = len(poses) - 1
            self.metrics_log = [{"psnr": 12.5}, {"psnr": 21.25}]
            self.timers = types.SimpleNamespace(
                summary=lambda: {"track_frame": {"total_s": 1.0}})
            Recorder.made.append(self)

        def run_slam(self):
            return {"ate": {"rmse": 0.0125}, "mesh_verts": 4321}

    return Recorder


def _oracle_outputs(update_fn, package, n_frames, H, W):
    """The oracle's (delta, weight) on one seeded state of `package`."""
    rng = np.random.default_rng(3)
    h, w = H // 8, W // 8
    ts = np.asarray([0.0, 2.0, 5.0, n_frames - 1.0], np.float32)
    disps = (0.3 + rng.random((4, h, w))).astype(np.float32)
    ii = np.asarray([0, 1, 2, 3, 1])
    jj = np.asarray([1, 0, 3, 2, 3])
    coords1 = (rng.random((5, h, w, 2)) * [w, h]).astype(np.float32)
    if package == "jax":
        st = types.SimpleNamespace(timestamps=jnp.asarray(ts),
                                   disps_sens=jnp.asarray(disps))
        args = (jnp.asarray(ii), jnp.asarray(jj))
        c1 = jnp.asarray(coords1)
    else:
        st = types.SimpleNamespace(timestamps=torch.tensor(ts),
                                   disps_sens=torch.tensor(disps))
        args = (torch.tensor(ii), torch.tensor(jj))
        c1 = torch.tensor(coords1)
    _, delta, weight = update_fn(None, st, *args, None, None, None, c1)
    return np.asarray(delta), np.asarray(weight)


@pytest.mark.parametrize("random_weights", [False, True])
def test_eval_slam_tool_matches_jax(random_weights, tmp_path, monkeypatch):
    """Both tools hand MNESLAM the same config overrides and dataset, the
    same oracle targets, and report the same numbers of the same run."""
    jtool = load_jax_tool("eval_slam_synthetic")
    rng = np.random.default_rng(0)
    poses = rng.standard_normal((7, 7)).astype(np.float32)
    disps = rng.random((7, 8, 12)).astype(np.float32)
    jrec = _recorder(poses, disps, np.asarray)
    prec = _recorder(poses, disps, torch.tensor)
    overrides = {}

    def capture(tag, make):
        def fn(ov):
            overrides[tag] = ov
            return make(ov)
        return fn

    monkeypatch.setattr(jtool, "MNESLAM", jrec)
    monkeypatch.setattr(jtool, "make_config",
                        capture("jax", jconfig.make_config))
    monkeypatch.setattr(pslam, "MNESLAM", prec)
    monkeypatch.setattr(pslam_tool, "make_config",
                        capture("port", pconfig.make_config))
    argv = ["--out", str(tmp_path), "--frames", "14", "--hw", "64,96",
            "--thresh", "2.5", "--buffer", "30", "--global-ba-every", "7",
            "--enable-loop", "--fast"]
    argv += ["--random-weights"] if random_weights else []
    jrep = printed_json(run_jax_main(jtool, argv, monkeypatch))
    prep = pslam_tool.main(argv + ["--device", "cpu"])

    assert overrides["port"] == overrides["jax"]
    (ja,), (pa,) = jrec.made, prec.made
    assert len(pa.ds) == len(ja.ds) == 14 and pa.rank == ja.rank == 0
    np.testing.assert_allclose(pa.ds[9]["c2w"], ja.ds[9]["c2w"], atol=1e-6)
    if random_weights:
        assert pa.update_fn is None and ja.update_fn is None
    else:
        jd, jw = _oracle_outputs(ja.update_fn, "jax", 14, 64, 96)
        pd, pw = _oracle_outputs(pa.update_fn, "port", 14, 64, 96)
        np.testing.assert_allclose(pd, jd, atol=ORACLE_TOL_PX)
        np.testing.assert_array_equal(pw, jw)
        assert pw.any()
    for rep in (jrep, prep):
        rep.pop("wall_s")
        rep.pop("end_to_end_fps")
    assert prep == jrep


def test_eval_slam_tool_runs_the_slam_path(tmp_path, monkeypatch):
    """The port's tool on the tiny shrink, oracle update."""
    monkeypatch.setattr(pslam_tool, "make_config", lambda ov:
                        pconfig.make_config(pconfig.deep_update(
                            ov, copy.deepcopy(TINY_SLAM))))
    rep = pslam_tool.main(["--out", str(tmp_path), "--hw", "64,64",
                           "--frames", "8", "--fast", "--device", "cpu"])
    assert rep["frames"] == 8 and rep["resolution"] == "64x64"
    assert rep["keyframes"] == 8 and rep["mapped"] >= 2
    assert rep["ate_rmse_m"] < APE_TOL_M
    assert rep["mesh_verts"] > 0
    assert np.isfinite(rep["final_train_psnr_db"])
    assert {"track_frame", "map_keyframe", "fill_trajectory",
            "mesh"} <= set(rep["stage_timers"])
    agent = os.path.join(str(tmp_path), "eval", "agent_0")
    for name in ("est_poses.npy", "key_est_poses.npy",
                 os.path.join("mesh", "final_mesh.ply")):
        assert os.path.exists(os.path.join(agent, name)), name


def _fakes(as_array, aligned):
    """Stand-ins for MNESLAM and MultiAgentRunner: the agents record what
    the tool hands them; the runner's run gives each agent fixed
    collaboration results. `as_array`: the package's array type."""
    rng = np.random.default_rng(5)
    kf_poses = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    kf_poses[:, :3, 3] = rng.standard_normal((6, 3))

    class Agent:
        made = []

        def __init__(self, cfg, ds, rank=0, world_size=1, update_fn=None,
                     agg_fn=None, device=None):
            self.cfg, self.ds, self.rank = cfg, ds, rank
            self.world_size = world_size
            self.update_fn, self.agg_fn = update_fn, agg_fn
            self.tracker = types.SimpleNamespace(counter=9 + rank)
            self.map_counter = 8 + rank
            self.mapped_timestamps = [0.0, 2.0, 3.0, 5.0, 7.0, 8.0]
            self.map_state = types.SimpleNamespace(kf_poses=as_array(kf_poses))
            Agent.made.append(self)

    class Runner:
        def __init__(self, agents):
            self.agents = agents
            for a in agents:
                a.collab = types.SimpleNamespace(
                    fused_agents={1 - a.rank},
                    aligned_poses_c2w=(None if not aligned or a.rank == 0
                                       else kf_poses[:4] + 0.01))

        def run_slam(self):
            return [{"ate": {"rmse": 0.01 * (a.rank + 1)}}
                    for a in self.agents]

    return Agent, Runner


@pytest.mark.parametrize("flags,aligned", [
    ([], True), (["--bias_rot_deg", "30", "--map_aligned"], True),
    (["--closure_mode", "reference", "--fast"], False)])
def test_eval_multiagent_tool_matches_jax(flags, aligned, tmp_path,
                                          monkeypatch):
    monkeypatch.chdir(REPO)   # its import reads tools/ from the cwd
    jtool = load_jax_tool("eval_multiagent_synthetic")
    jagent, jrunner = _fakes(np.asarray, aligned)
    pagent, prunner_fake = _fakes(torch.tensor, aligned)
    overrides = {"jax": [], "port": []}

    def capture(tag, make):
        def fn(ov):
            overrides[tag].append(ov)
            return make(ov)
        return fn

    monkeypatch.setattr(jtool, "MNESLAM", jagent)
    monkeypatch.setattr(jtool, "MultiAgentRunner", jrunner)
    monkeypatch.setattr(jtool, "make_config",
                        capture("jax", jconfig.make_config))
    monkeypatch.setattr(pslam, "MNESLAM", pagent)
    monkeypatch.setattr(prunner, "MultiAgentRunner", prunner_fake)
    monkeypatch.setattr(pma, "make_config",
                        capture("port", pconfig.make_config))
    argv = ["--out", str(tmp_path), "--frames", "15", "--hw", "64,96"] + flags
    jrep = printed_json(run_jax_main(jtool, argv, monkeypatch))
    prep = pma.main(argv + ["--device", "cpu"])

    assert overrides["port"] == overrides["jax"]
    assert len(overrides["port"]) == 3      # the dataset's, each agent's
    assert len(pagent.made) == len(jagent.made) == 2
    for pa, ja in zip(pagent.made, jagent.made):
        assert (pa.rank, pa.world_size) == (ja.rank, ja.world_size)
        assert (pa.ds.lo, len(pa.ds)) == (ja.ds.lo, len(ja.ds))
        for i in (0, len(pa.ds) - 1):
            p, j = pa.ds[i], ja.ds[i]
            assert p["frame_id"] == j["frame_id"] == i
            np.testing.assert_allclose(p["c2w"], j["c2w"], atol=1e-6)
        jd, jw = _oracle_outputs(ja.update_fn, "jax", len(ja.ds), 64, 96)
        pd, pw = _oracle_outputs(pa.update_fn, "port", len(pa.ds), 64, 96)
        np.testing.assert_allclose(pd, jd, atol=ORACLE_TOL_PX)
        np.testing.assert_array_equal(pw, jw)
    assert ("kf_err_after_closure_m" in prep) == aligned
    jrep.pop("wall_s")
    prep.pop("wall_s")
    assert prep == jrep


def test_eval_multiagent_tool_runs_two_agents(tmp_path, monkeypatch):
    """The port's tool on the tiny shrink (loop and distillation
    iterations cut to a few: each renders 256 samples a ray on the CPU)."""
    tiny = pconfig.deep_update(
        copy.deepcopy(TINY_SLAM),
        {"mapping": {"loop_iters": 4, "distill_iters": 2}})
    monkeypatch.setattr(pma, "make_config", lambda ov: pconfig.make_config(
        pconfig.deep_update(ov, copy.deepcopy(tiny))))
    rep = pma.main(["--out", str(tmp_path), "--hw", "64,64", "--frames",
                    "9", "--fast", "--device", "cpu"])
    assert rep["keyframes"] == [6, 6]
    assert all(m >= 2 for m in rep["mapped"])
    assert all(ape < APE_TOL_M for ape in rep["apes_m"])
    assert rep["closure_fired"] is True and 0 in rep["fused_agents"][1]
    for rank in (0, 1):
        agent = os.path.join(str(tmp_path), "ma", f"agent_{rank}")
        assert os.path.exists(os.path.join(agent, "est_poses.npy"))
