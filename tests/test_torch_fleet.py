"""The mesh fleet (`mneslam_tpu_torch/parallel/fleet.py`, `--device_mesh`)
on the CPU at one agent slice, against the sequential runner and the JAX
package's fleet tests (tests/test_fleet.py), and the fleet's collectives
(`parallel/mesh.py`) against the JAX package's (tests/test_parallel.py:66).
The SLAM-mode fleet is held in test_torch_fleet_slam.py. On one slice the super-step maps the agents in turn, each from its
own generator, so the fleet and `MultiAgentRunner` run the same
operations: their maps are equal bit for bit here.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mneslam_tpu.parallel import mesh as jpmesh
from mneslam_tpu_torch import cli
from mneslam_tpu_torch.agents import fusion
from mneslam_tpu_torch.agents.runner import MultiAgentRunner
from mneslam_tpu_torch.config import make_config
from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
from mneslam_tpu_torch.models.scene_rep import param_leaves
from mneslam_tpu_torch.parallel import fleet as pfleet
from mneslam_tpu_torch.parallel import mesh as pmesh
from mneslam_tpu_torch.slam import MNESLAM
from test_torch_multiagent import Slice, _record_loops
from tests._torch_dist import run_ranks

torch.set_num_threads(1)


def fleet_overrides(tmp_path, exp, loop=False):
    """tests/test_fleet.py:24's fleet_cfg, iterations cut to 20 / 4."""
    return {
        "mode": "mapping",
        "data": {"output": str(tmp_path), "exp_name": exp},
        "mapping": {
            "bound": [[-2.2, 2.2]] * 3,
            "marching_cubes_bound": [[-2.1, 2.1]] * 3,
            "sample": 256, "min_pixels_cur": 48, "first_iters": 20,
            "iters": 4, "keyframe_every": 2, "loop_iters": 6,
            "distill_iters": 4, "lr_rot": 0.01, "lr_trans": 0.01},
        "planes_res": {"coarse": 0.44, "fine": 0.22,
                       "bound_dividable": 0.22},
        "cam": {"H": 40, "W": 56, "fx": 35.0, "fy": 35.0, "cx": 27.5,
                "cy": 19.5, "near": 0.0, "far": 8.0},
        "training": {"n_range_d": 9, "n_samples_d": 8, "range_d": 0.25,
                     "trunc": 0.15},
        "model": {"c_dim": 16, "input_ch": 32, "input_ch_pos": 48,
                  "truncation": 0.15},
        "loop_detection": {"enabled": loop, "sim_threshold": 0.9,
                           "min_time_diff": 50, "loop_launch_th": 2,
                           "min_matches_for_fusion": 1},
        "loop_bound": {"bound_0": [[-2.2, 2.2]] * 3,
                       "bound_1": [[-2.2, 2.2]] * 3},
    }


def make_agents(ov, n_frames=10, segments=((0, 6), (4, 10))):
    cfg = make_config(ov)
    ds = SyntheticBoxDataset(cfg, num_frames=n_frames)
    return [MNESLAM(copy.deepcopy(cfg), Slice(ds, lo, hi), rank=r,
                    world_size=2, device="cpu")
            for r, (lo, hi) in enumerate(segments)]


def assert_same_maps(agents_a, agents_b):
    for a, b in zip(agents_a, agents_b):
        assert a.mapped_timestamps == b.mapped_timestamps
        for x, y in zip(param_leaves(a.map_state.params),
                        param_leaves(b.map_state.params)):
            np.testing.assert_array_equal(x.detach().numpy(),
                                          y.detach().numpy())


def test_fleet_matches_sequential_runner(tmp_path):
    """2-agent fleet mapping == the sequential runner (tests/test_fleet.py
    :68): the same keyframes, losses and maps, bit for bit; each agent's
    map state is its state in the fleet."""
    seq = make_agents(fleet_overrides(tmp_path, "seq"))
    seq_logs = MultiAgentRunner(seq).run_mapping_only()
    agents = make_agents(fleet_overrides(tmp_path, "mesh"))
    fleet = pfleet.MeshAgentFleet(agents)
    logs = fleet.run_mapping_only()
    assert fleet.mesh.shape == {"agent": 1, "ray": 1}
    assert [[m["loss"] for m in log] for log in logs] == \
        [[m["loss"] for m in log] for log in seq_logs]
    assert_same_maps(seq, agents)
    assert all(a.map_state is s for a, s in zip(agents, fleet.state))


def test_fleet_loop_closure_through_mesh_comms(tmp_path):
    """tests/test_fleet.py:101: the descriptor DB holds every mapped
    keyframe of both agents, read through `all_gather_descriptors`;
    cross-agent loops fire through it; a peer's checkpoint is its live
    map (the same storage, outside autograd) with its bound."""
    ov = fleet_overrides(tmp_path, "loop", loop=True)
    ov["meshing"] = {"resolution": 0.3}
    agents = make_agents(ov)
    fleet = pfleet.MeshAgentFleet(agents)
    loops = _record_loops(fleet)
    fleet.run_mapping_only()
    db = fleet.comms.descriptors()
    assert len(db) == sum(len(a.mapped_timestamps) for a in agents)
    assert {e["agent_id"] for e in db} == {0, 1}
    assert any(a != m for a, _, m, _ in loops), loops
    params1, meta = fleet.comms.get_checkpoint(1)
    for got, live in zip(param_leaves(params1),
                         param_leaves(agents[1].map_state.params)):
        assert got.data_ptr() == live.data_ptr() and not got.requires_grad
    assert "bound" in meta


def test_fleet_mapping_only_closure_does_not_compound(tmp_path):
    """tests/test_fleet.py:132: under loop_closure.map_aligned the publish
    hook reads the raw poses, so after every round the aligned trajectory
    is the raw one deformed once, and the map slots hold it."""
    ov = fleet_overrides(tmp_path, "cmp")
    ov["mapping"].update(first_iters=4, iters=2)
    ov["loop_closure"] = {"map_aligned": True, "pose_decay_sigma": 10.0,
                          "pose_decay_min_weight": 0.1}
    agents = make_agents(ov)
    fleet = pfleet.MeshAgentFleet(agents)
    tgt = agents[1]
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = 0.05
    orig = tgt.collab.on_keyframe_mapped
    fired = {}

    def hook(kf_id, rgb, cur, kf_poses, kf_ts):
        if not fired and len(kf_ts) >= 2:
            tgt.collab.closure_relative = T
            tgt.collab.closure_loss = 0.0
            tgt.collab.closure_init_loss = 1.0
            tgt.collab.closure_loop_ts = float(kf_ts[0])
            fired["ts"] = float(kf_ts[0])
        return orig(kf_id, rgb, cur, kf_poses, kf_ts)

    tgt.collab.on_keyframe_mapped = hook
    fleet.run_mapping_only()
    assert fired
    raw = np.stack([np.asarray(tgt.dataset[int(t)]["c2w"])
                    for t in tgt.mapped_timestamps]).astype(np.float32)
    expect = fusion.deform_trajectory(torch.tensor(raw), 0, torch.tensor(T),
                                      decay_sigma=10.0,
                                      min_weight=0.1).numpy()
    np.testing.assert_allclose(tgt.collab.aligned_poses_c2w, expect,
                               atol=1e-5)
    n = len(tgt.mapped_timestamps)
    np.testing.assert_allclose(fleet.state[1].kf_poses[:n].numpy(), expect,
                               atol=1e-5)
    np.testing.assert_allclose(tgt.kf_poses_raw(n), raw, atol=1e-6)


def test_fleet_overrides_a_mapper_mesh_and_refuses_a_world(tmp_path,
                                                           monkeypatch):
    """tests/test_fleet.py:295: with mapping.shard_plane_rows on one slice
    no row group is left, so the agents map with a plain mapper (one
    process builds no mesh mapper) and the fleet runs. On a world of
    several ranks the fleet is the composed one, and a mesh whose agent
    axis was clamped (2 agents on 3 ranks: one slice of 3) raises JAX's
    one-agent-per-slice error (tests/test_torch_fleet_composed.py holds
    the guards and the composed runs)."""
    ov = fleet_overrides(tmp_path, "rows")
    ov["mapping"].update(shard_plane_rows=True, first_iters=4, iters=2)
    agents = make_agents(ov)
    fleet = pfleet.MeshAgentFleet(agents)
    assert type(fleet) is pfleet.MeshAgentFleet
    assert not fleet.mapper.shard_rows and fleet.mapper.mesh is None
    logs = fleet.run_mapping_only()
    assert all(np.isfinite(m["loss"]) for log in logs for m in log)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 3)
    with pytest.raises(ValueError, match="exactly one agent per 'agent' "
                                         "slice: 2 agents on a mesh with "
                                         "agent axis 1"):
        pfleet.MeshAgentFleet(agents, mesh=pmesh.Mesh(1, 3, 0, {}, "host"))


def test_cli_device_mesh_runs_the_fleet(tmp_path):
    """`cli --device_mesh --num_agents 2 --device cpu` maps both agents
    through the fleet and writes both agents' outputs."""
    import yaml

    ov = fleet_overrides(tmp_path / "out", "cli")
    ov["mapping"].update(first_iters=4, iters=2)
    ov.update(dataset="synthetic")
    ov["data"].update(num_frames=4)
    ov["meshing"] = {"resolution": 0.3}
    path = tmp_path / "fleet.yaml"
    path.write_text(yaml.safe_dump(ov))
    res = cli.main(["--config", str(path), "--num_agents", "2",
                    "--device_mesh", "--device", "cpu"])
    assert len(res) == 2 and all(r["keyframes"] == 2 for r in res)
    for rank in (0, 1):
        d = tmp_path / "out" / "cli" / f"agent_{rank}"
        assert (d / "final_checkpoint.npz").exists()
        assert (d / "metrics.jsonl").exists()


def test_mesh_comms_descriptor_roundtrip_and_all_gather(tmp_path):
    """tests/test_fleet.py:279 on one slice, and the descriptor all-gather
    over an agent axis of 2 ranks (tests/test_parallel.py:66): every
    agent's stack on every rank; the fetch of one agent's slice; the
    similarity matrix as JAX's; a full DB raises."""
    comms = pfleet.MeshComms(pmesh.make_mesh(2), n_agents=2, desc_cap=4)
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((3, 16)).astype(np.float32)
    for v, kf, agent in zip(vecs, (0, 2, 4), (0, 1, 0)):
        comms.add_descriptor({"descriptor": v, "kf_id": kf,
                              "agent_id": agent})
    by_key = {(e["agent_id"], e["kf_id"]): e["descriptor"]
              for e in comms.descriptors()}
    assert len(by_key) == 3
    np.testing.assert_array_equal(by_key[(0, 0)], vecs[0])
    np.testing.assert_array_equal(by_key[(1, 2)], vecs[1])
    np.testing.assert_array_equal(by_key[(0, 4)], vecs[2])
    for kf in range(3):
        comms.add_descriptor({"descriptor": vecs[0], "kf_id": 10 + kf,
                              "agent_id": 1})
    with pytest.raises(RuntimeError, match="descriptor DB full"):
        comms.add_descriptor({"descriptor": vecs[0], "kf_id": 20,
                              "agent_id": 1})

    descs = rng.standard_normal((2, 8, 32)).astype(np.float32)
    outs = run_ranks("descriptors", 2, tmp_path, {"descs": descs})
    for o in outs:
        assert o["shape"] == {"agent": 2, "ray": 1}
        np.testing.assert_array_equal(o["gathered"], descs)
    stacked = torch.tensor(descs)
    np.testing.assert_array_equal(
        pmesh.fetch_agent_slice(stacked, 1).numpy(), descs[1])
    np.testing.assert_allclose(
        pmesh.cosine_similarity_matrix(stacked[0], stacked[1]).numpy(),
        np.asarray(jpmesh.cosine_similarity_matrix(jnp.asarray(descs[0]),
                                                   jnp.asarray(descs[1]))),
        rtol=1e-5, atol=1e-6)
