"""The composed mesh fleet (agents x row groups over a world of ranks,
`mneslam_tpu_torch/parallel/fleet.ComposedFleet`) on the CPU: its mapping
step against the JAX package's `make_fleet_super_step_row_sharded`
(`mneslam_tpu/parallel/fleet.py:143-225`), the world's layout and the
leaders' collectives (`parallel/mesh.py`), and the JAX fleet's guards
(`mneslam_tpu/parallel/fleet.py:238-282`). The port's ranks are
`tests/_torch_dist.py`'s processes (gloo, one thread each, 60 s
timeouts); the JAX side runs in this process on the conftest's virtual
CPU devices, its `shard_map` jitted. Whole runs against the one-slice
fleet are in test_torch_fleet_composed_runs.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mneslam_tpu.config import make_config as jmake_config
from mneslam_tpu.data.synthetic import SyntheticBoxDataset as JSyntheticBox
from mneslam_tpu.mapping.mapper import Mapper as JMapper
from mneslam_tpu.models.scene_rep import SceneRep as JSceneRep
from mneslam_tpu.parallel import fleet as jfleet
from mneslam_tpu.parallel import mesh as jpmesh
from mneslam_tpu_torch.parallel import fleet as pfleet
from mneslam_tpu_torch.parallel import mesh as pmesh
from test_torch_fleet import fleet_overrides, make_agents
from test_torch_parallel_optimize import (OVERRIDES, PARAM_ATOL, RTOL,
                                          SCHEDULE, _replay,
                                          assert_params_close)
from tests._torch_dist import run_ranks

torch.set_num_threads(1)


def jax_composed_run(overrides, n_agents=2, n_dev=4, schedule=SCHEDULE):
    """JAX's composed super-step (`make_fleet_super_step_row_sharded`) on
    an (agent, ray) mesh of n_dev virtual devices: per map call of
    `schedule` agent a adds frame (fi + a) % 2 and optimizes, its keys
    offset by 10 a -> (each agent's port run payload with the same start,
    keyframes and draws, its per-call losses, its final params)."""
    cfg = jmake_config(overrides)
    scene = JSceneRep(cfg)
    ds = JSyntheticBox(cfg, num_frames=2, half=1.6)
    mesh = jpmesh.make_mesh(n_agents, devices=jax.devices()[:n_dev])
    jm = JMapper(cfg, scene, num_kf=4, rays_per_kf=ds.num_rays_to_save,
                 mesh=mesh, shard_plane_rows=True, shard_axes=("ray",))
    states = [jm.init_state(jax.random.PRNGKey(2 + a))
              for a in range(n_agents)]
    runs = [{"overrides": overrides, "num_kf": 4,
             "rays_per_kf": ds.num_rays_to_save,
             "params": jax.tree.map(np.asarray, st.params), "calls": [],
             "rows": True} for st in states]
    state = jpmesh.shard_agent_stack(jfleet.tree_stack(states), mesh)
    step = jfleet.make_fleet_super_step_row_sharded(jm)
    S = scene.n_range_d + scene.n_samples_d
    losses = [[] for _ in range(n_agents)]
    for fi, k_add, k_opt, iters in schedule:
        items = [ds[(fi + a) % 2] for a in range(n_agents)]
        frames = [{k: jnp.asarray(it[k]) for k in ("direction", "rgb",
                                                   "depth")}
                  for it in items]
        poses = [jnp.asarray(it["c2w"]) for it in items]
        keys = [(jax.random.PRNGKey(k_add + 10 * a),
                 jax.random.PRNGKey(k_opt + 10 * a))
                for a in range(n_agents)]
        state, met = step(
            state, jnp.asarray([(fi + a) % 2 for a in range(n_agents)]),
            jfleet.tree_stack(frames), jfleet.tree_stack(poses),
            jnp.stack([k for k, _ in keys]), jnp.stack([k for _, k in keys]),
            jnp.ones((n_agents,), bool), iters=iters)
        for a in range(n_agents):
            count = int(state.db.count[a])
            runs[a]["calls"].append({
                "db_rays": np.asarray(state.db.rays[a]),
                "frame_ids": np.asarray(state.db.frame_ids[a]),
                "count": count, "kf_poses": np.asarray(state.kf_poses[a]),
                "frame": {k: np.asarray(v) for k, v in frames[a].items()},
                "pose": np.asarray(poses[a]),
                "draws": _replay(jm, keys[a][1], iters, count,
                                 ds.num_rays_to_save, ds.H * ds.W, S)})
            losses[a].append(float(met["loss"][a]))
    params = [jax.tree.map(lambda x: np.asarray(x[a]), state.params)
              for a in range(n_agents)]
    return runs, losses, params


def test_composed_super_step_matches_jax(tmp_path):
    """Two map calls (3 iterations each) of two agents on 4 ranks, each
    agent's mapper row-sharded over its slice's `ray` group
    (shard_axes ("ray",)), with JAX's draws: each agent's losses (rtol
    1e-4) and parameters (atol 3e-5) equal JAX's composed super-step on a
    2 x 2 mesh; a slice's two ranks end with the same map; the ray counts
    round to the slice's 2 ranks, not the world's 4."""
    runs, jlosses, jparams = jax_composed_run(OVERRIDES)
    outs = run_ranks("composed_optimize", 4, tmp_path, runs)
    assert [a for a, _ in outs] == [0, 0, 1, 1]
    for rank, (a, r) in enumerate(outs):
        np.testing.assert_allclose([m["loss"] for m in r["metrics"]],
                                   jlosses[a], rtol=RTOL)
        assert_params_close(r["params"], jparams[a], atol=PARAM_ATOL)
        assert set(r["steps"].values()) == {6}
        assert (r["n_global"], r["n_cur"]) == (64, 16)
    for a in (0, 1):
        for x, y in zip(jax.tree.leaves(outs[2 * a][1]["params"]),
                        jax.tree.leaves(outs[2 * a + 1][1]["params"])):
            np.testing.assert_array_equal(x, y)
    # the agents mapped different frames from different starts
    assert not np.allclose(jlosses[0], jlosses[1])


def test_world_layout_and_leaders_collectives(tmp_path):
    """`make_mesh(2)` on 8 ranks is the config's 2 x 4 layout (and 3
    agents clamp to 2 slices there, as on 4 ranks in
    test_torch_parallel.py): rank = agent * 4 + ray. The leaders' group
    is the `agent` group of ray index 0, and only a leader takes it; a
    broadcast from a group's last index and the metadata all-gather reach
    exactly the group's ranks."""
    outs = run_ranks("mesh", 8, tmp_path, {"n_agents": (2, 3), "grid": 2})
    for rank, o in enumerate(outs):
        assert o["shapes"] == {2: {"agent": 2, "ray": 4},
                               3: {"agent": 2, "ray": 4}}
        a, r = divmod(rank, 4)
        g = o["groups"]
        assert (g["agent"]["size"], g["agent"]["index"],
                g["agent"]["src"]) == (2, a, r)
        assert (g["ray"]["size"], g["ray"]["index"],
                g["ray"]["src"]) == (4, r, 4 * a)
        assert g["agent"]["bcast_last"] == 4 + r
        assert g["ray"]["bcast_last"] == 4 * a + 3
        assert g["agent/ray"]["bcast_last"] == 7
        assert g["agent"]["values"] == [[r, 7 * r], [4 + r, 7 * (4 + r)]]
        assert g["ray"]["values"] == [[k, 7 * k]
                                      for k in range(4 * a, 4 * a + 4)]
        assert o["leaders_size"] == (2 if r == 0 else None)
    local = pmesh.make_mesh(2)
    assert local.leaders().is_local
    np.testing.assert_array_equal(
        pmesh.all_gather_values([3, 4], local.leaders()).numpy(), [[3, 4]])


def test_guards_one_agent_per_slice(tmp_path, monkeypatch):
    """JAX's guards: a mesh whose agent axis was clamped (3 agents on 4
    ranks -> 2 slices of 2) raises JAX's one-agent-per-slice error under
    row sharding and the port's without it; a valid layout passes and
    says whether the mapper is row-sharded (R > 1 and
    mapping.shard_plane_rows)."""
    clamped = pmesh.Mesh(2, 2, 0, {}, "host")
    with pytest.raises(ValueError, match="exactly one agent per 'agent' "
                                         "slice: 3 agents"):
        pfleet.composed_layout(clamped, 3, want_rows=True)
    with pytest.raises(ValueError, match="one agent per 'agent' slice"):
        pfleet.composed_layout(clamped, 3, want_rows=False)
    assert pfleet.composed_layout(clamped, 2, want_rows=True)
    assert not pfleet.composed_layout(clamped, 2, want_rows=False)
    assert not pfleet.composed_layout(pmesh.Mesh(2, 1, 0, {}, "host"), 2,
                                      want_rows=True)
    # on a world, MeshAgentFleet is the composed fleet and guards first
    ov = fleet_overrides(tmp_path, "guard")
    ov["mapping"]["shard_plane_rows"] = True
    agents = make_agents(ov, n_frames=6, segments=((0, 2), (2, 4), (4, 6)))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    with pytest.raises(ValueError, match="exactly one agent per 'agent' "
                                         "slice"):
        pfleet.MeshAgentFleet(agents, mesh=clamped)


def test_one_rank_a_slice_maps_plain_and_says_so(tmp_path):
    """R = 1 (two agents on two ranks) with mapping.shard_plane_rows: each
    leader maps with a plain mapper and prints JAX's "mapper mesh ignored"
    note; no rank follows; the run equals the one-slice fleet's (the same
    keyframes, losses rtol 1e-4)."""
    ov = fleet_overrides(tmp_path / "out", "plain")
    ov["mapping"].update(shard_plane_rows=True, first_iters=6, iters=2)
    p = {"overrides": ov, "num_frames": 6, "segments": [(0, 4), (2, 6)]}
    outs = run_ranks("fleet", 2, tmp_path, p)
    ov["data"]["exp_name"] = "plain_ref"
    ref = make_agents(ov, n_frames=6, segments=((0, 4), (2, 6)))
    pfleet.MeshAgentFleet(ref).run_mapping_only()
    for rank, o in enumerate(outs):
        assert o["mesh"] == {"agent": 2, "ray": 1}
        assert not o["follower"] and not o["shard_rows"]
        assert o["composed"] == "ComposedFleet"
        assert "mapper mesh ignored" in o["note"]
        got = o["agents"][rank]
        assert got["mapped"] == ref[rank].mapped_timestamps
        np.testing.assert_allclose(
            got["losses"], [float(m["loss"]) for m in ref[rank].metrics_log],
            rtol=RTOL)
