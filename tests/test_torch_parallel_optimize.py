"""Port parity: the sharded mapper (`mneslam_tpu_torch/mapping/mapper.py`
over `parallel/mesh.py`) against the JAX package's sharded
`Mapper.optimize`.

The port's ranks are processes on the CPU over gloo (`tests/_torch_dist.py`,
one thread each, a `file://` store under tmp_path, 60 s timeouts); the JAX
side runs in this process on the conftest's virtual CPU devices. The
random draws are made by `jax.random` as the JAX optimize makes them and
handed to the port (`Mapper.optimize(draws=...)`). Tolerances as
tests/test_parallel.py:133: loss rtol 1e-4, parameters atol 3e-5.
The colour planes' pass through the seam (`grid.oneGrid: false`) is held
in tests/test_torch_scene_options_mapper.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mneslam_tpu.config import make_config as jmake_config
from mneslam_tpu.data.synthetic import SyntheticBoxDataset as JSyntheticBox
from mneslam_tpu.mapping.mapper import Mapper as JMapper
from mneslam_tpu.models.scene_rep import SceneRep as JSceneRep
from mneslam_tpu.parallel import mesh as jpmesh
from tests._torch_dist import run_optimize, run_ranks

torch.set_num_threads(1)

RTOL = 1e-4
PARAM_ATOL = 3e-5


# ---------------------------------------------------------------------------
# the sharded optimize
# ---------------------------------------------------------------------------

# tests/test_parallel.py:107-121: planes of 8 (coarse) and 15 (fine, one
# pad row on 2 ranks) nodes a side
OVERRIDES = {
    "mapping": {"bound": [[-1.75, 1.75]] * 3,
                "marching_cubes_bound": [[-1.75, 1.75]] * 3,
                "sample": 64, "min_pixels_cur": 16},
    "planes_res": {"coarse": 0.5, "fine": 0.25, "bound_dividable": 0.5},
    "cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
            "cy": 11.5, "near": 0.0, "far": 5.0},
    "training": {"n_range_d": 7, "n_samples_d": 4, "range_d": 0.2},
    "model": {"c_dim": 8, "input_ch": 16, "input_ch_pos": 48},
}
# (frame, add_keyframe key, optimize key, iterations) per map call
SCHEDULE = ((0, 3, 4, 3), (1, 5, 6, 3))


def _replay(jm, key, iters, count, rays_per_kf, hw, S):
    """The JAX optimize's draws per iteration (`_build_rays` and the
    render's `_block_uniform` of the whole batch): (g_idx, c_idx, u)."""
    out = []
    for i in range(iters):
        k_db, k_cur, k_render = jax.random.split(jax.random.fold_in(key, i),
                                                 3)
        g = jax.random.randint(k_db, (jm.n_global,), 0,
                               max(count * rays_per_kf, 1))
        c = jax.random.randint(k_cur, (jm.n_cur,), 0, hw)
        u = jax.random.uniform(k_render, (jm.n_global + jm.n_cur, S))
        out.append(tuple(np.asarray(a) for a in (g, c, u)))
    return out


def jax_mapping_run(overrides, n_dev, rows=True, schedule=SCHEDULE,
                    state0=None, optimize=True):
    """JAX `Mapper.optimize` over n_dev virtual devices (row-sharded, or
    ray-sharded without `rows`) from `state0` (default: `init_state` of
    PRNGKey(2)) -> (the port's run payload with the same start, keyframes
    and draws, per-call losses, final params). Without `optimize` the
    payload alone (one call)."""
    cfg = jmake_config(overrides)
    scene = JSceneRep(cfg)
    ds = JSyntheticBox(cfg, num_frames=2, half=1.6)
    mesh = jpmesh.make_mesh(1, devices=jax.devices()[:n_dev])
    jm = JMapper(cfg, scene, num_kf=4, rays_per_kf=ds.num_rays_to_save,
                 mesh=mesh, shard_plane_rows=rows)
    st = state0 if state0 is not None else \
        jm.init_state(jax.random.PRNGKey(2))
    run = {"overrides": overrides, "num_kf": 4,
           "rays_per_kf": ds.num_rays_to_save,
           "params": jax.tree.map(np.asarray, st.params), "calls": [],
           "rows": rows}
    S = scene.n_range_d + scene.n_samples_d
    losses = []
    for fi, k_add, k_opt, iters in schedule:
        item = ds[fi]
        frame = {k: jnp.asarray(item[k]) for k in ("direction", "rgb",
                                                   "depth")}
        pose = jnp.asarray(item["c2w"])
        st = jm.add_keyframe(st, jnp.asarray(fi), frame, pose,
                             jax.random.PRNGKey(k_add))
        key = jax.random.PRNGKey(k_opt)
        run["calls"].append({
            "db_rays": np.asarray(st.db.rays),
            "frame_ids": np.asarray(st.db.frame_ids),
            "count": int(st.db.count), "kf_poses": np.asarray(st.kf_poses),
            "frame": {k: np.asarray(v) for k, v in frame.items()},
            "pose": np.asarray(pose),
            "draws": _replay(jm, key, iters, int(st.db.count),
                             ds.num_rays_to_save, ds.H * ds.W, S)})
        if not optimize:
            return run, None, None
        st, met = jm.optimize(st, frame, pose, key, iters=iters)
        losses.append(float(met["loss"]))
    return run, losses, jax.tree.map(np.asarray, st.params)


def assert_params_close(got, ref, atol=PARAM_ATOL):
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(ref)):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def test_row_sharded_optimize_matches_jax_and_unsharded(tmp_path):
    """Two map calls (3 iterations each, a keyframe added between) of the
    row-sharded optimize on 2 ranks, with JAX's draws: the losses (rtol
    1e-4) and the parameters (atol 3e-5) equal JAX's 2-device row-sharded
    `Mapper.optimize` and the port's unsharded optimize; both ranks end
    with the same replicated parameters, and Adam's step count (6) came
    back with the moments."""
    run, jlosses, jparams = jax_mapping_run(OVERRIDES, 2)
    outs = run_ranks("optimize", 2, tmp_path, [run])
    plain = run_optimize(run, rows=False, mesh=False)
    for r in outs + [plain]:
        r = r[0] if isinstance(r, list) else r
        np.testing.assert_allclose([m["loss"] for m in r["metrics"]],
                                   jlosses, rtol=RTOL)
        assert_params_close(r["params"], jparams)
        assert set(r["steps"].values()) == {6}
    a, b = outs[0][0]["params"], outs[1][0]["params"]
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(x, y)
    assert (outs[0][0]["n_global"], outs[0][0]["n_cur"]) == (64, 16)


def test_ray_sharded_mapper_matches_jax(tmp_path):
    """The ray-sharded mapper (a mesh without row sharding:
    tests/test_parallel.py:84) on 2 ranks: replicated parameters,
    all-reduced gradients; equal to JAX's 2-device ray-sharded optimize
    and to the unsharded one (parameters atol 2e-5)."""
    sched = SCHEDULE[:1]
    run, jlosses, jparams = jax_mapping_run(OVERRIDES, 2, rows=False,
                                            schedule=sched)
    outs = run_ranks("optimize", 2, tmp_path, [run])
    plain = run_optimize(run, rows=False, mesh=False)
    for r in (outs[0][0], outs[1][0], plain):
        np.testing.assert_allclose(r["metrics"][0]["loss"], jlosses[0],
                                   rtol=RTOL)
        assert_params_close(r["params"], jparams, atol=2e-5)
