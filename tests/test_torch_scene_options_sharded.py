"""Port parity: the row-sharded mapper with colour planes
(`grid.oneGrid: false`), importance resampling and the smoothness term on
2 gloo ranks (`tests/_torch_dist.py`), against the plain mapper and JAX's
2-device row-sharded optimize (tests/test_parallel.py:133's setup, the
options added), with JAX's draws replayed through the `u` seam.

Tolerances: losses rtol 1e-4, parameters atol 3e-5 (tests/
test_parallel.py:133's), gradients per leaf within 1e-4 of the leaf's
largest element.
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
from mneslam_tpu.parallel import mesh as jpmesh
from tests._torch_dist import run_gradients, run_optimize, run_ranks
from tests.test_torch_scene_options import GRAD_TOL, RTOL, jax_uniforms

torch.set_num_threads(1)


# ---------------------------------------------------------------------------

# tests/test_parallel.py:133's setup (oneGrid false), with importance
# resampling and the smoothness term on
ROW_OVERRIDES = {
    "grid": {"oneGrid": False},
    "c_planes_res": {"coarse": 0.5, "fine": 0.25},
    "mapping": {"bound": [[-1.75, 1.75]] * 3,
                "marching_cubes_bound": [[-1.75, 1.75]] * 3,
                "sample": 64, "min_pixels_cur": 16},
    "planes_res": {"coarse": 0.5, "fine": 0.25, "bound_dividable": 0.5},
    "cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
            "cy": 11.5, "near": 0.0, "far": 5.0},
    "training": {"n_range_d": 7, "n_samples_d": 4, "range_d": 0.2},
    "model": {"c_dim": 8, "input_ch": 16, "input_ch_pos": 48},
}


def _jax_row_run(overrides, iters):
    """JAX's 2-device row-sharded optimize on frame 0 -> (the port's run
    payload (`tests/_torch_dist.run_optimize`), loss, params)."""
    cfg = jmake_config(overrides)
    scene = JSceneRep(cfg)
    ds = JSyntheticBox(cfg, num_frames=2, half=1.6)
    jm = JMapper(cfg, scene, num_kf=4, rays_per_kf=ds.num_rays_to_save,
                 mesh=jpmesh.make_mesh(1, devices=jax.devices()[:2]),
                 shard_plane_rows=True)
    st = jm.init_state(jax.random.PRNGKey(2))
    item = ds[0]
    frame = {k: jnp.asarray(item[k]) for k in ("direction", "rgb", "depth")}
    pose = jnp.asarray(item["c2w"])
    run = {"overrides": overrides, "num_kf": 4,
           "rays_per_kf": ds.num_rays_to_save,
           "params": jax.tree.map(np.asarray, st.params), "rows": True}
    st = jm.add_keyframe(st, jnp.asarray(0), frame, pose,
                         jax.random.PRNGKey(3))
    key = jax.random.PRNGKey(4)
    draws = []
    for i in range(iters):
        k_db, k_cur, k_render = jax.random.split(jax.random.fold_in(key, i),
                                                 3)
        g = jax.random.randint(k_db, (jm.n_global,), 0, ds.num_rays_to_save)
        c = jax.random.randint(k_cur, (jm.n_cur,), 0, ds.H * ds.W)
        u = jax_uniforms(k_render, jm.n_global + jm.n_cur, scene.n_importance,
                         smooth=True, S=scene.n_range_d + scene.n_samples_d)
        draws.append((np.asarray(g), np.asarray(c), u))
    run["calls"] = [{
        "db_rays": np.asarray(st.db.rays),
        "frame_ids": np.asarray(st.db.frame_ids), "count": 1,
        "kf_poses": np.asarray(st.kf_poses),
        "frame": {k: np.asarray(v) for k, v in frame.items()},
        "pose": np.asarray(pose), "draws": draws}]
    st, met = jm.optimize(st, frame, pose, key, iters=iters)
    return run, float(met["loss"]), jax.tree.map(np.asarray, st.params)


@pytest.fixture(scope="module")
def row_run():
    """JAX's row-sharded run with colour planes, n_importance 4 and the
    smoothness term (2 iterations) and its payload for the port."""
    ov = dict(ROW_OVERRIDES, training=dict(
        ROW_OVERRIDES["training"], n_importance=4, smooth_weight=0.01,
        smooth_pts=6, smooth_vox=0.4))
    return _jax_row_run(ov, 2)


def test_row_sharded_mapper_with_colour_planes_matches_jax(tmp_path,
                                                           row_run):
    """grid.oneGrid false, n_importance 4 and the smoothness term: 2
    iterations of the row-sharded optimize on 2 gloo ranks (the colour
    planes through the seam) give JAX's 2-device row-sharded loss (rtol
    1e-4) and parameters (atol 3e-5, tests/test_parallel.py:133's), the
    same as the port's plain mapper; both ranks end with the same map and
    Adam's step count came back for the colour planes."""
    run, jloss, jparams = row_run
    outs = run_ranks("optimize", 2, tmp_path, [run])
    plain = run_optimize(run, rows=False, mesh=False)
    for r in (outs[0][0], outs[1][0], plain):
        np.testing.assert_allclose(r["metrics"][0]["loss"], jloss, rtol=RTOL)
        for (path, a), b in zip(
                jax.tree_util.tree_flatten_with_path(r["params"])[0],
                jax.tree.leaves(jparams)):
            np.testing.assert_allclose(a, b, rtol=0, atol=3e-5,
                                       err_msg=jax.tree_util.keystr(path))
        assert r["steps"][("c_planes", "xy", 1)] == 2
    for x, y in zip(jax.tree.leaves(outs[0][0]["params"]),
                    jax.tree.leaves(outs[1][0]["params"])):
        np.testing.assert_array_equal(x, y)


def test_sharded_gradients_with_colour_planes_match_plain(tmp_path,
                                                          row_run):
    """`Mapper.gradients` of the first batch on 2 gloo ranks, row-sharded
    (the colour planes' cotangents through the seam's reduce-scatter and
    fold) and ray-sharded, against the plain mapper's: every leaf within
    1e-4 of its largest element (chip_smoke 14b's measure)."""
    run, _, _ = row_run
    outs = run_ranks("gradients", 2, tmp_path, run)
    plain = run_gradients(run, rows=False, mesh=False)
    assert len(plain) == 16          # 6 planes, 6 colour planes, 4 weights
    for out in outs:
        for mode in ("rows", "rays"):
            for a, b in zip(out[mode], plain):
                scale = max(float(np.abs(b).max()), 1e-30)
                assert float(np.abs(a - b).max()) <= GRAD_TOL * scale, mode
