"""Port parity: the sharded mapper's gradient of one batch
(`Mapper.gradients`), row- and ray-sharded over 3 ranks, against the
unsharded gradient and JAX's; the exact claim of the sharded paths (the
optimize's own parity is in test_torch_parallel_optimize.py). Ranks as
there.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mneslam_tpu.config import make_config as jmake_config
from mneslam_tpu.mapping.mapper import Mapper as JMapper
from mneslam_tpu.models.scene_rep import SceneRep as JSceneRep
from test_torch_parallel_optimize import (OVERRIDES, SCHEDULE,
                                          jax_mapping_run)
from tests._torch_dist import run_gradients, run_ranks

torch.set_num_threads(1)


def test_sharded_gradients_of_one_batch_match_jax(tmp_path):
    """`Mapper.gradients` on one batch, row- and ray-sharded over 3 ranks
    (the fine planes' 15 rows padded to 15, the coarse 8 to 9) and
    unsharded, against the gradient of JAX's `Mapper._loss_fn` on the
    same rays and uniforms: per leaf, max |error| <= 1e-4 x max |JAX|
    (tests/test_parallel.py:528-531's bound at reference shapes)."""
    from mneslam_tpu.data import rays as jrays

    run, _, _ = jax_mapping_run(OVERRIDES, 3, schedule=SCHEDULE[:1],
                                optimize=False)
    call = run["calls"][0]
    g_idx, c_idx, u = call["draws"][0]
    cfg = jmake_config(OVERRIDES)
    jm = JMapper(cfg, JSceneRep(cfg), num_kf=4,
                 rays_per_kf=run["rays_per_kf"])
    rays = call["db_rays"].reshape(-1, 7)[g_idx]
    g_o, g_d = jrays.rays_from_pose(jnp.asarray(rays[:, :3]), jnp.asarray(
        call["kf_poses"][g_idx // run["rays_per_kf"]]))
    fr = call["frame"]
    c_o, c_d = jrays.rays_from_pose(
        jnp.asarray(fr["direction"].reshape(-1, 3)[c_idx]),
        jnp.asarray(call["pose"]))
    t_rgb = np.concatenate([rays[:, 3:6], fr["rgb"].reshape(-1, 3)[c_idx]])
    t_d = np.concatenate([rays[:, 6], fr["depth"].reshape(-1)[c_idx]])
    scene = jm.scene
    params = jax.tree.map(jnp.asarray, run["params"])

    def loss(p):
        ret = scene.forward(p, jnp.concatenate([g_o, c_o]),
                            jnp.concatenate([g_d, c_d]), jnp.asarray(t_rgb),
                            jnp.asarray(t_d)[:, None], key=None)
        return scene.get_loss_from_ret(ret)

    # JAX draws the perturbation from a key: replay u through the port's
    # unsharded path instead, and hold that path to JAX without
    # perturbation first
    ov = copy.deepcopy(OVERRIDES)
    ov["training"]["perturb"] = 0.0
    run0 = dict(run, overrides=ov)
    ref = jax.jit(jax.grad(loss))(params)
    got = run_gradients(run0, rows=False, mesh=False)
    for (path, r), g in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                            got):
        r = np.asarray(r)
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max(), \
            jax.tree_util.keystr(path)
    # with the perturbation: the sharded gradients against the unsharded
    plain = run_gradients(run, rows=False, mesh=False)
    outs = run_ranks("gradients", 3, tmp_path, run)
    for o in outs:
        for kind in ("rows", "rays"):
            for g, r in zip(o[kind], plain):
                assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max(), kind
