"""Port parity: the mapper's optimizer, keyframe database, ray batches and
optimization steps against the JAX package.

The random draws (pixel indices, ray indices, depth perturbations) are
made by `jax.random` exactly as the JAX code makes them and handed to the
port as tensors. Tolerances: rtol 1e-4 / atol 1e-5 (fp32) unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mneslam_tpu.config import make_config as jmake_config
from mneslam_tpu.mapping import keyframe as jkf
from mneslam_tpu.mapping.mapper import Mapper as JMapper
from mneslam_tpu.models.scene_rep import SceneRep as JSceneRep
from mneslam_tpu_torch.config import make_config
from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
from mneslam_tpu_torch.mapping import keyframe as kf
from mneslam_tpu_torch.mapping.mapper import Mapper, make_optimizer
from mneslam_tpu_torch.models.scene_rep import SceneRep, param_items
from mneslam_tpu_torch.utils.convert import (load_adam_moments,
                                             params_from_jax)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5

OVERRIDES = {
    "mapping": {"bound": [[-2.2, 2.2]] * 3, "sample": 160,
                "min_pixels_cur": 32, "keyframe_every": 2},
    "planes_res": {"coarse": 0.44, "fine": 0.22, "bound_dividable": 0.22},
    "cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
            "cy": 11.5, "near": 0.0, "far": 8.0},
    "training": {"n_range_d": 9, "n_samples_d": 8, "range_d": 0.25,
                 "trunc": 0.15},
    "model": {"c_dim": 16, "input_ch": 32, "input_ch_pos": 48,
              "truncation": 0.15},
}


def _pair(num_kf=4):
    jcfg, cfg = jmake_config(OVERRIDES), make_config(OVERRIDES)
    ds = SyntheticBoxDataset(cfg, num_frames=4, half=1.6)
    jscene, scene = JSceneRep(jcfg), SceneRep(cfg, "cpu")
    jm = JMapper(jcfg, jscene, num_kf=num_kf, rays_per_kf=ds.num_rays_to_save)
    m = Mapper(cfg, scene, num_kf=num_kf, rays_per_kf=ds.num_rays_to_save)
    return jm, m, ds


def _carry_params(m, state, jparams):
    state.params = params_from_jax(jax.tree.map(np.asarray, jparams))
    state.optimizer = make_optimizer(m.config, state.params)


def test_make_optimizer_hyperparameters():
    _, m, _ = _pair()
    state = m.init_state(torch.Generator().manual_seed(0))
    dec, planes = state.optimizer.param_groups
    assert dec["lr"] == 0.01 and dec["betas"] == (0.9, 0.99)
    assert dec["weight_decay"] == 1e-6 and dec["eps"] == 1e-8
    assert planes["lr"] == 0.005 and planes["betas"] == (0.9, 0.99)
    assert planes["weight_decay"] == 0.0 and planes["eps"] == 1e-15
    # groups by top-level key, as optax.multi_transform labels them
    dec_ids = {id(t) for p, t in param_items(state.params)
               if p[0] == "decoder"}
    assert {id(t) for t in dec["params"]} == dec_ids
    assert len(planes["params"]) == 6 and not (
        {id(t) for t in planes["params"]} & dec_ids)


def test_keyframe_db_add_and_sample_match_jax():
    """Add two keyframes and sample global rays with the JAX draws."""
    jm, m, ds = _pair()
    n = ds.num_rays_to_save
    jdb = jkf.init_db(4, n)
    db = kf.init_db(4, n, "cpu")
    for fid, key in ((0, jax.random.PRNGKey(1)), (2, jax.random.PRNGKey(2))):
        item = ds[fid]
        jdb = jkf.add_keyframe(jdb, key, jnp.asarray(fid), item["direction"],
                               item["rgb"], item["depth"])
        idx = jax.random.randint(key, (n,), 0, ds.H * ds.W)   # the JAX draw
        kf.add_keyframe(db, None, fid, torch.tensor(item["direction"]),
                        torch.tensor(item["rgb"]), torch.tensor(item["depth"]),
                        idx=torch.tensor(np.asarray(idx)))
    assert db.count == int(jdb.count) == 2
    np.testing.assert_array_equal(db.frame_ids.numpy(),
                                  np.asarray(jdb.frame_ids))
    np.testing.assert_array_equal(db.rays.numpy(), np.asarray(jdb.rays))

    key = jax.random.PRNGKey(3)
    jrays, jslots = jkf.sample_global_rays(jdb, key, 50)
    idx = jax.random.randint(key, (50,), 0, 2 * n)
    rays, slots = kf.sample_global_rays(db, None, 50,
                                        idx=torch.tensor(np.asarray(idx)))
    np.testing.assert_array_equal(rays.numpy(), np.asarray(jrays))
    np.testing.assert_array_equal(slots.numpy(), np.asarray(jslots))

    # drawn from a generator: indices stay inside the filled slots
    rays, slots = kf.sample_global_rays(db, torch.Generator().manual_seed(0),
                                        500)
    assert int(slots.max()) < 2 and rays.shape == (500, 7)


def test_build_rays_matches_jax():
    jm, m, ds = _pair()
    jstate = jm.init_state(jax.random.PRNGKey(0))
    state = m.init_state(torch.Generator().manual_seed(0))
    n = ds.num_rays_to_save
    for slot, fid in enumerate((0, 2)):
        item = ds[fid]
        key = jax.random.PRNGKey(20 + fid)
        frame = {k: jnp.asarray(item[k]) for k in ("direction", "rgb",
                                                   "depth")}
        jstate = jm.add_keyframe(jstate, jnp.asarray(fid), frame,
                                 jnp.asarray(item["c2w"]), key)
        idx = jax.random.randint(key, (n,), 0, ds.H * ds.W)
        kf.add_keyframe(state.db, None, fid, *(torch.tensor(item[k]) for k in
                                               ("direction", "rgb", "depth")),
                        idx=torch.tensor(np.asarray(idx)))
        state.kf_poses[slot] = torch.tensor(item["c2w"])

    cur = ds[3]
    key = jax.random.PRNGKey(9)
    ref = jm._build_rays(jstate.db, jstate.kf_poses,
                         jnp.asarray(cur["direction"]).reshape(-1, 3),
                         jnp.asarray(cur["rgb"]).reshape(-1, 3),
                         jnp.asarray(cur["depth"]).reshape(-1),
                         jnp.asarray(cur["c2w"]), ds.H * ds.W, key, True)
    k_db, k_cur, _ = jax.random.split(key, 3)
    g_idx = jax.random.randint(k_db, (m.n_global,), 0, 2 * n)
    c_idx = jax.random.randint(k_cur, (m.n_cur,), 0, ds.H * ds.W)
    got = m._build_rays(state.db, state.kf_poses,
                        torch.tensor(cur["direction"]).reshape(-1, 3),
                        torch.tensor(cur["rgb"]).reshape(-1, 3),
                        torch.tensor(cur["depth"]).reshape(-1),
                        torch.tensor(cur["c2w"]), ds.H * ds.W, None, True,
                        g_idx=torch.tensor(np.asarray(g_idx)),
                        c_idx=torch.tensor(np.asarray(c_idx)))
    for a, b in zip(got, ref[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), RTOL, ATOL)


def _batches(n, steps, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        o = rng.normal(0, 0.2, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        out.append((o, d, rng.uniform(size=(n, 3)).astype(np.float32),
                    (0.4 + 1.2 * rng.uniform(size=(n, 1))).astype(
                        np.float32)))
    return out


def _jax_steps(jm, params, opt_state, batches, keys):
    losses = []
    for (o, d, rgb, td), key in zip(batches, keys):
        (loss, _), grads = jax.value_and_grad(jm._loss_fn, has_aux=True)(
            params, o, d, rgb, td, key)
        updates, opt_state = jm.optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return params, opt_state, losses


def _port_steps(m, state, batches, keys, S):
    losses = []
    for (o, d, rgb, td), key in zip(batches, keys):
        u = jax.random.uniform(key, (o.shape[0], S))  # JAX's perturbation
        met = m.step(state, *(torch.tensor(a) for a in (o, d, rgb, td)),
                     u=torch.tensor(np.asarray(u)))
        losses.append(float(met["loss"]))
    return losses


def _assert_params_close(tparams, jparams):
    items = dict(param_items(tparams))
    for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        np.testing.assert_allclose(items[key].detach().numpy(),
                                   np.asarray(v), RTOL, ATOL,
                                   err_msg=str(key))


def test_three_optimize_steps_match_jax():
    """Identical ray batches and perturbations: the loss trajectory and
    the parameters after 3 Adam steps equal the JAX step (`_loss_fn` +
    the optax update)."""
    jm, m, ds = _pair()
    S = jm.scene.n_range_d + jm.scene.n_samples_d
    jparams = jm.scene.init_params(jax.random.PRNGKey(0))
    opt_state = jm.optimizer.init(jparams)
    state = m.init_state(torch.Generator().manual_seed(0))
    _carry_params(m, state, jparams)

    batches = _batches(192, 3)
    keys = [jax.random.PRNGKey(100 + i) for i in range(3)]
    jparams, _, jlosses = _jax_steps(jm, jparams, opt_state, batches, keys)
    losses = _port_steps(m, state, batches, keys, S)
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    assert losses[-1] < losses[0]
    _assert_params_close(state.params, jparams)


def test_adam_moments_carried_mid_run():
    """One JAX step, then params AND optax's m / v / count carried into the
    port: two more steps on each side stay equal."""
    jm, m, ds = _pair()
    S = jm.scene.n_range_d + jm.scene.n_samples_d
    jparams = jm.scene.init_params(jax.random.PRNGKey(1))
    opt_state = jm.optimizer.init(jparams)
    batches = _batches(192, 3, seed=1)
    keys = [jax.random.PRNGKey(200 + i) for i in range(3)]
    jparams, opt_state, _ = _jax_steps(jm, jparams, opt_state, batches[:1],
                                       keys[:1])

    dec = opt_state.inner_states["decoder"].inner_state[1][0]
    pl = opt_state.inner_states["planes"].inner_state[0]
    mu = {"decoder": dec.mu["decoder"], "planes": pl.mu["planes"]}
    nu = {"decoder": dec.nu["decoder"], "planes": pl.nu["planes"]}
    state = m.init_state(torch.Generator().manual_seed(0))
    _carry_params(m, state, jparams)
    load_adam_moments(state.optimizer, state.params,
                      jax.tree.map(np.asarray, mu),
                      jax.tree.map(np.asarray, nu), int(dec.count))

    jparams, _, jlosses = _jax_steps(jm, jparams, opt_state, batches[1:],
                                     keys[1:])
    losses = _port_steps(m, state, batches[1:], keys[1:], S)
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    _assert_params_close(state.params, jparams)


def test_optimize_and_first_frame_mapping_run_from_generator():
    """The generator-driven loop: first-frame mapping then a keyframe; the
    loss drops and the metrics come back as device scalars."""
    _, m, ds = _pair()
    g = torch.Generator().manual_seed(0)
    state = m.init_state(g)
    frame = {k: torch.tensor(ds[0][k]) for k in ("direction", "rgb",
                                                 "depth")}
    frame["frame_id"] = 0
    state, met0 = m.first_frame_mapping(state, frame,
                                        torch.tensor(ds[0]["c2w"]), g,
                                        iters=30)
    assert state.db.count == 1 and set(met0) == {"loss", "psnr", "rgb_loss",
                                                 "depth_loss"}
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0
               for v in met0.values())
    frame2 = {k: torch.tensor(ds[2][k]) for k in ("direction", "rgb",
                                                  "depth")}
    state = m.add_keyframe(state, 2, frame2, torch.tensor(ds[2]["c2w"]), g)
    state, met1 = m.optimize(state, frame2, torch.tensor(ds[2]["c2w"]), g,
                             iters=10)
    assert state.db.count == 2
    np.testing.assert_array_equal(state.kf_poses[1].numpy(), ds[2]["c2w"])
    assert np.isfinite(float(met1["loss"]))


def test_filter_depth_samples_only_valid_pixels():
    """mapping.filter_depth: pixels with 0 < d <= depth_trunc only; a frame
    without any valid depth falls back to all pixels."""
    g = torch.Generator().manual_seed(0)
    depth = torch.zeros(6, 8)
    depth[2, 3], depth[4, 5], depth[1, 1] = 1.0, 2.0, 150.0
    idx = kf.sample_pixels(g, depth, 200, filter_depth=True, depth_trunc=100.0)
    assert set(idx.tolist()) == {2 * 8 + 3, 4 * 8 + 5}
    idx = kf.sample_pixels(g, torch.zeros(6, 8), 50, filter_depth=True)
    assert idx.shape == (50,) and int(idx.max()) < 48


def test_smoothness_loss_is_not_ported():
    """The smoothness loss is ported now (held against the JAX mapper in
    tests/test_torch_scene_options_mapper.py): a mapper with
    smooth_weight > 0 builds, and its step's loss holds the term."""
    cfg = make_config(dict(OVERRIDES, training=dict(
        OVERRIDES["training"], smooth_weight=0.1, smooth_pts=6)))
    m = Mapper(cfg, SceneRep(cfg, "cpu"), num_kf=2, rays_per_kf=8)
    (o, d, rgb, td), = _batches(64, 1)
    batch = [torch.tensor(a) for a in (o, d, rgb, td)]
    state = m.init_state(torch.Generator().manual_seed(0))
    params = state.params
    u = torch.rand((64, 17), generator=torch.Generator().manual_seed(1))
    on, ret = m._loss_fn(params, *batch, u=u)
    off = m.scene.get_loss_from_ret(ret)
    assert float(on.detach()) > float(off.detach())
