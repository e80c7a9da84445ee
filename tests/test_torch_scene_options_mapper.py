"""Port parity: the mapper with the scene representation's options that
the Replica configs leave off, against the JAX package on numpy inputs
from a seed (the scene-level checks are in
tests/test_torch_scene_options.py, whose helpers this file shares):

- the TV smoothness term (`training.smooth_weight`): `smoothness` through
  its uniforms, the mapper's optimize against the JAX mapper's, and under
  bf16 its kernel-1 calls in fp32;
- `c_planes` through `utils.convert` and the full-state checkpoint.

The row-sharded mapper with these options is held in
tests/test_torch_scene_options_sharded.py.

Tolerances: rtol 1e-4 (losses), gradients per leaf within 1e-4 of the
leaf's largest element; parameters as stated per test.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mneslam_tpu.config import make_config as jmake_config
from mneslam_tpu.data.synthetic import SyntheticBoxDataset as JSyntheticBox
from mneslam_tpu.mapping.mapper import Mapper as JMapper
from mneslam_tpu.models.scene_rep import SceneRep as JSceneRep
from mneslam_tpu_torch.agents import comms
from mneslam_tpu_torch.config import make_config
from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
from mneslam_tpu_torch.mapping.mapper import Mapper, make_optimizer
from mneslam_tpu_torch.models.scene_rep import (SceneRep, checkpoint_key,
                                                param_items)
from mneslam_tpu_torch.slam import MNESLAM
from mneslam_tpu_torch.utils.convert import (load_adam_moments,
                                             params_from_jax)
from tests.test_torch_scene_options import (GRAD_TOL, OVERRIDES, RTOL, _pair,
                                            _rays, _t, _tu, _with,
                                            jax_uniforms)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# smoothness
# ---------------------------------------------------------------------------

def test_smoothness_through_its_uniforms_matches_jax():
    jscene, scene, jparams, tparams = _pair()
    key = jax.random.PRNGKey(7)
    ref, jgrad = jax.jit(jax.value_and_grad(lambda p: jscene.smoothness(
        p, key, sample_points=8, voxel_size=0.3, margin=0.05)))(jparams)
    k1, k2 = jax.random.split(key)
    u = {"smooth_offset": _t(jax.random.uniform(k1, (3,))),
         "smooth_jitter": _t(jax.random.uniform(k2, (1, 1, 1, 3))).reshape(3)}
    got = scene.smoothness(tparams, u=u, sample_points=8, voxel_size=0.3,
                           margin=0.05)
    np.testing.assert_allclose(float(got.detach()), float(ref), RTOL)
    got.backward()
    items = dict(param_items(tparams))
    for path, g in jax.tree_util.tree_flatten_with_path(jgrad)[0]:
        key_ = tuple(getattr(k, "key", getattr(k, "idx", None))
                     for k in path)
        if key_[0] != "planes":
            assert items[key_].grad is None     # geometry planes only
            continue
        ref_g = np.asarray(g)
        assert float(np.abs(items[key_].grad.numpy() - ref_g).max()) <= \
            GRAD_TOL * float(np.abs(ref_g).max())
    # drawn from a generator: finite, and repeatable from its seed
    a = scene.smoothness(tparams, generator=torch.Generator().manual_seed(1),
                         sample_points=8, voxel_size=0.3)
    b = scene.smoothness(tparams, generator=torch.Generator().manual_seed(1),
                         sample_points=8, voxel_size=0.3)
    assert float(a.detach()) == float(b.detach()) > 0.0


def _mapper_pair(overrides):
    jcfg, cfg = jmake_config(overrides), make_config(overrides)
    ds = JSyntheticBox(jcfg, num_frames=2, half=1.6)
    jm = JMapper(jcfg, JSceneRep(jcfg), num_kf=4,
                 rays_per_kf=ds.num_rays_to_save)
    m = Mapper(cfg, SceneRep(cfg, "cpu"), num_kf=4,
               rays_per_kf=ds.num_rays_to_save)
    return jm, m, ds


def _jax_optimize(jm, ds, iters, key_opt):
    """The JAX mapper: keyframe 0 added, `iters` iterations -> (start
    state, end state, loss, the port's draws of every iteration)."""
    item = ds[0]
    frame = {k: jnp.asarray(item[k]) for k in ("direction", "rgb", "depth")}
    pose = jnp.asarray(item["c2w"])
    st = jm.init_state(jax.random.PRNGKey(0))
    st = jm.add_keyframe(st, jnp.asarray(0), frame, pose,
                         jax.random.PRNGKey(1))
    draws = []
    sc = jm.scene
    for i in range(iters):
        k_db, k_cur, k_render = jax.random.split(
            jax.random.fold_in(key_opt, i), 3)
        g = jax.random.randint(k_db, (jm.n_global,), 0,
                               int(st.db.count) * jm.rays_per_kf)
        c = jax.random.randint(k_cur, (jm.n_cur,), 0, ds.H * ds.W)
        u = jax_uniforms(k_render, jm.n_global + jm.n_cur, sc.n_importance,
                         float(sc.config["training"]["smooth_weight"]) > 0,
                         S=sc.n_range_d + sc.n_samples_d)
        draws.append((_t(g), _t(c), _tu(u)))
    end, met = jm.optimize(st, frame, pose, key_opt, iters=iters)
    return st, end, float(met["loss"]), draws


def _port_optimize(m, jstart, ds, draws):
    st = m.init_state(torch.Generator().manual_seed(0))
    st.params = params_from_jax(jax.tree.map(np.asarray, jstart.params))
    st.optimizer = make_optimizer(m.config, st.params)
    st.db.rays.copy_(_t(jstart.db.rays))
    st.db.frame_ids.copy_(_t(jstart.db.frame_ids))
    st.db.count = int(jstart.db.count)
    st.kf_poses.copy_(_t(jstart.kf_poses))
    item = ds[0]
    frame = {k: torch.tensor(item[k]) for k in ("direction", "rgb", "depth")}
    st, met = m.optimize(st, frame, torch.tensor(item["c2w"]), None,
                         iters=len(draws), draws=draws)
    return st, float(met["loss"])


def _assert_params_close(tparams, jparams, atol):
    items = dict(param_items(tparams))
    for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        np.testing.assert_allclose(items[key].detach().numpy(),
                                   np.asarray(v), rtol=0, atol=atol,
                                   err_msg=str(key))


def test_mapper_optimize_with_smoothness_matches_jax():
    """tests/test_mapping.py:165 at a smaller size, held against JAX: two
    mapper iterations with smooth_weight 1000 (8 points at 0.3 m) from the
    same state and draws give the JAX loss and parameters (atol 5e-5),
    and the term changes the loss (the same run with smooth_weight 0)."""
    ov = _with({**OVERRIDES, "grid": {"oneGrid": True}}, n_importance=0,
               smooth_weight=1000.0)
    jm, m, ds = _mapper_pair(ov)
    jstart, jend, jloss, draws = _jax_optimize(jm, ds, 2,
                                               jax.random.PRNGKey(2))
    st, loss = _port_optimize(m, jstart, ds, draws)
    np.testing.assert_allclose(loss, jloss, rtol=RTOL)
    _assert_params_close(st.params, jend.params, 5e-5)
    cfg = make_config(_with(ov, smooth_weight=0))
    off = Mapper(cfg, SceneRep(cfg, "cpu"), num_kf=4,
                 rays_per_kf=ds.num_rays_to_save)
    assert _port_optimize(off, jstart, ds, draws)[1] != loss


def test_bf16_smoothness_reaches_kernel1_in_fp32(monkeypatch):
    """Under render_dtype bfloat16 one mapper step with every option calls
    kernel 1's plain version (a CPU tensor) 30 times: 24 on bf16 values
    (the render's two passes over geometry and colour planes) and 6 on
    fp32 values (the smoothness term, not cast)."""
    import mneslam_tpu_torch.kernels.scatter_add_rows as k1

    cfg = make_config(_with(OVERRIDES, render_dtype="bfloat16"))
    scene = SceneRep(cfg, "cpu")
    m = Mapper(cfg, scene, num_kf=2, rays_per_kf=8)
    st = m.init_state(torch.Generator().manual_seed(0))
    dtypes = []
    real = k1.scatter_add_rows_plain

    def plain(idx, vals, n_rows):
        dtypes.append(vals.dtype)
        return real(idx, vals, n_rows)

    monkeypatch.setattr(k1, "scatter_add_rows_plain", plain)
    o, d, rgb, td = _rays(96, seed=7)
    met = m.step(st, *(_t(a) for a in (o, d, rgb, td)),
                 generator=torch.Generator().manual_seed(1))
    assert np.isfinite(float(met["loss"]))
    assert dtypes.count(torch.bfloat16) == 24
    assert dtypes.count(torch.float32) == 6 and len(dtypes) == 30
    assert all(t.grad.dtype == torch.float32 for _, t in
               param_items(st.params) if t.grad is not None)


# ---------------------------------------------------------------------------
# carrying the colour planes across
# ---------------------------------------------------------------------------

def test_colour_planes_carried_by_convert_and_full_state(tmp_path):
    """JAX params and optax moments with c_planes through
    `params_from_jax` / `load_adam_moments`, the JAX npz keys of the
    checkpoints and of the agents' exchange, and a full-state save / load
    of a oneGrid-false agent after a mapped keyframe."""
    jscene, scene, jparams, tparams = _pair()
    items = dict(param_items(tparams))
    jkeys = set()
    for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        np.testing.assert_array_equal(items[key].detach().numpy(),
                                      np.asarray(v))
        jkeys.add("/".join(str(k) for k in path))
    assert {checkpoint_key(p) for p in items} == jkeys
    assert "['c_planes']/['yz']/[1]" in jkeys
    # the agents' exchange (agents/comms) under the same keys
    flat = comms.pack_params(tparams)
    assert set(flat) == jkeys
    back = comms.unpack_params(tparams, flat)
    np.testing.assert_array_equal(back["c_planes"]["xy"][1].numpy(),
                                  np.asarray(jparams["c_planes"]["xy"][1]))
    opt = make_optimizer(scene.config, tparams)
    mu = jax.tree.map(lambda a: np.asarray(a) + 1.0, jparams)
    nu = jax.tree.map(lambda a: np.asarray(a) ** 2, jparams)
    load_adam_moments(opt, tparams, mu, nu, 3)
    t = tparams["c_planes"]["xz"][0]
    np.testing.assert_array_equal(opt.state[t]["exp_avg"].numpy(),
                                  np.asarray(jparams["c_planes"]["xz"][0])
                                  + 1.0)
    # the colour planes in Adam's lr_embed group, beside the planes
    assert any(t is x for x in opt.param_groups[1]["params"])

    ov = {**_with(OVERRIDES, n_importance=0, smooth_weight=0),
          "mode": "mapping", "dataset": "synthetic",
          "data": {"output": str(tmp_path), "exp_name": "c"},
          "mapping": dict(OVERRIDES["mapping"], first_iters=3, iters=2)}
    cfg = make_config(ov)
    ds = SyntheticBoxDataset(cfg, num_frames=2)
    a = MNESLAM(cfg, ds, rank=0, device="cpu")
    frame, pose = a._frame_for_mapping(0)
    a._map_keyframe(0, frame, pose, first=True)
    ck = os.path.join(str(tmp_path), "state.npz")
    a.save_full_state(ck)
    with np.load(ck) as data:
        assert "params/['c_planes']/['xy']/[0]" in data.files
        assert "adam/['c_planes']/['xy']/[0]/exp_avg" in data.files
    b = MNESLAM(cfg, ds, rank=0, device="cpu")
    b.load_full_state(ck)
    for (pa, x), (pb, y) in zip(param_items(a.map_state.params),
                                param_items(b.map_state.params)):
        assert pa == pb
        np.testing.assert_array_equal(x.detach().numpy(),
                                      y.detach().numpy())
        np.testing.assert_array_equal(
            a.map_state.optimizer.state[x]["exp_avg"].numpy(),
            b.map_state.optimizer.state[y]["exp_avg"].numpy())
