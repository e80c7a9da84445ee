"""Port parity of the fusion and exchange paths of the multi-agent layer
against the JAX package, on the CPU at a tiny size: render-based pose
alignment, distillation (JAX's draws replayed through the idx / u seams,
JAX's Adam moments carried over), and the FileComms protocol in both
directions.

Tolerances: best pose atol 1e-4 and losses rtol 1e-4 for the alignment;
rtol 1e-4 / atol 1e-5 for the distilled parameters (as
tests/test_torch_mapper.py).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mneslam_tpu.agents import comms as jcomms
from mneslam_tpu.agents import fusion as jfusion
from mneslam_tpu.config import make_config as jmake_config
from mneslam_tpu.mapping.mapper import Mapper as JMapper
from mneslam_tpu.models.scene_rep import SceneRep as JSceneRep
from mneslam_tpu.ops import rotations as jrot
from mneslam_tpu_torch.agents import comms, fusion
from mneslam_tpu_torch.config import make_config
from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
from mneslam_tpu_torch.mapping.mapper import Mapper, make_optimizer
from mneslam_tpu_torch.models.scene_rep import SceneRep, param_items
from mneslam_tpu_torch.utils.convert import (load_adam_moments,
                                             params_from_jax,
                                             params_to_numpy)
from test_torch_agents import ATOL, RTOL, t32, tiny_overrides

torch.set_num_threads(1)

ALIGN_POSE_ATOL = 1e-4


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny map trained by the port for 40 steps on frame 4 of the box
    room, as numpy, and the pieces both packages need."""
    tmp = tmp_path_factory.mktemp("agents")
    ov = tiny_overrides(tmp)
    cfg, jcfg = make_config(ov), jmake_config(ov)
    ds = SyntheticBoxDataset(cfg, num_frames=8)
    scene = SceneRep(cfg, "cpu")
    m = Mapper(cfg, scene, num_kf=2, rays_per_kf=ds.num_rays_to_save)
    g = torch.Generator().manual_seed(0)
    state = m.init_state(g)
    frame = {k: torch.tensor(ds[4][k]) for k in ("direction", "rgb",
                                                 "depth")}
    frame["frame_id"] = 4
    m.first_frame_mapping(state, frame, torch.tensor(ds[4]["c2w"]), g,
                          iters=40)
    return SimpleNamespace(ov=ov, cfg=cfg, jcfg=jcfg, ds=ds,
                           params=params_to_numpy(state.params),
                           jscene=JSceneRep(jcfg), scene=scene)


def test_align_pose_by_render_matches_jax(trained):
    """10 iterations on a trained map (base and target the same map) from
    a perturbed pose: best c2w atol 1e-4, best and init losses rtol 1e-4;
    the map takes no gradient."""
    tr = trained
    jp = jax.tree.map(jnp.asarray, tr.params)
    pp = params_from_jax(tr.params)
    base = tr.ds[4]["c2w"].astype(np.float32)
    perturb = np.asarray(jrot.rot_trans_to_transform(
        jnp.asarray([0.06, -0.04, 0.05]), jnp.asarray([0.08, -0.06, 0.05])))
    target = (perturb @ base).astype(np.float32)
    rays = tr.ds[0]["direction"].reshape(-1, 3)[
        np.random.default_rng(0).integers(0, 40 * 56, 256)]
    kw = dict(iters=10, lr_rot=0.01, lr_trans=0.01)
    jb, jbest, jinit = jfusion.align_pose_by_render(
        tr.jscene, jp, tr.jscene, jp, base, target, rays,
        jax.random.PRNGKey(0), **kw)
    pb, pbest, pinit = fusion.align_pose_by_render(
        tr.scene, pp, tr.scene, pp, t32(base), t32(target), t32(rays), **kw)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb),
                               atol=ALIGN_POSE_ATOL)
    np.testing.assert_allclose(float(pbest), float(jbest), rtol=RTOL)
    np.testing.assert_allclose(float(pinit), float(jinit), rtol=RTOL)
    assert float(pbest) < float(pinit)
    assert all(p.grad is None for _, p in param_items(pp))


def _jax_moments(opt_state):
    dec = opt_state.inner_states["decoder"].inner_state[1][0]
    pl = opt_state.inner_states["planes"].inner_state[0]
    mu = {"decoder": dec.mu["decoder"], "planes": pl.mu["planes"]}
    nu = {"decoder": dec.nu["decoder"], "planes": pl.nu["planes"]}
    return (jax.tree.map(np.asarray, mu), jax.tree.map(np.asarray, nu),
            int(dec.count))


def test_distill_matches_jax(trained):
    """3 distillation iterations of a student with one mapping step behind
    it (JAX's Adam moments carried over), with JAX's ray draws and
    perturbations through the idx / u seams: the parameters rtol 1e-4 /
    atol 1e-5, the last loss rtol 1e-4."""
    import optax

    tr = trained
    jteacher = jax.tree.map(jnp.asarray, tr.params)
    jm = JMapper(tr.jcfg, tr.jscene, num_kf=2,
                 rays_per_kf=tr.ds.num_rays_to_save)
    jparams = tr.jscene.init_params(jax.random.PRNGKey(3))
    opt_state = jm.optimizer.init(jparams)
    rng = np.random.default_rng(6)
    n = 96
    o = rng.normal(0, 0.2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    batch = (o, d, rng.uniform(size=(n, 3)).astype(np.float32),
             (0.4 + rng.uniform(size=(n, 1))).astype(np.float32))
    (_, _), grads = jax.value_and_grad(jm._loss_fn, has_aux=True)(
        jparams, *batch, jax.random.PRNGKey(9))
    updates, opt_state = jm.optimizer.update(grads, opt_state, jparams)
    jparams = optax.apply_updates(jparams, updates)

    m = Mapper(tr.cfg, tr.scene, num_kf=2,
               rays_per_kf=tr.ds.num_rays_to_save)
    state = m.init_state(torch.Generator().manual_seed(0))
    state.params = params_from_jax(jax.tree.map(np.asarray, jparams))
    state.optimizer = make_optimizer(tr.cfg, state.params)
    load_adam_moments(state.optimizer, state.params, *_jax_moments(
        opt_state))

    poses = np.stack([tr.ds[i]["c2w"] for i in (3, 5)]).astype(np.float32)
    rays = tr.ds[0]["direction"].reshape(-1, 3).astype(np.float32)
    iters, r, key = 3, 64, jax.random.PRNGKey(17)
    jout, _, jloss = jfusion.distill(
        tr.jscene, jteacher, tr.jscene, jm, jparams, opt_state, poses, rays,
        key, iters=iters, rays_per_kf=r)
    S = tr.jscene.n_range_d + tr.jscene.n_samples_d
    idx, u = [], []
    for it in range(iters):
        k = jax.random.fold_in(key, it)
        idx.append(np.asarray(jax.random.randint(k, (2, r), 0, len(rays))))
        u.append(np.asarray(jax.random.uniform(jax.random.fold_in(k, 1),
                                               (2 * r, S))))
    _, loss = fusion.distill(tr.scene, params_from_jax(tr.params), m, state,
                             t32(poses), t32(rays), iters=iters,
                             rays_per_kf=r, idx=torch.tensor(np.stack(idx)),
                             u=t32(np.stack(u)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    items = dict(param_items(state.params))
    for path_, v in jax.tree_util.tree_flatten_with_path(jout)[0]:
        key_ = tuple(getattr(k, "key", getattr(k, "idx", None))
                     for k in path_)
        np.testing.assert_allclose(items[key_].detach().numpy(),
                                   np.asarray(v), RTOL, ATOL,
                                   err_msg=str(key_))
    # drawn from a generator: runs and changes the student
    before = [a.detach().clone() for _, a in param_items(state.params)]
    fusion.distill(tr.scene, params_from_jax(tr.params), m, state,
                   t32(poses), t32(rays), torch.Generator().manual_seed(1),
                   iters=1, rays_per_kf=r)
    assert not all(torch.equal(a, b) for (_, a), b in zip(
        param_items(state.params), before))


# ---------------------------------------------------------------------------
# comms
# ---------------------------------------------------------------------------

def test_file_comms_interop_with_jax(tmp_path, trained):
    """What the JAX FileComms writes the port reads bit for bit, and the
    reverse: descriptors, keyframes, checkpoints (a real map's parameters
    under the JAX path keys, and the bound)."""
    tr = trained
    jparams = jax.tree.map(jnp.asarray, tr.params)
    jc = jcomms.FileComms(str(tmp_path), rank=0)
    pc = comms.FileComms(str(tmp_path), rank=1)
    rng = np.random.default_rng(7)
    d0 = rng.normal(size=64).astype(np.float32)
    d1 = rng.normal(size=64).astype(np.float32)
    jc.add_descriptor({"descriptor": d0, "kf_id": 3, "agent_id": 0})
    pc.add_descriptor({"descriptor": torch.tensor(d1).numpy(), "kf_id": 5,
                       "agent_id": 1})
    for reader in (jc, pc):
        db = reader.descriptors()
        assert [(e["agent_id"], e["kf_id"]) for e in db] == [(0, 3), (1, 5)]
        np.testing.assert_array_equal(db[0]["descriptor"], d0)
        np.testing.assert_array_equal(db[1]["descriptor"], d1)

    poses = rng.normal(size=(3, 4, 4)).astype(np.float32)
    ts = np.asarray([0.0, 5.0, 10.0])
    bound = np.asarray(tr.cfg["mapping"]["bound"], np.float32)
    jc.publish_keyframes(0, poses, ts)
    jc.publish_checkpoint(0, jparams, {"bound": bound})
    got_poses, got_ts = pc.get_keyframes(0)
    np.testing.assert_array_equal(got_poses, poses)
    np.testing.assert_array_equal(got_ts, ts)
    flat, meta = pc.get_checkpoint(0)
    np.testing.assert_array_equal(meta["bound"], bound)
    template = tr.scene.init_params(torch.Generator().manual_seed(0))
    restored = comms.unpack_params(template, flat)
    for (_, a), (_, b) in zip(param_items(restored), param_items(tr.params)):
        np.testing.assert_array_equal(a.numpy(), b)
        assert not a.requires_grad

    pparams = params_from_jax(tr.params)
    pc.publish_keyframes(1, poses[:2], ts[:2])
    pc.publish_checkpoint(1, pparams, {"bound": bound})
    got_poses, got_ts = jc.get_keyframes(1)
    np.testing.assert_array_equal(got_poses, poses[:2])
    flat, meta = jc.get_checkpoint(1)
    assert set(flat) == set(jcomms.pack_params(jparams))
    back = jcomms.unpack_params(jparams, flat)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert pc.get_checkpoint(5) is None and pc.get_keyframes(5) is None


def test_in_memory_comms_snapshots_the_map():
    """A published checkpoint is the map as it was at the publish, as JAX's
    immutable arrays are, not the live tensors."""
    c = comms.InMemoryComms()
    p = {"planes": {"xy": [torch.ones(2, 3, requires_grad=True)]}}
    c.publish_checkpoint(0, p, {"bound": np.zeros((3, 2))})
    with torch.no_grad():
        p["planes"]["xy"][0].add_(1.0)
    got, meta = c.get_checkpoint(0)
    assert float(got["planes"]["xy"][0].max()) == 1.0
    assert not got["planes"]["xy"][0].requires_grad
    assert c.get_checkpoint(1) is None and c.get_keyframes(0) is None
