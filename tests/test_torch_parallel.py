"""Port parity: the row-sharded mapper's collective seam
(`mneslam_tpu_torch/parallel/mesh.py`, `ops/interp.py`) against the JAX
package's `shard_map` programs.

The port's ranks are processes on the CPU over gloo (`tests/_torch_dist.py`,
one thread each, a `file://` store under tmp_path, 60 s timeouts); the JAX
side runs in this process on the conftest's virtual CPU devices. The
tolerances are rtol 1e-4 / atol 1e-5 (fp32), or bit for bit where
stated. The sharded optimize is held in test_torch_parallel_optimize.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mneslam_tpu.ops import interp as jinterp
from mneslam_tpu.parallel import mesh as jpmesh
from mneslam_tpu_torch.ops import interp
from mneslam_tpu_torch.config import make_config
from mneslam_tpu_torch.models.scene_rep import SceneRep, param_leaves
from mneslam_tpu_torch.parallel import mesh as pmesh
from mneslam_tpu_torch.utils.convert import params_from_jax
from tests._torch_dist import run_ranks

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
AXES = ("agent", "ray")


# ---------------------------------------------------------------------------
# the packed-table seam, one process
# ---------------------------------------------------------------------------

def test_fold_corners_rows_blocks_match_jax():
    """`_fold_b_rows` and `fold_corners_rows` on a block at y0 > 0 with a
    halo, and on a padded table, equal the JAX functions; consecutive
    blocks with their halos fold to the whole table's adjoint."""
    rng = np.random.default_rng(0)
    C, H, W = 3, 7, 5
    d = rng.normal(size=(8 * W, 4 * C)).astype(np.float32)  # 1 pad row
    halo = rng.normal(size=(W, C)).astype(np.float32)
    np.testing.assert_allclose(
        interp._fold_b_rows(torch.tensor(d).reshape(8, W, 4 * C)).numpy(),
        np.asarray(jinterp._fold_b_rows(jnp.asarray(d).reshape(8, W, 4 * C))),
        RTOL, ATOL)
    blk = d[3 * W:6 * W]
    got = interp.fold_corners_rows(torch.tensor(blk), H, W, y0=3,
                                   halo_row=torch.tensor(halo))
    ref = jinterp.fold_corners_rows(jnp.asarray(blk), H, W, y0=3,
                                    halo_row=jnp.asarray(halo))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), RTOL, ATOL)
    d[H * W:] = 0.0                                        # the pad is zero
    full = interp.fold_corners_rows(torch.tensor(d), H, W)
    np.testing.assert_allclose(
        full.numpy(), np.asarray(jinterp.fold_corners_rows(jnp.asarray(d),
                                                            H, W)),
        RTOL, ATOL)
    assert not full[H * W:].any()
    # blocks [0, 4) and [4, 8) with the halo of the first
    dt = torch.tensor(d)
    a = interp.fold_corners_rows(dt[:4 * W], H, W, y0=0)
    tail = interp._fold_b_rows(dt[3 * W:4 * W].reshape(1, W, 4 * C))
    b = interp.fold_corners_rows(dt[4 * W:], H, W, y0=4,
                                 halo_row=tail.reshape(W, C))
    adj = interp._unpack_corners_adjoint(dt[:H * W], C, H, W)
    np.testing.assert_allclose(torch.cat([a, b])[:H * W].numpy(),
                               adj.permute(1, 2, 0).reshape(H * W, C).numpy(),
                               RTOL, ATOL)


def test_sample_packed_table_forward_and_cotangents_match_jax():
    """The differentiable packed-table sampler: the forward, the table's
    cotangent (the raw packed scatter, no fold) and the coordinates'
    cotangent equal JAX's `interp.sample_packed_table`; the forward is
    the packed sampler's, bit for bit."""
    rng = np.random.default_rng(1)
    C, H, W, N = 4, 6, 9, 200
    plane = rng.normal(size=(C, H, W)).astype(np.float32)
    coords = rng.uniform(-1.1, 1.1, (N, 2)).astype(np.float32)
    dout = rng.normal(size=(N, C)).astype(np.float32)
    packed = np.asarray(jinterp.pack_corners(jnp.asarray(plane)))

    def jloss(pk, cc):
        return jnp.sum(jinterp.sample_packed_table(pk, cc, (C, H, W)) * dout)

    jout = jinterp.sample_packed_table(jnp.asarray(packed),
                                       jnp.asarray(coords), (C, H, W))
    jd_pk, jd_cc = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(packed),
                                                   jnp.asarray(coords))
    pk = torch.tensor(packed, requires_grad=True)
    cc = torch.tensor(coords, requires_grad=True)
    out = interp.sample_packed_table(pk, cc, H, W)
    (out * torch.tensor(dout)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               RTOL, ATOL)
    np.testing.assert_allclose(pk.grad.numpy(), np.asarray(jd_pk), RTOL,
                               ATOL)
    np.testing.assert_allclose(cc.grad.numpy(), np.asarray(jd_cc), RTOL,
                               ATOL)
    with torch.no_grad():
        ref = interp.sample_plane_packed(torch.tensor(plane),
                                         torch.tensor(coords))
        same = interp.sample_packed_table(torch.tensor(packed),
                                          torch.tensor(coords), H, W)
    assert torch.equal(same, ref)


# ---------------------------------------------------------------------------
# the mesh and the collective seam over N ranks
# ---------------------------------------------------------------------------

def test_make_mesh_layout_and_axis_groups(tmp_path):
    """`make_mesh` on 4 ranks: the agent axis clamps to the largest
    divisor of the rank count <= n_agents (mneslam_tpu/parallel/mesh.py:
    30-44); a 2 x 2 mesh lays rank a * 2 + r out and gives each axis its
    process group, whose sum, gather and broadcast cover exactly the
    ranks that share the other coordinate. Without a world the mesh is
    the one-process mesh."""
    outs = run_ranks("mesh", 4, tmp_path, {"n_agents": (1, 2, 3, 4, 8),
                                           "grid": 2})
    for rank, o in enumerate(outs):
        assert {n: s["agent"] for n, s in o["shapes"].items()} == \
            {1: 1, 2: 2, 3: 2, 4: 4, 8: 4}
        a, r = divmod(rank, 2)
        g = o["groups"]
        agent_ranks, ray_ranks = [r, 2 + r], [2 * a, 2 * a + 1]
        assert (g["agent"]["size"], g["agent"]["index"],
                g["agent"]["src"]) == (2, a, r)
        assert (g["ray"]["size"], g["ray"]["index"],
                g["ray"]["src"]) == (2, r, 2 * a)
        assert g["agent"]["gather"] == [float(k) for k in agent_ranks]
        assert g["ray"]["gather"] == [float(k) for k in ray_ranks]
        assert g["ray"]["sum"] == sum(ray_ranks)
        assert g["agent"]["bcast"] == r and g["ray"]["bcast"] == 2 * a
        assert g["agent/ray"]["sum"] == 6.0
        assert g["agent/ray"]["index"] == rank
    mesh = pmesh.make_mesh(3)
    assert mesh.shape == {"agent": 1, "ray": 1}
    assert mesh.group().is_local and mesh.group(("ray",)).size == 1


def _jax_seam(x, d, n, fold):
    """JAX `make_row_sharded_pack` in a shard_map over n virtual devices:
    -> (table, the blocks' cotangents [Hp*W, C]) with device k's table
    cotangent d[k]."""
    C, H, W = x.shape
    pad_h = -(-H // n) * n
    mesh = jpmesh.make_mesh(1, devices=jax.devices()[:n])
    f = jpmesh.make_row_sharded_pack(AXES, (1, n), (C, H, W), pad_h,
                                     fold=fold)
    flat = np.pad(x.transpose(1, 2, 0).reshape(H * W, C),
                  ((0, (pad_h - H) * W), (0, 0)))

    def body(xb, db):
        tbl, vjp = jax.vjp(f, xb)
        return tbl, vjp(db)[0]

    smap = jax.jit(jax.shard_map(body, mesh=mesh,
                                 in_specs=(P(AXES), P(AXES)),
                                 out_specs=(P(), P(AXES)), check_vma=False))
    tbl, g = smap(jnp.asarray(flat), jnp.asarray(d.reshape(-1, 4 * C)))
    return np.asarray(tbl), np.asarray(g)


@pytest.mark.parametrize("n,H", [(2, 7), (3, 4), (3, 8)])
def test_row_sharded_pack_matches_jax(tmp_path, n, H):
    """The seam on N ranks with pad rows (H = 7 on 2 ranks, 8 on 3; H = 4
    on 3 ranks leaves the last block wholly pad): the gathered table
    equals JAX's and `pack_corners`; the blocks' cotangents, for a
    different table cotangent on each rank, equal JAX's and the fold of
    their sum, in both fold orders; consume(gather) equals the seam."""
    rng = np.random.default_rng(n * 10 + H)
    C, W = 3, 5
    x = rng.normal(size=(C, H, W)).astype(np.float32)
    d = rng.normal(size=(n, H * W, 4 * C)).astype(np.float32)
    outs = run_ranks("seam", n, tmp_path, {"shape": (C, H, W), "x": x,
                                           "d": d})
    packed = interp.pack_corners(torch.tensor(x)).numpy()
    adj = interp._unpack_corners_adjoint(torch.tensor(d.sum(0)), C, H, W)
    adj = adj.permute(1, 2, 0).reshape(H * W, C).numpy()
    for fold in ("after", "before"):
        jtbl, jg = _jax_seam(x, d, n, fold)
        np.testing.assert_array_equal(jtbl, packed)
        for r in outs:
            np.testing.assert_array_equal(r[fold]["table"], packed)
        g = np.concatenate([r[fold]["grad"] for r in outs])
        np.testing.assert_allclose(g, jg, RTOL, ATOL, err_msg=fold)
        np.testing.assert_allclose(g[:H * W], adj, RTOL, ATOL, err_msg=fold)
        assert not g[H * W:].any()
        gc = np.concatenate([r[fold]["grad_consume"] for r in outs])
        np.testing.assert_array_equal(gc, g)


# ---------------------------------------------------------------------------
# agents in one slice
# ---------------------------------------------------------------------------

def test_multi_agent_train_step_matches_jax():
    """tests/test_parallel.py:36: one mapping step of 2 agents (agents in
    turn within one slice) == JAX's vmapped step on the same weights,
    rays and perturbation uniforms (loss rtol 1e-4, parameters atol
    1e-5), with Adam(1e-3) on both sides; tree_stack / tree_index."""
    from mneslam_tpu.config import make_config as jmake_config
    from mneslam_tpu.models.scene_rep import SceneRep as JSceneRep

    ov = {"mapping": {"bound": [[-1.2, 1.2]] * 3,
                      "marching_cubes_bound": [[-1.2, 1.2]] * 3},
          "planes_res": {"coarse": 0.6, "fine": 0.3,
                         "bound_dividable": 0.3},
          "cam": {"near": 0.0, "far": 5.0},
          "training": {"n_range_d": 7, "n_samples_d": 4, "range_d": 0.2},
          "model": {"c_dim": 8, "input_ch": 16, "input_ch_pos": 48}}
    jscene = JSceneRep(jmake_config(ov))
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    jparams = jax.vmap(jscene.init_params)(keys)
    opt = optax.adam(1e-3)
    key = jax.random.PRNGKey(1)
    ro = 0.1 * jax.random.normal(key, (2, 64, 3))
    rd = jax.random.normal(jax.random.fold_in(key, 1), (2, 64, 3))
    rd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
    rgb = jax.random.uniform(jax.random.fold_in(key, 2), (2, 64, 3))
    d = 0.5 + jax.random.uniform(jax.random.fold_in(key, 3), (2, 64, 1))
    step_keys = jax.random.split(jax.random.PRNGKey(2), 2)
    jstep = jpmesh.make_multi_agent_train_step(jscene, opt)
    jp, _, jloss = jstep(jparams, jax.vmap(opt.init)(jparams), ro, rd, rgb,
                         d, step_keys)

    scene = SceneRep(make_config(ov), "cpu")
    S = scene.n_range_d + scene.n_samples_d
    us = [torch.tensor(np.asarray(jax.random.uniform(k, (64, S))))
          for k in step_keys]
    params = [params_from_jax(jax.tree.map(lambda x: np.asarray(x[i]),
                                           jparams)) for i in range(2)]
    opts = [torch.optim.Adam(param_leaves(p), lr=1e-3) for p in params]
    step = pmesh.make_multi_agent_train_step(scene)
    t = [torch.tensor(np.asarray(a)) for a in (ro, rd, rgb, d)]
    loss = step(params, opts, *t, us=us)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-4)
    stacked = pmesh.tree_stack([{k: v for k, v in p.items()}
                                for p in params])
    for i in range(2):
        got = pmesh.tree_index(stacked, i)
        ref = jax.tree.map(lambda x: np.asarray(x[i]), jp)
        for (path, r), g in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                                param_leaves(got)):
            np.testing.assert_allclose(g.detach().numpy(), r, rtol=0,
                                       atol=1e-5,
                                       err_msg=jax.tree_util.keystr(path))
