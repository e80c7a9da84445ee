"""Port of the tracker (`mneslam_tpu_torch.tracking`) against the JAX
package on the CPU: one shared keyframe buffer and edge table through both
packages' `FactorGraph.update` (DROID nets with the JAX-initialised
weights), the oracle pose recovery, keyframe removal, frame distance and
the batched motion filter.

Tolerance: fp32. After one or two full updates (correlation, ConvGRU,
2 GN iterations each) poses agree to 1e-4, disps to 1e-3; hidden state,
targets and weights to 1e-3 absolute (conv stacks and BA solves summed in
another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mneslam_tpu.models import droid_net as jdn
from mneslam_tpu.tracking import graph as jgraph
from mneslam_tpu.tracking import motion_filter as jmf
from mneslam_tpu.tracking import video as jvideo
from mneslam_tpu_torch.ops import lie as plie
from mneslam_tpu_torch.ops import projective as pproj
from mneslam_tpu_torch.tracking import graph as pgraph
from mneslam_tpu_torch.tracking import motion_filter as pmf
from mneslam_tpu_torch.tracking import video as pvideo
from mneslam_tpu_torch.utils.convert import (droid_params_from_jax,
                                             video_state_from_numpy)

torch.set_num_threads(1)

HT, WD = 12, 16
INTR = np.array([12.0, 12.0, WD / 2 - 0.5, HT / 2 - 0.5], np.float32)
B = 8


@pytest.fixture(scope="module")
def params():
    jp = jdn.init_droid_net(jax.random.PRNGKey(0))
    return jp, droid_params_from_jax(jax.tree.map(np.asarray, jp))


def _gt(rng, n):
    """A smooth GT trajectory (first pose identity) and a disparity map."""
    phi = 0.02 * rng.normal(size=(n, 3))
    t = np.cumsum(0.06 * rng.normal(size=(n, 3)), axis=0)
    xi = np.concatenate([t, phi], -1).astype(np.float32)
    poses = plie.exp(torch.tensor(xi))
    poses[0] = plie.identity()
    poses = torch.cat([poses, plie.identity((B - n,))])
    disps = torch.tensor(0.4 + 0.2 * rng.random((1, HT, WD)),
                         dtype=torch.float32).expand(B, HT, WD).contiguous()
    return poses, disps


def _shared_state(seed):
    """Numpy arrays of one keyframe buffer, perturbed from a GT
    trajectory, with random features."""
    rng = np.random.default_rng(seed)
    gt_poses, gt_disps = _gt(rng, 6)
    dxi = torch.tensor(0.03 * rng.normal(size=(B, 6)), dtype=torch.float32)
    dxi[0] = 0
    feats = lambda f: f(rng.normal(size=(B, 128, HT, WD))).astype(np.float32)
    return {
        "timestamps": np.arange(B, dtype=np.float32),
        "poses": plie.retr(gt_poses, dxi).numpy(),
        "poses_gt": np.tile(np.eye(4, dtype=np.float32), (B, 1, 1)),
        "disps": (gt_disps.numpy()
                  * (1 + 0.05 * rng.normal(size=(B, HT, WD)))
                  ).astype(np.float32),
        "disps_sens": gt_disps.numpy(),
        "fmaps": feats(lambda a: a),
        "nets": feats(np.tanh),
        "inps": feats(lambda a: np.maximum(a, 0)),
        "damping": np.full((B, HT, WD), 1e-6, np.float32),
    }


def _jax_state(arrays):
    return jvideo.VideoState(**{k: jnp.asarray(v) for k, v in arrays.items()})


@pytest.mark.parametrize("n_updates", [1, 2])
def test_graph_update_matches_jax(params, n_updates):
    jp, tp = params
    arrays = _shared_state(0)
    js, ts = _jax_state(arrays), video_state_from_numpy(arrays)
    jg = jgraph.FactorGraph(B, HT, WD, capacity=24, params=jp,
                            intrinsics=jnp.asarray(INTR), window=8)
    tg = pgraph.FactorGraph(B, HT, WD, capacity=24, params=tp,
                            intrinsics=torch.tensor(INTR), window=8)
    for g, s in ((jg, js), (tg, ts)):
        g.add_neighborhood_factors(s, 0, 6, r=2)
    assert tg.n_active == jg.n_active == 18
    for k in range(n_updates):
        js = jg.update(js, t0=1, t1=6, use_inactive=True)
        ts = tg.update(ts, t0=1, t1=6, use_inactive=True)
        if k == 0:   # archive some edges: the second update uses them
            for g in (jg, tg):
                g.rm_factors(g.ii == 0, store=True)
    np.testing.assert_array_equal(tg.ii, jg.ii)
    np.testing.assert_array_equal(tg.ii_inac, jg.ii_inac)
    n = tg.n_active
    np.testing.assert_allclose(ts.poses.numpy(), np.asarray(js.poses),
                               atol=1e-4)
    np.testing.assert_allclose(ts.disps.numpy(), np.asarray(js.disps),
                               atol=1e-3)
    np.testing.assert_allclose(ts.damping.numpy(), np.asarray(js.damping),
                               rtol=1e-3, atol=1e-7)
    for name in ("net", "target", "weight"):
        np.testing.assert_allclose(
            getattr(tg, name)[:n].numpy(),
            np.asarray(getattr(jg, name)[:n]), atol=1e-3, err_msg=name)
    np.testing.assert_allclose(tg.target_inac[:len(tg.ii_inac)].numpy(),
                               np.asarray(jg.target_inac[:len(jg.ii_inac)]),
                               atol=1e-3)


def _oracle(gt_poses, gt_disps, intr):
    def update_fn(params, state, ii, jj, net, corr, motion, coords1):
        tgt, valid = pproj.projective_transform(gt_poses, gt_disps, intr,
                                                ii, jj)
        return net, tgt - coords1, valid.expand(tgt.shape)

    def agg_fn(params, net, ii, mask, n):
        return 1e-4 * torch.ones((net.shape[0], HT, WD)), \
            torch.zeros((n, 576, HT, WD))

    return update_fn, agg_fn


def _pose_err(a, b):
    return float(plie.log(plie.mul(a, plie.inv(b))).norm(dim=-1).max())


def test_graph_update_recovers_poses_with_oracle():
    rng = np.random.default_rng(1)
    n = 6
    gt_poses, gt_disps = _gt(rng, n)
    intr = torch.tensor(INTR)
    state = pvideo.init_video(B, HT, WD)
    state = state._replace(disps=gt_disps.clone(), disps_sens=gt_disps)
    dxi = torch.tensor(0.05 * rng.normal(size=(B, 6)), dtype=torch.float32)
    dxi[0] = 0
    state = state._replace(poses=plie.retr(gt_poses, dxi))
    update_fn, agg_fn = _oracle(gt_poses, gt_disps, intr)
    graph = pgraph.FactorGraph(B, HT, WD, capacity=40, params={},
                               intrinsics=intr, window=8,
                               update_fn=update_fn, agg_fn=agg_fn)
    graph.add_neighborhood_factors(state, 0, n, r=2)
    err0 = _pose_err(state.poses[:n], gt_poses[:n])
    for _ in range(6):
        state = graph.update(state, t0=1, t1=n, iters=2, ep=1e-3, lm=1e-5)
    err1 = _pose_err(state.poses[:n], gt_poses[:n])
    assert err1 < 0.05 * err0, (err0, err1)


def test_keyframe_removal_consistency():
    state = pvideo.init_video(6, HT, WD)
    state = state._replace(timestamps=torch.arange(6, dtype=torch.float32))
    graph = pgraph.FactorGraph(6, HT, WD, capacity=20, params={},
                               intrinsics=torch.tensor(INTR), window=8)
    graph.add_factors(state, [0, 1, 2, 3], [1, 2, 3, 4])
    graph.rm_factors(graph.ii == 3, store=True)          # (3, 4) inactive
    state = graph.rm_keyframe(state, 2)
    assert set(zip(graph.ii.tolist(), graph.jj.tolist())) == {(0, 1)}
    assert set(zip(graph.ii_inac.tolist(), graph.jj_inac.tolist())) == {
        (2, 3)}
    np.testing.assert_array_equal(state.timestamps.numpy(),
                                  [0, 1, 3, 4, 5, 5])   # last slot repeated


def test_unported_graph_options_raise():
    """`sparse_ba` and `corr_chunk` are ported now (they raised before):
    they construct, and the capacity rounds up to a multiple of the chunk
    as in the JAX package. Their updates are held against JAX in
    tests/test_torch_backend.py."""
    for kw, cap in (({"sparse_ba": True}, 10), ({"corr_chunk": 8}, 16)):
        g = pgraph.FactorGraph(B, HT, WD, capacity=10, params={},
                               intrinsics=torch.tensor(INTR), **kw)
        j = jgraph.FactorGraph(B, HT, WD, capacity=10, params={},
                               intrinsics=jnp.asarray(INTR), **kw)
        assert g.capacity == j.capacity == cap
        assert g.sparse_ba == j.sparse_ba and g.corr_chunk == j.corr_chunk
        assert g.net.shape[0] == cap


def test_seed_next_frame_at_a_full_buffer_is_a_no_op():
    """The JAX package drops the out-of-range write of slot t1 == buffer
    (a buffer filled to its last slot); the port leaves the state as it
    is too, where it used to raise an IndexError."""
    arrays = _shared_state(4)
    js, ts = _jax_state(arrays), video_state_from_numpy(arrays)
    js = jvideo.seed_next_frame(js, jnp.asarray(B))
    ts = pvideo.seed_next_frame(ts, B)
    np.testing.assert_array_equal(ts.poses.numpy(), np.asarray(js.poses))
    np.testing.assert_array_equal(ts.disps.numpy(), np.asarray(js.disps))
    np.testing.assert_array_equal(ts.poses.numpy(), arrays["poses"])
    ts = pvideo.seed_next_frame(ts, 3)
    js = jvideo.seed_next_frame(js, jnp.asarray(3))
    np.testing.assert_allclose(ts.disps.numpy(), np.asarray(js.disps),
                               rtol=1e-6)


def test_frame_distance_and_proximity_factors_match_jax():
    arrays = _shared_state(2)
    js, ts = _jax_state(arrays), video_state_from_numpy(arrays)
    ii = np.array([0, 1, 2, 5, 3])
    jj = np.array([1, 0, 4, 2, 3])
    ref = jvideo.frame_distance(js, jnp.asarray(INTR), jnp.asarray(ii),
                                jnp.asarray(jj), beta=0.75)
    got = pvideo.frame_distance(ts, torch.tensor(INTR), torch.tensor(ii),
                                torch.tensor(jj), beta=0.75)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    graphs = []
    for mod, s, intr, p in ((jgraph, js, jnp.asarray(INTR), {}),
                            (pgraph, ts, torch.tensor(INTR), {})):
        g = mod.FactorGraph(B, HT, WD, capacity=40, params=p,
                            intrinsics=intr, window=8, max_factors=30)
        g.add_proximity_factors(s, t=8, t0=0, t1=0, rad=1, nms=1,
                                thresh=25.0, beta=0.75)
        graphs.append(g)
    np.testing.assert_array_equal(graphs[1].ii, graphs[0].ii)
    np.testing.assert_array_equal(graphs[1].jj, graphs[0].jj)


def _frames(n, seed=3, H=64, W=96):
    rng = np.random.default_rng(seed)
    imgs = [rng.random((3, H, W)).astype(np.float32) for _ in range(n)]
    deps = [(0.5 + rng.random((H, W))).astype(np.float32) for _ in range(n)]
    return imgs, deps


def test_motion_filter_batch_equals_per_frame_and_jax(params):
    """track_batch (device-side admission) == per-frame track in the port,
    and its admitted flags == the JAX package's on the same frames."""
    jp, tp = params
    n, H, W = 9, 64, 96
    imgs, deps = _frames(n)
    t_imgs = [torch.tensor(a) for a in imgs]
    t_deps = [torch.tensor(a) for a in deps]
    # threshold midway between the two middle flows to frame 0, so both
    # branches occur
    fm = pmf.encode_frame(tp, t_imgs[0])
    net, inp = pmf.encode_context(tp, t_imgs[0])
    ds = sorted(float(pmf.encode_and_flow(tp, fm, net, inp, im)[1])
                for im in t_imgs[1:])
    thresh = 0.5 * (ds[3] + ds[4])

    def run_port(batched):
        mf = pmf.MotionFilter(tp, thresh=thresh)
        state = pvideo.init_video(16, H // 8, W // 8)
        counter, flags = 0, []
        for s in range(0, n, 4 if batched else 1):
            e = min(s + 4, n) if batched else s + 1
            if batched:
                state, counter, f = mf.track_batch(
                    state, counter, [float(i) for i in range(s, e)],
                    t_imgs[s:e], t_deps[s:e])
            else:
                state, counter, a = mf.track(state, counter, float(s),
                                             t_imgs[s], t_deps[s], None)
                f = [a]
            flags.extend(f)
        return state, counter, flags, mf

    st_a, c_a, f_a, mf_a = run_port(False)
    st_b, c_b, f_b, mf_b = run_port(True)
    assert f_a == f_b and c_a == c_b and mf_a.count == mf_b.count
    assert 1 < c_a < n                       # some frames skipped
    for name in ("timestamps", "fmaps", "nets", "inps", "disps_sens",
                 "disps", "poses_gt"):
        np.testing.assert_allclose(getattr(st_a, name)[:c_a].numpy(),
                                   getattr(st_b, name)[:c_a].numpy(),
                                   atol=1e-5, err_msg=name)

    mf = jmf.MotionFilter(jp, thresh=thresh)
    js = jvideo.init_video(16, H // 8, W // 8)
    counter, f_j = 0, []
    for s in range(0, n, 4):
        e = min(s + 4, n)
        js, counter, f = mf.track_batch(
            js, counter, [float(i) for i in range(s, e)],
            [jnp.asarray(a) for a in imgs[s:e]],
            [jnp.asarray(a) for a in deps[s:e]])
        f_j.extend(f)
    assert f_b == f_j and c_b == counter
    np.testing.assert_allclose(st_b.fmaps[:c_b].numpy(),
                               np.asarray(js.fmaps[:c_b]), atol=1e-4)
    np.testing.assert_allclose(st_b.disps[:c_b].numpy(),
                               np.asarray(js.disps[:c_b]), rtol=1e-6)
