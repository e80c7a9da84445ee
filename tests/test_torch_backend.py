"""Port of the tracking backend (`mneslam_tpu_torch.ops.ba_sparse`,
`tracking.graph`'s chunked and sparse-Schur updates, `tracking.dist_cache`,
`tracking.backend`) against the JAX package on the CPU. Inputs come from
numpy seeds (or the JAX tests' own problem builders) and go to both
packages.

Tolerances: the pair tables and the proposed edge lists are equal. BA
results in fp32: poses 1e-4 and disps 1e-3 between the packages (solves
summed in another order); the sparse-Schur BA against the dense one
2e-4 / 2e-3 (the JAX test's bounds: the Schur complement is summed in
another grouping); the chunked update against the monolithic one 1e-6
(the same arithmetic on the same slices). Frame distances 1e-5 relative
(fp32 reductions over a 12 x 16 grid)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mneslam_tpu.config import make_config as jmake_config
from mneslam_tpu.ops import ba as jba
from mneslam_tpu.ops import ba_sparse as jbs
from mneslam_tpu.tracking import backend as jbackend
from mneslam_tpu.tracking import dist_cache as jdc
from mneslam_tpu.tracking import graph as jgraph
from mneslam_tpu.tracking import video as jvideo
from mneslam_tpu_torch.config import make_config as pmake_config
from mneslam_tpu_torch.ops import ba as pba
from mneslam_tpu_torch.ops import ba_sparse as pbs
from mneslam_tpu_torch.ops import lie as plie
from mneslam_tpu_torch.ops import projective as pproj
from mneslam_tpu_torch.tracking import backend as pbackend
from mneslam_tpu_torch.tracking import dist_cache as pdc
from mneslam_tpu_torch.tracking import graph as pgraph
from mneslam_tpu_torch.tracking import video as pvideo
from mneslam_tpu_torch.utils.convert import (factor_graph_from_numpy,
                                             video_state_from_numpy)
from test_ba import make_problem
from test_tracking import make_oracle as jax_oracle

torch.set_num_threads(1)

HT, WD = 12, 16
INTR = np.array([12.0, 12.0, WD / 2 - 0.5, HT / 2 - 0.5], np.float32)
POSE_TOL, DISP_TOL = 1e-4, 1e-3


def _np(x):
    return np.asarray(x)


def _port_problem(problem):
    return pba.BAProblem(*(torch.tensor(_np(x)) for x in problem))


# ---------------------------------------------------------------------------
# ops/ba_sparse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_build_pairs_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ii, jj = rng.integers(0, 6, 20), rng.integers(0, 6, 20)
    valid = rng.random(20) > 0.3
    for cap in (None, 1024):
        ref = jbs.build_pairs(ii, jj, valid, capacity=cap)
        got = pbs.build_pairs(ii, jj, valid, capacity=cap)
        assert got.n_pairs == ref.n_pairs > 0
        for name in ("a", "b", "mask"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          _np(getattr(ref, name)))


def test_sparse_schur_matches_jax_and_dense():
    """tests/test_ba.py:123 in the port, and against the JAX sparse BA."""
    _, _, init_poses, init_disps, problem = make_problem(
        jax.random.PRNGKey(5))
    valid = _np(problem.mask) > 0
    jpairs = jbs.build_pairs(_np(problem.ii), _np(problem.jj), valid)
    pairs = pbs.build_pairs(_np(problem.ii), _np(problem.jj), valid)
    kw = dict(t0=1, iters=3, ep=1e-3, lm=1e-5)
    p_j, d_j = jbs.bundle_adjust_sparse(init_poses, init_disps,
                                        jnp.asarray(INTR), problem, jpairs,
                                        pair_chunk=64, **kw)
    args = (torch.tensor(_np(init_poses)), torch.tensor(_np(init_disps)),
            torch.tensor(INTR), _port_problem(problem))
    p_s, d_s = pbs.bundle_adjust_sparse(*args, pairs, pair_chunk=64, **kw)
    p_d, d_d = pba.bundle_adjust(*args, **kw)
    np.testing.assert_allclose(p_s.numpy(), _np(p_j), atol=POSE_TOL)
    np.testing.assert_allclose(d_s.numpy(), _np(d_j), atol=DISP_TOL)
    np.testing.assert_allclose(p_s.numpy(), p_d.numpy(), atol=2e-4)
    np.testing.assert_allclose(d_s.numpy(), d_d.numpy(), atol=2e-3)


@pytest.mark.parametrize("motion_only", [False, True])
def test_sparse_schur_with_padding_and_sensor(motion_only):
    """tests/test_ba.py:140 in the port (padded edges, a padded pair table,
    the sensor prior), and against the JAX sparse BA."""
    _, gt_disps, init_poses, init_disps, problem = make_problem(
        jax.random.PRNGKey(6))
    pad = 3
    problem_p = jba.BAProblem(
        target=jnp.concatenate([problem.target,
                                jnp.ones((pad, HT, WD, 2))]),
        weight=jnp.concatenate([problem.weight,
                                jnp.ones((pad, HT, WD, 2))]),
        eta=problem.eta,
        ii=jnp.concatenate([problem.ii, jnp.zeros(pad, jnp.int32)]),
        jj=jnp.concatenate([problem.jj, jnp.ones(pad, jnp.int32)]),
        mask=jnp.concatenate([problem.mask, jnp.zeros(pad)]))
    valid = _np(problem_p.mask) > 0
    jpairs = jbs.build_pairs(_np(problem_p.ii), _np(problem_p.jj), valid,
                             capacity=2048)
    pairs = pbs.build_pairs(_np(problem_p.ii), _np(problem_p.jj), valid,
                            capacity=2048)
    kw = dict(t0=1, iters=2, motion_only=motion_only)
    p_j, d_j = jbs.bundle_adjust_sparse(init_poses, init_disps,
                                        jnp.asarray(INTR), problem_p, jpairs,
                                        disps_sens=gt_disps, **kw)
    sens = torch.tensor(_np(gt_disps))
    p0, d0 = torch.tensor(_np(init_poses)), torch.tensor(_np(init_disps))
    p_s, d_s = pbs.bundle_adjust_sparse(p0, d0, torch.tensor(INTR),
                                        _port_problem(problem_p), pairs,
                                        disps_sens=sens, **kw)
    p_d, d_d = pba.bundle_adjust(p0, d0, torch.tensor(INTR),
                                 _port_problem(problem), disps_sens=sens,
                                 **kw)
    np.testing.assert_allclose(p_s.numpy(), _np(p_j), atol=POSE_TOL)
    np.testing.assert_allclose(d_s.numpy(), _np(d_j), atol=DISP_TOL)
    np.testing.assert_allclose(p_s.numpy(), p_d.numpy(), atol=2e-4)
    np.testing.assert_allclose(d_s.numpy(), d_d.numpy(), atol=2e-3)


# ---------------------------------------------------------------------------
# FactorGraph: sparse-Schur and chunked updates
# ---------------------------------------------------------------------------

N_FR, BUF = 6, 8


def _trajectory(seed, noise=0.05):
    """GT poses / disps of a buffer (N_FR frames move, the rest identity)
    and noisy initial poses, as numpy."""
    rng = np.random.default_rng(seed)
    xi = np.zeros((BUF, 6), np.float32)
    xi[1:N_FR, :3] = np.cumsum(0.06 * rng.normal(size=(N_FR - 1, 3)), 0)
    xi[1:N_FR, 3:] = 0.02 * rng.normal(size=(N_FR - 1, 3))
    gt = plie.exp(torch.tensor(xi))
    gt[N_FR:] = plie.identity((BUF - N_FR,))
    disps = np.broadcast_to(0.4 + 0.2 * rng.random((1, HT, WD)),
                            (BUF, HT, WD)).astype(np.float32)
    dxi = (noise * rng.normal(size=(BUF, 6))).astype(np.float32)
    dxi[0] = 0
    init = plie.retr(gt, torch.tensor(dxi))
    return gt.numpy(), disps, init.numpy()


def _port_oracle(gt_poses, gt_disps, intr=INTR):
    """The port's counterpart of test_tracking.make_oracle."""
    gt_poses, gt_disps = torch.tensor(gt_poses), torch.tensor(gt_disps)
    intr = torch.tensor(intr)

    def update_fn(params, state, ii, jj, net, corr, motion, coords1):
        tgt, valid = pproj.projective_transform(gt_poses, gt_disps, intr,
                                                ii, jj)
        return net, tgt - coords1, valid.expand(tgt.shape)

    def agg_fn(params, net, ii, mask, n):
        h, w = net.shape[2:]
        return 1e-4 * torch.ones((net.shape[0], h, w)), \
            torch.zeros((net.shape[0], 576, h, w))

    return update_fn, agg_fn


def _states(gt_disps, init_poses):
    j = jvideo.init_video(BUF, HT, WD)
    j = j._replace(disps=jnp.asarray(gt_disps), disps_sens=jnp.asarray(gt_disps),
                   poses=jnp.asarray(init_poses))
    p = pvideo.init_video(BUF, HT, WD)
    p = p._replace(disps=torch.tensor(gt_disps),
                   disps_sens=torch.tensor(gt_disps),
                   poses=torch.tensor(init_poses))
    return j, p


def test_graph_sparse_ba_matches_dense_path_and_jax():
    """tests/test_tracking.py:260 in the port, and the sparse path against
    the JAX package's."""
    gt, disps, init = _trajectory(0)
    upd, agg = _port_oracle(gt, disps)
    ju, ja = jax_oracle(jnp.asarray(gt), jnp.asarray(disps),
                        jnp.asarray(INTR))
    results = {}
    for sparse in (False, True):
        _, state = _states(disps, init)
        g = pgraph.FactorGraph(BUF, HT, WD, capacity=40, params={},
                               intrinsics=torch.tensor(INTR), window=8,
                               update_fn=upd, agg_fn=agg, sparse_ba=sparse)
        g.add_neighborhood_factors(state, 0, N_FR, r=2)
        for _ in range(4):
            state = g.update(state, t0=1, t1=N_FR, iters=2, ep=1e-3, lm=1e-5)
        assert g.sparse_updates == (4 if sparse else 0)
        results[sparse] = state.poses[:N_FR].numpy()
    jstate, _ = _states(disps, init)
    jg = jgraph.FactorGraph(BUF, HT, WD, capacity=40, params={},
                            intrinsics=jnp.asarray(INTR), window=8,
                            update_fn=ju, agg_fn=ja, sparse_ba=True)
    jg.add_neighborhood_factors(jstate, 0, N_FR, r=2)
    for _ in range(4):
        jstate = jg.update(jstate, t0=1, t1=N_FR, iters=2, ep=1e-3, lm=1e-5)

    err = plie.log(plie.mul(torch.tensor(results[True]),
                            plie.inv(torch.tensor(gt[:N_FR])))).norm(dim=-1)
    assert float(err.max()) < 5e-3
    np.testing.assert_allclose(results[True], results[False], atol=1e-4)
    np.testing.assert_allclose(results[True], _np(jstate.poses[:N_FR]),
                               atol=POSE_TOL)


def test_sparse_pairs_cache_invalidation():
    """tests/test_tracking.py:294 in the port: the pair cache hits across
    updates of one edge set and rebuilds after every index mutation
    (add_factors, rm_factors, rm_keyframe, Backend._copy_graph)."""
    gt = plie.identity((BUF,)).numpy()
    disps = np.full((BUF, HT, WD), 0.5, np.float32)
    upd, agg = _port_oracle(gt, disps)
    _, state = _states(disps, gt)
    graph = pgraph.FactorGraph(BUF, HT, WD, capacity=40, params={},
                               intrinsics=torch.tensor(INTR), window=8,
                               update_fn=upd, agg_fn=agg, sparse_ba=True)
    graph.add_neighborhood_factors(state, 0, N_FR, r=2)
    state = graph.update(state, t0=1, t1=N_FR)
    pairs0 = graph._pairs
    assert pairs0 is not None
    state = graph.update(state, t0=1, t1=N_FR)
    assert graph._pairs is pairs0                   # same edges: a hit
    graph.add_factors(state, [0], [3])
    state = graph.update(state, t0=1, t1=N_FR)
    pairs1 = graph._pairs
    assert pairs1 is not pairs0
    graph.rm_factors(np.arange(graph.n_active) == 0, store=False)
    state = graph.update(state, t0=1, t1=N_FR)
    pairs2 = graph._pairs
    assert pairs2 is not pairs1
    state = graph.rm_keyframe(state, N_FR - 1)
    state = graph.update(state, t0=1, t1=N_FR - 1)
    pairs3 = graph._pairs
    assert pairs3 is not pairs2                     # renumbering
    src = pgraph.FactorGraph(BUF, HT, WD, capacity=40, params={},
                             intrinsics=torch.tensor(INTR), window=8)
    src.add_factors(state, [0, 1], [1, 2])
    pbackend.Backend._copy_graph(graph, src)
    state = graph.update(state, t0=1, t1=N_FR - 1)
    assert graph._pairs is not pairs3


def _chunk_local_agg(params, net, ii, mask, B):
    """eta from the masked mean over this call's edges: any difference in
    the chunk grouping changes the damping (tests/test_tracking.py:487)."""
    h, w = net.shape[2:]
    m = mask.to(net.dtype)
    bias = (net.mean(dim=(1, 2, 3)) * m).sum() / (m.sum() + 1.0)
    return ((1e-4 + 1e-5 * bias) * torch.ones((net.shape[0], h, w)),
            torch.zeros((net.shape[0], 576, h, w)))


def test_graph_update_lowmem_matches_monolithic():
    """tests/test_tracking.py:421 in the port: the chunked update gives the
    monolithic update's poses, disps, targets, weights and damping when
    the update / agg functions do not depend on the chunking."""
    gt, disps, init = _trajectory(3, noise=0.04)
    upd, agg = _port_oracle(gt, disps)
    results = {}
    for name, chunk in (("mono", None), ("chunked", 8)):
        g = pgraph.FactorGraph(BUF, HT, WD, capacity=40, params={},
                               intrinsics=torch.tensor(INTR), window=8,
                               update_fn=upd, agg_fn=agg, corr_chunk=chunk)
        if chunk is not None:
            assert g.capacity % chunk == 0           # rounded up
        _, state = _states(disps, init)
        g.add_neighborhood_factors(state, 0, N_FR, r=2)
        for _ in range(2):
            state = g.update(state, t0=1, t1=N_FR, iters=2, ep=1e-3, lm=1e-5)
        assert g.chunked_updates == (2 if chunk else 0)
        n = g.n_active
        results[name] = [state.poses.numpy(), state.disps.numpy(),
                         g.target[:n].numpy(), g.weight[:n].numpy(),
                         state.damping.numpy()]
    for a, b in zip(results["mono"], results["chunked"]):
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=1e-6)


def test_update_chunked_step_matches_loop_and_jax():
    """tests/test_tracking.py:467 in the port: `update_chunked_step` (which
    overwrites its net / target tables slice by slice) equals the loop of
    `gru_chunk_step` and one `ba_step` on copies of the inputs, with a
    chunk-local agg function, and equals the JAX package's."""
    gt, disps, init = _trajectory(9, noise=0.04)
    upd, _ = _port_oracle(gt, disps)
    chunk = 8
    jstate, state0 = _states(disps, init)
    g = pgraph.FactorGraph(BUF, HT, WD, capacity=40, params={},
                           intrinsics=torch.tensor(INTR), window=8,
                           update_fn=upd, agg_fn=_chunk_local_agg,
                           corr_chunk=chunk)
    g.add_neighborhood_factors(state0, 0, N_FR, r=2)
    ii, jj, mask = g._padded_indices()
    net0, target0 = g.net.clone(), g.target.clone()
    n_chunks = (g.n_active + chunk - 1) // chunk
    empty = torch.zeros(0, dtype=torch.long)
    inac = (empty, empty, torch.zeros(0), g.target_inac[:0],
            g.weight_inac[:0])
    ba_kw = dict(window=8, iters=2, lm=1e-5, ep=1e-3)

    state = pvideo.VideoState(*(t.clone() for t in state0))
    net, target = net0.clone(), target0.clone()
    weight = torch.zeros_like(target)
    up_loop = None
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        state, net_c, tgt_c, w_c, up_c = pgraph.gru_chunk_step(
            state, {}, torch.tensor(INTR), ii[sl], jj[sl], mask[sl],
            net[sl].clone(), target[sl].clone(), update_fn=upd,
            agg_fn=_chunk_local_agg)
        net[sl], target[sl], weight[sl] = net_c, tgt_c, w_c
        if c == 0:
            up_loop = up_c
    state_loop = pgraph.ba_step(state, torch.tensor(INTR), ii, jj, mask,
                                target, weight, 1, N_FR, **ba_kw)

    state_m = pvideo.VideoState(*(t.clone() for t in state0))
    state_m, net_m, target_m, weight_m, up_m = pgraph.update_chunked_step(
        state_m, {}, torch.tensor(INTR), ii, jj, mask, net0.clone(),
        target0.clone(), *inac, 1, N_FR, n_chunks, chunk=chunk,
        update_fn=upd, agg_fn=_chunk_local_agg, **ba_kw)
    for a, b in ((state_m.poses, state_loop.poses),
                 (state_m.damping, state_loop.damping), (net_m, net),
                 (target_m, target), (weight_m, weight), (up_m, up_loop)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)

    def jagg(params, net, ii, mask, B):
        h, w = net.shape[2], net.shape[3]
        m = mask.astype(net.dtype)
        bias = (net.mean(axis=(1, 2, 3)) * m).sum() / (m.sum() + 1.0)
        return ((1e-4 + 1e-5 * bias) * jnp.ones((net.shape[0], h, w)),
                jnp.zeros((net.shape[0], 576, h, w)))

    ju, _ = jax_oracle(jnp.asarray(gt), jnp.asarray(disps), jnp.asarray(INTR))
    jg = jgraph.FactorGraph(BUF, HT, WD, capacity=40, params={},
                            intrinsics=jnp.asarray(INTR), window=8,
                            update_fn=ju, agg_fn=jagg, corr_chunk=chunk)
    jg.add_neighborhood_factors(jstate, 0, N_FR, r=2)
    jii, jjj, jmask = jg._padded_indices()
    zi = jnp.zeros(jg.cap_inac, jnp.int32)
    js, jnet, jtarget, jweight, _ = jgraph.update_chunked_step(
        jstate, {}, jnp.asarray(INTR), jii, jjj, jmask, jg.net, jg.target,
        zi, zi, jnp.zeros(jg.cap_inac), jg.target_inac, jg.weight_inac,
        jnp.asarray(1), jnp.asarray(N_FR), jnp.asarray(n_chunks, jnp.int32),
        window=8, chunk=chunk, iters=2, lm=1e-5, ep=1e-3, update_fn=ju,
        agg_fn=jagg)
    np.testing.assert_allclose(state_m.poses.numpy(), _np(js.poses),
                               atol=POSE_TOL)
    np.testing.assert_allclose(state_m.damping.numpy(), _np(js.damping),
                               rtol=1e-5, atol=1e-9)
    # the processed chunks' slots (JAX's add_factors also fills the slots
    # of its power-of-two padding, which no chunk reads)
    k = n_chunks * chunk
    np.testing.assert_allclose(target_m[:k].numpy(), _np(jtarget[:k]),
                               atol=1e-3)
    np.testing.assert_allclose(weight_m.numpy(), _np(jweight), atol=1e-6)


# ---------------------------------------------------------------------------
# FrameDistanceCache (tests/test_dist_cache.py)
# ---------------------------------------------------------------------------

DC_INTR = np.array([16.0, 16.0, 8.0, 6.0], np.float32)
DC_BUF, DC_T = 16, 12


def _dc_arrays(seed=0):
    rng = np.random.default_rng(seed)
    poses = np.zeros((DC_BUF, 7), np.float32)
    poses[:, :3] = np.cumsum(0.05 * rng.standard_normal((DC_BUF, 3)), 0)
    q = rng.standard_normal((DC_BUF, 4)) * 0.05
    q[:, 3] += 1.0
    poses[:, 3:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    disps = (0.5 + 0.3 * rng.random((DC_BUF, HT, WD))).astype(np.float32)
    return poses, disps


def _dc_states(poses, disps):
    j = jvideo.init_video(DC_BUF, HT, WD)._replace(
        poses=jnp.asarray(poses), disps=jnp.asarray(disps),
        timestamps=jnp.arange(DC_BUF, dtype=jnp.float32))
    p = pvideo.init_video(DC_BUF, HT, WD)._replace(
        poses=torch.tensor(poses), disps=torch.tensor(disps),
        timestamps=torch.arange(DC_BUF, dtype=torch.float32))
    return j, p


def _grid(rows=range(DC_T)):
    ii, jj = np.meshgrid(np.asarray(rows), np.arange(DC_T), indexing="ij")
    return ii.reshape(-1), jj.reshape(-1)


def _fresh(state, ii, jj):
    return pvideo.frame_distance_padded(state, torch.tensor(DC_INTR), ii, jj,
                                        beta=0.3).astype(np.float64)


def _both(caches, states, ii, jj):
    """One distance_grid call on the JAX and the port cache -> port's,
    after checking the two agree (values and recompute counts)."""
    ref = caches[0].distance_grid(states[0], jnp.asarray(DC_INTR), ii, jj,
                                  DC_T)
    got = caches[1].distance_grid(states[1], torch.tensor(DC_INTR), ii, jj,
                                  DC_T)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert caches[1].recomputed_pairs == caches[0].recomputed_pairs
    return got


def _caches(**kw):
    return jdc.FrameDistanceCache(DC_BUF, **kw), \
        pdc.FrameDistanceCache(DC_BUF, **kw)


def test_dist_cache_cold_grid_matches_fresh_and_jax():
    poses, disps = _dc_arrays()
    states = _dc_states(poses, disps)
    caches = _caches()
    ii, jj = _grid()
    d = _both(caches, states, ii, jj)
    np.testing.assert_allclose(d, _fresh(states[1], ii, jj), rtol=1e-6,
                               atol=1e-6)
    assert caches[1].recomputed_pairs == DC_T * (DC_T - 1) // 2


def test_dist_cache_incremental_after_reposing_subset():
    poses, disps = _dc_arrays()
    caches = _caches()
    ii, jj = _grid()
    _both(caches, _dc_states(poses, disps), ii, jj)
    dirty = [3, 7, 8]
    poses2, disps2 = poses.copy(), disps.copy()
    poses2[dirty, :3] += 0.11
    disps2[7] *= 1.3
    states2 = _dc_states(poses2, disps2)
    d = _both(caches, states2, ii, jj)
    np.testing.assert_allclose(d, _fresh(states2[1], ii, jj), rtol=1e-6,
                               atol=1e-6)
    n_dirty = sum(1 for a in range(DC_T) for b in range(a + 1, DC_T)
                  if a in dirty or b in dirty)
    assert caches[1].recomputed_pairs == n_dirty


def test_dist_cache_partial_grid_then_full_stays_coherent():
    poses, disps = _dc_arrays()
    caches = _caches()
    _both(caches, _dc_states(poses, disps), *_grid(range(8, DC_T)))
    poses2 = poses.copy()
    poses2[2, :3] += 0.2
    states2 = _dc_states(poses2, disps)
    ii, jj = _grid()
    np.testing.assert_allclose(_both(caches, states2, ii, jj),
                               _fresh(states2[1], ii, jj), rtol=1e-6,
                               atol=1e-6)


def test_dist_cache_tolerance_mode():
    """Drift below the tolerance recomputes nothing and stays near a fresh
    computation; motion above it invalidates the moved frame's pairs."""
    poses, disps = _dc_arrays()
    caches = _caches(pose_tol=1e-3, disp_tol=1e-2)
    ii, jj = _grid()
    _both(caches, _dc_states(poses, disps), ii, jj)
    poses2 = poses.copy()
    poses2[:, :3] += 2e-4
    states2 = _dc_states(poses2, disps)
    d = _both(caches, states2, ii, jj)
    assert caches[1].recomputed_pairs == 0
    ref = _fresh(states2[1], ii, jj)
    ok = np.isfinite(ref) & (ref < 999) & (d < 999)
    assert np.abs(d[ok] - ref[ok]).max() < 0.05
    poses2[5, :3] += 0.05
    _both(caches, _dc_states(poses2, disps), ii, jj)
    assert caches[1].recomputed_pairs == DC_T - 1


def test_dist_cache_snapshot_does_not_follow_in_place_writes():
    """The port's BA writes poses in place: the cache's snapshot must be
    a copy, or a moved frame would look clean."""
    poses, disps = _dc_arrays()
    _, state = _dc_states(poses, disps)
    cache = pdc.FrameDistanceCache(DC_BUF)
    ii, jj = _grid()
    cache.distance_grid(state, torch.tensor(DC_INTR), ii, jj, DC_T)
    state.poses[4, :3] += 0.1
    d = cache.distance_grid(state, torch.tensor(DC_INTR), ii, jj, DC_T)
    assert cache.recomputed_pairs == DC_T - 1
    np.testing.assert_allclose(d, _fresh(state, ii, jj), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Backend
# ---------------------------------------------------------------------------

def _backend_cfgs(**backend):
    be = {"thresh": 25.0, "radius": 1, "nms": 1, "loop_window": 6,
          "loop_thresh": 25.0, "loop_radius": 1, "loop_nms": 1}
    be.update(backend)
    ov = {"tracking": {"buffer": DC_BUF, "backend": be}}
    return jmake_config(ov), pmake_config(ov)


@pytest.mark.parametrize("loop", [False, True])
@pytest.mark.parametrize("cache", [False, True])
def test_propose_edges_matches_jax(loop, cache):
    """The same edge list as the JAX backend, dense and loop, with the
    distance cache on and off, cold and after re-posing two frames."""
    poses, disps = _dc_arrays(seed=3)
    jcfg, pcfg = _backend_cfgs(dist_cache={"enabled": cache})
    jb = jbackend.Backend(None, jnp.asarray(DC_INTR), jcfg, DC_BUF, HT, WD)
    pb = pbackend.Backend(None, torch.tensor(DC_INTR), pcfg, DC_BUF, HT, WD)
    assert (pb.dist_cache is not None) == cache
    if loop:
        args = (0, DC_T, DC_T - 6, pb.loop_radius, pb.loop_nms,
                pb.loop_thresh, 48, True)
    else:
        args = (0, DC_T, 0, pb.radius, pb.nms, pb.thresh, 128, False)
    for shift in (0.0, 0.08):
        p = poses.copy()
        p[[4, 9], :3] += shift
        js, ps = _dc_states(p, disps)
        ref = jb._propose_edges(js, *args)
        got = pb._propose_edges(ps, *args)
        assert len(got) > 3
        np.testing.assert_array_equal(got, ref)


def _backend_problem(seed=4, n=10):
    """A buffer of n keyframes on a GT trajectory with noisy poses, both
    packages' states, and the oracle update functions of both."""
    rng = np.random.default_rng(seed)
    xi = np.zeros((DC_BUF, 6), np.float32)
    xi[1:n, :3] = np.cumsum(0.04 * rng.normal(size=(n - 1, 3)), 0)
    xi[1:n, 3:] = 0.01 * rng.normal(size=(n - 1, 3))
    gt = plie.exp(torch.tensor(xi))
    gt[n:] = plie.identity((DC_BUF - n,))
    disps = np.broadcast_to(0.4 + 0.2 * rng.random((1, HT, WD)),
                            (DC_BUF, HT, WD)).astype(np.float32)
    dxi = (0.02 * rng.normal(size=(DC_BUF, 6))).astype(np.float32)
    dxi[0] = 0
    init = plie.retr(gt, torch.tensor(dxi)).numpy()
    arrays = {
        "timestamps": np.arange(DC_BUF, dtype=np.float32), "poses": init,
        "poses_gt": np.tile(np.eye(4, dtype=np.float32), (DC_BUF, 1, 1)),
        "disps": disps, "disps_sens": disps,
        "fmaps": np.zeros((DC_BUF, 128, HT, WD), np.float32),
        "nets": np.zeros((DC_BUF, 128, HT, WD), np.float32),
        "inps": np.zeros((DC_BUF, 128, HT, WD), np.float32),
        "damping": np.full((DC_BUF, HT, WD), 1e-6, np.float32)}
    js = jvideo.VideoState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    ps = video_state_from_numpy(arrays)
    return (js, ps, jax_oracle(jnp.asarray(gt.numpy()), jnp.asarray(disps),
                               jnp.asarray(DC_INTR)),
            _port_oracle(gt.numpy(), disps, DC_INTR), n)


@pytest.mark.parametrize("mode", ["dense", "sparse_chunked"])
def test_dense_ba_matches_jax(mode):
    js, ps, (ju, ja), (pu, pa), n = _backend_problem()
    kw = {} if mode == "dense" else {"corr_chunk": 16}
    jcfg, pcfg = _backend_cfgs(**kw)
    jb = jbackend.Backend({}, jnp.asarray(DC_INTR), jcfg, DC_BUF, HT, WD,
                          update_fn=ju, agg_fn=ja)
    pb = pbackend.Backend({}, torch.tensor(DC_INTR), pcfg, DC_BUF, HT, WD,
                          update_fn=pu, agg_fn=pa)
    if mode != "dense":
        jb.SPARSE_BA_THRESHOLD = pb.SPARSE_BA_THRESHOLD = 6
    js, jn, jn_edges = jb.dense_ba(js, n, steps=2)
    ps, pn, pn_edges = pb.dense_ba(ps, n, steps=2)
    assert (pn, pn_edges) == (jn, jn_edges) and pn_edges > 0
    assert pb.dense_bas == 1 and pb.updates == 2
    assert pb.sparse_updates == (0 if mode == "dense" else 2)
    assert pb.chunked_updates == (0 if mode == "dense" else 2)
    np.testing.assert_allclose(ps.poses.numpy(), _np(js.poses),
                               atol=POSE_TOL)
    np.testing.assert_allclose(ps.disps.numpy(), _np(js.disps),
                               atol=DISP_TOL)


@pytest.mark.parametrize("sparse", [False, True])
def test_loop_ba_with_local_graph_matches_jax(sparse):
    """loop_ba seeded with a frontend graph: the JAX graph's edge table is
    loaded into the port's (`factor_graph_from_numpy`), then both run."""
    js, ps, (ju, ja), (pu, pa), n = _backend_problem(seed=5)
    jcfg, pcfg = _backend_cfgs()
    jb = jbackend.Backend({}, jnp.asarray(DC_INTR), jcfg, DC_BUF, HT, WD,
                          update_fn=ju, agg_fn=ja)
    pb = pbackend.Backend({}, torch.tensor(DC_INTR), pcfg, DC_BUF, HT, WD,
                          update_fn=pu, agg_fn=pa)
    if sparse:
        jb.SPARSE_BA_THRESHOLD = pb.SPARSE_BA_THRESHOLD = 6
    jlocal = jgraph.FactorGraph(DC_BUF, HT, WD, capacity=24, params={},
                                intrinsics=jnp.asarray(DC_INTR), window=16,
                                update_fn=ju, agg_fn=ja)
    jlocal.add_neighborhood_factors(js, n - 5, n, r=1)
    js = jlocal.update(js, t0=n - 4, t1=n, use_inactive=True)
    jlocal.rm_factors(jlocal.ii == n - 5, store=True)
    plocal = pgraph.FactorGraph(DC_BUF, HT, WD, capacity=24, params={},
                                intrinsics=torch.tensor(DC_INTR), window=16,
                                update_fn=pu, agg_fn=pa)
    factor_graph_from_numpy(jlocal, plocal)
    ps = video_state_from_numpy(
        {k: _np(getattr(js, k)) for k in jvideo.VideoState._fields})
    np.testing.assert_array_equal(plocal.ii_inac, _np(jlocal.ii_inac))
    np.testing.assert_allclose(plocal.target[:plocal.n_active].numpy(),
                               _np(jlocal.target[:jlocal.n_active]))

    js, jw, jn_edges = jb.loop_ba(js, n, t_start=0, t_end=n, steps=2,
                                  local_graph=jlocal)
    ps, pw, pn_edges = pb.loop_ba(ps, n, t_start=0, t_end=n, steps=2,
                                  local_graph=plocal)
    assert (pw, pn_edges) == (jw, jn_edges) and pn_edges > plocal.n_active
    assert pb.loop_bas == 1 and pb.sparse_updates == (2 if sparse else 0)
    np.testing.assert_allclose(ps.poses.numpy(), _np(js.poses),
                               atol=POSE_TOL)
    np.testing.assert_allclose(ps.disps.numpy(), _np(js.disps),
                               atol=DISP_TOL)
