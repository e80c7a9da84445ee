"""Port of the dense bundle adjustment (`mneslam_tpu_torch.ops.ba`) against
the JAX package on the CPU, on `tests/test_ba.py`'s synthetic problem.

Tolerance: poses atol 1e-4 and disps atol 1e-3 after 2-3 GN iterations
(fp32 Cholesky solves of a damped system summed in another order; the
depth updates divide by per-pixel sums, so they move more than poses)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mneslam_tpu.ops import ba as jba
from mneslam_tpu_torch.ops import ba as pba
from mneslam_tpu_torch.ops import lie as plie
from test_ba import INTR, make_problem

torch.set_num_threads(1)

POSE_ATOL, DISP_ATOL = 1e-4, 1e-3


def _to_torch(problem):
    return pba.BAProblem(*(torch.tensor(np.asarray(a)) for a in problem))


def _run_both(seed, **kw):
    gt_poses, gt_disps, init_poses, init_disps, problem = make_problem(
        jax.random.PRNGKey(seed))
    sens = kw.pop("sens", False)
    jout = jba.bundle_adjust(init_poses, init_disps, INTR, problem,
                             disps_sens=gt_disps if sens else None, **kw)
    tout = pba.bundle_adjust(
        torch.tensor(np.asarray(init_poses)),
        torch.tensor(np.asarray(init_disps)),
        torch.tensor(np.asarray(INTR)), _to_torch(problem),
        disps_sens=torch.tensor(np.asarray(gt_disps)) if sens else None,
        **kw)
    return (gt_poses, gt_disps, init_poses), jout, tout


def _pose_err(a, b):
    return float(plie.log(plie.mul(a, plie.inv(b))).norm(dim=-1).max())


def test_bundle_adjust_matches_jax():
    (gt, _, init), (jp, jd), (tp, td) = _run_both(0, t0=1, iters=2)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=POSE_ATOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=DISP_ATOL)
    gt_t = torch.tensor(np.asarray(gt))
    assert _pose_err(tp, gt_t) < 0.5 * _pose_err(
        torch.tensor(np.asarray(init)), gt_t)


def test_bundle_adjust_converges_like_jax():
    (gt, gt_d, init), (jp, jd), (tp, td) = _run_both(
        0, t0=1, iters=12, ep=0.001, lm=1e-5)
    gt_t = torch.tensor(np.asarray(gt))
    err0 = _pose_err(torch.tensor(np.asarray(init)), gt_t)
    assert _pose_err(tp, gt_t) < 0.05 * err0
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=POSE_ATOL)
    assert float((td - torch.tensor(np.asarray(gt_d))).abs().mean()) < 0.01


def test_padded_edges_are_inert():
    gt_poses, _, init_poses, init_disps, problem = make_problem(
        jax.random.PRNGKey(2))
    p = _to_torch(problem)
    args = (torch.tensor(np.asarray(init_poses)),
            torch.tensor(np.asarray(init_disps)),
            torch.tensor(np.asarray(INTR)))
    pa, da = pba.bundle_adjust(*args, p, t0=1, iters=3)
    pad = 4
    HT, WD = p.target.shape[1:3]
    padded = pba.BAProblem(
        target=torch.cat([p.target, 777.0 * torch.ones(pad, HT, WD, 2)]),
        weight=torch.cat([p.weight, torch.ones(pad, HT, WD, 2)]),
        eta=p.eta,
        ii=torch.cat([p.ii, torch.zeros(pad, dtype=p.ii.dtype)]),
        jj=torch.cat([p.jj, torch.ones(pad, dtype=p.jj.dtype)]),
        mask=torch.cat([p.mask, torch.zeros(pad)]))
    pb, db = pba.bundle_adjust(*args, padded, t0=1, iters=3)
    np.testing.assert_allclose(pa.numpy(), pb.numpy(), atol=1e-5)
    np.testing.assert_allclose(da.numpy(), db.numpy(), atol=1e-5)


def test_motion_only_and_gauge_fix_match_jax():
    (gt, gt_d, init), (jp, jd), (tp, td) = _run_both(
        3, t0=2, iters=3, ep=0.001, lm=1e-5, motion_only=True)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=POSE_ATOL)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))   # untouched
    np.testing.assert_array_equal(tp[:2].numpy(), np.asarray(init)[:2])


def test_depth_prior_matches_jax():
    (gt, gt_d, _), (jp, jd), (tp, td) = _run_both(
        4, t0=1, iters=3, ep=0.001, lm=1e-5, sens=True)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=POSE_ATOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=DISP_ATOL)


def test_singular_system_gives_zero_update():
    S = torch.tensor([[1.0, 2.0], [2.0, 1.0]])      # indefinite
    assert not pba._solve_psd(S, torch.tensor([1.0, 1.0])).any()
    nan = torch.tensor([[float("nan"), 0.0], [0.0, 1.0]])
    assert not pba._solve_psd(nan, torch.tensor([1.0, 1.0])).any()
    x = pba._solve_psd(torch.tensor([[4.0, 0.0], [0.0, 2.0]]),
                       torch.tensor([2.0, 1.0]))
    np.testing.assert_allclose(x.numpy(), [0.5, 0.5], rtol=1e-6)
    # and in BA: a problem with weight NaN leaves the poses where they were
    gt_poses, _, init_poses, init_disps, problem = make_problem(
        jax.random.PRNGKey(5))
    p = _to_torch(problem)
    p = p._replace(weight=torch.full_like(p.weight, float("nan")))
    poses, _ = pba.bundle_adjust(torch.tensor(np.asarray(init_poses)),
                                 torch.tensor(np.asarray(init_disps)),
                                 torch.tensor(np.asarray(INTR)), p, t0=1,
                                 iters=1, motion_only=True)
    np.testing.assert_array_equal(poses.numpy(), np.asarray(init_poses))


def test_reprojection_residuals_match_jax():
    gt_poses, gt_disps, init_poses, init_disps, problem = make_problem(
        jax.random.PRNGKey(6))
    ref = jba.reprojection_residuals(init_poses, init_disps, INTR, problem)
    got = pba.reprojection_residuals(
        torch.tensor(np.asarray(init_poses)),
        torch.tensor(np.asarray(init_disps)),
        torch.tensor(np.asarray(INTR)), _to_torch(problem))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-4)
    assert float(pba.reprojection_residuals(
        torch.tensor(np.asarray(gt_poses)),
        torch.tensor(np.asarray(gt_disps)),
        torch.tensor(np.asarray(INTR)), _to_torch(problem))) < 1e-3
