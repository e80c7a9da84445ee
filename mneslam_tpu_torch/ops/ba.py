"""Dense bundle adjustment: damped Gauss-Newton with a Schur solve.

Port of `mneslam_tpu/ops/ba.py`. One call runs `iters` damped GN
iterations over keyframe poses and per-pixel inverse depths, given dense
reprojection targets and confidences on a padded edge table. Fixed poses
are masked out of the system rather than sliced away, so every window
position has the same shapes; the depth block is diagonal per pixel, so
the Schur complement is one [2E*6, HW] x [HW, 2E*6] product. Everything
is fp32 (TF32 off, `device.resolve_device`) and nothing reads back to the
host: a failed Cholesky gives a zero update through a device-side select.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import lie, projective

RES_WEIGHT = 0.001          # ba.py:38 - global residual weight
DEPTH_PRIOR_ALPHA = 0.05    # droid_kernels.cu:1396 - RGB-D disparity prior
LM_LAMBDA = 1e-4            # chol.py:46 - multiplicative damping
LM_EP = 0.1                 # chol.py:46 - additive damping


class BAProblem(NamedTuple):
    """target / weight [E, H, W, 2], eta [N, H, W], ii / jj [E] long,
    mask [E] (1 real edge, 0 padding)."""

    target: torch.Tensor
    weight: torch.Tensor
    eta: torch.Tensor
    ii: torch.Tensor
    jj: torch.Tensor
    mask: torch.Tensor


def _segment_sum(vals: torch.Tensor, idx: torch.Tensor, n: int):
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, idx, vals)


def _solve_psd(S: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Cholesky solve; zeros when the factorisation fails or the solution
    is not finite (the reference's exception-tolerant CholeskySolver,
    chol.py:4-29), selected on the device."""
    L, info = torch.linalg.cholesky_ex(S)
    x = torch.cholesky_solve(rhs[:, None], L)[:, 0]
    ok = (info == 0) & torch.isfinite(x).all()
    return torch.where(ok, x, torch.zeros_like(x))


def _retract_poses(poses, dx, opt_pose):
    return torch.where(opt_pose[:, None] > 0, lie.retr(poses, dx), poses)


def bundle_adjust(poses: torch.Tensor, disps: torch.Tensor,
                  intrinsics: torch.Tensor, problem: BAProblem,
                  disps_sens: Optional[torch.Tensor] = None, t0: int = 1,
                  t1: Optional[int] = None, iters: int = 2,
                  lm: float = LM_LAMBDA, ep: float = LM_EP,
                  motion_only: bool = False):
    """`iters` damped GN iterations -> (poses, disps).

    poses [N, 7] w2c, disps [N, H, W]; poses before t0 are gauge-fixed and
    poses at or after t1 (default N) are out of the system."""
    N = poses.shape[0]
    E, ht, wd = problem.target.shape[0], disps.shape[1], disps.shape[2]
    HW = ht * wd
    D = 6
    dev, dt = disps.device, disps.dtype
    if t1 is None:
        t1 = N
    frame_idx = torch.arange(N, device=dev)
    opt_pose = ((frame_idx >= t0) & (frame_idx < t1)).to(dt)
    ii, jj = problem.ii.long(), problem.jj.long()
    emask = problem.mask.to(dt)

    target_pl = problem.target.reshape(E, HW, 2).transpose(1, 2)  # [E,2,HW]
    weight_pl = problem.weight.reshape(E, HW, 2).transpose(1, 2)
    eye_d = torch.eye(D, dtype=dt, device=dev)

    for _ in range(iters):
        coords, valid, (Ji, Jj, Jz) = projective.projective_transform_planes(
            poses, disps, intrinsics, ii, jj)
        r = target_pl - coords                               # [E, 2, HW]
        w = RES_WEIGHT * valid * weight_pl * emask[:, None, None]

        wJi = w[:, None] * Ji                                # [E, D, 2, HW]
        wJj = w[:, None] * Jj
        Ji_f, Jj_f = Ji.reshape(E, D, 2 * HW), Jj.reshape(E, D, 2 * HW)
        wJi_f, wJj_f = wJi.reshape(E, D, 2 * HW), wJj.reshape(E, D, 2 * HW)
        r_f = r.reshape(E, 2 * HW)

        Hii = torch.einsum("eip,ejp->eij", wJi_f, Ji_f)
        Hij = torch.einsum("eip,ejp->eij", wJi_f, Jj_f)
        Hji = torch.einsum("eip,ejp->eij", wJj_f, Ji_f)
        Hjj = torch.einsum("eip,ejp->eij", wJj_f, Jj_f)
        vi = torch.einsum("eip,ep->ei", wJi_f, r_f)
        vj = torch.einsum("eip,ep->ei", wJj_f, r_f)

        Ei = torch.einsum("edcp,ecp->edp", wJi, Jz)          # [E, D, HW]
        Ej = torch.einsum("edcp,ecp->edp", wJj, Jz)
        wJz = w * Jz
        Ck = (wJz * Jz).sum(1)                               # [E, HW]
        wk = (wJz * r).sum(1)

        H = (_segment_sum(Hii, ii * N + ii, N * N)
             + _segment_sum(Hij, ii * N + jj, N * N)
             + _segment_sum(Hji, jj * N + ii, N * N)
             + _segment_sum(Hjj, jj * N + jj, N * N)).reshape(N, N, D, D)
        v = _segment_sum(vi, ii, N) + _segment_sum(vj, jj, N)  # [N, D]

        # gauge fix, damping (chol.py:52-57), identity on fixed blocks
        H = H * opt_pose[:, None, None, None] * opt_pose[None, :, None, None]
        v = v * opt_pose[:, None]
        Hmat = H.permute(0, 2, 1, 3).reshape(N * D, N * D)
        Hmat = Hmat + torch.diag(ep + lm * torch.diagonal(Hmat))
        Hmat = Hmat + torch.diag((1.0 - opt_pose).repeat_interleave(D))
        vvec = v.reshape(N * D)

        if motion_only:
            dx = _solve_psd(Hmat, vvec).reshape(N, D) * opt_pose[:, None]
            poses = _retract_poses(poses, dx, opt_pose)
            continue

        C = _segment_sum(Ck, ii, N) + problem.eta.reshape(N, HW) + 1e-7
        wvec = _segment_sum(wk, ii, N)
        if disps_sens is not None:
            sens = disps_sens.reshape(N, HW)
            has_sens = (sens > 0).to(dt)
            C = C + DEPTH_PRIOR_ALPHA * has_sens
            wvec = wvec + DEPTH_PRIOR_ALPHA * has_sens * (
                sens - disps.reshape(N, HW))

        # Schur complement over same-source block pairs, as one product
        Ecat = torch.cat([Ei, Ej])                           # [2E, D, HW]
        pidx = torch.cat([ii, jj])                           # pose per block
        kidx = torch.cat([ii, ii])                           # depth frame
        Ecat = Ecat * opt_pose[pidx][:, None, None]
        Qk = (1.0 / C)[kidx]                                 # [2E, HW]
        Pq = Ecat * Qk[:, None, :]
        twoE = Pq.shape[0]
        G = Pq.reshape(twoE * D, HW) @ Ecat.reshape(twoE * D, HW).T
        same_k = (kidx[:, None] == kidx[None, :]).to(dt)
        M = same_k.repeat_interleave(D, 0).repeat_interleave(D, 1)
        onehot = (pidx[:, None] == frame_idx[None, :]).to(dt)
        L = (onehot[:, None, :, None] * eye_d[None, :, None, :]
             ).reshape(twoE * D, N * D)
        S = Hmat - L.T @ (G * M) @ L

        rhs_blocks = torch.einsum("adp,ap->ad", Pq, wvec[kidx])
        rhs = vvec - _segment_sum(rhs_blocks, pidx, N).reshape(N * D)
        dx = _solve_psd(S, rhs)

        # dz = Q (w - E^T dx), back-substituted per source frame
        Etdx = torch.einsum("adp,ad->ap", Ecat, dx.reshape(N, D)[pidx])
        Etdx = _segment_sum(Etdx, kidx, N)                   # [N, HW]
        dz = (wvec - Etdx) / C

        dx = dx.reshape(N, D) * opt_pose[:, None]
        poses = _retract_poses(poses, dx, opt_pose)
        disps = disps + dz.reshape(N, ht, wd)
        # the reference's clamps: > 10 reset to 0, then floored at 0
        disps = torch.where(disps > 10.0, torch.zeros_like(disps), disps)
        disps = disps.clamp(min=0.0)
    return poses, disps


def reprojection_residuals(poses, disps, intrinsics, problem: BAProblem):
    """Masked mean reprojection error in pixels (a metric, not the loss)."""
    coords, valid = projective.projective_transform(
        poses, disps, intrinsics, problem.ii.long(), problem.jj.long())
    m = problem.mask.to(disps.dtype)[:, None, None]
    err = (problem.target - coords).norm(dim=-1) * valid[..., 0] * m
    denom = (valid[..., 0] * m).sum().clamp(min=1.0)
    return err.sum() / denom
