"""Full-history dense BA with sparse Schur assembly.

Port of `mneslam_tpu/ops/ba_sparse.py`. The windowed solver in `ops/ba.py`
forms the pose-depth coupling blockwise over a window; for a BA over the
whole keyframe buffer this module solves the same system without forming
the E matrix:

  S[p1, p2] = H[p1, p2] - sum_k E[p1, k] Q_k E[p2, k]^T

where E[p, k] is nonzero only when an edge couples pose p to depth frame
k = ii(edge). The host enumerates the contribution pairs (two slots per
edge, Ei at pose ii and Ej at pose jj, interacting within each depth-frame
group) into padded index tables; the device gathers the per-edge blocks a
chunk of pairs at a time and scatter-adds their 6 x 6 products, so peak
memory is one pair chunk of [chunk, 6, HW] blocks. fp32 throughout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import lie, projective
from .ba import (BAProblem, DEPTH_PRIOR_ALPHA, LM_EP, LM_LAMBDA, RES_WEIGHT,
                 _segment_sum, _solve_psd)


class SchurPairs(NamedTuple):
    """Contribution-pair table: slot 2e = (pose ii[e], Ei) and slot 2e + 1
    = (pose jj[e], Ej), both attached to depth frame ii[e]; every ordered
    pair of slots of one depth frame gives one 6 x 6 term of S. a, b [P]
    int32 slot indices, mask [P] float32 (1 = real pair); n_pairs the real
    count (host int)."""

    a: torch.Tensor
    b: torch.Tensor
    mask: torch.Tensor
    n_pairs: int


def build_pairs(ii: np.ndarray, jj: np.ndarray, valid: np.ndarray,
                capacity: Optional[int] = None, device="cpu") -> SchurPairs:
    """Enumerate the contribution pairs grouped by depth frame (host
    numpy; the JAX package's arrays, padded to `capacity`)."""
    groups = {}
    for e, (i, ok) in enumerate(zip(np.asarray(ii), np.asarray(valid))):
        if not ok:
            continue
        groups.setdefault(int(i), []).extend([2 * e, 2 * e + 1])
    a, b = [], []
    for slots in groups.values():
        for x in slots:
            for y in slots:
                a.append(x)
                b.append(y)
    n = len(a)
    cap = capacity or max(n, 1)
    pa = np.zeros(cap, np.int32)
    pb = np.zeros(cap, np.int32)
    m = np.zeros(cap, np.float32)
    pa[:n] = a[:cap]
    pb[:n] = b[:cap]
    m[:n] = 1.0
    return SchurPairs(*(torch.from_numpy(x).to(device) for x in (pa, pb, m)),
                      n)


def bundle_adjust_sparse(poses: torch.Tensor, disps: torch.Tensor,
                         intrinsics: torch.Tensor, problem: BAProblem,
                         pairs: SchurPairs,
                         disps_sens: Optional[torch.Tensor] = None,
                         t0: int = 1, t1: Optional[int] = None,
                         iters: int = 2, lm: float = LM_LAMBDA,
                         ep: float = LM_EP, motion_only: bool = False,
                         pair_chunk: int = 2048):
    """The semantics of `ba.bundle_adjust` over the whole buffer ->
    (poses, disps). Pairs go `pair_chunk` at a time, up to the table's
    real count (the padding's products are zero)."""
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
    emask2 = emask.repeat_interleave(2)
    pa, pb = pairs.a.long(), pairs.b.long()
    pm = pairs.mask.to(dt)
    n_pairs = min(int(pairs.n_pairs), pa.shape[0])

    target_pl = problem.target.reshape(E, HW, 2).transpose(1, 2)  # [E,2,HW]
    weight_pl = problem.weight.reshape(E, HW, 2).transpose(1, 2)
    # per slot: its pose and its depth frame (slot 2e + h)
    blk_pose0 = torch.stack([ii, jj], dim=1).reshape(2 * E)
    blk_k = ii.repeat_interleave(2)

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

        H = (_segment_sum(Hii, ii * N + ii, N * N)
             + _segment_sum(Hij, ii * N + jj, N * N)
             + _segment_sum(Hji, jj * N + ii, N * N)
             + _segment_sum(Hjj, jj * N + jj, N * N)).reshape(N, N, D, D)
        v = _segment_sum(vi, ii, N) + _segment_sum(vj, jj, N)  # [N, D]

        H = H * opt_pose[:, None, None, None] * opt_pose[None, :, None, None]
        v = v * opt_pose[:, None]
        Hmat = H.permute(0, 2, 1, 3).reshape(N * D, N * D)
        Hmat = Hmat + torch.diag(ep + lm * torch.diagonal(Hmat))
        Hmat = Hmat + torch.diag((1.0 - opt_pose).repeat_interleave(D))
        vvec = v.reshape(N * D)

        if motion_only:
            dx = _solve_psd(Hmat, vvec).reshape(N, D) * opt_pose[:, None]
            poses = _retract(poses, dx, opt_pose)
            continue

        # per-edge pose-depth blocks, stacked as 2E contribution slots;
        # blocks of fixed / padded poses drop out of the reduced system
        Ei = torch.einsum("edcp,ecp->edp", wJi, Jz)          # [E, D, HW]
        Ej = torch.einsum("edcp,ecp->edp", wJj, Jz)
        Eblk = torch.stack([Ei, Ej], dim=1).reshape(2 * E, D, HW)
        slot_w = emask2 * opt_pose[blk_pose0]
        Eblk = Eblk * slot_w[:, None, None]
        blk_pose = blk_pose0 * slot_w.long()

        wJz = w * Jz                                         # [E, 2, HW]
        Ck = (wJz * Jz).sum(1)
        wk = (wJz * r).sum(1)
        C = _segment_sum(Ck, ii, N) + problem.eta.reshape(N, HW) + 1e-7
        wvec = _segment_sum(wk, ii, N)
        if disps_sens is not None:
            sens = disps_sens.reshape(N, HW)
            has = (sens > 0).to(dt)
            C = C + DEPTH_PRIOR_ALPHA * has
            wvec = wvec + DEPTH_PRIOR_ALPHA * has * (
                sens - disps.reshape(N, HW))
        Q = 1.0 / C                                          # [N, HW]

        # S = H - sum over pairs, one chunk of gathered blocks at a time
        S_blocks = torch.zeros((N * N, D, D), dtype=dt, device=dev)
        for s in range(0, n_pairs, pair_chunk):
            a_c, b_c = pa[s:s + pair_chunk], pb[s:s + pair_chunk]
            A = Eblk[a_c] * Q[blk_k[a_c]][:, None, :]        # [c, D, HW]
            M = torch.bmm(A, Eblk[b_c].transpose(1, 2))      # [c, D, D]
            M = M * pm[s:s + pair_chunk, None, None]
            S_blocks.index_add_(0, blk_pose[a_c] * N + blk_pose[b_c], M)
        EQEt = S_blocks.reshape(N, N, D, D).permute(0, 2, 1, 3).reshape(
            N * D, N * D)
        S = Hmat - EQEt

        # rhs = v - sum_slots Eblk (Q w)[k]
        Qw = Q * wvec                                        # [N, HW]
        contrib = torch.einsum("sdh,sh->sd", Eblk, Qw[blk_k])
        contrib = contrib * emask2[:, None]
        rhs = vvec - _segment_sum(contrib, blk_pose, N).reshape(N * D)

        dx = _solve_psd(S, rhs)
        # dz_k = Q_k (w_k - sum over slots of k of Eblk^T dx[pose])
        dx_n = dx.reshape(N, D) * opt_pose[:, None]
        Etdx = torch.einsum("sdh,sd->sh", Eblk, dx_n[blk_pose])
        Etdx = Etdx * emask2[:, None]
        dz = Q * (wvec - _segment_sum(Etdx, blk_k, N))

        poses = _retract(poses, dx_n, opt_pose)
        disps = disps + dz.reshape(N, ht, wd)
        disps = torch.where(disps > 10.0, torch.zeros_like(disps), disps)
        disps = disps.clamp(min=0.0)
    return poses, disps


def _retract(poses, dx, opt_pose):
    return torch.where(opt_pose[:, None] > 0, lie.retr(poses, dx), poses)
