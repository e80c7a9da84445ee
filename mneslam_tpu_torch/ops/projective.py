"""Pinhole projective geometry with analytic Jacobians.

Port of `mneslam_tpu/ops/projective.py`: inverse-depth point lifting, the
SE(3) homogeneous action, pinhole projection, and the edge-indexed
`projective_transform` mapping pixels of keyframe ii into keyframe jj with
Jacobians w.r.t. both poses and the source inverse depth.

Shapes: poses [N, 7] world-to-camera, disps [N, H, W] inverse depth at 1/8
resolution, intrinsics [4] (fx, fy, cx, cy), ii / jj [E] long.
Everything here runs in the dtype of `disps` (fp32 on the main path).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import lie

MIN_DEPTH = 0.2  # the reference's validity floor (projective_ops.py:4)


def coords_grid(ht: int, wd: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Pixel-centre grid [ht, wd, 2] in (x, y) order."""
    y = torch.arange(ht, dtype=dtype, device=device)
    x = torch.arange(wd, dtype=dtype, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def iproj(disps: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """disps [..., H, W] -> homogeneous points [..., H, W, 4] = (X, Y, 1, d);
    the 3-D point is (X, Y, 1) / d."""
    ht, wd = disps.shape[-2:]
    fx, fy, cx, cy = intrinsics.unbind(-1)
    grid = coords_grid(ht, wd, disps.dtype, disps.device)
    X = ((grid[..., 0] - cx) / fx).expand(disps.shape)
    Y = ((grid[..., 1] - cy) / fy).expand(disps.shape)
    return torch.stack([X, Y, torch.ones_like(disps), disps], dim=-1)


def proj(Xs: torch.Tensor, intrinsics: torch.Tensor, jacobian: bool = False,
         return_depth: bool = False
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Pinhole projection [..., 4] -> pixels [..., 2|3], and with `jacobian`
    d(pixel)/d(X, Y, Z, d) [..., 2, 4]. Z below MIN_DEPTH / 2 is replaced by
    1 (projective_ops.py:93) so invalid points stay finite."""
    fx, fy, cx, cy = intrinsics.unbind(-1)
    X, Y, Z, D = Xs.unbind(-1)
    Z = torch.where(Z < 0.5 * MIN_DEPTH, torch.ones_like(Z), Z)
    x = fx * (X / Z) + cx
    y = fy * (Y / Z) + cy
    coords = torch.stack([x, y, D / Z] if return_depth else [x, y], dim=-1)
    if not jacobian:
        return coords, None
    o = torch.zeros_like(Z)
    J0 = torch.stack([fx / Z, o, -(fx / Z) * (X / Z), o], dim=-1)
    J1 = torch.stack([o, fy / Z, -(fy / Z) * (Y / Z), o], dim=-1)
    return coords, torch.stack([J0, J1], dim=-2)


def act4_jacobian(X1: torch.Tensor) -> torch.Tensor:
    """d(exp(xi) * X1)/dxi at X1 [..., 4] -> [..., 4, 6]:
    [[d I, -skew(p)], [0, 0]] (projective_ops.py:66-71)."""
    X, Y, Z, d = X1.unbind(-1)
    o = torch.zeros_like(d)
    return torch.stack([
        torch.stack([d, o, o, o, Z, -Y], -1),
        torch.stack([o, d, o, -Z, o, X], -1),
        torch.stack([o, o, d, Y, -X, o], -1),
        torch.stack([o, o, o, o, o, o], -1),
    ], dim=-2)


def relative_poses(poses: torch.Tensor, ii: torch.Tensor,
                   jj: torch.Tensor) -> torch.Tensor:
    """poses[jj] * poses[ii]^-1; self-edges (ii == jj) get the reference's
    fixed small x-translation (projective_ops.py:124)."""
    Gij = lie.mul(poses[jj], lie.inv(poses[ii]))
    self_edge = lie.identity(dtype=poses.dtype, device=poses.device)
    self_edge[0] = -0.1
    return torch.where((ii == jj)[:, None], self_edge, Gij)


def projective_transform(poses, disps, intrinsics, ii, jj,
                         jacobian: bool = False, return_depth: bool = False):
    """Reproject pixels of frames ii into frames jj.

    Returns coords [E, H, W, 2(|3)], valid [E, H, W, 1] in {0, 1} and, with
    `jacobian`, (Ji, Jj [E, H, W, 2, 6], Jz [E, H, W, 2, 1])."""
    X0 = iproj(disps[ii], intrinsics)                        # [E, H, W, 4]
    Gij = relative_poses(poses, ii, jj)                      # [E, 7]
    X1 = lie.act4(Gij[:, None, None, :], X0)
    x1, Jp = proj(X1, intrinsics, jacobian=jacobian,
                  return_depth=return_depth)
    valid = ((X1[..., 2] > MIN_DEPTH) & (X0[..., 2] > MIN_DEPTH))
    valid = valid[..., None].to(disps.dtype)
    if not jacobian:
        return x1, valid

    Ja = act4_jacobian(X1)                                   # [E, H, W, 4, 6]
    Jj = Jp @ Ja                                             # [E, H, W, 2, 6]
    Ji = -lie.adjT_apply(Gij[:, None, None, :], Jj)
    # d(coords)/d(disp): the source point moves along (0, 0, 0, 1)
    dz = torch.zeros_like(X0)
    dz[..., 3] = 1.0
    Jz = Jp @ lie.act4(Gij[:, None, None, :], dz)[..., None]  # [E,H,W,2,1]
    return x1, valid, (Ji, Jj, Jz)


def projective_transform_planes(poses, disps, intrinsics, ii, jj):
    """`projective_transform(jacobian=True)` with the pixel axis minor:
    coords [E, 2, HW], valid [E, 1, HW], Ji / Jj [E, 6, 2, HW], Jz
    [E, 2, HW]. The BA's layout: every Jacobian entry is an [E, HW] plane
    built from closed-form per-edge scalars (projective_ops.py:66-141)."""
    E = ii.shape[0]
    ht, wd = disps.shape[-2:]
    HW = ht * wd
    fx, fy, cx, cy = intrinsics.unbind(-1)

    grid = coords_grid(ht, wd, disps.dtype, disps.device).reshape(HW, 2)
    X0x = ((grid[:, 0] - cx) / fx)[None, :]                  # [1, HW]
    X0y = ((grid[:, 1] - cy) / fy)[None, :]
    d = disps[ii].reshape(E, HW)

    Gij = relative_poses(poses, ii, jj)
    R = lie.quat_to_matrix(Gij[:, 3:7])                      # [E, 3, 3]
    t0, t1, t2 = Gij[:, 0:1], Gij[:, 1:2], Gij[:, 2:3]

    def rc(r, c):
        return R[:, r, c][:, None]

    x1 = rc(0, 0) * X0x + rc(0, 1) * X0y + rc(0, 2) + t0 * d
    y1 = rc(1, 0) * X0x + rc(1, 1) * X0y + rc(1, 2) + t1 * d
    z1 = rc(2, 0) * X0x + rc(2, 1) * X0y + rc(2, 2) + t2 * d

    Z = torch.where(z1 < 0.5 * MIN_DEPTH, torch.ones_like(z1), z1)
    coords = torch.stack([fx * (x1 / Z) + cx, fy * (y1 / Z) + cy], dim=1)
    valid = (z1 > MIN_DEPTH).to(disps.dtype)[:, None, :]

    a = fx / Z
    b = fy / Z
    u2 = a * (x1 / Z)
    v2 = b * (y1 / Z)
    zero = torch.zeros_like(a)
    Jj0 = [a * d, zero, -u2 * d, -u2 * y1, a * z1 + u2 * x1, -a * y1]
    Jj1 = [zero, b * d, -v2 * d, -b * z1 - v2 * y1, v2 * x1, b * x1]
    Jj = torch.stack([torch.stack(Jj0, dim=1), torch.stack(Jj1, dim=1)],
                     dim=2)                                  # [E, 6, 2, HW]
    Ji = -torch.einsum("elcp,elk->ekcp", Jj, lie.adjoint(Gij))
    Jz = torch.stack([a * t0 - u2 * t2, b * t1 - v2 * t2], dim=1)
    return coords, valid, (Ji, Jj, Jz)
