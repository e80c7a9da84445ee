"""Keyframe video buffer: fixed-capacity device state plus a host counter.

Port of `mneslam_tpu/tracking/video.py`. `VideoState` holds the keyframe
ring buffer (timestamps, w2c poses, 1/8-resolution inverse depths, sensor
disparities, feature / context maps, GT poses, BA damping) as tensors of
fixed shape. Unlike the JAX package's pure functions, the writers here
(`append_frame`, `seed_next_frame`, `windowed_ba`) update the state's
tensors in place and return the same state: the feature buffers are
hundreds of MB at room0, and no caller reads the state from before a
write. `remove_keyframe` gathers into new tensors.

Poses are world-to-camera [tx ty tz qx qy qz qw]; poses, disps and
damping are fp32, the feature buffers may be bf16 (the tracker's dtype).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import ba as ba_lib
from ..ops import lie, projective


class VideoState(NamedTuple):
    timestamps: torch.Tensor   # [B]
    poses: torch.Tensor        # [B, 7] w2c
    poses_gt: torch.Tensor     # [B, 4, 4] c2w
    disps: torch.Tensor        # [B, h, w] inverse depth (1/8 res)
    disps_sens: torch.Tensor   # [B, h, w] sensor inverse depth (0 = none)
    fmaps: torch.Tensor        # [B, 128, h, w]
    nets: torch.Tensor         # [B, 128, h, w]
    inps: torch.Tensor         # [B, 128, h, w]
    damping: torch.Tensor      # [B, h, w] per-frame BA damping


def init_video(buffer: int, ht8: int, wd8: int, device="cpu",
               feat_dtype: torch.dtype = torch.float32) -> VideoState:
    """An empty buffer; `feat_dtype` is the storage type of fmaps / nets /
    inps (geometry stays fp32)."""
    f32 = dict(dtype=torch.float32, device=device)
    feat = dict(dtype=feat_dtype, device=device)
    return VideoState(
        timestamps=torch.zeros((buffer,), **f32),
        poses=lie.identity((buffer,), device=device),
        poses_gt=torch.eye(4, **f32).repeat(buffer, 1, 1),
        disps=torch.ones((buffer, ht8, wd8), **f32),
        disps_sens=torch.zeros((buffer, ht8, wd8), **f32),
        fmaps=torch.zeros((buffer, 128, ht8, wd8), **feat),
        nets=torch.zeros((buffer, 128, ht8, wd8), **feat),
        inps=torch.zeros((buffer, 128, ht8, wd8), **feat),
        damping=1e-6 * torch.ones((buffer, ht8, wd8), **f32),
    )


def sensor_disparity(depth: torch.Tensor) -> torch.Tensor:
    """Full-res depth -> 1/8-res disparity sampled at pixel centres (3::8),
    0 where there is no depth (depth_video.py:92-127)."""
    d8 = depth[3::8, 3::8].float()
    return torch.where(d8 > 0, 1.0 / d8.clamp(min=1e-8), torch.zeros_like(d8))


def append_frame(state: VideoState, index: int, timestamp: float,
                 pose: Optional[torch.Tensor], depth: Optional[torch.Tensor],
                 fmap: torch.Tensor, net: torch.Tensor, inp: torch.Tensor,
                 gt_pose: torch.Tensor) -> VideoState:
    """Write one keyframe at slot `index` (in place); the sensor disparity
    seeds disps."""
    state.timestamps[index] = timestamp
    state.fmaps[index] = fmap
    state.nets[index] = net
    state.inps[index] = inp
    state.poses_gt[index] = gt_pose
    if pose is not None:
        state.poses[index] = pose
    if depth is not None:
        disp = sensor_disparity(depth)
        state.disps_sens[index] = disp
        state.disps[index] = torch.where(disp > 0, disp, torch.ones_like(disp))
    return state


def remove_keyframe(state: VideoState, ix: int) -> VideoState:
    """Drop slot ix: every buffer shifts down by one from ix; the last slot
    is repeated (the source index is clamped at B - 1, video.py:100)."""
    B = state.timestamps.shape[0]
    idx = torch.arange(B, device=state.poses.device)
    src = torch.where(idx >= ix, (idx + 1).clamp(max=B - 1), idx)
    return VideoState(*(a[src] for a in state))


def seed_next_frame(state: VideoState, t1: int) -> VideoState:
    """Initialise slot t1's pose and disps from slot t1 - 1 (in place;
    frontend.py:100-101)."""
    state.poses[t1] = state.poses[t1 - 1]
    state.disps[t1] = state.disps[t1 - 1].mean()
    return state


def reproject(state: VideoState, intrinsics: torch.Tensor, ii, jj):
    return projective.projective_transform(state.poses, state.disps,
                                           intrinsics, ii, jj)


def frame_distance(state: VideoState, intrinsics: torch.Tensor,
                   ii: torch.Tensor, jj: torch.Tensor, beta: float = 0.3,
                   chunk: int = 2048) -> torch.Tensor:
    """Mean-flow distance (droid_kernels.cu frame_distance_kernel): a
    beta-blend of full-reprojection flow and translation-only flow,
    averaged both ways; 1000 where under 75% of the pixels stay valid.
    Edges go `chunk` at a time."""
    ht, wd = state.disps.shape[1:]
    grid = projective.coords_grid(ht, wd, device=state.disps.device)

    def one_direction(a, b):
        X0 = projective.iproj(state.disps[a], intrinsics)
        Gij = lie.mul(state.poses[b], lie.inv(state.poses[a]))
        X1 = lie.act4(Gij[:, None, None, :], X0)
        coords_full, _ = projective.proj(X1, intrinsics)
        X1t = torch.cat([X0[..., :3] + X0[..., 3:4]
                         * lie.translation(Gij)[:, None, None, :],
                         X0[..., 3:]], dim=-1)
        coords_trans, _ = projective.proj(X1t, intrinsics)
        d_full = (coords_full - grid).norm(dim=-1)
        d_trans = (coords_trans - grid).norm(dim=-1)
        v_full = (X1[..., 2] > projective.MIN_DEPTH).to(d_full.dtype)
        v_trans = (X1t[..., 2] > projective.MIN_DEPTH).to(d_full.dtype)
        accum = beta * (d_full * v_full).sum((1, 2)) \
            + (1 - beta) * (d_trans * v_trans).sum((1, 2))
        valid = beta * v_full.sum((1, 2)) + (1 - beta) * v_trans.sum((1, 2))
        frac = valid / (ht * wd + 1e-8)
        return torch.where(frac < 0.75, torch.full_like(accum, 1000.0),
                           accum / valid.clamp(min=1e-8))

    ii, jj = ii.long(), jj.long()
    out = [0.5 * (one_direction(ii[s:s + chunk], jj[s:s + chunk])
                  + one_direction(jj[s:s + chunk], ii[s:s + chunk]))
           for s in range(0, ii.shape[0], chunk)]
    return torch.cat(out)


def frame_distance_padded(state: VideoState, intrinsics: torch.Tensor, ii,
                          jj, beta: float = 0.3) -> np.ndarray:
    """Host edge lists -> host distances (one readback)."""
    dev = state.poses.device
    d = frame_distance(state, intrinsics,
                       torch.as_tensor(np.asarray(ii), device=dev),
                       torch.as_tensor(np.asarray(jj), device=dev), beta=beta)
    return d.cpu().numpy().astype(np.float32)


def get_poses_c2w(state: VideoState, n: int,
                  pose_compensate: Optional[torch.Tensor] = None,
                  first_gt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """w2c buffer poses [:n] -> c2w matrices with the reference's world
    alignment (depth_video.py:185-218): optional compensation pose, then
    alignment to the first GT pose with OpenGL column flips."""
    c2w = lie.inv(state.poses[:n])
    if pose_compensate is not None:
        c2w = lie.mul(pose_compensate[None], c2w)
    M = lie.matrix(c2w)
    if first_gt is not None:
        trans = first_gt.clone()
        trans[:3, 1:3] = -trans[:3, 1:3]
        M = torch.einsum("ij,njk->nik", trans, M)
        M[:, :3, 1:3] = -M[:, :3, 1:3]
    return M


def windowed_ba(state: VideoState, intrinsics: torch.Tensor,
                target: torch.Tensor, weight: torch.Tensor, ii: torch.Tensor,
                jj: torch.Tensor, mask: torch.Tensor, t0: int, t1: int,
                window: int = 32, iters: int = 2, lm: float = 1e-4,
                ep: float = 0.1, motion_only: bool = False,
                eps_damping: float = 1e-7) -> VideoState:
    """Dense BA over a `window`-slot slice ending at t1 (the start clipped
    into the buffer, video.py:347), written back in place. Edges with an
    endpoint outside the slice are masked out."""
    B = state.poses.shape[0]
    window = min(window, B)
    w0 = min(max(t1 - window, 0), max(B - window, 0))
    sl = slice(w0, w0 + window)

    ii_w, jj_w = ii.long() - w0, jj.long() - w0
    inb = (ii_w >= 0) & (ii_w < window) & (jj_w >= 0) & (jj_w < window)
    problem = ba_lib.BAProblem(
        target=target, weight=weight,
        eta=0.2 * state.damping[sl] + eps_damping,
        ii=ii_w.clamp(0, window - 1), jj=jj_w.clamp(0, window - 1),
        mask=mask * inb.to(mask.dtype))
    new_poses, new_disps = ba_lib.bundle_adjust(
        state.poses[sl], state.disps[sl], intrinsics, problem,
        disps_sens=state.disps_sens[sl], t0=t0 - w0, t1=t1 - w0,
        iters=iters, lm=lm, ep=ep, motion_only=motion_only)
    state.poses[sl] = new_poses
    state.disps[sl] = new_disps.clamp(min=0.001)  # depth_video.py:350
    return state
