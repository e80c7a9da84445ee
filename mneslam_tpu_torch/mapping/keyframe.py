"""Fixed-capacity keyframe ray database.

Port of `mneslam_tpu/mapping/keyframe.py`: a tensor of sampled rays per
keyframe `[num_kf, rays_per_kf, 7]` with layout (direction 3, rgb 3,
depth 1) and a slot count. The port updates the database in place. The
pixel and ray draws come from a `torch.Generator`; tests hand in the
indices instead (`idx=`), since torch cannot replay `jax.random`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass
class KeyframeDB:
    rays: torch.Tensor       # [num_kf, rays_per_kf, 7]
    frame_ids: torch.Tensor  # [num_kf] int32 dataset frame id (-1 = empty)
    count: int               # number of filled slots


def init_db(num_kf: int, rays_per_kf: int, device) -> KeyframeDB:
    return KeyframeDB(
        rays=torch.zeros((num_kf, rays_per_kf, 7), device=device),
        frame_ids=torch.full((num_kf,), -1, dtype=torch.int32, device=device),
        count=0)


def sample_pixels(generator: Optional[torch.Generator], depth: torch.Tensor,
                  n: int, filter_depth: bool = False,
                  depth_trunc: float = 100.0) -> torch.Tensor:
    """n pixel indices into depth.reshape(-1), with replacement: uniform
    over all pixels, or with `filter_depth` over pixels with
    0 < d <= depth_trunc (all pixels when a frame has none)."""
    n_pix = depth.numel()
    if filter_depth:
        z = depth.reshape(-1)
        valid = ((z > 0.0) & (z <= depth_trunc)).float()
        if bool(valid.sum() > 0):
            return torch.multinomial(valid, n, replacement=True,
                                     generator=generator)
    return torch.randint(0, n_pix, (n,), generator=generator,
                         device=depth.device)


def add_keyframe(db: KeyframeDB, generator: Optional[torch.Generator],
                 frame_id: int, direction: torch.Tensor, rgb: torch.Tensor,
                 depth: torch.Tensor, filter_depth: bool = False,
                 depth_trunc: float = 100.0,
                 idx: Optional[torch.Tensor] = None) -> KeyframeDB:
    """Store a ray sample of the frame in the next slot (in place).
    `idx` [rays_per_kf]: pixel indices to use instead of drawing them."""
    n = db.rays.shape[1]
    if db.count >= db.rays.shape[0]:
        raise ValueError(f"keyframe database full ({db.rays.shape[0]} slots)")
    if idx is None:
        idx = sample_pixels(generator, depth, n, filter_depth, depth_trunc)
    idx = idx.long()
    packed = torch.cat([direction.reshape(-1, 3)[idx],
                        rgb.reshape(-1, 3)[idx],
                        depth.reshape(-1)[idx][:, None]], dim=-1)
    db.rays[db.count] = packed
    db.frame_ids[db.count] = int(frame_id)
    db.count += 1
    return db


def sample_global_rays(db: KeyframeDB, generator: Optional[torch.Generator],
                       n: int, idx: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform sample over all stored rays -> (rays [n, 7], slot_ids [n]).
    `idx` [n]: flat ray indices to use instead of drawing them."""
    rays_per_kf = db.rays.shape[1]
    if idx is None:
        total = max(db.count * rays_per_kf, 1)
        idx = torch.randint(0, total, (n,), generator=generator,
                            device=db.rays.device)
    idx = idx.long()
    return db.rays.reshape(-1, 7)[idx], idx // rays_per_kf


def keyframe_selection_overlap(db_poses: torch.Tensor, rays_o: torch.Tensor,
                               rays_d: torch.Tensor, target_d: torch.Tensor,
                               intrinsics: torch.Tensor, H: int,
                               W: int) -> torch.Tensor:
    """Share of the current frame's back-projected points [R] (rays_o +
    rays_d * target_d, world) that each candidate keyframe (c2w poses
    [K, 4, 4], OpenGL: the camera looks down -z) sees inside its H x W
    image with depth above 0.01 (NICE-SLAM's selection) -> ratios [K];
    callers pick the top slots."""
    pts = rays_o + rays_d * target_d[:, None]
    w2c = torch.linalg.inv(db_poses)
    cam = torch.einsum("kij,rj->kri", w2c[:, :3, :3], pts) \
        + w2c[:, None, :3, 3]
    z = -cam[..., 2]
    fx, fy, cx, cy = (intrinsics[i] for i in range(4))
    u = fx * (cam[..., 0] / torch.clamp(z, min=1e-6)) + cx
    v = -fy * (cam[..., 1] / torch.clamp(z, min=1e-6)) + cy
    inb = (z > 0.01) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    return inb.float().mean(dim=1)
