"""Camera ray generation (OpenGL convention, -z forward).

Port of `mneslam_tpu/data/rays.py`: camera-frame directions
((i-cx)/fx, -(j-cy)/fy, -1) per pixel, rotated into the world by c2w poses.
"""

from __future__ import annotations

import torch


def get_camera_rays(H: int, W: int, fx: float, fy: float, cx: float,
                    cy: float, device="cpu") -> torch.Tensor:
    """Camera-frame ray directions [H, W, 3] float32, OpenGL (-z forward,
    y up)."""
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device),
        torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)],
                       dim=-1)


def rays_from_pose(directions: torch.Tensor, c2w: torch.Tensor):
    """Rotate camera-frame directions [N, 3] by pose(s).

    c2w may be [4, 4] (one pose for all rays) or [N, 4, 4] (per-ray poses,
    as when sampling the global keyframe ray set). Returns (rays_o, rays_d),
    each [N, 3]."""
    if c2w.dim() == 2:
        rays_d = directions @ c2w[:3, :3].T
        rays_o = c2w[:3, 3].expand_as(rays_d)
    else:
        rays_d = torch.einsum("nc,nrc->nr", directions, c2w[:, :3, :3])
        rays_o = c2w[:, :3, 3]
    return rays_o, rays_d
