"""Procedural box-room RGB-D sequence for tests and chip runs.

Port of `mneslam_tpu/data/synthetic.py`: an analytic textured box viewed
from a smooth interior trajectory, with exact z-buffer depth from ray-box
intersection. Frames are rendered with numpy on the host; no files needed,
fully deterministic.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .rays import get_camera_rays


def _box_room_color(pts: np.ndarray, half: float) -> np.ndarray:
    """Smooth per-wall color pattern for hit points [..., 3]."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    base = np.stack(
        [
            0.5 + 0.45 * np.sin(2.1 * x + 0.7),
            0.5 + 0.45 * np.sin(1.7 * y + 2.9),
            0.5 + 0.45 * np.sin(2.5 * z + 1.3),
        ],
        axis=-1,
    )
    # face id tint: which axis the hit lies on
    ax = np.argmax(np.abs(pts) / half, axis=-1)
    tint = np.asarray([[1.0, 0.7, 0.7], [0.7, 1.0, 0.7], [0.7, 0.7, 1.0]])
    return np.clip(base * tint[ax], 0.0, 1.0)


class SyntheticBoxDataset:
    """RGB-D frames of a textured box room [-half, half]^3, camera rotating
    near the center.

    Items: frame_id, c2w [4,4] (OpenGL), rgb [H,W,3] in [0,1], depth [H,W]
    (z-buffer, meters), direction [H,W,3] — numpy float32 arrays, the same
    dict as the JAX package's datasets."""

    def __init__(self, config, num_frames: int = 24, half: float = 2.0):
        cam = config["cam"]
        self.H, self.W = cam["H"], cam["W"]
        self.fx, self.fy = cam["fx"], cam["fy"]
        self.cx, self.cy = cam["cx"], cam["cy"]
        self.num_frames = num_frames
        self.half = half
        self.rays_d_cam = get_camera_rays(self.H, self.W, self.fx, self.fy,
                                          self.cx, self.cy).numpy()
        n_pix = config["mapping"].get("n_pixels", 0.05)
        self.num_rays_to_save = int(self.H * self.W * n_pix)
        self.poses = [self.c2w(i) for i in range(num_frames)]

    def c2w(self, idx: int) -> np.ndarray:
        """Smooth yaw rotation + small circular translation."""
        t = idx / max(self.num_frames - 1, 1)
        yaw = 2.0 * np.pi * t * 0.75
        pitch = 0.15 * np.sin(2 * np.pi * t)
        cy_, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        Ry = np.asarray([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
        Rx = np.asarray([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        R = Ry @ Rx
        pos = np.asarray([0.5 * np.cos(yaw), 0.2 * np.sin(2 * yaw),
                          0.5 * np.sin(yaw)])
        c2w = np.eye(4)
        c2w[:3, :3] = R
        c2w[:3, 3] = pos
        return c2w

    def render_frame(self, idx: int):
        c2w = self.poses[idx]
        dirs = self.rays_d_cam @ c2w[:3, :3].T          # [H, W, 3] world
        o = c2w[:3, 3]
        # ray-box intersection from inside: first positive exit t per axis
        with np.errstate(divide="ignore"):
            t_exit = np.where(
                dirs > 0, (self.half - o) / dirs,
                np.where(dirs < 0, (-self.half - o) / dirs, np.inf),
            )
        t_hit = np.min(t_exit, axis=-1)                  # [H, W]
        pts = o + dirs * t_hit[..., None]
        rgb = _box_room_color(pts, self.half)
        # z-buffer depth: dirs_cam z component is -1, so depth == t_hit
        depth = t_hit.astype(np.float32)
        return rgb.astype(np.float32), depth, c2w

    def __len__(self):
        return self.num_frames

    def __getitem__(self, idx: int) -> Dict:
        rgb, depth, c2w = self.render_frame(idx)
        return {
            "frame_id": idx,
            "c2w": c2w.astype(np.float32),
            "rgb": rgb,
            "depth": depth,
            "direction": self.rays_d_cam,
        }
