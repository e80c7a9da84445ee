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
    dict as the JAX package's datasets.

    Each frame is rendered once and kept: a SLAM run reads a frame several
    times (tracking, mapping, the trajectory filler, the pose table and
    the observed space at terminate), and ray-casting a 680 x 1200 frame
    on the host costs about as much as mapping it. The cost is host memory:
    about 13 MB a frame at 680 x 1200 (rgb and depth in float32), about
    1 GB for 80 frames. Every call returns a fresh dict (callers set its
    keys, e.g. "frame_id"), and its arrays, shared with the memo, are
    read-only."""

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
        self.rays_d_cam.setflags(write=False)
        self._frames: Dict[int, tuple] = {}

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
        if idx not in self._frames:
            rgb, depth, c2w = self.render_frame(idx)
            arrays = (c2w.astype(np.float32), rgb, depth)
            for a in arrays:
                a.setflags(write=False)
            self._frames[idx] = arrays
        c2w, rgb, depth = self._frames[idx]
        return {
            "frame_id": idx,
            "c2w": c2w,
            "rgb": rgb,
            "depth": depth,
            "direction": self.rays_d_cam,
        }


# write_tum_sequence's clock: the first frame's stamp (s), the frame
# spacing and the ground truth's spacing (100 Hz, as TUM's)
TUM_T0, TUM_DT, TUM_GT_DT = 1305031102.0, 0.05, 0.01


def write_tum_sequence(ds: SyntheticBoxDataset, out_dir: str,
                       png_depth_scale: float = 5000.0) -> Dict:
    """Write the box room's frames as a TUM RGB-D folder: `rgb/*.png`
    (8-bit), `depth/*.png` (uint16, metres x png_depth_scale), `rgb.txt`,
    `depth.txt` (each depth stamp 10-20 ms after its colour frame's, so
    nearer its own frame than any other at TUM_DT = 50 ms) and
    `groundtruth.txt` (`t tx ty tz qx qy qz qw`, one pose every TUM_GT_DT
    s; frame i at TUM_T0 + i TUM_DT, a multiple of TUM_GT_DT, so each
    frame has a pose at its own stamp). The poses are the stored (OpenCV)
    ones: the TUM loader's Y / Z column flips give back `ds.c2w`. One
    colour frame more, 0.2 s after the last, has no depth within 0.08 s
    and must be dropped by the loader's association. -> {"frames": associated frames,
    "rgb_lines", "gt_lines"}."""
    import os

    import torch

    from ..ops import lie
    from .image_io import write_png

    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    n = len(ds)
    rgb_lines, depth_lines = [], []
    for i in range(n):
        rgb, depth, _ = ds.render_frame(i)
        t = TUM_T0 + i * TUM_DT
        name = f"{t:.6f}.png"
        write_png(os.path.join(out_dir, "rgb", name),
                  np.round(rgb[..., ::-1] * 255.0).astype(np.uint8))
        write_png(os.path.join(out_dir, "depth", name),
                  np.clip(np.round(depth * png_depth_scale), 0,
                          65535).astype(np.uint16))
        rgb_lines.append(f"{t:.6f} rgb/{name}")
        depth_lines.append(f"{t + 0.010 + 0.010 * (i % 3) / 2:.6f} "
                           f"depth/{name}")
    # a colour frame without depth: dropped by the association
    t_extra = TUM_T0 + (n - 1) * TUM_DT + 0.2
    write_png(os.path.join(out_dir, "rgb", f"{t_extra:.6f}.png"),
              np.zeros((ds.H, ds.W, 3), np.uint8))
    rgb_lines.append(f"{t_extra:.6f} rgb/{t_extra:.6f}.png")

    step = int(round(TUM_DT / TUM_GT_DT))
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    gt_lines = []
    for k in range((n - 1) * step + 1):
        c2w = ds.c2w(k / step) @ flip
        q = lie.matrix_to_quat(torch.tensor(c2w[:3, :3])).numpy()
        gt_lines.append(f"{TUM_T0 + k * TUM_GT_DT:.6f} " + " ".join(
            f"{v:.9f}" for v in (*c2w[:3, 3], *q)))
    for name, lines, what in (("rgb.txt", rgb_lines, "color images"),
                              ("depth.txt", depth_lines, "depth maps"),
                              ("groundtruth.txt", gt_lines,
                               "ground truth trajectory")):
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(f"# {what}\n# timestamp data\n" + "\n".join(lines)
                    + "\n")
    return {"frames": n, "rgb_lines": len(rgb_lines),
            "gt_lines": len(gt_lines)}
