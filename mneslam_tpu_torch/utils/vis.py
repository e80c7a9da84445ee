"""Render panels and trajectory plots (matplotlib, imported when used).

Port of `mneslam_tpu/utils/vis.py`: a 2 x 3 panel per mapped keyframe (GT
depth, rendered depth, depth residual / GT rgb, rendered rgb, rgb
residual) written as JPG, and a top-down trajectory plot.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def save_render_panel(
    path: str,
    gt_rgb: np.ndarray,      # [H, W, 3]
    gt_depth: np.ndarray,    # [H, W]
    rend_rgb: np.ndarray,
    rend_depth: np.ndarray,
    title: Optional[str] = None,
):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    depth_res = np.abs(gt_depth - rend_depth)
    depth_res[gt_depth == 0] = 0.0
    rgb_res = np.abs(gt_rgb - rend_rgb).mean(-1)
    max_d = max(float(gt_depth.max()), 1e-6)

    fig, axes = plt.subplots(2, 3, figsize=(12, 6))
    panels = [
        (gt_depth, "GT depth", "plasma", (0, max_d)),
        (rend_depth, "rendered depth", "plasma", (0, max_d)),
        (depth_res, "depth residual", "plasma", (0, 0.3 * max_d)),
        (gt_rgb, "GT rgb", None, None),
        (np.clip(rend_rgb, 0, 1), "rendered rgb", None, None),
        (rgb_res, "rgb residual", "magma", (0, 0.5)),
    ]
    for ax, (img, name, cmap, clim) in zip(axes.reshape(-1), panels):
        if cmap is None:
            ax.imshow(img)
        else:
            im = ax.imshow(img, cmap=cmap)
            if clim:
                im.set_clim(*clim)
        ax.set_title(name, fontsize=9)
        ax.axis("off")
    if title:
        fig.suptitle(title, fontsize=10)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fig.savefig(path, dpi=90, bbox_inches="tight")
    plt.close(fig)


def save_trajectory_plot(path: str, gt_xyz: np.ndarray, est_xyz: np.ndarray,
                         plane=(0, 2)):
    """Top-down plot of the ground-truth and estimated trajectories."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    a, b = plane
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(gt_xyz[:, a], gt_xyz[:, b], "k-", lw=1, label="ground truth")
    ax.plot(est_xyz[:, a], est_xyz[:, b], "b-", lw=1, label="estimated")
    ax.legend()
    ax.set_aspect("equal")
    ax.set_xlabel("xyz"[a] + " [m]")
    ax.set_ylabel("xyz"[b] + " [m]")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
