"""Camera frusta and trajectory in 3D (matplotlib, headless).

    python -m mneslam_tpu_torch.tools.vis_cameras \
        --poses output/exp/agent_0/key_est_poses.npy [--gt gt_poses.npy] \
        [--bound "[[-4,4],[-4,4],[-4,4]]"] [--every 5] [--scale S] \
        [--out cameras.png]

Poses are [N, 4, 4] c2w stacks (OpenGL convention, -z forward). Draws a
wire frustum every `--every` poses, the camera-centre trajectory, the
ground truth's in red where given, and an optional scene-bound cuboid
(the reference's draw_cuboid / draw_camera). Host only; needs matplotlib,
imported when the plot is drawn.

Port of the repository's `tools/vis_cameras.py`.
"""

from __future__ import annotations

import argparse
import ast

import numpy as np

FRUSTUM = np.asarray([
    [0.0, 0.0, 0.0],
    [-1.0, -0.75, -2.0],
    [1.0, -0.75, -2.0],
    [1.0, 0.75, -2.0],
    [-1.0, 0.75, -2.0],
])
FRUSTUM_EDGES = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
CUBOID_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
                (0, 4), (1, 5), (2, 6), (3, 7)]


def add_frusta(ax, poses, scale: float, color: str, every: int, label: str):
    """A wire frustum on `ax` for every `every`-th pose, then the centres'
    polyline; the first segment carries `label`."""
    for n, c2w in enumerate(poses):
        if n % every:
            continue
        pts = (FRUSTUM * scale) @ c2w[:3, :3].T + c2w[:3, 3]
        for a, b in FRUSTUM_EDGES:
            ax.plot(*zip(pts[a], pts[b]), color=color, linewidth=0.6,
                    label=label if (n == 0 and a == 0 and b == 1) else None)
    centers = poses[:, :3, 3]
    ax.plot(centers[:, 0], centers[:, 1], centers[:, 2], color=color,
            linewidth=1.2, alpha=0.8)


def add_cuboid(ax, bound):
    """The 12 edges of the box `bound` [[x0, x1], [y0, y1], [z0, z1]]."""
    b = np.asarray(bound, float)
    corners = np.asarray([[b[0, i], b[1, j], b[2, k]]
                          for k in (0, 1) for j in (0, 1) for i in (0, 1)])
    corners = corners[[0, 1, 3, 2, 4, 5, 7, 6]]
    for a, c in CUBOID_EDGES:
        ax.plot(*zip(corners[a], corners[c]), color="green", linewidth=0.8)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--poses", required=True, help="[N,4,4] c2w .npy")
    ap.add_argument("--gt", default=None, help="optional GT [N,4,4] .npy")
    ap.add_argument("--bound", default=None,
                    help='e.g. "[[-4,4],[-4,4],[-4,4]]"')
    ap.add_argument("--every", type=int, default=5, help="frustum stride")
    ap.add_argument("--scale", type=float, default=None, help="frustum size")
    ap.add_argument("--out", default="cameras.png")
    args = ap.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    poses = np.load(args.poses)
    assert poses.ndim == 3 and poses.shape[1:] == (4, 4), poses.shape
    scale = args.scale
    if scale is None:
        span = np.ptp(poses[:, :3, 3], axis=0).max()
        scale = max(0.02, 0.03 * span)

    fig = plt.figure(figsize=(9, 9))
    ax = fig.add_subplot(projection="3d")
    add_frusta(ax, poses, scale, "tab:blue", args.every, "estimated")
    if args.gt:
        add_frusta(ax, np.load(args.gt), scale, "tab:red", args.every, "gt")
    if args.bound:
        add_cuboid(ax, ast.literal_eval(args.bound))
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.legend(loc="upper right")
    ax.set_title(f"{poses.shape[0]} cameras (frustum every {args.every})")
    # equal aspect around the centres
    centers = poses[:, :3, 3]
    mid = centers.mean(0)
    r = max(np.ptp(centers, axis=0).max() / 2, 1e-3) * 1.4
    ax.set_xlim(mid[0] - r, mid[0] + r)
    ax.set_ylim(mid[1] - r, mid[1] + r)
    ax.set_zlim(mid[2] - r, mid[2] + r)
    fig.savefig(args.out, dpi=130, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
