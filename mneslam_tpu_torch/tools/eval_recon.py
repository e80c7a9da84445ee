"""Reconstruction metrics of a mesh against a ground-truth mesh.

    python -m mneslam_tpu_torch.tools.eval_recon --rec mesh.ply --gt gt.ply \
        [--cull poses.npy --intr fx,fy,cx,cy --hw H,W] [--n 200000] \
        [--dist_th 0.05] [--align [--icp_threshold 0.1]] [--device cuda|cpu]

Prints accuracy (cm), completion (cm) and completion ratio (%). Port of the
repository's `tools/eval_recon.py`. `--cull` first drops the vertices that
no keyframe of the c2w poses sees (frustum only), counted on `--device`
(default cuda, which raises when no GPU is visible; cpu only when asked).
The metrics themselves run on the host.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rec", required=True)
    ap.add_argument("--gt", required=True)
    ap.add_argument("--n", type=int, default=200000)
    ap.add_argument("--dist_th", type=float, default=0.05)
    ap.add_argument("--cull", default=None,
                    help="keyframe c2w .npy for frustum culling")
    ap.add_argument("--intr", default=None, help="fx,fy,cx,cy")
    ap.add_argument("--hw", default=None, help="H,W")
    ap.add_argument("--align", action="store_true",
                    help="rigid ICP registration onto the GT first")
    ap.add_argument("--icp_threshold", type=float, default=0.1)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the culling counts (default cuda; "
                         "cpu only when asked)")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..eval import recon
    from ..mapping.cull import cull_mesh
    from ..ops import mc

    rec_v, rec_f, _ = mc.load_ply(args.rec)
    gt_v, gt_f, _ = mc.load_ply(args.gt)
    if args.cull:
        poses = np.load(args.cull)
        intr = np.asarray([float(x) for x in args.intr.split(",")])
        H, W = (int(x) for x in args.hw.split(","))
        rec_v, rec_f, _ = cull_mesh(rec_v, rec_f, poses, intr, H, W,
                                    device=resolve_device(args.device))
        print(f"culled mesh: {len(rec_v)} verts, {len(rec_f)} faces")
    m = recon.eval_mesh(rec_v, rec_f, gt_v, gt_f, n_samples=args.n,
                        dist_th=args.dist_th, align=args.align,
                        icp_threshold=args.icp_threshold)
    for k, v in m.items():
        print(f"{k}: {v:.3f}")
    return m


if __name__ == "__main__":
    main()
