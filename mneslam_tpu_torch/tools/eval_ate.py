"""Trajectory error of an estimated trajectory against ground truth.

    python -m mneslam_tpu_torch.tools.eval_ate --est est_poses.npy \
        --gt gt_poses.npy [--sim3] [--plot traj.png]

Both files hold [N, 4, 4] c2w stacks; the first min(N_est, N_gt) poses are
compared after a Horn (SE(3), the ATE) or, with `--sim3`, an Umeyama
(Sim(3), evo's APE) alignment. Prints rmse / mean / median / std / min /
max in the trajectory's units and n, and returns them. Port of the
repository's `tools/eval_ate.py`; `--plot` needs matplotlib.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--est", required=True)
    ap.add_argument("--gt", required=True)
    ap.add_argument("--sim3", action="store_true",
                    help="Umeyama Sim(3) alignment (evo APE)")
    ap.add_argument("--plot", default=None)
    args = ap.parse_args(argv)

    from ..eval import ate

    est = np.load(args.est)
    gt = np.load(args.gt)
    m = ate.evaluate_ate(gt, est, alignment="sim3" if args.sim3 else "se3")
    for k, v in m.items():
        print(f"{k}: {v}")
    if args.plot:
        from ..utils.vis import save_trajectory_plot

        n = min(len(gt), len(est))
        save_trajectory_plot(args.plot, gt[:n, :3, 3], est[:n, :3, 3])
        print(f"plot -> {args.plot}")
    return m


if __name__ == "__main__":
    main()
