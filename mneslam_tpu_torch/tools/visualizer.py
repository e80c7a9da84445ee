"""Offline run visualizer: trajectory plot, metric curves, mesh statistics.

    python -m mneslam_tpu_torch.tools.visualizer --run output/exp/agent_0 \
        [--gt gt_poses.npy]

Writes, inside <run>/vis/: the estimated-against-ground-truth trajectory
plot (from est_poses.npy; against itself without `--gt`) and the loss /
train-PSNR curves from metrics.jsonl; prints each PLY of <run>/mesh/ with
its vertex and face counts. Host only; needs matplotlib for the plots,
imported when one is drawn.

Port of the repository's `tools/visualizer.py`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run", required=True)
    ap.add_argument("--gt", default=None)
    args = ap.parse_args(argv)

    from ..ops import mc
    from ..utils.vis import save_trajectory_plot

    out = os.path.join(args.run, "vis")
    os.makedirs(out, exist_ok=True)
    lines = []

    def say(line):
        print(line)
        lines.append(line)

    est_path = os.path.join(args.run, "est_poses.npy")
    if os.path.exists(est_path):
        est = np.load(est_path)
        gt = np.load(args.gt) if args.gt else est
        save_trajectory_plot(os.path.join(out, "trajectory.png"),
                             gt[:, :3, 3], est[:, :3, 3])
        say(f"trajectory plot -> {out}/trajectory.png ({len(est)} poses)")

    metrics_path = os.path.join(args.run, "metrics.jsonl")
    if os.path.exists(metrics_path):
        steps, loss, psnr = [], [], []
        with open(metrics_path) as f:
            for line in f:
                rec = json.loads(line)
                if "loss" in rec:
                    steps.append(rec["step"])
                    loss.append(rec["loss"])
                    psnr.append(rec.get("psnr", float("nan")))
        if steps:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, (a1, a2) = plt.subplots(1, 2, figsize=(10, 4))
            a1.plot(steps, loss)
            a1.set_title("mapping loss")
            a1.set_yscale("log")
            a2.plot(steps, psnr)
            a2.set_title("train PSNR (dB)")
            fig.savefig(os.path.join(out, "curves.png"), dpi=110,
                        bbox_inches="tight")
            plt.close(fig)
            say(f"metric curves -> {out}/curves.png ({len(steps)} "
                f"keyframes)")

    mesh_dir = os.path.join(args.run, "mesh")
    if os.path.isdir(mesh_dir):
        for name in sorted(os.listdir(mesh_dir)):
            if name.endswith(".ply"):
                v, f, c = mc.load_ply(os.path.join(mesh_dir, name))
                say(f"mesh {name}: {len(v)} verts, {len(f)} faces, "
                    f"colors={'yes' if c is not None else 'no'}")
    return lines


if __name__ == "__main__":
    main()
