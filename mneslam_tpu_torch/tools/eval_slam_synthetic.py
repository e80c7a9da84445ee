"""End-to-end SLAM on the synthetic box room, with quality and stage times.

    python -m mneslam_tpu_torch.tools.eval_slam_synthetic [--frames 40] \
        [--hw 320,640] [--random-weights] [--device cuda|cpu]

The tracker's update gets ground-truth reprojection targets (the oracle:
trained droid.pth weights are an external input); everything else is the
production path: the motion filter, the frontend's updates, windowed BA
with the RGB-D prior, lagged mapping, the trajectory filler and the Sim(3)
APE. `--random-weights` runs the real DROID update with random weights
instead: no quality claim, but the learned tracker's whole compute path at
realistic shapes, and the run asserts that every pose and disparity stays
finite. Prints one JSON report with the stage times. Runs on the GPU unless
`--device cpu` is given.

Port of the repository's `tools/eval_slam_synthetic.py`; its oracle is
`validate_dataset.oracle_fns`.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from ..config import make_config


def parser(out_name: str) -> argparse.ArgumentParser:
    """The flags this tool shares with `eval_multiagent_synthetic`
    (`--out` defaults to <temp dir>/<out_name>)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  out_name))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    return ap


def camera(H: int, W: int) -> dict:
    """The tools' pinhole camera: fx = fy = W / 2, centred, tracked at full
    resolution."""
    fx = W / 2.0
    return {"H": H, "W": W, "fx": fx, "fy": fx, "cx": W / 2 - 0.5,
            "cy": H / 2 - 0.5, "H_out": H, "W_out": W, "near": 0.0,
            "far": 8.0}


def intr8(H: int, W: int) -> list:
    """The camera's intrinsics at 1/8 of the tracking resolution."""
    fx = W / 2.0
    return [fx / 8, fx / 8, (W / 2 - 0.5) / 8, (H / 2 - 0.5) / 8]


def oracle(ds, H: int, W: int, device):
    """(update_fn, agg_fn) of the oracle tracker on `ds`."""
    from .validate_dataset import oracle_fns

    return oracle_fns(ds, intr8(H, W), device)


def slam_config(args, H: int, W: int):
    return make_config({
        "mode": "slam",
        "data": {"output": args.out, "exp_name": "eval"},
        "mapping": {
            "bound": [[-2.2, 2.2]] * 3,
            "marching_cubes_bound": [[-2.05, 2.05]] * 3,
            "sample": 2048, "min_pixels_cur": 100, "first_iters": 200,
            "iters": 25 if args.fast else 50,
            "keyframe_every": 5, "global_ba_every": args.global_ba_every,
        },
        "planes_res": {"coarse": 0.08, "fine": 0.04, "bound_dividable": 0.08},
        "cam": camera(H, W),
        "training": {"n_range_d": 11, "n_samples_d": 8 if args.fast else 32,
                     "range_d": 0.1, "trunc": 0.1},
        "model": {"c_dim": 32, "input_ch": 64, "input_ch_pos": 48,
                  "truncation": 0.1},
        "meshing": {"resolution": 0.04},
        "tracking": {
            "buffer": args.buffer or args.frames + 2, "warmup": 8,
            "upsample": False,
            "motion_filter": {"thresh": args.thresh},
            "frontend": {"enable_loop": args.enable_loop,
                         "keyframe_thresh": -1.0,
                         "window": 25, "radius": 1, "max_factors": 75,
                         "nms": 0, "thresh": 25.0},
            "backend": {"thresh": 25.0, "radius": 1, "nms": 2,
                        "loop_window": 25, "loop_thresh": 25.0,
                        "loop_radius": 1, "loop_nms": 2},
        },
        "loop_detection": {"enabled": False},
    })


def main(argv=None) -> dict:
    ap = parser("eval_slam")
    ap.description = __doc__.split("\n")[0]
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--hw", default="320,640")
    ap.add_argument("--random-weights", action="store_true",
                    help="run the real DROID update with random weights "
                    "instead of the oracle; asserts every pose and "
                    "disparity stays finite")
    ap.add_argument("--thresh", type=float, default=-1.0,
                    help="motion-filter admission threshold in px (-1 = "
                    "admit every frame; 4.0 = the reference's Replica / "
                    "ScanNet setting)")
    ap.add_argument("--buffer", type=int, default=0,
                    help="keyframe buffer size (0 = frames + 2)")
    ap.add_argument("--global-ba-every", type=int, default=1000,
                    help="full-history dense BA every N admitted keyframes")
    ap.add_argument("--enable-loop", action="store_true",
                    help="the frontend's windowed loop BA")
    ap.add_argument("--fast", action="store_true",
                    help="the fast mapping profile (8 depth samples, 25 "
                    "iterations)")
    args = ap.parse_args(argv)

    from ..data.synthetic import SyntheticBoxDataset
    from ..device import resolve_device
    from ..slam import MNESLAM

    device = resolve_device(args.device)
    H, W = (int(x) for x in args.hw.split(","))
    cfg = slam_config(args, H, W)
    ds = SyntheticBoxDataset(cfg, num_frames=args.frames)
    update_fn = agg_fn = None
    if not args.random_weights:
        update_fn, agg_fn = oracle(ds, H, W, device)

    slam = MNESLAM(cfg, ds, rank=0, device=device, update_fn=update_fn,
                   agg_fn=agg_fn)
    t0 = time.perf_counter()
    results = slam.run_slam()
    wall = time.perf_counter() - t0

    if args.random_weights:
        n = slam.tracker.counter
        poses = slam.tracker.state.poses[:n].cpu().numpy()
        disps = slam.tracker.state.disps[:n].cpu().numpy()
        assert np.isfinite(poses).all(), "non-finite poses with real GRU"
        assert np.isfinite(disps).all(), "non-finite disparities with real GRU"
        print(f"real-GRU path finite over {n} keyframes "
              f"(|t| max {np.abs(poses[:, :3]).max():.2f} m)")

    report = {
        "frames": args.frames,
        "resolution": f"{H}x{W}",
        "keyframes": slam.tracker.counter,
        "mapped": slam.map_counter,
        "ate_rmse_m": results.get("ate", {}).get("rmse"),
        "mesh_verts": results.get("mesh_verts"),
        "final_train_psnr_db": (slam.metrics_log[-1]["psnr"]
                                if slam.metrics_log else None),
        "wall_s": round(wall, 1),
        "end_to_end_fps": round(args.frames / wall, 2),
        "stage_timers": slam.timers.summary(),
    }
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
