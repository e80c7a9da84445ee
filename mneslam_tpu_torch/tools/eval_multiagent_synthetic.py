"""Two-agent end-to-end SLAM on the synthetic box room.

    python -m mneslam_tpu_torch.tools.eval_multiagent_synthetic \
        [--frames 60] [--hw 240,320] [--fast] [--device cuda|cpu]

Two agents on overlapping segments of one trajectory, agent 1's world
frame rigidly biased (`--bias_rot_deg` adds a yaw); interleaved SLAM
(`agents/runner.MultiAgentRunner.run_slam`) with descriptor exchange, the
render-based inter-agent loop closure mid-run, the trajectory's SLERP
deformation, bound-overlap fusion and distillation at the end, and each
agent's terminate (mesh, trajectory filler, Sim(3) APE). The trackers'
update gets ground-truth reprojection targets (`eval_slam_synthetic`'s
oracle); everything else is the production path. Prints one JSON report:
each agent's APE, the closure's keyframe errors against the biased
control, and the wall clock. Runs on the GPU unless `--device cpu` is
given.

Port of the repository's `tools/eval_multiagent_synthetic.py`.
"""

from __future__ import annotations

import json
import time

import numpy as np

from ..config import make_config
from .eval_slam_synthetic import camera, oracle, parser


class Slice:
    """Frames lo..hi-1 of `ds`, ids from 0, c2w left-multiplied by `bias`."""

    def __init__(self, ds, lo, hi, bias=None):
        self.ds, self.lo, self.n = ds, lo, hi - lo
        self.bias = bias
        self.num_rays_to_save = ds.num_rays_to_save

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        item = dict(self.ds[self.lo + i])
        item["frame_id"] = i
        if self.bias is not None:
            item["c2w"] = self.bias @ np.asarray(item["c2w"])
        return item


def agent_config(args, H: int, W: int):
    return make_config({
        "mode": "slam",
        "data": {"output": args.out, "exp_name": "ma"},
        "mapping": {
            "bound": [[-2.4, 2.4]] * 3,
            "marching_cubes_bound": [[-2.1, 2.1]] * 3,
            "sample": 2048, "min_pixels_cur": 100, "first_iters": 200,
            "iters": 25 if args.fast else 50,
            "keyframe_every": 5, "global_ba_every": 1000,
            "loop_iters": 100, "distill_iters": 100,
            "lr_rot": 0.005, "lr_trans": 0.01,
        },
        "planes_res": {"coarse": 0.08, "fine": 0.04, "bound_dividable": 0.08},
        "cam": camera(H, W),
        "training": {"n_range_d": 11, "n_samples_d": 8 if args.fast else 32,
                     "range_d": 0.1, "trunc": 0.1,
                     "render_dtype": "bfloat16" if args.fast else "float32"},
        "model": {"c_dim": 32, "input_ch": 64, "input_ch_pos": 48,
                  "truncation": 0.1},
        "meshing": {"resolution": 0.04},
        "tracking": {
            "buffer": args.frames + 2, "warmup": 8, "upsample": False,
            "motion_filter": {"thresh": -1.0},
            "frontend": {"enable_loop": False, "keyframe_thresh": -1.0,
                         "window": 25, "radius": 1, "max_factors": 75,
                         "nms": 0, "thresh": 25.0},
            "backend": {"thresh": 25.0, "radius": 1, "nms": 2,
                        "loop_window": 25, "loop_thresh": 25.0,
                        "loop_radius": 1, "loop_nms": 2},
        },
        "loop_detection": {"enabled": True, "sim_threshold": 0.9,
                           "min_time_diff": 50, "loop_launch_th": 2,
                           "min_matches_for_fusion": 1},
        "loop_bound": {"bound_0": [[-2.4, 2.4]] * 3,
                       "bound_1": [[-2.4, 2.4]] * 3},
        "loop_closure": {"pose_decay_sigma": 50.0,
                         "pose_decay_min_weight": 0.8,
                         "mode": args.closure_mode,
                         "map_aligned": args.map_aligned},
    })


def bias_transform(bias_rot_deg: float) -> np.ndarray:
    """Agent 1's world bias: a (0.15, -0.10, 0) m shift, then the yaw."""
    bias = np.eye(4, dtype=np.float32)
    bias[0, 3] = 0.15
    bias[1, 3] = -0.10
    if bias_rot_deg:
        th = np.deg2rad(bias_rot_deg)
        bias[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
    return bias


def main(argv=None) -> dict:
    ap = parser("eval_ma")
    ap.description = __doc__.split("\n")[0]
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--hw", default="240,320")
    ap.add_argument("--fast", action="store_true",
                    help="the fast mapping profile (8 depth samples, 25 "
                    "iterations, bf16: the room0_fast.yaml defaults)")
    ap.add_argument("--bias_rot_deg", type=float, default=0.0,
                    help="also rotate agent 1's world frame by this yaw "
                    "(deg)")
    ap.add_argument("--closure_mode", choices=["gated", "reference"],
                    default="gated",
                    help="loop_closure.mode: 'gated' (acceptance gate and "
                    "best closure wins) or 'reference' (every closure "
                    "applied, as the reference does)")
    ap.add_argument("--map_aligned", action="store_true",
                    help="loop_closure.map_aligned: feed the deformed "
                    "trajectory back into the agent's own map; the report "
                    "adds map_kf_err_m")
    args = ap.parse_args(argv)

    from ..agents.runner import MultiAgentRunner
    from ..data.synthetic import SyntheticBoxDataset
    from ..device import resolve_device
    from ..slam import MNESLAM

    device = resolve_device(args.device)
    H, W = (int(x) for x in args.hw.split(","))
    full = SyntheticBoxDataset(agent_config(args, H, W),
                               num_frames=args.frames)
    bias = bias_transform(args.bias_rot_deg)

    # agent 0 covers the later segment (publishes the overlap first);
    # agent 1 starts at 0 in a biased world frame and must close the loop
    third = args.frames // 3
    slices = [Slice(full, third, args.frames),
              Slice(full, 0, 2 * third, bias=bias)]
    agents = []
    for rank, sl in enumerate(slices):
        update_fn, agg_fn = oracle(sl, H, W, device)
        agents.append(MNESLAM(agent_config(args, H, W), sl, rank=rank,
                              world_size=2, device=device,
                              update_fn=update_fn, agg_fn=agg_fn))

    runner = MultiAgentRunner(agents)
    t0 = time.perf_counter()
    results = runner.run_slam()
    wall = time.perf_counter() - t0

    a1 = agents[1]
    report = {
        "frames": args.frames, "resolution": f"{H}x{W}",
        "fast": args.fast, "closure_mode": args.closure_mode,
        "bias_rot_deg": args.bias_rot_deg,
        "wall_s": round(wall, 1),
        "apes_m": [r.get("ate", {}).get("rmse") for r in results],
        "keyframes": [a.tracker.counter for a in agents],
        "mapped": [a.map_counter for a in agents],
        "closure_fired": 0 in a1.collab.fused_agents,
        "fused_agents": [sorted(a.collab.fused_agents) for a in agents],
    }
    aligned = a1.collab.aligned_poses_c2w
    if aligned is not None:
        n = len(aligned)
        # agent 1's slice starts at frame 0 of the full sequence, so its
        # local timestamps index `full` directly
        true_pos = np.stack([np.asarray(full[int(ts)]["c2w"])[:3, 3]
                             for ts in a1.mapped_timestamps[:n]])
        biased_pos = true_pos @ bias[:3, :3].T + bias[:3, 3]
        aligned_pos = np.asarray(aligned)[:, :3, 3]
        report["kf_err_biased_control_m"] = round(float(
            np.linalg.norm(biased_pos - true_pos, axis=1).mean()), 4)
        report["kf_err_after_closure_m"] = round(float(
            np.linalg.norm(aligned_pos - true_pos, axis=1).mean()), 4)
        # the private map's keyframe poses: with map_aligned they carry the
        # closure's correction (about kf_err_after_closure); without, the
        # map stays in the biased tracker world (about
        # kf_err_biased_control)
        map_pos = a1.map_state.kf_poses[:n].cpu().numpy()[:, :3, 3]
        report["map_aligned"] = args.map_aligned
        report["map_kf_err_m"] = round(float(
            np.linalg.norm(map_pos - true_pos, axis=1).mean()), 4)
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
