"""Profile a target step with torch.profiler and print its top ops.

    python -m mneslam_tpu_torch.tools.trace_ops mapping [TOP_K] \
        [--device cuda|cpu]      # the mapper's optimize (kernel 1)
    python -m mneslam_tpu_torch.tools.trace_ops frontend [TOP_K] \
        [--device cuda|cpu]      # the frontend's graph.update (kernel 2)

The step runs once to warm up, then once under torch.profiler. The table
lists the top TOP_K (default 30) entries of `key_averages()` by self time:
on a GPU the device kernels by `self_device_time_total`, on the CPU the ops
by self CPU time, each in ms per rep and as a share of the total. The
shapes are the repository's `tools/trace_ops.py`'s: mapping at 320 x 640,
2048 + 100 rays, 0.04 / 0.02 m planes over a 4 m bound, 10 iterations a
rep; the frontend at 320 x 640, a buffer of 64, 75 edges over 26
keyframes, 4 updates of 2 iterations, random DROID weights (bf16 on a
GPU). Runs on the GPU unless `--device cpu` is given; run it in a process
of its own (the profiler of a long-lived process may record nothing).

Port of the repository's `tools/trace_ops.py` (xprof's framework_op_stats
there).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def run_mapping(device, n_reps: int = 10, H: int = 320, W: int = 640,
                bound: float = 4.0, coarse: float = 0.04,
                fine: float = 0.02, sample: int = 2048,
                min_pixels_cur: int = 100, n_samples_d: int = 32):
    """-> (step, n_reps): `step` runs `Mapper.optimize` for n_reps
    iterations on one keyframe of the box room and returns the loss."""
    from ..config import make_config
    from ..data.synthetic import SyntheticBoxDataset
    from ..device import make_generator
    from ..mapping.mapper import Mapper
    from ..models.scene_rep import SceneRep

    cfg = make_config({
        "mapping": {"bound": [[-bound, bound]] * 3,
                    "marching_cubes_bound": [[-bound, bound]] * 3,
                    "sample": sample, "min_pixels_cur": min_pixels_cur,
                    "iters": n_reps},
        "planes_res": {"coarse": coarse, "fine": fine,
                       "bound_dividable": coarse},
        "cam": {"H": H, "W": W, "fx": W / 2, "fy": W / 2,
                "cx": W / 2 - 0.5, "cy": H / 2 - 0.5,
                "H_out": H, "W_out": W, "near": 0.0, "far": 10.0},
        "training": {"n_range_d": 11, "n_samples_d": n_samples_d,
                     "range_d": 0.1},
    })
    scene = SceneRep(cfg, device)
    ds = SyntheticBoxDataset(cfg, num_frames=2, half=bound * 0.9)
    mapper = Mapper(cfg, scene, num_kf=8, rays_per_kf=ds.num_rays_to_save)
    st = mapper.init_state(make_generator(device, 2))
    item = ds[0]
    frame = {k: torch.as_tensor(item[k], device=device)
             for k in ("direction", "rgb", "depth")}
    c2w = torch.as_tensor(item["c2w"], device=device)
    gen = make_generator(device, 3)
    st = mapper.add_keyframe(st, 0, frame, c2w, gen)

    def step():
        _, met = mapper.optimize(st, frame, c2w, gen, iters=n_reps)
        return met["loss"]

    return step, n_reps


def frontend_edges(n_kf: int, factors: int):
    """The frontend target's edges: every keyframe to its neighbours at
    distance 1 and 2, both ways, the first `factors` of them."""
    ii = np.concatenate([np.arange(0, n_kf - 1), np.arange(1, n_kf),
                         np.arange(0, n_kf - 2), np.arange(2, n_kf)])[:factors]
    jj = np.concatenate([np.arange(1, n_kf), np.arange(0, n_kf - 1),
                         np.arange(2, n_kf), np.arange(0, n_kf - 2)])[:factors]
    return ii, jj


def run_frontend(device, n_reps: int = 4, H: int = 320, W: int = 640,
                 buffer: int = 64, window: int = 32, factors: int = 75,
                 n_kf: int = 26):
    """-> (step, n_reps): `step` runs n_reps frontend updates (2
    iterations each) over `factors` edges on random features."""
    from ..device import make_generator
    from ..models import droid_net
    from ..tracking import video as video_lib
    from ..tracking.graph import FactorGraph

    ht, wd = H // 8, W // 8
    params = droid_net.init_droid_net(make_generator(device, 0),
                                      device=device)
    if device.type != "cpu":
        params = droid_net.cast_params(params, torch.bfloat16)
    feat_dtype = droid_net.params_dtype(params)
    state = video_lib.init_video(buffer, ht, wd, device=device,
                                 feat_dtype=feat_dtype)
    rng = np.random.default_rng(1)

    def feats():
        x = rng.standard_normal((buffer, 128, ht, wd), np.float32) * 0.1
        return torch.from_numpy(x).to(device=device, dtype=feat_dtype)

    state = state._replace(
        fmaps=feats(), inps=feats(),
        disps=torch.full((buffer, ht, wd), 0.5, device=device))
    intr8 = torch.tensor([W / 16, W / 16, W / 16 - 0.5, H / 16 - 0.5],
                         device=device)
    graph = FactorGraph(buffer, ht, wd, capacity=factors + 16, params=params,
                        intrinsics=intr8, window=window, max_factors=factors)
    graph.add_factors(state, *frontend_edges(n_kf, factors))
    holder = {"st": state}

    @torch.no_grad()
    def step():
        for _ in range(n_reps):
            holder["st"] = graph.update(holder["st"], t0=1, t1=n_kf, iters=2)
        return holder["st"].poses[1]

    return step, n_reps


TARGETS = {"mapping": run_mapping, "frontend": run_frontend}


def profile_table(step, n_reps: int, device, top_k: int = 30) -> dict:
    """Warm `step` up, run it once under torch.profiler and print the top
    ops by self time -> {"total_ms_per_rep", "rows": [(name, ms per rep,
    %)]}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"

    def run():
        float(step().reshape(-1)[0])   # waits for the device

    run()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        run()
    events = prof.key_averages()
    if cuda:
        ops = [(e.key, e.self_device_time_total) for e in events
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
        kind, what = "kernel", "device"
    else:
        ops = [(e.key, e.self_cpu_time_total) for e in events
               if not e.is_user_annotation]
        kind, what = "cpu op", "host"
    ops.sort(key=lambda r: -r[1])
    tot = sum(t for _, t in ops)
    print(f"\n{what} total self time: {tot / 1e3 / n_reps:.2f} ms/rep "
          f"({n_reps} reps)\n")
    rows = []
    for name, t_us in ops[:top_k]:
        share = 100 * t_us / tot if tot else 0.0
        rows.append((name, t_us / 1e3 / n_reps, share))
        print(f"{t_us / 1e3 / n_reps:9.3f} ms  {share:5.1f}%  "
              f"{kind:16s} {name[:80]}")
    return {"total_ms_per_rep": tot / 1e3 / n_reps, "rows": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("target", nargs="?", default="mapping",
                    choices=sorted(TARGETS))
    ap.add_argument("top_k", nargs="?", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    device = resolve_device(args.device)
    step, n_reps = TARGETS[args.target](device)
    report = profile_table(step, n_reps, device, args.top_k)
    return {"target": args.target, "n_reps": n_reps, **report}


if __name__ == "__main__":
    main()
