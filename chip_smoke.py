"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
  1. the card's name and power limit;
  2. build every CUDA kernel of the port from this checkout's sources (one
     nvcc per source, started together);
  3. small parity: a few mapper steps of a tiny config on the GPU agree with
     the same steps on the CPU (the plain path, which the CPU tests hold
     against the JAX package);
  4. tracking parity: two factor-graph updates of a tiny shared keyframe
     buffer with the same random DROID weights, GPU vs CPU, in fp32;
  5. oracle tracking: a tiny SLAM run (`MNESLAM.run_slam`) on the GPU whose
     tracker update gets ground-truth reprojection targets; its key poses
     must lie within 5 cm of the dataset's (the check that BA and geometry
     are right on the card). It runs with MNESLAM_CORR_IMPL=
     pallas_per_level, so every lookup goes through kernel 3;
  6. oracle backend: the same tiny oracle run past its frontend window
     (72 frames): loop BA after every keyframe, global BA on the dense,
     chunked and sparse-Schur paths, the trajectory filler; APE (Sim(3))
     under 5 cm and every branch counter above 0;
  7. the mapping-only path: `MNESLAM.run_mapping_only` at the room0 widths
     (configs/Replica/room0.yaml) on the synthetic box room, with the
     kernels' launch counts set to 0 just before and read just after, then
     steady-state step times and a torch.profiler table of 5 iterations
     (chiprun_out/chip_smoke/mapping_profile.txt);
  8. the SLAM main path: `MNESLAM.run_slam` at the room0 widths (tracking
     at 320 x 640, buffer 250, frontend window 25) with random DROID
     weights in bf16 for 80 frames: loop BA dense and sparse, global BA
     dense, chunked and sparse + chunked (checked by the port's counters),
     the filler and the APE; the counts set to 0 just before and read just
     after; times per tracked frame, per loop BA, per global BA; then
     torch.profiler tables of 3 frontend updates and of one sparse global-
     BA step (chiprun_out/chip_smoke/{tracking,global_ba}_profile.txt);
  9. the same path with MNESLAM_CORR_IMPL=pallas_mxu for 32 frames: every
     correlation lookup is a launch of kernel 2b and none of kernel 2;
 10. each kernel against its plain PyTorch version at the main path's
     shapes, with times (CUDA events) beside its bound and, where one
     exists, the one-call PyTorch yardstick;
 11. the TPU probes on the H100 (`mneslam_tpu_torch/tools/prof_corr.py`,
     `prof_scatter.py` in fp32 and bf16): every variant checked against
     its plain version, then timed, with the launch counts set to 0 just
     before and read just after; the scatter probe also runs kernel 1 and
     the blocked and bucketed scatters on one mapping iteration's real
     index stream (every result in probes.json beside the profile tables).
Prints the kernels' JSON line, then as the last line
{"ok": true, "device": {...}}. Needs torch with CUDA and nvcc; imports
nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# small outputs (the profile table) go to chiprun_out/, kept under 64 MiB;
# the room0 run's own outputs (a 130 MB checkpoint) go to output/
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")
RUN_OUT = os.path.join(ROOT, "output", "chip_smoke")

# 6 scatter calls per mapping iteration: 2 levels x 3 planes
SCATTERS_PER_ITER = 6
# Atomics add the duplicates of a row in a run-dependent order, so a sum of
# k fp32 values moves by up to about k ulp of the sum of their magnitudes.
# Tolerance per output: SCATTER_RTOL * sum|vals| into that row +
# SCATTER_ATOL. (The main path's indices put thousands of samples into one
# coarse texel; a dropped or doubled update still exceeds this by far.)
SCATTER_RTOL = 5e-5
SCATTER_ATOL = 1e-6
PSNR_FLOOR = 16.0

# corr_window: fp32 dots of C = 128 products, summed in another order by
# the kernel and by the plain version's matrix product; each sum is off by
# at most C * 2^-24 of the sum of the products' magnitudes, so the two
# differ by at most twice that.
CORR_RTOL = 2 * 128 * 2.0 ** -24
CORR_ATOL = 1e-7
# corr_window_mma (kernel 2b) takes each product as 3xTF32, a_hi b_hi +
# a_hi b_lo + a_lo b_hi with |a - a_hi - a_lo| <= 2^-22 |a| (two
# round-to-nearest conversions to 10 explicit mantissa bits): each product
# is off by at most 3 * 2^-22 |a b|, the dropped a_lo b_lo included. The
# tensor core adds the 3 C products into an fp32 accumulator, each addition
# counted at one ulp of the running sum (2^-23: rounding toward zero, no
# guard bit assumed); the other side (plain version or kernel 2) sums C
# products at 2^-24 each. Against both, per output: MMA_RTOL x the dot of
# the magnitudes + CORR_ATOL.
MMA_RTOL = 3 * 2.0 ** -22 + 3 * 128 * 2.0 ** -23 + 128 * 2.0 ** -24
# GPU vs CPU tracking parity after two updates (fp32 nets; cuDNN and oneDNN
# sum the convolutions in other orders): the CPU tests' bounds against JAX
TRACK_TOL = {"poses": 1e-4, "disps": 1e-3, "target": 1e-3, "weight": 1e-3}
# oracle tracking: key-pose translation error against the dataset
ORACLE_TOL_M = 0.05
# oracle backend run: frames, and the APE limit (tests/test_slam_full.py:93)
BACKEND_FRAMES = 72
ATE_TOL_M = 0.05
# room0 SLAM path: frames of the box room. With the motion-filter batch of 8
# and global_ba_every 10, global BA fires at 32 / 48 / 64 / 80 keyframes:
# dense, chunked (from 41), chunked, sparse + chunked (past 64); loop BA
# runs after every keyframe past 25, sparse past 64
SLAM_FRAMES = 80
MXU_FRAMES = 32             # the pallas_mxu run: loop BA and one global BA
FLIP = ((1.0, 0.0, 0.0, 0.0), (0.0, -1.0, 0.0, 0.0), (0.0, 0.0, -1.0, 0.0),
        (0.0, 0.0, 0.0, 1.0))


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def _wrappers():
    from mneslam_tpu_torch.kernels.corr_window import (
        corr_window, corr_window_multilevel, corr_window_multilevel_mma,
        corr_window_multilevel_unrolled)
    from mneslam_tpu_torch.kernels.scatter_add_rows import (
        scatter_add_rows, scatter_add_rows_per_warp)
    from mneslam_tpu_torch.kernels.scatter_rows_blocked import (
        scatter_add_rows_blocked)
    from mneslam_tpu_torch.kernels.scatter_rows_bucketed import (
        scatter_add_rows_bucketed)

    return {"scatter_add_rows": scatter_add_rows,
            "corr_window": corr_window_multilevel,
            "corr_window_mma": corr_window_multilevel_mma,
            "corr_window_per_level": corr_window,
            "scatter_add_rows_per_warp": scatter_add_rows_per_warp,
            "corr_window_unrolled": corr_window_multilevel_unrolled,
            "scatter_add_rows_blocked": scatter_add_rows_blocked,
            "scatter_add_rows_bucketed": scatter_add_rows_bucketed}


def reset_launches():
    """Every kernel wrapper's launch count to 0 (just before a path)."""
    import torch

    torch.cuda.synchronize()
    for w in _wrappers().values():
        w.launches = 0


def read_launches() -> dict:
    return {name: w.launches for name, w in _wrappers().items()}


def lookups(slam) -> int:
    """Correlation lookups the port counted in a SLAM run: the motion
    filter's comparisons, the frontend's and the backend's graph lookups
    (one per update, or one per chunk), the filler's."""
    t = slam.tracker
    return (t.motion_filter.comparisons + t.frontend.graph.lookups
            + t.backend.lookups + slam.traj_filler.lookups)


def tiny_config(out_dir):
    from mneslam_tpu_torch.config import make_config

    return make_config({
        "mode": "mapping",
        "data": {"output": out_dir, "exp_name": "tiny"},
        "mapping": {"bound": [[-2.2, 2.2]] * 3, "sample": 384,
                    "min_pixels_cur": 64, "first_iters": 80, "iters": 15,
                    "keyframe_every": 3},
        "planes_res": {"coarse": 0.44, "fine": 0.22, "bound_dividable": 0.22},
        "cam": {"H": 40, "W": 56, "fx": 35.0, "fy": 35.0, "cx": 27.5,
                "cy": 19.5, "near": 0.0, "far": 8.0},
        "training": {"n_range_d": 9, "n_samples_d": 8, "range_d": 0.25,
                     "trunc": 0.15},
        "model": {"c_dim": 16, "input_ch": 32, "input_ch_pos": 48,
                  "truncation": 0.15},
    })


def small_parity():
    """Three mapper steps on identical inputs, GPU vs CPU; -> max relative
    loss difference and max parameter difference."""
    import numpy as np
    import torch

    from mneslam_tpu_torch.mapping.mapper import Mapper, make_optimizer
    from mneslam_tpu_torch.models.scene_rep import SceneRep, param_leaves
    from mneslam_tpu_torch.utils.convert import (params_from_jax,
                                                 params_to_numpy)

    cfg = tiny_config(os.path.join(RUN_OUT, "parity"))
    rng = np.random.default_rng(0)
    runs = {}
    for dev in ("cpu", "cuda"):
        scene = SceneRep(cfg, dev)
        mapper = Mapper(cfg, scene, num_kf=2, rays_per_kf=16)
        state = mapper.init_state(torch.Generator(device=dev).manual_seed(0))
        runs[dev] = (mapper, state)
    # same starting weights on both devices
    params_np = params_to_numpy(runs["cpu"][1].params)
    for dev, (mapper, state) in runs.items():
        state.params = params_from_jax(params_np, device=dev)
        state.optimizer = make_optimizer(cfg, state.params)

    n = 448
    S = 17
    batches = []
    for _ in range(3):
        o = rng.normal(0, 0.1, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        batches.append((o, d, rng.uniform(size=(n, 3)).astype(np.float32),
                        (0.5 + rng.uniform(size=(n, 1))).astype(np.float32),
                        rng.uniform(size=(n, S)).astype(np.float32)))
    losses = {}
    for dev, (mapper, state) in runs.items():
        losses[dev] = []
        for o, d, rgb, td, u in batches:
            t = [torch.as_tensor(a, device=dev) for a in (o, d, rgb, td, u)]
            m = mapper.step(state, *t[:4], u=t[4])
            losses[dev].append(float(m["loss"]))
    rel = max(abs(a - b) / max(abs(b), 1e-12)
              for a, b in zip(losses["cuda"], losses["cpu"]))
    pdiff = max(float((a.detach().cpu() - b.detach()).abs().max())
                for a, b in zip(param_leaves(runs["cuda"][1].params),
                                param_leaves(runs["cpu"][1].params)))
    return losses, rel, pdiff


def main_path():
    """Mapping-only at room0 widths through the user entry point; -> (slam,
    cfg, metrics, seconds, scatter launches)."""
    import torch

    from mneslam_tpu_torch.config import make_config
    from mneslam_tpu_torch.configs import ROOM0
    from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
    from mneslam_tpu_torch.slam import MNESLAM

    cfg = make_config(ROOM0)
    cfg["dataset"] = "synthetic"
    cfg["mode"] = "mapping"
    cfg["data"]["output"] = RUN_OUT
    # the box room [-0.95, 0.95]^3 lies inside room0's mapping bound
    ds = SyntheticBoxDataset(cfg, num_frames=11, half=0.95)
    slam = MNESLAM(cfg, ds, rank=0, device="cuda")

    reset_launches()
    t0 = time.perf_counter()
    metrics = slam.run_mapping_only(log_every=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    if any(v for k, v in launches.items() if k != "scatter_add_rows"):
        raise SystemExit(f"the mapping-only path launched a correlation "
                         f"kernel: {launches}")
    return slam, cfg, metrics, seconds, launches["scatter_add_rows"]


def path_scatter_inputs(slam, generator):
    """The six (idx, vals, n_rows) scatter inputs of one mapping iteration
    at the trained state: indices from a real ray batch, values random."""
    import torch

    from mneslam_tpu_torch.ops import interp

    mapper, state, scene = slam.mapper, slam.map_state, slam.scene
    frame, pose = slam._frame_for_mapping(int(slam.mapped_timestamps[-1]))
    H, W = frame["depth"].shape
    rays_o, rays_d, _, target_d = mapper._build_rays(
        state.db, state.kf_poses, frame["direction"].reshape(-1, 3),
        frame["rgb"].reshape(-1, 3), frame["depth"].reshape(-1), pose, H * W,
        generator, True)
    z = scene.sample_z_vals(target_d, rays_o.shape[0], generator)
    pts = (rays_o[:, None] + rays_d[:, None] * z[..., None]).reshape(-1, 3)
    p_nor = scene._normalize(pts)
    out = []
    for lvl, shapes in enumerate(scene.plane_shapes):
        for name, dims in (("xy", [0, 1]), ("xz", [0, 2]), ("yz", [1, 2])):
            C, Hp, Wp = shapes[name]
            idx, _, _ = interp._cell(p_nor[:, dims], Hp, Wp)
            vals = torch.randn((idx.shape[0], 4 * C), generator=generator,
                               device="cuda")
            out.append((f"{'coarse' if lvl == 0 else 'fine'}_{name}", idx,
                        vals, Hp * Wp))
    return out


def check_scatter(idx, vals, n_rows):
    """Kernel vs plain version on the same inputs; -> (max abs error, max
    error / tolerance). Raises SystemExit past the tolerance."""
    import torch

    from mneslam_tpu_torch.kernels.scatter_add_rows import (
        scatter_add_rows, scatter_add_rows_plain)

    got = scatter_add_rows(idx, vals, n_rows)
    ref = scatter_add_rows_plain(idx, vals, n_rows)
    mag = scatter_add_rows_plain(idx, vals.abs(), n_rows)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    ratio = float((err / (SCATTER_RTOL * mag + SCATTER_ATOL)).max())
    if not ratio <= 1.0:
        raise SystemExit(f"scatter_add_rows disagrees with its plain version "
                         f"(n_rows {n_rows}): error / tolerance {ratio}")
    return float(err.max()), ratio


def tracking_parity():
    """Two factor-graph updates (correlation, ConvGRU, windowed BA) of one
    tiny keyframe buffer with the same random DROID weights on the GPU and
    on the CPU, fp32 -> {name: max abs difference}."""
    import numpy as np
    import torch

    from mneslam_tpu_torch.models import droid_net
    from mneslam_tpu_torch.ops import lie
    from mneslam_tpu_torch.tracking.graph import FactorGraph
    from mneslam_tpu_torch.utils.convert import video_state_from_numpy

    B, HT, WD = 8, 12, 16
    rng = np.random.default_rng(0)
    xi = (0.05 * rng.normal(size=(B, 6))).astype(np.float32)
    xi[0] = 0.0
    feats = rng.normal(size=(3, B, 128, HT, WD)).astype(np.float32)
    disps = (0.4 + 0.2 * rng.random((B, HT, WD))).astype(np.float32)
    arrays = {
        "timestamps": np.arange(B, dtype=np.float32),
        "poses": lie.exp(torch.tensor(xi)).numpy(),
        "poses_gt": np.tile(np.eye(4, dtype=np.float32), (B, 1, 1)),
        "disps": disps, "disps_sens": disps,
        "fmaps": feats[0], "nets": np.tanh(feats[1]),
        "inps": np.maximum(feats[2], 0.0),
        "damping": np.full((B, HT, WD), 1e-6, np.float32),
    }
    params = droid_net.init_droid_net(torch.Generator().manual_seed(0))
    intr = np.array([12.0, 12.0, 7.5, 5.5], np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        p = droid_net.map_params(params, lambda t: t.to(dev))
        st = video_state_from_numpy(arrays, device=dev)
        g = FactorGraph(B, HT, WD, capacity=24, params=p,
                        intrinsics=torch.tensor(intr, device=dev), window=8)
        g.add_neighborhood_factors(st, 0, 6, r=2)
        with torch.no_grad():
            for _ in range(2):
                st = g.update(st, t0=1, t1=6, use_inactive=True)
        n = g.n_active
        out[dev] = {"poses": st.poses, "disps": st.disps,
                    "target": g.target[:n], "weight": g.weight[:n]}
    return {k: float((out["cuda"][k].cpu() - out["cpu"][k]).abs().max())
            for k in TRACK_TOL}


def tiny_slam_config(out_dir, exp_name="oracle"):
    from mneslam_tpu_torch.config import make_config

    H, W = 64, 96
    return make_config({
        "mode": "slam",
        "data": {"output": out_dir, "exp_name": exp_name},
        "mapping": {"bound": [[-2.2, 2.2]] * 3, "sample": 256,
                    "min_pixels_cur": 48, "first_iters": 60, "iters": 10,
                    "global_ba_every": 1000},
        "planes_res": {"coarse": 0.44, "fine": 0.22, "bound_dividable": 0.22},
        "cam": {"H": H, "W": W, "fx": 60.0, "fy": 60.0, "cx": 47.5,
                "cy": 31.5, "H_out": H, "W_out": W, "near": 0.0, "far": 8.0},
        "training": {"n_range_d": 9, "n_samples_d": 8, "range_d": 0.25,
                     "trunc": 0.15},
        "model": {"c_dim": 16, "input_ch": 32, "input_ch_pos": 48,
                  "truncation": 0.15},
        "tracking": {
            "buffer": 40, "warmup": 5,
            "motion_filter": {"thresh": -1.0, "batch": 4},
            "frontend": {"enable_loop": False, "keyframe_thresh": -1.0,
                         "window": 25, "radius": 1, "max_factors": 30,
                         "nms": 0, "thresh": 25.0},
        },
    })


def oracle_slam(cfg, ds):
    """`MNESLAM` on the GPU whose tracker update gets ground-truth
    reprojection targets in place of the DROID update (tests/
    test_slam_full.py's oracle)."""
    import numpy as np
    import torch

    from mneslam_tpu_torch.ops import lie, projective
    from mneslam_tpu_torch.slam import MNESLAM

    flip = np.asarray(FLIP, np.float32)
    G0 = ds[0]["c2w"]
    gt = torch.stack([lie.from_matrix(torch.tensor(np.linalg.inv(
        flip @ np.linalg.inv(G0) @ ds[i]["c2w"] @ flip).astype(np.float32)))
        for i in range(len(ds))]).cuda()
    intr8 = torch.tensor([60.0 / 8, 60.0 / 8, 47.5 / 8, 31.5 / 8],
                         device="cuda")

    def update_fn(params, state, ii, jj, net, corr, motion, coords1):
        idx = state.timestamps.long().clamp(0, len(gt) - 1)
        tgt, valid = projective.projective_transform(
            gt[idx], state.disps_sens, intr8, ii, jj)
        return net, tgt - coords1, valid.expand(tgt.shape)

    def agg_fn(params, net, ii, mask, n):
        h, w = net.shape[2:]
        return (1e-4 * torch.ones((net.shape[0], h, w), device="cuda"),
                torch.zeros((net.shape[0], 576, h, w), device="cuda"))

    return MNESLAM(cfg, ds, device="cuda", update_fn=update_fn,
                   agg_fn=agg_fn)


def oracle_tracking():
    """A tiny oracle SLAM run on the GPU within the frontend window, every
    correlation lookup through kernel 3 (MNESLAM_CORR_IMPL=
    pallas_per_level) -> (keyframes, max key-pose translation error in m,
    lookups, launches)."""
    import numpy as np

    from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
    from mneslam_tpu_torch.tools.prof_corr import corr_impl

    cfg = tiny_slam_config(os.path.join(RUN_OUT, "oracle"))
    ds = SyntheticBoxDataset(cfg, num_frames=16)
    with corr_impl("pallas_per_level"):
        slam = oracle_slam(cfg, ds)
        reset_launches()
        slam.run_slam()
        launches = read_launches()
    key = np.load(os.path.join(slam.out_dir, "key_est_poses.npy"))
    ts = np.load(os.path.join(slam.out_dir, "key_timestamps.npy"))
    ref = np.stack([ds[int(t)]["c2w"] for t in ts])
    err = np.linalg.norm(key[:, :3, 3] - ref[:, :3, 3], axis=-1)
    return len(ts), float(err.max()), lookups(slam), launches


def oracle_backend():
    """The tiny oracle run past its frontend window of 8: loop BA (window
    8) after every keyframe from 9, global BA every 8 keyframes (dense at
    12-36, chunked from 44: 6 n + 16 > 256 edge slots, sparse-Schur past
    64), the filler at terminate -> (slam, results, seconds, launches)."""
    import torch

    from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset

    cfg = tiny_slam_config(os.path.join(RUN_OUT, "oracle"),
                           exp_name="oracle_backend")
    tr = cfg["tracking"]
    tr["buffer"] = BACKEND_FRAMES + 8
    tr["frontend"].update(enable_loop=True, window=8)
    tr["backend"].update(thresh=25.0, radius=1, nms=2, loop_window=8,
                         loop_thresh=25.0, loop_radius=1, loop_nms=2)
    cfg["mapping"]["global_ba_every"] = 8
    ds = SyntheticBoxDataset(cfg, num_frames=BACKEND_FRAMES)
    slam = oracle_slam(cfg, ds)
    reset_launches()
    t0 = time.perf_counter()
    res = slam.run_slam()
    torch.cuda.synchronize()
    return slam, res, time.perf_counter() - t0, read_launches()


def _timed(obj, name: str, records: list, info):
    """Wrap obj.<name> (an instance attribute, removed by `del`): each call
    is timed between two synchronisations and recorded as (seconds,
    info() before, info() after)."""
    import torch

    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        before = info()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        records.append((time.perf_counter() - t0, before, info()))
        return out

    setattr(obj, name, wrapper)


def slam_main_path(n_frames: int, exp_name: str):
    """SLAM mode at room0 widths through the user entry point, the
    tracker's batches, loop BAs and global BAs timed as they run (each
    between two synchronisations); -> (slam, cfg, results, seconds,
    launches, {"batches", "loop", "global"} call records)."""
    import torch

    from mneslam_tpu_torch.config import make_config
    from mneslam_tpu_torch.configs import ROOM0
    from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
    from mneslam_tpu_torch.slam import MNESLAM

    cfg = make_config(ROOM0)
    cfg["dataset"] = "synthetic"
    cfg["data"]["output"] = RUN_OUT
    cfg["data"]["exp_name"] = exp_name
    # random weights give flows of no meaning: admit every frame so that
    # the frontend initialises (warmup 12) and tracks the rest, and cull no
    # keyframe, so that the keyframe counts reach the backend's branches
    cfg["tracking"]["motion_filter"]["thresh"] = -1.0
    cfg["tracking"]["frontend"]["keyframe_thresh"] = -1.0
    ds = SyntheticBoxDataset(cfg, num_frames=n_frames, half=0.95)
    slam = MNESLAM(cfg, ds, rank=0, device="cuda")
    tracker, backend = slam.tracker, slam.tracker.backend

    def state():
        return (tracker.counter, backend.sparse_updates,
                backend.chunked_updates)

    rec = {"batches": [], "loop": [], "global": []}
    _timed(tracker, "run_batch", rec["batches"], state)
    _timed(backend, "loop_ba", rec["loop"], state)
    _timed(tracker, "global_ba", rec["global"], state)
    reset_launches()
    t0 = time.perf_counter()
    results = slam.run_slam()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    for obj, name in ((tracker, "run_batch"), (backend, "loop_ba"),
                      (tracker, "global_ba")):
        delattr(obj, name)
    return slam, cfg, results, seconds, launches, rec


def branch(before, after) -> str:
    """A backend call's branch from the (counter, sparse, chunked) counts
    before and after it."""
    sparse, chunked = after[1] > before[1], after[2] > before[2]
    return ("sparse+chunked" if sparse and chunked else
            "sparse" if sparse else "chunked" if chunked else "dense")


def corr_path_inputs(slam, n_real=75, cap=None, seed=0):
    """The multi-level kernels' inputs at a path's shapes: the final
    buffer's features, the frontend graph's edges topped up with random
    pairs of live keyframes to n_real real edges in a table of `cap` slots
    (default the frontend's 91), their reprojected lookup centres."""
    import numpy as np
    import torch

    from mneslam_tpu_torch.ops import correlation
    from mneslam_tpu_torch.tracking import video

    st, graph = slam.tracker.state, slam.tracker.frontend.graph
    n_kf = slam.tracker.counter
    pairs = list(zip(graph.ii.tolist(), graph.jj.tolist()))[:n_real]
    rng = np.random.default_rng(seed)
    while len(pairs) < n_real:
        i, j = rng.choice(n_kf, 2, replace=False)
        pairs.append((int(i), int(j)))
    cap = graph.capacity if cap is None else cap
    ii = np.zeros(cap, np.int64)
    jj = np.zeros(cap, np.int64)
    ii[:n_real], jj[:n_real] = np.asarray(pairs).T
    mask = np.zeros(cap, np.int32)
    mask[:n_real] = 1
    ii_t = torch.as_tensor(ii, device="cuda")
    jj_t = torch.as_tensor(jj, device="cuda")
    coords, _ = video.reproject(st, graph.intrinsics, ii_t, jj_t)
    pyr = correlation.build_pyramid(st.fmaps)
    N, C, H, W = pyr[0].shape
    f1 = pyr[0].permute(0, 2, 3, 1).reshape(N, H * W, C).contiguous()
    levels, w2ps, xs, _ = correlation._padded_levels(pyr, coords, 3)
    return (f1, levels, ii_t.int(), jj_t.int(), xs, w2ps,
            torch.as_tensor(mask, device="cuda"))


def check_corr(got, ref, mag, mask=None, rtol=CORR_RTOL,
               what="corr_window vs its plain version"):
    """Kernel output vs a reference; masked edges must be exactly zero.
    -> (max abs error, max error / tolerance); SystemExit past it."""
    import torch

    torch.cuda.synchronize()
    err = (got - ref).abs()
    ratio = float((err / (rtol * mag + CORR_ATOL)).max())
    if not ratio <= 1.0:
        raise SystemExit(f"{what}: error / tolerance {ratio}")
    if mask is not None and bool(got[mask == 0].any()):
        raise SystemExit(f"{what}: non-zeros for masked edges")
    return float(err.max()), ratio


def tpu_probes(real, card) -> dict:
    """Phase 11: the H100 counterparts of the TPU probes (`mneslam_tpu_torch/
    tools/prof_corr.py`, `prof_scatter.py` in fp32 and bf16), the scatter
    probe also on the `real` cases (tag, idx, vals, n_rows). Writes every
    result to probes.json in OUT; raises SystemExit on a
    wrong or failing variant. -> {"seconds", the extra keys of the
    "scatter_add_rows" and "corr_window" entries, the two new kernels'
    entries without their launch counts}."""
    import torch

    from mneslam_tpu_torch.kernels.scatter_rows_blocked import (
        DEFAULT_TILE_ROWS)
    from mneslam_tpu_torch.tools import prof_corr, prof_scatter

    t0 = time.perf_counter()
    corr = prof_corr.run("cuda", log=log)
    # K = 10 calls per timed run (the probe's own default is 20), to keep
    # this phase near a minute
    scat = prof_scatter.run("cuda", cases=real, reps=10, log=log)
    scat_bf16 = prof_scatter.run("cuda", bf16=True, reps=10, log=log)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with open(os.path.join(OUT, "probes.json"), "w") as f:
        json.dump({"card": card, "corr": corr, "scatter": scat,
                   "scatter_bf16": scat_bf16}, f)
    failed = corr["failed"] + scat["failed"] + scat_bf16["failed"]
    if failed:
        raise SystemExit(f"probe variants wrong or failing: {failed}")
    unequal = [k for k, v in corr.items()
               if isinstance(v, dict) and v.get("equal_to_kernel2") is False]
    log(f"corr unroll variants equal to kernel 2 bit for bit: "
        f"{not unequal} (unequal: {unequal})")

    def real_sum(variant, key="ms"):
        """A variant's `key` summed over the real stream's calls."""
        return sum(v[key] for k, v in scat.items()
                   if k.startswith("real:") and k.endswith(f"/{variant}"))

    def max_err(prefix):
        return max(v["max_abs_err"] for res in (scat, scat_bf16)
                   for k, v in res.items() if isinstance(v, dict)
                   and "max_abs_err" in v
                   and k.split("/")[-1].startswith(prefix))

    tiles = prof_scatter.TILES
    log(f"real index stream, sum of one iteration's {len(real)} calls (ms): "
        f"kernel 1 {real_sum('kernel1'):.4f}; serialU8/16/32 "
        f"{[round(real_sum(f'serialU{u}'), 4) for u in (8, 16, 32)]}; "
        f"blocked T {list(tiles)} "
        f"{[round(real_sum(f'blockedT{t}'), 4) for t in tiles]}; bucketed "
        f"{[round(real_sum(f'bucketT{t}'), 4) for t in tiles]}; presorted "
        f"{[round(real_sum(f'bucketT{t}_presorted'), 4) for t in tiles]}; "
        f"route {real_sum('route'):.4f}; index_add_ {real_sum('xla'):.4f}; "
        f"bound {real_sum('kernel1', 'bound_ms'):.4f}")
    T = DEFAULT_TILE_ROWS
    tol = (f"{prof_scatter.SCATTER_RTOL:g} x sum|vals| + "
           f"{prof_scatter.SCATTER_ATOL:g} (+ one bf16 ulp)")

    def entry(name, source, replaces, variant, plain, timed_as):
        return {"name": name, "route": "cuda",
                "source": f"mneslam_tpu_torch/kernels/csrc/{source}",
                "replaces": replaces, "max_abs_err": max_err(variant),
                "tolerance": tol, "ms": real_sum(f"{variant}T{T}"),
                "plain_ms": real_sum(plain),
                "bound_ms": real_sum(f"{variant}T{T}", "bound_ms"),
                "bound_by": "bytes", "library_ms": real_sum("xla"),
                "timed_as": f"sum of one mapping iteration's {len(real)} "
                            f"calls on the real index stream, {timed_as}"
                            f"tiles of {T} rows",
                "ms_by_tile": {t: real_sum(f"{variant}T{t}")
                               for t in tiles}}

    bucketed = entry("scatter_add_rows_bucketed", "scatter_rows_bucketed.cu",
                     "tools/prof_scatter_bucketed.py:82", "bucket",
                     "bucket_plain", "route included, ")
    bucketed.update(route_ms=real_sum("route"),
                    presorted_ms=real_sum(f"bucketT{T}_presorted"))
    return {
        "seconds": seconds,
        "scatter_add_rows": {
            "per_warp_ms": {u: real_sum(f"serialU{u}") for u in (8, 16, 32)},
            "probe_ms": real_sum("kernel1")},
        "corr_window": {
            "probe_ms": corr["kernel2+skip"]["ms"],
            "unroll_ms": {u: corr[f"kernel2+skip u{u}"]["ms"]
                          for u in prof_corr.UNROLLS},
            "unroll_equal_to_kernel2": not unequal},
        "scatter_add_rows_blocked": entry(
            "scatter_add_rows_blocked", "scatter_rows_blocked.cu",
            "tools/prof_pallas_scatter.py:61", "blocked", "blocked_plain",
            ""),
        "scatter_add_rows_bucketed": bucketed,
    }


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from mneslam_tpu_torch.device import resolve_device
    from mneslam_tpu_torch.kernels import build
    from mneslam_tpu_torch.kernels.scatter_add_rows import (
        scatter_add_rows, scatter_add_rows_plain)
    from mneslam_tpu_torch.tools.measure import (FP32_FLOPS, HBM_BYTES_PER_S,
                                                 TF32_FLOPS, corr_bound_ms,
                                                 cuda_ms)
    from mneslam_tpu_torch.tools.prof_corr import corr_impl

    resolve_device("cuda")  # TF32 off
    os.makedirs(OUT, exist_ok=True)

    # 1. card
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {len(libs)} kernel(s) in {time.perf_counter() - t0:.2f} s: "
        f"{sorted(libs)}")

    # 3. small parity, GPU vs CPU
    losses, rel, pdiff = small_parity()
    log(f"parity: losses cuda {losses['cuda']} cpu {losses['cpu']}; "
        f"max rel loss diff {rel:.3e}, max param diff {pdiff:.3e}")
    if not (rel < 1e-4 and pdiff < 1e-4):
        raise SystemExit("parity: GPU and CPU mapper steps disagree")

    # 4. tracking parity, GPU vs CPU
    diffs = tracking_parity()
    log(f"tracking parity (2 frontend updates, fp32, GPU vs CPU): max abs "
        f"differences {json.dumps(diffs)}; tolerances {json.dumps(TRACK_TOL)}")
    bad = [k for k, v in diffs.items() if not v <= TRACK_TOL[k]]
    if bad:
        raise SystemExit(f"tracking parity: GPU and CPU disagree on {bad}")

    # 5. oracle tracking on the card, every lookup through kernel 3
    n_key, pose_err, o_lookups, o_launches = oracle_tracking()
    log(f"oracle tracking (MNESLAM_CORR_IMPL=pallas_per_level): {n_key} "
        f"keyframes, key-pose translation error max {pose_err:.3e} m (limit "
        f"{ORACLE_TOL_M} m); {o_lookups} lookups, launches "
        f"{json.dumps(o_launches)}")
    if not pose_err < ORACLE_TOL_M:
        raise SystemExit("oracle tracking did not recover the poses")
    if (o_launches["corr_window_per_level"] != 4 * o_lookups
            or o_launches["corr_window"] or o_launches["corr_window_mma"]):
        raise SystemExit(f"pallas_per_level: expected 4 x {o_lookups} "
                         f"kernel-3 launches and no other correlation "
                         f"kernel, got {o_launches}")

    # 6. oracle backend: past the frontend window, every backend branch
    b_slam, b_res, b_seconds, b_launches = oracle_backend()
    be = b_slam.tracker.backend
    b_counts = {k: getattr(be, k) for k in ("loop_bas", "dense_bas",
                                            "sparse_updates",
                                            "chunked_updates")}
    b_ate = b_res["ate"]["rmse"]
    log(f"oracle backend: {BACKEND_FRAMES} frames, "
        f"{b_slam.tracker.counter} keyframes in {b_seconds:.2f} s; branch "
        f"counters {json.dumps(b_counts)}; APE(sim3) rmse {b_ate:.3e} m "
        f"(limit {ATE_TOL_M} m); {lookups(b_slam)} lookups, launches "
        f"{json.dumps(b_launches)}")
    if not min(b_counts.values()) > 0:
        raise SystemExit(f"oracle backend: a branch did not run: {b_counts}")
    if not b_ate < ATE_TOL_M:
        raise SystemExit(f"oracle backend: APE {b_ate} m")
    if b_launches["corr_window"] != lookups(b_slam):
        raise SystemExit("oracle backend: corr_window launches != lookups")

    # 7. the mapping-only path
    slam, cfg, metrics, seconds, launches = main_path()
    n_kf = len(metrics)
    iters = (int(cfg["mapping"]["first_iters"])
             + (n_kf - 1) * int(cfg["mapping"]["iters"]))
    log(f"mapping-only path: room0 widths, {n_kf} keyframes, {iters} "
        f"iterations in {seconds:.2f} s; scatter launches {launches}")
    for m in metrics:
        log(f"  keyframe metrics: {json.dumps(m)}")
    if launches != SCATTERS_PER_ITER * iters:
        raise SystemExit(f"scatter launches {launches} != "
                         f"{SCATTERS_PER_ITER} x {iters}")
    if not all(math.isfinite(v) for m in metrics for v in m.values()):
        raise SystemExit("non-finite loss in the mapping-only path")
    from mneslam_tpu_torch.models.scene_rep import param_leaves
    if not all(bool(torch.isfinite(p).all())
               for p in param_leaves(slam.map_state.params)):
        raise SystemExit("non-finite parameters after the mapping-only path")
    if not metrics[-1]["psnr"] > PSNR_FLOOR:
        raise SystemExit(f"last keyframe PSNR {metrics[-1]['psnr']} <= "
                         f"{PSNR_FLOOR}")
    res = slam.terminate()
    log(f"terminate: {res}")

    # steady-state step times at the trained state (after the counted run)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    frame, pose = slam._frame_for_mapping(int(slam.mapped_timestamps[-1]))
    slam.mapper.optimize(slam.map_state, frame, pose, gen, iters=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam.mapper.optimize(slam.map_state, frame, pose, gen,
                         iters=int(cfg["mapping"]["iters"]))
    torch.cuda.synchronize()
    kf_ms = 1e3 * (time.perf_counter() - t0)
    iter_ms = kf_ms / int(cfg["mapping"]["iters"])
    log(f"slice: {iter_ms:.3f} ms per iteration, {kf_ms:.1f} ms per keyframe "
        f"({cfg['mapping']['iters']} iterations) on {card}")
    log(f"host stage timers: {json.dumps(slam.timers.summary())}")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        slam.mapper.optimize(slam.map_state, frame, pose, gen, iters=5)
        torch.cuda.synchronize()
    events = prof.key_averages()
    # kernel time only: CPU-op rows and GPU user annotations repeat it
    kernels_run = [e for e in events if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation]
    device_ms = 1e-3 * sum(e.self_device_time_total for e in kernels_run) / 5
    launches_per_iter = sum(e.count for e in kernels_run) / 5
    table = events.table(sort_by="self_cuda_time_total", row_limit=40)
    path = os.path.join(OUT, "mapping_profile.txt")
    with open(path, "w") as f:
        f.write(f"{card}: 5 mapping iterations at room0 widths\n{table}")
    log(f"profile: {launches_per_iter:.0f} kernel launches and "
        f"{device_ms:.3f} ms of kernels per iteration, i.e. the "
        f"device idles {100 * (1 - device_ms / iter_ms):.1f}% of the "
        f"{iter_ms:.3f} ms iteration; table in {path}")

    map_launches = launches

    # 8. the SLAM main path past the frontend window
    log(f"SLAM main path: room0 widths (tracking 320 x 640, buffer 250, "
        f"warmup 12, frontend window 25, 91 edge slots), random DROID "
        f"weights in bf16, motion_filter.thresh and frontend.keyframe_thresh "
        f"-1; cut to {SLAM_FRAMES} frames of the synthetic box room")
    slam_s, scfg, sres, sseconds, slaunches, rec = slam_main_path(
        SLAM_FRAMES, "room0_slam")
    tracker = slam_s.tracker
    graph = tracker.frontend.graph
    n_map = len(slam_s.mapped_timestamps)
    s_iters = (int(scfg["mapping"]["first_iters"])
               + (n_map - 1) * int(scfg["mapping"]["iters"]))
    n_corr = lookups(slam_s)
    log(f"SLAM main path: {SLAM_FRAMES} frames, {tracker.counter} keyframes "
        f"tracked ({tracker.frontend.removed_count} culled), {n_map} mapped "
        f"({s_iters} mapping iterations) in {sseconds:.2f} s; {n_corr} "
        f"lookups ({tracker.motion_filter.comparisons} motion filter, "
        f"{graph.lookups} frontend, {tracker.backend.lookups} backend, "
        f"{slam_s.traj_filler.lookups} filler); launches "
        f"{json.dumps(slaunches)}")
    if slaunches["corr_window"] != n_corr:
        raise SystemExit(f"corr_window launches {slaunches['corr_window']} "
                         f"!= {n_corr} lookups counted by the port")
    if slaunches["corr_window_mma"] or slaunches["corr_window_per_level"]:
        raise SystemExit(f"the default path launched kernel 2b or 3: "
                         f"{slaunches}")
    if slaunches["scatter_add_rows"] != SCATTERS_PER_ITER * s_iters:
        raise SystemExit(f"scatter launches {slaunches['scatter_add_rows']}"
                         f" != {SCATTERS_PER_ITER} x {s_iters}")
    window = int(scfg["tracking"]["frontend"]["window"])
    loop_by = {}
    for sec, before, after in rec["loop"]:
        loop_by.setdefault(branch(before, after), []).append(sec)
    global_by = {}
    for sec, before, after in rec["global"]:
        global_by.setdefault(branch(before, after), []).append(
            (before[0], sec))
    log(f"SLAM main path: loop BA calls by branch "
        f"{json.dumps({k: len(v) for k, v in loop_by.items()})}; global BA "
        f"calls (keyframes, s) by branch {json.dumps(global_by)}")
    need_loop = {"dense", "sparse"} - set(loop_by)
    need_global = {"dense", "chunked", "sparse+chunked"} - set(global_by)
    if need_loop or need_global:
        raise SystemExit(f"SLAM main path: branches not run: loop BA "
                         f"{need_loop}, global BA {need_global}")
    n_kf = tracker.counter
    est = np.load(os.path.join(slam_s.out_dir, "est_poses.npy"))
    finite = {
        "poses": bool(torch.isfinite(tracker.state.poses[:n_kf]).all()),
        "disps": bool(torch.isfinite(tracker.state.disps[:n_kf]).all()),
        "losses": all(math.isfinite(v) for m in slam_s.metrics_log
                      for v in m.values()),
        "est_poses": bool(np.isfinite(est).all()),
        "ate": math.isfinite(sres["ate"]["rmse"]),
    }
    log(f"SLAM main path: finite {json.dumps(finite)}; est_poses "
        f"{list(est.shape)}; APE(sim3) rmse {sres['ate']['rmse']:.4f} m "
        f"(random weights: printed, not checked); last keyframe metrics "
        f"{json.dumps(slam_s.metrics_log[-1])}")
    if not all(finite.values()) or est.shape != (SLAM_FRAMES, 4, 4):
        raise SystemExit("non-finite or missing outputs of the SLAM path")
    stages = slam_s.timers.summary()
    log(f"SLAM host stage timers: {json.dumps(stages)}")

    def per_frame_ms(batches):
        n = sum(after[0] - before[0] for _, before, after in batches)
        return 1e3 * sum(sec for sec, _, _ in batches) / max(n, 1), n

    pre_ms, pre_n = per_frame_ms([b for b in rec["batches"]
                                  if b[2][0] <= window])
    post_ms, post_n = per_frame_ms([b for b in rec["batches"]
                                    if b[1][0] >= window])
    loop_ms = {k: 1e3 * sum(v) / len(v) for k, v in loop_by.items()}
    global_ms = {k: [1e3 * sec for _, sec in v]
                 for k, v in global_by.items()}
    fill_stage_s = stages["fill_trajectory"]["total_s"]
    # the terminate stage above streams the frames from the synthetic
    # dataset, which ray-casts each 680 x 1200 frame in numpy on the host:
    # time that rendering and the filler alone, on frames rendered first
    t0 = time.perf_counter()
    frames = [(float(i), slam_s._to_tracking_res(slam_s.dataset[i]["rgb"]))
              for i in range(SLAM_FRAMES)]
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    slam_s.traj_filler(tracker.state, tracker.counter, iter(frames))
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    del frames
    log(f"trajectory filler: {fill_stage_s:.2f} s in terminate's stage, of "
        f"which rendering the {SLAM_FRAMES} synthetic frames on the host and "
        f"resizing them takes {render_s:.2f} s when timed alone; the filler "
        f"alone on frames rendered first {fill_s:.2f} s")
    log(f"SLAM slice times (host clock, each call between two "
        f"synchronisations): {pre_ms:.1f} ms per tracked frame before the "
        f"window ({pre_n} frames), {post_ms:.1f} ms after it ({post_n} "
        f"frames, loop BA included); loop BA ms per call "
        f"{json.dumps(loop_ms)}; global BA ms per call "
        f"{json.dumps(global_ms)}; trajectory filler alone {fill_s:.2f} s "
        f"({SLAM_FRAMES} frames); "
        f"{1e3 * stages['map_keyframe']['total_s'] / n_map:.1f} ms per "
        f"mapped keyframe (mean, the first with 500 iterations) on {card}")

    def profiled(fn, n, path, title):
        """fn() run n times under torch.profiler -> (wall ms, kernel ms,
        launches, top kernels) per run; the table goes to `path`."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / n
        events = prof.key_averages()
        kernels_run = [e for e in events if e.device_type == DeviceType.CUDA
                       and not e.is_user_annotation]
        dev_ms = 1e-3 * sum(e.self_device_time_total
                            for e in kernels_run) / n
        count = sum(e.count for e in kernels_run) / n
        top = sorted(kernels_run, key=lambda e: -e.self_device_time_total)
        top_s = "; ".join(f"{e.key[:60]} {1e-3 * e.self_device_time_total / n:.3f}"
                          for e in top[:6])
        with open(path, "w") as f:
            f.write(f"{card}: {title}\n"
                    + events.table(sort_by="self_cuda_time_total",
                                   row_limit=40))
        return wall, dev_ms, count, top_s

    # frontend updates at the final state (after the counted run)
    st = tracker.state
    with torch.no_grad():
        for _ in range(2):
            st = graph.update(st, use_inactive=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            st = graph.update(st, use_inactive=True)
        torch.cuda.synchronize()
        upd_ms = 1e3 * (time.perf_counter() - t0) / 5
        tracker.state = st
        path = os.path.join(OUT, "tracking_profile.txt")
        _, upd_dev_ms, upd_launches, top_s = profiled(
            lambda: graph.update(tracker.state, use_inactive=True), 3, path,
            f"3 frontend updates at room0 widths ({graph.n_active} active "
            f"edges)")
    log(f"tracking profile: {upd_launches:.0f} kernel launches and "
        f"{upd_dev_ms:.3f} ms of kernels per frontend update, i.e. the "
        f"device idles {100 * (1 - upd_dev_ms / upd_ms):.1f}% of the "
        f"{upd_ms:.2f} ms update ({graph.n_active} active edges); top "
        f"kernels (ms per update): {top_s}; table in {path}")

    # one sparse global-BA step (one update over the whole history)
    before = (tracker.counter, tracker.backend.sparse_updates,
              tracker.backend.chunked_updates)
    path = os.path.join(OUT, "global_ba_profile.txt")
    gba_ms, gba_dev_ms, gba_launches, gtop = profiled(
        lambda: tracker.global_ba(steps=1), 1, path,
        f"one global-BA step over {tracker.counter} keyframes")
    gba_branch = branch(before, (tracker.counter,
                                 tracker.backend.sparse_updates,
                                 tracker.backend.chunked_updates))
    log(f"global BA profile ({gba_branch}, {tracker.counter} keyframes, one "
        f"update with its edge proposal): wall {gba_ms:.1f} ms, "
        f"{gba_launches:.0f} kernel launches and {gba_dev_ms:.3f} ms of "
        f"kernels, i.e. the device idles "
        f"{100 * (1 - gba_dev_ms / gba_ms):.1f}%; top kernels (ms): {gtop}; "
        f"table in {path}")
    if gba_branch != "sparse+chunked":
        raise SystemExit(f"the profiled global BA took {gba_branch}")

    # 9. the same path with MNESLAM_CORR_IMPL=pallas_mxu: kernel 2b
    with corr_impl("pallas_mxu"):
        mslam, _, mres, mseconds, mlaunches, mrec = slam_main_path(
            MXU_FRAMES, "room0_slam_mxu")
    m_lookups = lookups(mslam)
    mbe = mslam.tracker.backend
    log(f"pallas_mxu path: {MXU_FRAMES} frames, {mslam.tracker.counter} "
        f"keyframes in {mseconds:.2f} s; {mbe.loop_bas} loop BAs, "
        f"{mbe.dense_bas} global BAs; {m_lookups} lookups; launches "
        f"{json.dumps(mlaunches)}; APE(sim3) rmse "
        f"{mres['ate']['rmse']:.4f} m")
    if (mlaunches["corr_window_mma"] != m_lookups
            or mlaunches["corr_window"] or mlaunches["corr_window_per_level"]
            or not (mbe.loop_bas and mbe.dense_bas)):
        raise SystemExit(f"pallas_mxu path: expected {m_lookups} kernel-2b "
                         f"launches, none of kernels 2 and 3, loop and global "
                         f"BA: {mlaunches}")

    # 10. kernels against their plain versions at the main path's shapes
    # (a) the contract cases: forced duplicates, untouched rows, dropped
    #     out-of-range rows
    max_err = 0.0
    for n_rows in (400_299, 100_400):
        nu, width = 92_364, 128
        idx = torch.randint(0, n_rows - 1000, (nu,), generator=gen,
                            device="cuda")
        idx[: nu // 4] = idx[nu // 4: 2 * (nu // 4)]
        idx[0], idx[1] = -1, n_rows
        vals = torch.randn((nu, width), generator=gen, device="cuda")
        err, ratio = check_scatter(idx, vals, n_rows)
        untouched = float(scatter_add_rows(idx, vals, n_rows)[
            n_rows - 1000:].abs().max())
        log(f"scatter_add_rows n_rows {n_rows} nu {nu} width {width}: max "
            f"abs err {err:.3e}, err / tolerance {ratio:.3f} (tolerance "
            f"{SCATTER_RTOL:g} x sum|vals| + {SCATTER_ATOL:g}: atomics "
            f"reorder the fp32 sums), untouched rows max {untouched}")
        if untouched != 0.0:
            raise SystemExit("scatter_add_rows wrote to untouched rows")
        max_err = max(max_err, err)

    # (b) one mapping iteration's six calls with the path's real indices
    calls = path_scatter_inputs(slam, gen)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
              "bound_ms": 0.0}
    for name, idx, vals, n_rows in calls:
        err, ratio = check_scatter(idx, vals, n_rows)
        max_err = max(max_err, err)
        nu, width = vals.shape
        ms = cuda_ms(lambda: scatter_add_rows(idx, vals, n_rows))
        plain = cuda_ms(lambda: scatter_add_rows_plain(idx, vals, n_rows))
        lib = cuda_ms(lambda: torch.zeros(
            (n_rows, width), device="cuda").index_add_(0, idx, vals))
        nbytes = nu * width * 4 + nu * idx.element_size() + n_rows * width * 4
        # bytes: each input read once, the table written once; operations:
        # one fp32 add per value
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, nu * width / FP32_FLOPS)
        log(f"scatter_add_rows {name}: n_rows {n_rows} nu {nu} width "
            f"{width}: kernel {ms:.4f} ms, plain {plain:.4f} ms, index_add_ "
            f"{lib:.4f} ms, bound {1e3 * bound:.1f} us ({nbytes} bytes at "
            f"3.35 TB/s), max abs err {err:.3e}, err / tolerance {ratio:.3f}")
        totals["ms"] += ms
        totals["plain_ms"] += plain
        totals["library_ms"] += lib
        totals["bytes"] += nbytes
        totals["bound_ms"] += bound
    bound_ms = totals["bound_ms"]
    log(f"scatter_add_rows, one iteration's {len(calls)} calls: kernel "
        f"{totals['ms']:.4f} ms, plain {totals['plain_ms']:.4f} ms, "
        f"index_add_ {totals['library_ms']:.4f} ms, bound "
        f"{1e3 * bound_ms:.1f} us ({totals['bytes']} bytes)")

    # (c) corr_window (kernels 2 and 3) at the frontend's shapes: 91 edge
    #     slots, 75 real; then the motion filter's single edge
    from mneslam_tpu_torch.kernels.corr_window import (
        corr_window, corr_window_multilevel, corr_window_multilevel_mma,
        corr_window_multilevel_mma_plain, corr_window_multilevel_plain,
        corr_window_plain)

    f1, levels, ii, jj, xs, w2ps, cmask = corr_path_inputs(slam_s)
    f1_abs, levels_abs = f1.abs(), [lv.abs() for lv in levels]
    got = corr_window_multilevel(f1, levels, ii, jj, xs, w2ps, mask=cmask)
    ref = corr_window_multilevel_plain(f1, levels, ii, jj, xs, w2ps,
                                       mask=cmask)
    mag = corr_window_multilevel_plain(f1_abs, levels_abs, ii, jj, xs, w2ps,
                                       mask=cmask)
    c_err, c_ratio = check_corr(got, ref, mag, cmask)
    c_ms = cuda_ms(lambda: corr_window_multilevel(f1, levels, ii, jj, xs,
                                                  w2ps, mask=cmask))
    c_plain = cuda_ms(lambda: corr_window_multilevel_plain(
        f1, levels, ii, jj, xs, w2ps, mask=cmask), reps=5, warmup=1)
    c_bound, c_by, c_bytes, c_flops = corr_bound_ms(f1, levels, ii, jj, xs,
                                                    cmask)
    E, HW = xs.shape[:2]
    log(f"corr_window (kernel 2) E {E} ({int(cmask.sum())} real) HW {HW} "
        f"C {f1.shape[2]} 4 levels: kernel {c_ms:.4f} ms, plain "
        f"{c_plain:.4f} ms, bound {c_bound:.4f} ms by {c_by} ({c_flops} "
        f"flops at 67 TFLOP/s fp32, {c_bytes} bytes at 3.35 TB/s), max abs "
        f"err {c_err:.3e}, err / tolerance {c_ratio:.3f} (tolerance "
        f"{CORR_RTOL:.3g} x dot of magnitudes + {CORR_ATOL:g}: both sum 128 "
        f"fp32 products, in other orders); no one PyTorch call computes it")

    # the motion filter's lookup: one edge between two frames
    m_args = (f1[:2].contiguous(), [lv[:2].contiguous() for lv in levels],
              torch.zeros(1, dtype=torch.int32, device="cuda"),
              torch.ones(1, dtype=torch.int32, device="cuda"),
              xs[:1].contiguous(), w2ps)
    m_abs = (m_args[0].abs(), [lv.abs() for lv in m_args[1]], *m_args[2:])
    m_err, m_ratio = check_corr(corr_window_multilevel(*m_args),
                                corr_window_multilevel_plain(*m_args),
                                corr_window_multilevel_plain(*m_abs))
    m_ms = cuda_ms(lambda: corr_window_multilevel(*m_args))
    m_plain = cuda_ms(lambda: corr_window_multilevel_plain(*m_args))
    m_bound = corr_bound_ms(m_args[0], m_args[1], m_args[2], m_args[3],
                            m_args[4], torch.ones(1, device="cuda"))[0]
    log(f"corr_window (kernel 2) E 1: kernel {m_ms:.4f} ms, plain "
        f"{m_plain:.4f} ms, bound {m_bound:.4f} ms, max abs err "
        f"{m_err:.3e}, err / tolerance {m_ratio:.3f}")

    # kernel 3: the per-level entry, each level of the same 91 edges (all
    # computed: no mask), bound as the four levels' work at once
    p_ms = p_plain = 0.0
    p_err = 0.0
    for lvl in range(len(levels)):
        xl = xs[..., lvl].contiguous()
        args = (f1, levels[lvl], ii, jj, xl, w2ps[lvl])
        e, r = check_corr(corr_window(*args), corr_window_plain(*args),
                          corr_window_plain(f1_abs, levels_abs[lvl], ii, jj,
                                            xl, w2ps[lvl]))
        p_err = max(p_err, e)
        p_ms += cuda_ms(lambda: corr_window(*args))
        p_plain += cuda_ms(lambda: corr_window_plain(*args), reps=5,
                           warmup=1)
    p_bound, p_by, _, _ = corr_bound_ms(f1, levels, ii, jj, xs,
                                        torch.ones_like(cmask))
    log(f"corr_window (kernel 3, one level per launch) E {E} (all computed)"
        f": four levels {p_ms:.4f} ms, plain {p_plain:.4f} ms, bound "
        f"{p_bound:.4f} ms by {p_by}, max abs err {p_err:.3e}")
    del got, ref, mag

    # (d) corr_window_mma (kernel 2b) at the frontend's shapes and at one
    #     256-edge chunk of a global BA's update, against its plain version
    #     and against kernel 2; kernel 2 timed beside it in the same call
    mma = {}
    for label, n_real, cap in (("frontend", 75, None),
                               ("global_chunk", 256, 256)):
        a = corr_path_inputs(slam_s, n_real=n_real, cap=cap)
        fb, lvb, iib, jjb, xsb, w2b, mb = a
        a_abs = (fb.abs(), [lv.abs() for lv in lvb], iib, jjb, xsb, w2b)
        got = corr_window_multilevel_mma(*a[:6], mask=mb)
        mag = corr_window_multilevel_plain(*a_abs, mask=mb)
        e_p, r_p = check_corr(got, corr_window_multilevel_mma_plain(
            *a[:6], mask=mb), mag, mb, MMA_RTOL,
            "corr_window_mma vs its plain version")
        e_k, r_k = check_corr(got, corr_window_multilevel(*a[:6], mask=mb),
                              mag, mb, MMA_RTOL,
                              "corr_window_mma vs corr_window")
        del got, mag
        k2b_ms = cuda_ms(lambda: corr_window_multilevel_mma(*a[:6], mask=mb))
        k2_ms = cuda_ms(lambda: corr_window_multilevel(*a[:6], mask=mb))
        plain_ms = cuda_ms(lambda: corr_window_multilevel_mma_plain(
            *a[:6], mask=mb), reps=2, warmup=1)
        bound, by, nbytes, flops = corr_bound_ms(fb, lvb, iib, jjb, xsb, mb,
                                                 flops_per_s=TF32_FLOPS)
        mma[label] = {"ms": k2b_ms, "kernel2_ms": k2_ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": by,
                      "max_abs_err": max(e_p, e_k),
                      "err_ratio": max(r_p, r_k)}
        log(f"corr_window_mma (kernel 2b, tensor cores, 3xTF32) {label}: E "
            f"{xsb.shape[0]} ({n_real} real): kernel {k2b_ms:.4f} ms, kernel "
            f"2 in the same call {k2_ms:.4f} ms, plain (block form) "
            f"{plain_ms:.4f} ms, bound {bound:.4f} ms by {by} ({flops} "
            f"useful flops at 495 TFLOP/s TF32, {nbytes} bytes at 3.35 TB/s;"
            f" the kernel issues 24 x the useful flops: 8-wide mma x 3 "
            f"passes), max abs err {max(e_p, e_k):.3e}, err / tolerance vs "
            f"plain {r_p:.3f}, vs kernel 2 {r_k:.3f} (tolerance "
            f"{MMA_RTOL:.3g} x dot of magnitudes + {CORR_ATOL:g})")

    # 11. the TPU probes on the H100, with the counts set to 0 just before
    #     and read just after
    real = [(f"real:{name}", idx, vals, n_rows)
            for name, idx, vals, n_rows in path_scatter_inputs(slam, gen)]
    reset_launches()
    probes = tpu_probes(real, card)
    probe_launches = read_launches()
    del real
    log(f"TPU probes on the H100: {probes['seconds']:.1f} s; launches "
        f"{json.dumps(probe_launches)}")
    for name in ("scatter_add_rows_blocked", "scatter_add_rows_bucketed"):
        probes[name]["launches"] = probe_launches[name]
        probes[name]["launches_by_path"] = {"probes": probe_launches[name]}

    kernels = [{
        "name": "scatter_add_rows",
        "route": "cuda",
        "source": "mneslam_tpu_torch/kernels/csrc/scatter_add_rows.cu",
        "replaces": "mneslam_tpu/ops/pallas_kernels.py:283",
        "launches": slaunches["scatter_add_rows"],
        "launches_by_path": {"slam": slaunches["scatter_add_rows"],
                             "mapping": map_launches,
                             "probes": probe_launches["scatter_add_rows"]},
        "max_abs_err": max_err,
        "max_err": max_err,
        "tolerance": f"{SCATTER_RTOL:g} x sum|vals| + {SCATTER_ATOL:g}",
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": bound_ms,
        "bound_us": 1e3 * bound_ms,
        "bound_by": "bytes",
        "library_ms": totals["library_ms"],
        "timed_as": "sum of one mapping iteration's 6 calls",
        **probes["scatter_add_rows"],
        "probe_launches": probe_launches["scatter_add_rows"]
        + probe_launches["scatter_add_rows_per_warp"],
        "iter_ms": iter_ms,
        "iter_device_ms": device_ms,
        "keyframe_ms": kf_ms,
    }, {
        "name": "corr_window",
        "route": "cuda",
        "source": "mneslam_tpu_torch/kernels/csrc/corr_window.cu",
        "replaces": "mneslam_tpu/ops/pallas_kernels.py:176",
        "launches": slaunches["corr_window"],
        "launches_by_path": {"slam": slaunches["corr_window"],
                             "oracle_backend": b_launches["corr_window"],
                             "mapping": 0},
        "max_abs_err": max(c_err, m_err),
        "tolerance": f"{CORR_RTOL:.3g} x dot of |f1|, |f2| + {CORR_ATOL:g}",
        "ms": c_ms,
        "plain_ms": c_plain,
        "bound_ms": c_bound,
        "bound_by": c_by,
        "library_ms": None,
        "timed_as": f"one frontend lookup: {E} edge slots, "
                    f"{int(cmask.sum())} real, 4 levels",
        "e1_ms": m_ms, "e1_plain_ms": m_plain, "e1_bound_ms": m_bound,
        **probes["corr_window"],
        "probe_launches": probe_launches["corr_window"]
        + probe_launches["corr_window_unrolled"],
        "global_chunk_ms": mma["global_chunk"]["kernel2_ms"],
        "frontend_update_ms": upd_ms,
        "frontend_update_device_ms": upd_dev_ms,
        "tracked_frame_ms_before_window": pre_ms,
        "tracked_frame_ms_after_window": post_ms,
        "loop_ba_ms": loop_ms,
        "global_ba_ms": global_ms,
        "global_ba_step_profile": {"wall_ms": gba_ms,
                                   "device_ms": gba_dev_ms},
        "filler_s": fill_s,
        "filler_stage_s": fill_stage_s,
        "render_frames_s": render_s,
    }, {
        "name": "corr_window_mma",
        "route": "cuda",
        "source": "mneslam_tpu_torch/kernels/csrc/corr_window_mma.cu",
        "replaces": "mneslam_tpu/ops/pallas_kernels.py:114",
        "launches": mlaunches["corr_window_mma"],
        "launches_by_path": {"slam_pallas_mxu":
                             mlaunches["corr_window_mma"]},
        "max_abs_err": max(v["max_abs_err"] for v in mma.values()),
        "tolerance": f"{MMA_RTOL:.3g} x dot of |f1|, |f2| + {CORR_ATOL:g}",
        "ms": mma["frontend"]["ms"],
        "plain_ms": mma["frontend"]["plain_ms"],
        "bound_ms": mma["frontend"]["bound_ms"],
        "bound_by": mma["frontend"]["bound_by"],
        "library_ms": None,
        "timed_as": f"one frontend lookup: {E} edge slots, 75 real, 4 "
                    f"levels; bound: the useful flops at the TF32 "
                    f"tensor-core rate",
        "kernel2_ms_same_call": mma["frontend"]["kernel2_ms"],
        "global_chunk": mma["global_chunk"],
    }, {
        "name": "corr_window_per_level",
        "route": "cuda",
        "source": "mneslam_tpu_torch/kernels/csrc/corr_window.cu",
        "replaces": "mneslam_tpu/ops/pallas_kernels.py:241",
        "launches": o_launches["corr_window_per_level"],
        "launches_by_path": {"oracle_pallas_per_level":
                             o_launches["corr_window_per_level"]},
        "max_abs_err": p_err,
        "tolerance": f"{CORR_RTOL:.3g} x dot of |f1|, |f2| + {CORR_ATOL:g}",
        "ms": p_ms,
        "plain_ms": p_plain,
        "bound_ms": p_bound,
        "bound_by": p_by,
        "library_ms": None,
        "timed_as": f"the four levels launched one by one over {E} edge "
                    f"slots, all computed",
    }, probes["scatter_add_rows_blocked"],
        probes["scatter_add_rows_bucketed"]]
    idle = [k["name"] for k in kernels if not k["launches"] >= 1]
    if idle:
        raise SystemExit(f"kernels never launched on their path: {idle}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
