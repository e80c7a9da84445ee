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
     are right on the card);
  6. the mapping-only path: `MNESLAM.run_mapping_only` at the room0 widths
     (configs/Replica/room0.yaml) on the synthetic box room, with the
     kernels' launch counts set to 0 just before and read just after, then
     steady-state step times and a torch.profiler table of 5 iterations
     (chiprun_out/chip_smoke/mapping_profile.txt);
  7. the SLAM main path: `MNESLAM.run_slam` at the room0 widths (tracking
     at 320 x 640, buffer 250, frontend window 25) with random DROID
     weights in bf16, the counts set to 0 just before and read just after;
     then frontend-update times and a torch.profiler table of 3 updates
     (chiprun_out/chip_smoke/tracking_profile.txt);
  8. each kernel against its plain PyTorch version at the main path's
     shapes, with times (CUDA events) beside its bound and, where one
     exists, the one-call PyTorch yardstick.
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

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

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
# GPU vs CPU tracking parity after two updates (fp32 nets; cuDNN and oneDNN
# sum the convolutions in other orders): the CPU tests' bounds against JAX
TRACK_TOL = {"poses": 1e-4, "disps": 1e-3, "target": 1e-3, "weight": 1e-3}
# oracle tracking: key-pose translation error against the dataset
ORACLE_TOL_M = 0.05
SLAM_FRAMES = 20            # room0 SLAM path: frames of the box room
FLIP = ((1.0, 0.0, 0.0, 0.0), (0.0, -1.0, 0.0, 0.0), (0.0, 0.0, -1.0, 0.0),
        (0.0, 0.0, 0.0, 1.0))


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    from mneslam_tpu_torch.kernels.corr_window import corr_window_multilevel
    from mneslam_tpu_torch.kernels.scatter_add_rows import scatter_add_rows
    from mneslam_tpu_torch.slam import MNESLAM

    cfg = make_config(ROOM0)
    cfg["dataset"] = "synthetic"
    cfg["mode"] = "mapping"
    cfg["data"]["output"] = RUN_OUT
    # the box room [-0.95, 0.95]^3 lies inside room0's mapping bound
    ds = SyntheticBoxDataset(cfg, num_frames=11, half=0.95)
    slam = MNESLAM(cfg, ds, rank=0, device="cuda")

    torch.cuda.synchronize()
    scatter_add_rows.launches = 0
    corr_window_multilevel.launches = 0
    t0 = time.perf_counter()
    metrics = slam.run_mapping_only(log_every=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if corr_window_multilevel.launches != 0:
        raise SystemExit("the mapping-only path launched corr_window")
    launches = scatter_add_rows.launches
    return slam, cfg, metrics, seconds, launches


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


def tiny_slam_config(out_dir):
    from mneslam_tpu_torch.config import make_config

    H, W = 64, 96
    return make_config({
        "mode": "slam",
        "data": {"output": out_dir, "exp_name": "oracle"},
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


def oracle_tracking():
    """A tiny SLAM run on the GPU with ground-truth reprojection targets
    in place of the DROID update (tests/test_slam_full.py's oracle) ->
    (keyframes, max key-pose translation error in m)."""
    import numpy as np
    import torch

    from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
    from mneslam_tpu_torch.ops import lie, projective
    from mneslam_tpu_torch.slam import MNESLAM

    cfg = tiny_slam_config(os.path.join(RUN_OUT, "oracle"))
    ds = SyntheticBoxDataset(cfg, num_frames=16)
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
                torch.zeros((n, 576, h, w), device="cuda"))

    slam = MNESLAM(cfg, ds, device="cuda", update_fn=update_fn,
                   agg_fn=agg_fn)
    slam.run_slam()
    key = np.load(os.path.join(slam.out_dir, "key_est_poses.npy"))
    ts = np.load(os.path.join(slam.out_dir, "key_timestamps.npy"))
    ref = np.stack([ds[int(t)]["c2w"] for t in ts])
    err = np.linalg.norm(key[:, :3, 3] - ref[:, :3, 3], axis=-1)
    return len(ts), float(err.max())


def slam_main_path():
    """SLAM mode at room0 widths through the user entry point; -> (slam,
    cfg, results, seconds, {kernel: launches})."""
    import torch

    from mneslam_tpu_torch.config import make_config
    from mneslam_tpu_torch.configs import ROOM0
    from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
    from mneslam_tpu_torch.kernels.corr_window import corr_window_multilevel
    from mneslam_tpu_torch.kernels.scatter_add_rows import scatter_add_rows
    from mneslam_tpu_torch.slam import MNESLAM

    cfg = make_config(ROOM0)
    cfg["dataset"] = "synthetic"
    cfg["data"]["output"] = RUN_OUT
    cfg["data"]["exp_name"] = "room0_slam"
    # random weights give flows of no meaning: admit every frame so that
    # the frontend initialises (warmup 12) and tracks the rest
    cfg["tracking"]["motion_filter"]["thresh"] = -1.0
    ds = SyntheticBoxDataset(cfg, num_frames=SLAM_FRAMES, half=0.95)
    slam = MNESLAM(cfg, ds, rank=0, device="cuda")

    torch.cuda.synchronize()
    corr_window_multilevel.launches = 0
    scatter_add_rows.launches = 0
    t0 = time.perf_counter()
    results = slam.run_slam()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"corr_window": corr_window_multilevel.launches,
                "scatter_add_rows": scatter_add_rows.launches}
    return slam, cfg, results, seconds, launches


def corr_path_inputs(slam, n_real=75, seed=0):
    """The multi-level kernel's inputs at the frontend's shapes: the final
    buffer's features, the graph's edges topped up with random pairs of
    live keyframes to n_real real edges in the capacity-91 table, their
    reprojected lookup centres."""
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
    cap = graph.capacity
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


def corr_bound_ms(f1, levels, ii, jj, xs, mask):
    """The least time for the real edges' work: bytes (f1 rows of the
    distinct source frames, the padded levels of the distinct target
    frames, the slab starts, the output, each once) over the HBM rate, and
    fp32 operations (2 C per output) over the CUDA cores' rate; -> (ms,
    "bytes" or "operations", bytes, flops)."""
    real = mask != 0
    E_real = int(real.sum())
    HW, C = f1.shape[1], f1.shape[2]
    L = len(levels)
    n_i = int(ii[real].unique().numel())
    n_j = int(jj[real].unique().numel())
    nbytes = (n_i * HW * C * 4 + n_j * sum(lv.shape[1] for lv in levels) * C
              * 4 + E_real * HW * L * 4 + E_real * HW * L * 64 * 4)
    flops = 2 * C * 64 * L * HW * E_real
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations", nbytes, flops)


def check_corr(got, ref, mag, mask=None):
    """Kernel output vs the plain version; masked edges must be exactly
    zero. -> (max abs error, max error / tolerance); SystemExit past it."""
    import torch

    torch.cuda.synchronize()
    err = (got - ref).abs()
    ratio = float((err / (CORR_RTOL * mag + CORR_ATOL)).max())
    if not ratio <= 1.0:
        raise SystemExit(f"corr_window disagrees with its plain version: "
                         f"error / tolerance {ratio}")
    if mask is not None and bool(got[mask == 0].any()):
        raise SystemExit("corr_window wrote non-zeros for masked edges")
    return float(err.max()), ratio


def main():
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

    # 5. oracle tracking on the card
    n_key, pose_err = oracle_tracking()
    log(f"oracle tracking: {n_key} keyframes, key-pose translation error "
        f"max {pose_err:.3e} m (limit {ORACLE_TOL_M} m)")
    if not pose_err < ORACLE_TOL_M:
        raise SystemExit("oracle tracking did not recover the poses")

    # 6. the mapping-only path
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

    # 7. the SLAM main path
    log(f"SLAM main path: room0 widths (tracking 320 x 640, buffer 250, "
        f"warmup 12, frontend window 25, 91 edge slots), random DROID "
        f"weights in bf16, motion_filter.thresh -1; cut to {SLAM_FRAMES} "
        f"frames of the synthetic box room so that the keyframe count stays "
        f"within the frontend window (loop BA and global BA are not ported)")
    slam_s, scfg, sres, sseconds, slaunches = slam_main_path()
    tracker = slam_s.tracker
    graph = tracker.frontend.graph
    n_map = len(slam_s.mapped_timestamps)
    s_iters = (int(scfg["mapping"]["first_iters"])
               + (n_map - 1) * int(scfg["mapping"]["iters"]))
    n_corr = tracker.motion_filter.comparisons + graph.updates
    log(f"SLAM main path: {SLAM_FRAMES} frames, {tracker.counter} keyframes "
        f"tracked ({tracker.frontend.removed_count} culled), {n_map} mapped "
        f"({s_iters} mapping iterations) in {sseconds:.2f} s; "
        f"{tracker.motion_filter.comparisons} motion-filter comparisons + "
        f"{graph.updates} frontend updates; launches "
        f"{json.dumps(slaunches)}")
    if slaunches["corr_window"] != n_corr:
        raise SystemExit(f"corr_window launches {slaunches['corr_window']} "
                         f"!= {n_corr} lookups counted by the port")
    if slaunches["scatter_add_rows"] != SCATTERS_PER_ITER * s_iters:
        raise SystemExit(f"scatter launches {slaunches['scatter_add_rows']}"
                         f" != {SCATTERS_PER_ITER} x {s_iters}")
    if min(slaunches.values()) < 1:
        raise SystemExit("a kernel of the SLAM path was never launched")
    n_kf = tracker.counter
    finite = {
        "poses": bool(torch.isfinite(tracker.state.poses[:n_kf]).all()),
        "disps": bool(torch.isfinite(tracker.state.disps[:n_kf]).all()),
        "losses": all(math.isfinite(v) for m in slam_s.metrics_log
                      for v in m.values()),
    }
    log(f"SLAM main path: finite {json.dumps(finite)}; last keyframe "
        f"metrics {json.dumps(slam_s.metrics_log[-1])}; {json.dumps(sres)}")
    if not all(finite.values()):
        raise SystemExit("non-finite poses, disps or losses in the SLAM path")
    stages = slam_s.timers.summary()
    frame_ms = 1e3 * stages["track_frame"]["total_s"] / SLAM_FRAMES
    log(f"SLAM host stage timers: {json.dumps(stages)}")
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
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                st = graph.update(st, use_inactive=True)
            torch.cuda.synchronize()
    tracker.state = st
    events = prof.key_averages()
    kernels_run = [e for e in events if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation]
    upd_dev_ms = 1e-3 * sum(e.self_device_time_total
                            for e in kernels_run) / 3
    upd_launches = sum(e.count for e in kernels_run) / 3
    top = sorted(kernels_run, key=lambda e: -e.self_device_time_total)[:6]
    top_s = "; ".join(f"{e.key[:60]} {1e-3 * e.self_device_time_total / 3:.3f}"
                      for e in top)
    path = os.path.join(OUT, "tracking_profile.txt")
    with open(path, "w") as f:
        f.write(f"{card}: 3 frontend updates at room0 widths "
                f"({graph.n_active} active edges)\n"
                + events.table(sort_by="self_cuda_time_total", row_limit=40))
    log(f"SLAM slice: {frame_ms:.1f} ms per tracked frame (host clock, "
        f"motion filter + frontend, mean over {SLAM_FRAMES} frames), "
        f"{upd_ms:.2f} ms per frontend update ({graph.n_active} active "
        f"edges), {1e3 * stages['map_keyframe']['total_s'] / n_map:.1f} ms "
        f"per mapped keyframe (mean, the first with 500 iterations) on "
        f"{card}")
    log(f"tracking profile: {upd_launches:.0f} kernel launches and "
        f"{upd_dev_ms:.3f} ms of kernels per frontend update, i.e. the "
        f"device idles {100 * (1 - upd_dev_ms / upd_ms):.1f}% of the "
        f"{upd_ms:.2f} ms update; top kernels (ms per update): {top_s}; "
        f"table in {path}")

    # 8. kernels against their plain versions at the main path's shapes
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
        corr_window, corr_window_multilevel, corr_window_multilevel_plain,
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

    # kernel 3: the per-level entry, each level of the same 91 edges
    p_ms = p_plain = p_bound = 0.0
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
        p_bound += corr_bound_ms(f1, [levels[lvl]], ii, jj, xl[..., None],
                                 torch.ones_like(cmask))[0]
    log(f"corr_window (kernel 3, one level per launch) E {E} (all computed)"
        f": four levels {p_ms:.4f} ms, plain {p_plain:.4f} ms, bound "
        f"{p_bound:.4f} ms, max abs err {p_err:.3e}")

    kernels = [{
        "name": "scatter_add_rows",
        "route": "cuda",
        "source": "mneslam_tpu_torch/kernels/csrc/scatter_add_rows.cu",
        "replaces": "mneslam_tpu/ops/pallas_kernels.py:283",
        "launches": slaunches["scatter_add_rows"],
        "launches_by_path": {"slam": slaunches["scatter_add_rows"],
                             "mapping": map_launches},
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
        "iter_ms": iter_ms,
        "iter_device_ms": device_ms,
        "keyframe_ms": kf_ms,
    }, {
        "name": "corr_window",
        "route": "cuda",
        "source": "mneslam_tpu_torch/kernels/csrc/corr_window.cu",
        "replaces": "mneslam_tpu/ops/pallas_kernels.py:176",
        "also_replaces": "mneslam_tpu/ops/pallas_kernels.py:241 "
                         "(one level per launch, wrapper corr_window)",
        "launches": slaunches["corr_window"],
        "launches_by_path": {"slam": slaunches["corr_window"],
                             "mapping": 0},
        "max_abs_err": max(c_err, m_err, p_err),
        "tolerance": f"{CORR_RTOL:.3g} x dot of |f1|, |f2| + {CORR_ATOL:g}",
        "ms": c_ms,
        "plain_ms": c_plain,
        "bound_ms": c_bound,
        "bound_by": c_by,
        "library_ms": None,
        "timed_as": f"one frontend lookup: {E} edge slots, "
                    f"{int(cmask.sum())} real, 4 levels",
        "e1_ms": m_ms, "e1_plain_ms": m_plain, "e1_bound_ms": m_bound,
        "per_level_ms": p_ms, "per_level_plain_ms": p_plain,
        "per_level_bound_ms": p_bound,
        "frontend_update_ms": upd_ms,
        "frontend_update_device_ms": upd_dev_ms,
        "tracked_frame_ms": frame_ms,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
