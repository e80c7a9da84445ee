"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
  1. the card's name and power limit;
  2. build every CUDA kernel of the port from this checkout's sources;
  3. small parity: a few mapper steps of a tiny config on the GPU agree with
     the same steps on the CPU (the plain path, which the CPU tests hold
     against the JAX package);
  4. the main path: mapping-only mode through `MNESLAM.run_mapping_only` at
     the room0 widths (configs/Replica/room0.yaml) on the synthetic box
     room, with every kernel's launch count read just before and after,
     then steady-state step times and a torch.profiler table of 5
     iterations (chiprun_out/chip_smoke/mapping_profile.txt);
  5. each kernel against its plain PyTorch version at the main path's
     shapes, with times (CUDA events) beside its bound and the one-call
     PyTorch yardstick.
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
    metrics, seconds, scatter launches)."""
    import torch

    from mneslam_tpu_torch.config import make_config
    from mneslam_tpu_torch.configs import ROOM0
    from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
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
    t0 = time.perf_counter()
    metrics = slam.run_mapping_only(log_every=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
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

    # 4. main path
    slam, cfg, metrics, seconds, launches = main_path()
    n_kf = len(metrics)
    iters = (int(cfg["mapping"]["first_iters"])
             + (n_kf - 1) * int(cfg["mapping"]["iters"]))
    log(f"main path: room0 widths, {n_kf} keyframes, {iters} iterations in "
        f"{seconds:.2f} s; scatter launches {launches}")
    for m in metrics:
        log(f"  keyframe metrics: {json.dumps(m)}")
    if launches != SCATTERS_PER_ITER * iters:
        raise SystemExit(f"scatter launches {launches} != "
                         f"{SCATTERS_PER_ITER} x {iters}")
    if not all(math.isfinite(v) for m in metrics for v in m.values()):
        raise SystemExit("non-finite loss in the main path")
    from mneslam_tpu_torch.models.scene_rep import param_leaves
    if not all(bool(torch.isfinite(p).all())
               for p in param_leaves(slam.map_state.params)):
        raise SystemExit("non-finite parameters after the main path")
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

    # 5. kernels against their plain versions at the main path's shapes
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

    kernels = [{
        "name": "scatter_add_rows",
        "route": "cuda",
        "source": "mneslam_tpu_torch/kernels/csrc/scatter_add_rows.cu",
        "replaces": "mneslam_tpu/ops/pallas_kernels.py:283",
        "launches": launches,
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
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
