"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
  1. the card's name and power limit;
  2. build every CUDA kernel of the port from this checkout's sources (one
     nvcc per source, started together) and the host marching-tetrahedra
     polygoniser (g++, in parallel with them);
  3. small parity: a few mapper steps of a tiny config on the GPU agree with
     the same steps on the CPU (the plain path, which the CPU tests hold
     against the JAX package); 3b. mesh parity: the same steps on one
     frame of the tiny box room on both devices, then `extract_mesh` with
     the keyframe's observed space on both: the SDF volumes within rtol
     1e-4 / atol 1e-5, the vertex counts within 4, eval_mesh of the GPU
     mesh against the CPU mesh within 0.1 cm (accuracy and completion),
     and the native and numpy polygonisers give the same mesh from the GPU
     volume;
  4. tracking parity: two factor-graph updates of a tiny shared keyframe
     buffer with the same random DROID weights, GPU vs CPU, in fp32. The
     GPU side runs twice by default (printed: index_add_'s atomics make
     its sums run-dependent) and twice with
     `torch.use_deterministic_algorithms` (CUBLAS_WORKSPACE_CONFIG is set
     before CUDA starts): those two must be bit-identical and hold the
     tolerances against the CPU (`mneslam_tpu_torch/tools/
     prof_determinism.py` takes the gap apart);
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
     (chiprun_out/chip_smoke/mapping_profile.txt). Its terminate must write
     mesh/final_mesh.ply and final_mesh_culled.ply; 7b. the mesh step by
     step on that map (the SDF grid on the card timed with CUDA events,
     the copy to the host, the polygoniser, the weld, the observed-space
     filter, vertex colours, the cull; vertex and face counts; eval_mesh of
     the culled mesh against the box room's walls; the raw triangle
     vertices inside and outside the observed space, and the weld's time
     on the triangles wholly inside), and again at
     mesh.voxel_eval (a snapshot's cost); 7c. one keyframe rendered whole
     (680 x 1200) with its PSNR and depth L1, its panel written where
     matplotlib is installed; 7d. resume: a tiny mapping run interrupted
     after two keyframes, its full state loaded by a fresh agent that maps
     the third, against the uninterrupted run (phase 3's parameter
     tolerance; kernel 1 launches after the resume);
  8. the SLAM main path: `MNESLAM.run_slam` at the room0 widths (tracking
     at 320 x 640, buffer 250, frontend window 25) with random DROID
     weights in bf16 for 80 frames: loop BA dense and sparse, global BA
     dense, chunked and sparse + chunked (checked by the port's counters),
     the filler and the APE; the counts set to 0 just before and read just
     after; times per tracked frame, per loop BA, per global BA; then
     torch.profiler tables of 3 frontend updates and of one sparse global-
     BA step (chiprun_out/chip_smoke/{tracking,global_ba}_profile.txt); its
     terminate must write both meshes, and the mesh step's seconds (79
     keyframes' depths, the grid, the cull) are printed;
  9. the same path with MNESLAM_CORR_IMPL=pallas_mxu for 32 frames: every
     correlation lookup is a launch of kernel 2b and none of kernel 2;
 10. each kernel against its plain PyTorch version at the main path's
     shapes, with times (CUDA events) beside its bound and, where one
     exists, the one-call PyTorch yardstick; the correlation kernels 2,
     2b and 3 (box design) also timed in turns with their row design of
     the first port (`*_rows`, checked too) on the frontend's inputs, the
     same edges with smooth centres, the motion filter's single edge and
     a 256-edge chunk, each with the share of pixel tiles on the box path;
 11. the TPU probes on the H100 (`mneslam_tpu_torch/tools/prof_corr.py`,
     `prof_scatter.py` in fp32 and bf16): every variant checked against
     its plain version, then timed, with the launch counts set to 0 just
     before and read just after; the scatter probe also runs kernel 1 and
     the blocked and bucketed scatters (the thread-block cluster design at
     every (T, CL) the card can hold, with its cudaOccupancyMaxActive-
     Clusters, and the tile design of the first port) on one
     mapping iteration's real index stream, with its busiest bucket
     (every result in probes.json beside the profile tables; the stream's
     indices in output/chip_smoke/real_stream.pt, the input of
     `mneslam_tpu_torch/tools/scatter_ablation.py`). The phase's time is
     printed beside its budget of 90 s;
 12. multi-agent collaboration (`mneslam_tpu_torch/agents/`): 12a. on
     phase 3's tiny config, GPU against CPU on the same inputs: the stub
     descriptor (1e-6), NetVLAD with random weights (rtol 1e-4), render
     alignment for 10 iterations (best c2w 1e-4, losses rtol 1e-4; kernel
     1 never launches) and 3 distillation iterations through the idx / u
     seams (parameters within 1e-4; 6 kernel-1 launches per iteration);
     12b. phase 7's room0 map, a keyframe's pose perturbed and aligned back
     at `mapping.sample` rays for `mapping.loop_iters` iterations: the
     translation error under half its start and the best loss under a
     quarter of the initial one; 12c. two agents under
     `MultiAgentRunner.run_slam` at room0 widths with the ROOM0
     collaboration keys, on frames 0-27 and 14-41 of one 42-frame
     box-room trajectory (bf16 DROID encoders with random weights, the
     update's flow and weights replaced by ground-truth reprojection
     targets as in phases 5-6, every frame admitted; with the random
     update net the key poses leave the room's bound and nothing is
     distilled): both terminates' outputs, the descriptor DB holding every
     mapped keyframe, a cross-agent loop aligned, a distillation by each
     agent and its fused mesh, kernel 1's launches = 6 x (mapping +
     distillation iterations), kernel 2's = the agents' lookups; times
     per tracked frame, mapped keyframe, alignment, distillation and fused
     mesh, and a torch.profiler table of 5 distillation iterations
     (chiprun_out/chip_smoke/distill_profile.txt); 12d. `python -m
     mneslam_tpu_torch.cli --num_agents 2 --spawn` on phase 3's tiny
     config: both children exit 0 and write the on-disk exchange. The
     phase's time is printed beside its budget of 240 s;
 13. the shipped single-device configs on files: 13a. whether cv2 and PIL
     import, and the port's PNG codec (`data/image_io.py`) writing and
     reading 8-bit RGB and 16-bit depth at 480 x 640 with each filter type
     bit for bit (and against cv2 where it is there); 13b. the box room
     rendered at configs/TUM/fr1_desk.yaml's intrinsics and written as a
     TUM folder (24 frames and one colour frame without depth), the port's
     `validate_dataset --kind tum --no-smoke` on it (exit 0), then
     `cli.main --config <a yaml that inherits fr1_desk.yaml> --mode slam`
     on the card with the oracle update: the association's count, APE
     (Sim(3)) under 5 cm, kernel 2's launches equal to the lookups, both
     meshes (over the box's bound); ms per tracked frame and mapped
     keyframe; kernel 2 at its 30 x 40 grid (ragged tiles, levels 15 x 20,
     7 x 10, 3 x 5) against its plain version, timed beside its bound;
     13c. the mapping-only path with configs/Replica/room0_fast.yaml's
     keys (bf16 render) on phase 7's box room: last PSNR above 16 dB,
     every kernel-1 launch on bf16 values (6 per iteration), ms per
     iteration and keyframe beside phase 7's fp32 ones, kernel 1's bf16
     time at its shapes, and the tiny config's 3 mapper steps in bf16, GPU
     vs CPU (loss rtol 1e-4, parameters 5e-4). The phase's time is printed
     beside its budget of 180 s.
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

# cuBLAS picks a deterministic reduction only with a fixed workspace, read
# when CUDA initialises: phase 4 runs with deterministic algorithms
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
# one bf16 ulp relative to the value (7 explicit mantissa bits)
BF16_ULP = 2.0 ** -7
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
# the room0 paths' synthetic box room [-BOX_HALF, BOX_HALF]^3
BOX_HALF = 0.95
# mesh parity: the tiny map's grid covers a 0.5 x 0.5 m patch of the wall
# (z = -2) that frame 0 of the tiny box room faces, at 2.5 cm
MESH_PARITY_BOUND = [[0.25, 0.75], [-0.25, 0.25], [-2.2, -1.7]]
MESH_PARITY_VOXEL = 0.025
MESH_PARITY_STEPS = 20
# eval_mesh of the GPU mesh against the CPU mesh, accuracy and completion
MESH_PARITY_CM = 0.1
# the GPU volume against the CPU volume, per voxel: the CPU parity tests'
# fp32 bounds (the maps differ by kernel 1's atomic sum order)
MESH_PARITY_SDF_RTOL = 1e-4
MESH_PARITY_SDF_ATOL = 1e-5
# vertex counts, GPU against CPU: a voxel whose SDF lies within the fp32
# difference of the level set may flip sides and move a vertex or two
MESH_PARITY_VERTS = 4
# small parity's and the resume check's parameter tolerance
PARAM_TOL = 1e-4
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
        corr_window_multilevel_mma_rows, corr_window_multilevel_rows,
        corr_window_multilevel_unrolled)
    from mneslam_tpu_torch.kernels.scatter_add_rows import (
        scatter_add_rows, scatter_add_rows_per_warp)
    from mneslam_tpu_torch.kernels.scatter_rows_blocked import (
        scatter_add_rows_blocked, scatter_add_rows_blocked_tiles)
    from mneslam_tpu_torch.kernels.scatter_rows_bucketed import (
        scatter_add_rows_bucketed, scatter_add_rows_bucketed_tiles)

    return {"scatter_add_rows": scatter_add_rows,
            "corr_window": corr_window_multilevel,
            "corr_window_mma": corr_window_multilevel_mma,
            "corr_window_per_level": corr_window,
            "scatter_add_rows_per_warp": scatter_add_rows_per_warp,
            "corr_window_unrolled": corr_window_multilevel_unrolled,
            "corr_window_rows": corr_window_multilevel_rows,
            "corr_window_mma_rows": corr_window_multilevel_mma_rows,
            "scatter_add_rows_blocked": scatter_add_rows_blocked,
            "scatter_add_rows_bucketed": scatter_add_rows_bucketed,
            "scatter_add_rows_blocked_tiles": scatter_add_rows_blocked_tiles,
            "scatter_add_rows_bucketed_tiles":
                scatter_add_rows_bucketed_tiles}


def reset_launches():
    """Every kernel wrapper's launch count to 0 (just before a path)."""
    import torch

    torch.cuda.synchronize()
    for w in _wrappers().values():
        w.launches = 0
    _wrappers()["scatter_add_rows"].launches_bf16 = 0


def read_launches() -> dict:
    """Launches by wrapper; `scatter_add_rows_bf16`: kernel 1's launches on
    bf16 values, counted within `scatter_add_rows` too."""
    ws = _wrappers()
    return {**{name: w.launches for name, w in ws.items()},
            "scatter_add_rows_bf16": ws["scatter_add_rows"].launches_bf16}


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


def small_parity(render_dtype="float32"):
    """Three mapper steps on identical inputs, GPU vs CPU, with
    `training.render_dtype`; -> (losses, max relative loss difference, max
    parameter difference)."""
    import numpy as np
    import torch

    from mneslam_tpu_torch.mapping.mapper import Mapper, make_optimizer
    from mneslam_tpu_torch.models.scene_rep import SceneRep, param_leaves
    from mneslam_tpu_torch.utils.convert import (params_from_jax,
                                                 params_to_numpy)

    cfg = tiny_config(os.path.join(RUN_OUT, "parity"))
    cfg["training"]["render_dtype"] = render_dtype
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


def box_room_mesh(half: float):
    """The synthetic box room's six walls as 12 triangles (the ground
    truth of the room0 paths' meshes)."""
    import numpy as np

    v = np.array([[x, y, z] for x in (-half, half) for y in (-half, half)
                  for z in (-half, half)], np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    f = np.array([t for a, b, c, d in quads for t in ((a, b, c), (a, c, d))],
                 np.int64)
    return v, f


def n_eval_samples(verts, faces, spacing_m=1e-3):
    """Surface samples for eval_mesh so that two samplings of one mesh lie
    about `spacing_m` apart (their accuracy then reads about half that):
    area / spacing^2, within [2e5, 2e6]."""
    import numpy as np

    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    area = float(0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0),
                                      axis=1).sum())
    return int(min(max(area / spacing_m ** 2, 2e5), 2e6)), area


def mesh_parity():
    """The same MESH_PARITY_STEPS mapper steps of the tiny config on frame
    0 of the tiny box room, on the GPU and on the CPU from the same
    weights and inputs, then `extract_mesh` with the keyframe's observed
    space on both -> dict of the comparisons."""
    import numpy as np
    import torch

    from mneslam_tpu_torch.data.rays import rays_from_pose
    from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
    from mneslam_tpu_torch.eval import recon
    from mneslam_tpu_torch.mapping import mesher
    from mneslam_tpu_torch.mapping.mapper import Mapper, make_optimizer
    from mneslam_tpu_torch.models.scene_rep import SceneRep
    from mneslam_tpu_torch.ops import mc
    from mneslam_tpu_torch.utils.convert import (params_from_jax,
                                                 params_to_numpy)

    t0 = time.perf_counter()
    cfg = tiny_config(os.path.join(RUN_OUT, "mesh_parity"))
    cfg["mapping"]["marching_cubes_bound"] = MESH_PARITY_BOUND
    cfg["meshing"]["resolution"] = MESH_PARITY_VOXEL
    item = SyntheticBoxDataset(cfg, num_frames=1)[0]
    H, W = item["depth"].shape
    rng = np.random.default_rng(1)
    S = int(cfg["training"]["n_range_d"]) + int(cfg["training"]["n_samples_d"])
    batches = [(rng.integers(0, H * W, 448),
                rng.uniform(size=(448, S)).astype(np.float32))
               for _ in range(MESH_PARITY_STEPS)]
    cam = cfg["cam"]
    intr = np.asarray([cam["fx"], cam["fy"], cam["cx"], cam["cy"]],
                      np.float32)
    observed = (item["c2w"][None], intr, H, W, item["depth"][None],
                3.0 * float(cfg["training"]["trunc"]))
    params_np = None
    out = {}
    for dev in ("cpu", "cuda"):
        scene = SceneRep(cfg, dev)
        mapper = Mapper(cfg, scene, num_kf=2, rays_per_kf=16)
        state = mapper.init_state(torch.Generator(device=dev).manual_seed(0))
        if params_np is None:
            params_np = params_to_numpy(state.params)
        state.params = params_from_jax(params_np, device=dev)
        state.optimizer = make_optimizer(cfg, state.params)
        f = {k: torch.as_tensor(item[k], device=dev)
             for k in ("direction", "rgb", "depth", "c2w")}
        for idx, u in batches:
            i = torch.as_tensor(idx, device=dev)
            o, d = rays_from_pose(f["direction"].reshape(-1, 3)[i], f["c2w"])
            mapper.step(state, o, d, f["rgb"].reshape(-1, 3)[i],
                        f["depth"].reshape(-1)[i][:, None],
                        u=torch.as_tensor(u, device=dev))
        bound = np.asarray(MESH_PARITY_BOUND, np.float32)
        vol, _, _ = mesher.sdf_grid(scene, state.params, bound,
                                    MESH_PARITY_VOXEL)
        verts, faces, _ = mesher.extract_mesh(scene, state.params, cfg,
                                              observed=observed)
        out[dev] = (vol, verts, faces)
    (vol_c, v_c, f_c), (vol_g, v_g, f_g) = out["cpu"], out["cuda"]
    if not (len(v_g) and len(v_c)):
        raise SystemExit(f"mesh parity: an empty mesh ({len(v_g)} GPU, "
                         f"{len(v_c)} CPU vertices)")
    n, area = n_eval_samples(v_g, f_g)
    m = recon.eval_mesh(v_g, f_g, v_c, f_c, n_samples=n)
    raw_n = mc.polygonize(vol_g, 0.0, 3.0)
    raw_p = mc.polygonize(vol_g, 0.0, 3.0, native=False)
    vn, fn = mc.marching_cubes(vol_g, 0.0, truncation=3.0)
    vp, fp = mc.marching_cubes(vol_g, 0.0, truncation=3.0, native=False)

    def rows(a):
        return a[np.lexsort(a.T[::-1])]

    return {
        "seconds": time.perf_counter() - t0,
        "grid": list(vol_g.shape),
        "sdf_max_abs_diff": float(np.abs(vol_g - vol_c).max()),
        "sdf_err_ratio": float((np.abs(vol_g - vol_c) / (
            MESH_PARITY_SDF_RTOL * np.abs(vol_c) + MESH_PARITY_SDF_ATOL)
        ).max()),
        "verts_gpu": len(v_g), "verts_cpu": len(v_c),
        "faces_gpu": len(f_g), "faces_cpu": len(f_c),
        "area_m2": area, "n_samples": n,
        "eval_gpu_vs_cpu": m,
        "native_raw_equal": bool(np.array_equal(rows(raw_n), rows(raw_p))),
        "native_faces_equal": bool(np.array_equal(rows(fn), rows(fp))),
        "native_verts_max_diff": float(np.abs(vn - vp).max())
        if vn.shape == vp.shape else float("inf"),
    }


def mesh_room0(slam, res):
    """The mapping-only run's terminate wrote both meshes; its mesh step's
    split from the agent's stage timers (host clock; the grid's stage waits
    for the device), the grid's device part again with CUDA events, the
    culled mesh against the box room's walls, and a mesh at
    mesh.voxel_eval (a snapshot's cost) -> dict."""
    import numpy as np
    import torch

    from mneslam_tpu_torch.eval import recon
    from mneslam_tpu_torch.mapping import mesher
    from mneslam_tpu_torch.ops import mc
    from mneslam_tpu_torch.utils.metrics import StageTimers

    t_phase = time.perf_counter()
    mesh_dir = os.path.join(slam.out_dir, "mesh")
    for name in ("final_mesh.ply", "final_mesh_culled.ply"):
        if not os.path.exists(os.path.join(mesh_dir, name)):
            raise SystemExit(f"mapping-only terminate wrote no {name}")
    if not res.get("mesh_verts", 0) > 0 or \
            not res.get("mesh_verts_culled", 0) > 0:
        raise SystemExit(f"mapping-only terminate: empty mesh {res}")
    cfg, scene, params = slam.config, slam.scene, slam.map_state.params
    bound = np.asarray(cfg["mapping"]["marching_cubes_bound"],
                       np.float32) * cfg["scale"]
    stages = slam.timers.summary()
    v, f, _ = mc.load_ply(os.path.join(mesh_dir, "final_mesh.ply"))
    cv, cf, _ = mc.load_ply(os.path.join(mesh_dir, "final_mesh_culled.ply"))
    gv, gf = box_room_mesh(BOX_HALF)
    out = {"final": {
        "seconds": {k: stages[k]["total_s"] for k in stages
                    if k.startswith("mesh")},
        "verts": len(v), "faces": len(f), "culled_verts": len(cv),
        "culled_faces": len(cf),
        # eval_mesh's own 200k samples, as the reference evaluation
        "eval_culled_vs_box": recon.eval_mesh(cv, cf, gv, gf)}}
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    vol, origin, spacing = mesher.sdf_volume(
        scene, params, bound, float(cfg["meshing"]["resolution"]))
    end.record()
    torch.cuda.synchronize()
    out["final"]["grid"] = list(vol.shape)
    out["final"]["sdf_grid_cuda_events_s"] = 1e-3 * start.elapsed_time(end)
    out["final"]["weld_input"] = weld_input_split(
        slam, vol.cpu().numpy(), origin, spacing)
    del vol
    timers = StageTimers()
    t0 = time.perf_counter()
    sv, sf, _ = mesher.extract_mesh(
        scene, params, cfg, voxel_size=float(cfg["mesh"]["voxel_eval"]),
        timers=timers)
    out["voxel_eval"] = {
        "total_s": time.perf_counter() - t0, "verts": len(sv),
        "faces": len(sf), "seconds": {k: v["total_s"] for k, v in
                                      timers.summary().items()}}
    out["seconds"] = time.perf_counter() - t_phase
    return out


def weld_input_split(slam, vol, origin, spacing):
    """How much of the weld's input the observed-space filter keeps: the
    raw triangle vertices of the final grid inside and outside the mapped
    keyframes' observed space (the filter's test, on the card), and the
    weld's time on the triangles wholly inside (terminate's "mesh/weld"
    stage welds all of them) -> dict."""
    import numpy as np
    import torch

    from mneslam_tpu_torch.mapping import cull
    from mneslam_tpu_torch.ops import mc

    cfg = slam.config
    tri = mc.polygonize(vol, float(cfg["meshing"].get("level_set", 0.0)),
                        3.0)
    kf_poses, intr, H, W, depths, eps = slam._observed_space()

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device="cuda")

    counts = cull.visible_counts(
        dev(tri * spacing + origin), dev(kf_poses), dev(intr), dev(depths),
        int(H), int(W), eps=float(eps) + float(np.linalg.norm(spacing)),
        chunk=1 << 18).cpu().numpy()
    inside = counts > 0
    tri_in = tri[np.repeat(inside.reshape(-1, 3).all(axis=1), 3)]
    t0 = time.perf_counter()
    v, _ = mc.weld(tri_in)
    return {"raw_verts": len(tri), "raw_verts_inside": int(inside.sum()),
            "raw_verts_outside": int((~inside).sum()),
            "weld_inside_s": time.perf_counter() - t0,
            "weld_inside_verts": len(v)}


def render_panel(slam):
    """The last mapped keyframe of the mapping-only run rendered whole
    (680 x 1200 rays through `render_image_rays`) on the card; its panel
    written where matplotlib is present -> dict."""
    import importlib.util

    import numpy as np
    import torch

    from mneslam_tpu_torch.eval import recon
    from mneslam_tpu_torch.utils import vis

    have_mpl = importlib.util.find_spec("matplotlib") is not None
    idx = int(slam.mapped_timestamps[-1])
    frame, pose = slam._frame_for_mapping(idx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    depth, rgb = slam.render_frame(frame, pose)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    mse = float(((rgb - frame["rgb"]) ** 2).mean())
    out = {"matplotlib": have_mpl, "frame": idx,
           "shape": list(depth.shape), "render_s": render_s,
           "psnr_db": -10.0 * math.log10(max(mse, 1e-12)),
           "depth_l1_cm": recon.depth_l1(depth.cpu().numpy(),
                                         frame["depth"].cpu().numpy()),
           "finite": bool(torch.isfinite(depth).all()
                          and torch.isfinite(rgb).all())}
    if have_mpl:
        path = os.path.join(RUN_OUT, "eval_vis", f"kf_{idx:05d}.jpg")
        vis.save_render_panel(path, frame["rgb"].cpu().numpy(),
                              frame["depth"].cpu().numpy(),
                              rgb.cpu().numpy(), depth.cpu().numpy(),
                              title=f"room0 mapping-only keyframe {idx}")
        out["panel"] = path
    return out


def resume_check():
    """A tiny mapping run on the card interrupted after two keyframes
    (0 and 3), its full state saved and loaded into a fresh agent, which
    maps keyframe 6; against the uninterrupted run -> dict with the
    largest parameter difference and kernel 1's launches after the
    resume."""
    import numpy as np

    from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
    from mneslam_tpu_torch.models.scene_rep import param_items
    from mneslam_tpu_torch.slam import MNESLAM

    t0 = time.perf_counter()

    def agent(exp):
        cfg = tiny_config(os.path.join(RUN_OUT, "resume"))
        cfg["data"]["exp_name"] = exp
        return MNESLAM(cfg, SyntheticBoxDataset(cfg, num_frames=9),
                       device="cuda")

    def map_kf(a, idx):
        frame, pose = a._frame_for_mapping(idx)
        a._map_keyframe(idx, frame, pose, first=not a.first_frame_mapped)

    full = agent("uninterrupted")
    full.run_mapping_only(log_every=100)
    part = agent("interrupted")
    for idx in (0, 3):
        map_kf(part, idx)
    path = os.path.join(RUN_OUT, "resume", "full_state.npz")
    part.save_full_state(path)
    resumed = agent("resumed")
    resumed.load_full_state(path)
    reset_launches()
    map_kf(resumed, 6)
    launches = read_launches()["scatter_add_rows"]
    diff = max(float((a.detach() - b.detach()).abs().max())
               for (_, a), (_, b) in zip(param_items(full.map_state.params),
                                         param_items(resumed.map_state.params)))
    iters = int(resumed.config["mapping"]["iters"])
    return {"seconds": time.perf_counter() - t0,
            "state_mb": os.path.getsize(path) / 2 ** 20,
            "max_param_diff": diff, "launches_after_resume": launches,
            "expected_launches": SCATTERS_PER_ITER * iters,
            "mapped": resumed.mapped_timestamps,
            "psnr": [float(m["psnr"]) for m in full.metrics_log[-1:]]
            + [float(resumed.metrics_log[-1]["psnr"])],
            "finite": bool(np.isfinite(diff))}


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
    ds = SyntheticBoxDataset(cfg, num_frames=11, half=BOX_HALF)
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
    error / tolerance). Raises SystemExit past the tolerance. For bf16
    values both sides round an fp32 sum to bf16, so one bf16 ulp (2^-7 of
    the plain result) is added to the tolerance."""
    import torch

    from mneslam_tpu_torch.kernels.scatter_add_rows import (
        scatter_add_rows, scatter_add_rows_plain)

    got = scatter_add_rows(idx, vals, n_rows).float()
    ref = scatter_add_rows_plain(idx, vals, n_rows).float()
    mag = scatter_add_rows_plain(idx, vals.float().abs(), n_rows)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    tol = SCATTER_RTOL * mag + SCATTER_ATOL
    if vals.dtype == torch.bfloat16:
        tol = tol + BF16_ULP * ref.abs()
    ratio = float((err / tol).max())
    if not ratio <= 1.0:
        raise SystemExit(f"scatter_add_rows disagrees with its plain version "
                         f"(n_rows {n_rows}): error / tolerance {ratio}")
    return float(err.max()), ratio


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


def oracle_fns(ds, intr8):
    """update_fn / agg_fn of a tracker whose update gets ground-truth
    reprojection targets in place of the DROID update (tests/
    test_slam_full.py's oracle, as `tools/validate_dataset` builds it);
    intr8: the intrinsics at 1/8 of the tracking resolution."""
    from mneslam_tpu_torch.tools.validate_dataset import oracle_fns as fns

    return fns(ds, intr8, "cuda")


def oracle_slam(cfg, ds):
    """`MNESLAM` on the GPU with the oracle tracker update (tiny config)."""
    from mneslam_tpu_torch.slam import MNESLAM

    update_fn, agg_fn = oracle_fns(ds, [60.0 / 8, 60.0 / 8, 47.5 / 8,
                                        31.5 / 8])
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


def slam_main_path(n_frames: int, exp_name: str, mesh_bound=None):
    """SLAM mode at room0 widths through the user entry point, the
    tracker's batches, loop BAs and global BAs timed as they run (each
    between two synchronisations); -> (slam, cfg, results, seconds,
    launches, {"batches", "loop", "global"} call records). `mesh_bound`
    replaces mapping.marching_cubes_bound (the terminate mesh's grid)."""
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
    if mesh_bound is not None:
        cfg["mapping"]["marching_cubes_bound"] = mesh_bound
    ds = SyntheticBoxDataset(cfg, num_frames=n_frames, half=BOX_HALF)
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


def corr_path_inputs(slam, n_real=75, cap=None, seed=0, smooth=False):
    """The multi-level kernels' inputs at a path's shapes: the final
    buffer's features, the frontend graph's edges topped up with random
    pairs of live keyframes to n_real real edges in a table of `cap` slots
    (default the frontend's 91), their reprojected lookup centres (with
    `smooth`, `prof_corr.smooth_coords` in their place)."""
    import numpy as np
    import torch

    from mneslam_tpu_torch.ops import correlation
    from mneslam_tpu_torch.tools.prof_corr import smooth_coords
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
    pyr = correlation.build_pyramid(st.fmaps)
    N, C, H, W = pyr[0].shape
    if smooth:
        coords = torch.as_tensor(smooth_coords(cap, H, W, seed=seed),
                                 device="cuda")
    else:
        coords, _ = video.reproject(st, graph.intrinsics, ii_t, jj_t)
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


def ab_ms(new, old, reps=20):
    """Two versions timed in turns, old, new, new, old (CUDA events, `reps`
    calls each after a warm-up); -> (new ms, old ms), each the mean of its
    two runs."""
    from mneslam_tpu_torch.tools.measure import cuda_ms

    o1, n1 = cuda_ms(old, reps), cuda_ms(new, reps)
    n2, o2 = cuda_ms(new, reps), cuda_ms(old, reps)
    return (n1 + n2) / 2, (o1 + o2) / 2


def corr_kernels(slam) -> dict:
    """Phase 10 (c): kernels 2 and 2b in the box design against their plain
    versions (2b also against kernel 2), on the path's inputs (`frontend`:
    the frontend's 91 slots, 75 real, reprojected centres), the same edges
    with smooth centres (`smooth`), the motion filter's single edge (`e1`)
    and one 256-edge chunk of a global BA's update (`chunk256`); each timed
    in turns with its row design of the first port (`*_rows`), which is
    checked as well; kernel 3, the per-level launch, the same way on the
    frontend and smooth inputs. Each case reports the bound and the share
    of (real edge, tile, level) that took the box path (`box_path_share`,
    by level). -> {kernel: {case: {...}}}."""
    import torch

    from mneslam_tpu_torch.kernels.corr_window import (
        box_path_share, corr_window, corr_window_multilevel,
        corr_window_multilevel_mma, corr_window_multilevel_mma_plain,
        corr_window_multilevel_mma_rows, corr_window_multilevel_plain,
        corr_window_multilevel_rows, corr_window_plain)
    from mneslam_tpu_torch.tools.measure import (TF32_FLOPS, corr_bound_ms,
                                                 cuda_ms)

    front = corr_path_inputs(slam)
    f1, levels, ii, jj, xs, w2ps, cmask = front
    W = slam.tracker.state.fmaps.shape[3]
    cases = {
        "frontend": front,
        "smooth": corr_path_inputs(slam, smooth=True),
        "e1": (f1[:2].contiguous(), [lv[:2].contiguous() for lv in levels],
               torch.zeros(1, dtype=torch.int32, device="cuda"),
               torch.ones(1, dtype=torch.int32, device="cuda"),
               xs[:1].contiguous(), w2ps,
               torch.ones(1, dtype=torch.int32, device="cuda")),
        "chunk256": corr_path_inputs(slam, n_real=256, cap=256),
    }
    res = {"corr_window": {}, "corr_window_mma": {},
           "corr_window_per_level": {}}
    for case, (f1c, lvc, iic, jjc, xsc, w2c, mc) in cases.items():
        args = (f1c, lvc, iic, jjc, xsc, w2c)
        abs_args = (f1c.abs(), [lv.abs() for lv in lvc], iic, jjc, xsc, w2c)
        share = box_path_share(xsc, [lv.shape[1] for lv in lvc], w2c, W, mc)
        mag = corr_window_multilevel_plain(*abs_args, mask=mc)
        ref = corr_window_multilevel_plain(*args, mask=mc)
        k2 = corr_window_multilevel(*args, W, mask=mc)
        e2, r2 = check_corr(k2, ref, mag, mc)
        e2r, r2r = check_corr(corr_window_multilevel_rows(*args, mask=mc),
                              ref, mag, mc,
                              what="corr_window_rows vs its plain version")
        del ref
        ref_b = corr_window_multilevel_mma_plain(*args, mask=mc)
        e2b, r2b = check_corr(corr_window_multilevel_mma(*args, W, mask=mc),
                              ref_b, mag, mc, MMA_RTOL,
                              "corr_window_mma vs its plain version")
        e2bk, r2bk = check_corr(corr_window_multilevel_mma(*args, W, mask=mc),
                                k2, mag, mc, MMA_RTOL,
                                "corr_window_mma vs corr_window")
        e2br, r2br = check_corr(corr_window_multilevel_mma_rows(*args,
                                                                mask=mc),
                                ref_b, mag, mc, MMA_RTOL,
                                "corr_window_mma_rows vs its plain version")
        del ref_b, mag, k2
        ms2, ms2r = ab_ms(lambda: corr_window_multilevel(*args, W, mask=mc),
                          lambda: corr_window_multilevel_rows(*args, mask=mc))
        ms2b, ms2br = ab_ms(
            lambda: corr_window_multilevel_mma(*args, W, mask=mc),
            lambda: corr_window_multilevel_mma_rows(*args, mask=mc))
        slow = case == "chunk256"
        plain = cuda_ms(lambda: corr_window_multilevel_plain(*args, mask=mc),
                        reps=2 if slow else 5, warmup=1)
        plain_b = cuda_ms(
            lambda: corr_window_multilevel_mma_plain(*args, mask=mc),
            reps=2, warmup=1)
        b2, by2, nbytes, flops = corr_bound_ms(*args[:5], mc)
        b2b, by2b = corr_bound_ms(*args[:5], mc, flops_per_s=TF32_FLOPS)[:2]
        E, n_real = xsc.shape[0], int(mc.sum())
        res["corr_window"][case] = {
            "ms": ms2, "rows_ms": ms2r, "plain_ms": plain, "bound_ms": b2,
            "bound_by": by2, "box_share": share,
            "max_abs_err": max(e2, e2r), "err_ratio": r2,
            "rows_err_ratio": r2r, "edges": E, "real": n_real}
        res["corr_window_mma"][case] = {
            "ms": ms2b, "rows_ms": ms2br, "plain_ms": plain_b,
            "bound_ms": b2b, "bound_by": by2b, "box_share": share,
            "max_abs_err": max(e2b, e2bk, e2br),
            "err_ratio": max(r2b, r2bk), "rows_err_ratio": r2br,
            "edges": E, "real": n_real}
        log(f"corr {case}: E {E} ({n_real} real) HW {xsc.shape[1]} C "
            f"{f1c.shape[2]} 4 levels, box path share by level "
            f"{[round(v, 4) for v in share]}; kernel 2 box {ms2:.4f} ms, "
            f"row design {ms2r:.4f} ms, plain {plain:.4f} ms, bound "
            f"{b2:.4f} ms by {by2} ({flops} flops at 67 TFLOP/s fp32, "
            f"{nbytes} bytes at 3.35 TB/s), err / tolerance {r2:.3f} "
            f"(rows {r2r:.3f}); kernel 2b box {ms2b:.4f} ms, row design "
            f"{ms2br:.4f} ms, plain {plain_b:.4f} ms, bound {b2b:.4f} ms by "
            f"{by2b} (TF32 rate), err / tolerance vs plain {r2b:.3f}, vs "
            f"kernel 2 {r2bk:.3f} (rows {r2br:.3f}); tolerances "
            f"{CORR_RTOL:.3g} / {MMA_RTOL:.3g} x dot of magnitudes + "
            f"{CORR_ATOL:g}; no one PyTorch call computes it")

        if case not in ("frontend", "smooth"):
            continue
        # kernel 3: each level of all the slots (no mask) in its own launch;
        # its row design is the row entry launched with that one level
        p_ms = p_rows = p_plain = p_err = p_ratio = 0.0
        for lvl in range(len(lvc)):
            xl = xsc[..., lvl].contiguous()
            a3 = (f1c, lvc[lvl], iic, jjc, xl, w2c[lvl])
            e, r = check_corr(corr_window(*a3, W), corr_window_plain(*a3),
                              corr_window_plain(f1c.abs(), lvc[lvl].abs(),
                                                iic, jjc, xl, w2c[lvl]))
            p_err, p_ratio = max(p_err, e), max(p_ratio, r)
            x1 = xl[..., None]
            new, old = ab_ms(lambda: corr_window(*a3, W),
                             lambda: corr_window_multilevel_rows(
                                 f1c, [lvc[lvl]], iic, jjc, x1, [w2c[lvl]]))
            p_ms, p_rows = p_ms + new, p_rows + old
            if case == "frontend":
                p_plain += cuda_ms(lambda: corr_window_plain(*a3), reps=5,
                                   warmup=1)
        p_bound, p_by = corr_bound_ms(*args[:5], torch.ones_like(mc))[:2]
        res["corr_window_per_level"][case] = {
            "ms": p_ms, "rows_ms": p_rows,
            "plain_ms": p_plain if case == "frontend" else None,
            "bound_ms": p_bound, "bound_by": p_by,
            "box_share": box_path_share(
                xsc, [lv.shape[1] for lv in lvc], w2c, W),
            "max_abs_err": p_err, "err_ratio": p_ratio}
        log(f"corr {case}, kernel 3 (one level per launch, all {E} slots "
            f"computed): four levels box {p_ms:.4f} ms, row design "
            f"{p_rows:.4f} ms, plain {p_plain:.4f} ms, bound {p_bound:.4f} "
            f"ms by {p_by}, err / tolerance {p_ratio:.3f}")
    return res


def corr_entry(corr, name, key, source, line, launches, by_path, rtol,
               rows=False, **extra) -> dict:
    """A correlation kernel's entry of the kernels' JSON line from
    `corr_kernels`' results `corr[key]`: its times on the path's inputs
    (`frontend`; for kernel 3 its four levels) beside the other design's
    in the same call, then every other case. `rows`: the entry of the
    row design of the first port (`*_rows`; on no main path since the box
    design replaced it, so its launches are the probe phase's)."""
    res = corr[key]
    ours, other = ("rows_ms", "ms") if rows else ("ms", "rows_ms")
    front = res["frontend"]
    return {
        "name": name, "route": "cuda",
        "source": f"mneslam_tpu_torch/kernels/csrc/{source}",
        "replaces": f"mneslam_tpu/ops/pallas_kernels.py{line}",
        "launches": launches, "launches_by_path": by_path,
        "design": "rows (first port)" if rows else "box",
        "max_abs_err": max(v["max_abs_err"] for v in res.values()),
        "tolerance": f"{rtol:.3g} x dot of |f1|, |f2| + {CORR_ATOL:g}",
        "ms": front[ours], "plain_ms": front["plain_ms"],
        "bound_ms": front["bound_ms"], "bound_by": front["bound_by"],
        "library_ms": None,
        "other_design_ms": front[other],
        "box_share": front["box_share"],
        "timed_as": "the frontend lookup's inputs (91 edge slots, 75 real, "
                    "reprojected centres), 4 levels"
                    + (" launched one by one, all slots computed"
                       if key == "corr_window_per_level" else ""),
        "cases": res,
        **extra}


def tpu_probes(real, card) -> dict:
    """Phase 11: the H100 counterparts of the TPU probes (`mneslam_tpu_torch/
    tools/prof_corr.py`, `prof_scatter.py` in fp32 and bf16), the scatter
    probe also on the `real` cases (tag, idx, vals, n_rows). Writes every
    result to probes.json in OUT;
    raises SystemExit on a wrong or failing variant. -> {"seconds", the
    extra keys of the "scatter_add_rows" and "corr_window" entries, the
    blocked and bucketed kernels' entries without their launch counts}."""
    import torch

    from mneslam_tpu_torch.kernels.scatter_cluster import (
        DEFAULT_CLUSTER, DEFAULT_TILE_ROWS, TILES_TILE_ROWS)
    from mneslam_tpu_torch.tools import prof_corr, prof_scatter

    t0 = time.perf_counter()
    corr = prof_corr.run("cuda", log=log)
    # K = 10 calls per timed run (the probe's own default is 20)
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
               if isinstance(v, dict) and v.get("equal_to_rows") is False]
    log(f"corr unroll variants equal to the row design's entry bit for bit: "
        f"{not unequal} (unequal: {unequal}); box path share by level "
        f"{corr['box_share']}")

    tags = [tag for tag, _, _, _ in real]

    def real_sum(variant, key="ms"):
        """A variant's `key` summed over the real stream's calls (None if
        it did not run on all of them)."""
        vals = [scat.get(f"{tag}/{variant}") for tag in tags]
        vals = [v.get(key) if isinstance(v, dict) else None for v in vals]
        return None if None in vals else sum(vals)

    def max_err(prefix):
        return max(v["max_abs_err"] for res in (scat, scat_bf16)
                   for k, v in res.items() if isinstance(v, dict)
                   and "max_abs_err" in v
                   and k.split("/")[-1].startswith(prefix))

    occupancy = scat["max_active_clusters"]
    log("cudaOccupancyMaxActiveClusters at width 128 (fp32, int64 "
        "indices): " + ", ".join(f"{k} {v}" for k, v in occupancy.items()))
    loads = {tag: scat[f"{tag}/tiles"] for tag in tags}
    log("real index stream, busiest 64-row tile / busiest bucket of "
        f"{prof_scatter.BUCKET_ROWS} rows per call: "
        + ", ".join(f"{tag.split(':')[1]} {v['busiest']} / "
                    f"{v['busiest_bucket']} of {v['buckets']}"
                    for tag, v in loads.items()))
    T, CL, TT = DEFAULT_TILE_ROWS, DEFAULT_CLUSTER, TILES_TILE_ROWS

    def by_config(variant, suffix=""):
        """ms on the real stream of each configuration that ran."""
        times = {f"T{t}C{cl}": real_sum(f"{variant}T{t}C{cl}{suffix}")
                 for t, cl in prof_scatter.CONFIGS}
        return {k: v for k, v in times.items() if v is not None}

    def fastest(times):
        return min(times, key=times.get) if times else None

    def fmt(times):
        return {k: round(v, 4) for k, v in times.items()}

    blocked_ms = by_config("blocked")
    bucket_ms = by_config("bucket")
    presorted_ms = by_config("bucket", "_presorted")
    log(f"real index stream, sum of one iteration's {len(real)} calls (ms): "
        f"kernel 1 {real_sum('kernel1'):.4f}; serialU8/16/32 "
        f"{[round(real_sum(f'serialU{u}'), 4) for u in (8, 16, 32)]}; "
        f"blocked cluster {fmt(blocked_ms)}, tiles T{TT} "
        f"{real_sum(f'blockedT{TT}'):.4f}; bucketed cluster "
        f"{fmt(bucket_ms)}, tiles T{TT} {real_sum(f'bucketT{TT}'):.4f}; "
        f"presorted cluster {fmt(presorted_ms)}, tiles T{TT} "
        f"{real_sum(f'bucketT{TT}_presorted'):.4f}; route "
        f"{real_sum('route'):.4f}, tile route "
        f"{real_sum('route_tiles'):.4f}; index_add_ {real_sum('xla'):.4f}; "
        f"bound {real_sum('kernel1', 'bound_ms'):.4f}; fastest "
        f"configuration: blocked {fastest(blocked_ms)}, bucketed "
        f"{fastest(bucket_ms)}, presorted {fastest(presorted_ms)} "
        f"(default T{T}C{CL})")
    tol = (f"{prof_scatter.SCATTER_RTOL:g} x sum|vals| + "
           f"{prof_scatter.SCATTER_ATOL:g} (+ one bf16 ulp)")

    def synthetic(variant, key):
        v = scat.get(f"fine@11.5k/{variant}")
        return v[key] if isinstance(v, dict) else None

    def entry(name, source, replaces, variant, plain, times, timed_as):
        ours, tiles_v = f"{variant}T{T}C{CL}", f"{variant}T{TT}"
        return {"name": name, "route": "cuda",
                "source": f"mneslam_tpu_torch/kernels/csrc/{source}",
                "replaces": replaces, "design": "cluster",
                "tile_rows": T, "cluster": CL,
                "max_abs_err": max_err(variant),
                "tolerance": tol, "ms": real_sum(ours),
                "graph_ms": real_sum(ours, "graph_ms"),
                "plain_ms": real_sum(plain),
                "bound_ms": real_sum(ours, "bound_ms"),
                "bound_by": "bytes", "library_ms": real_sum("xla"),
                "tiles_ms": real_sum(tiles_v),
                "tiles_graph_ms": real_sum(tiles_v, "graph_ms"),
                "ms_by_config": times,
                "fastest_config": fastest(times),
                "max_active_clusters": {
                    k: v for k, v in occupancy.items()
                    if k.startswith(variant)},
                "busiest_bucket": max(v["busiest_bucket"]
                                      for v in loads.values()),
                "fine11k_graph_ms": synthetic(ours, "graph_ms"),
                "fine11k_tiles_graph_ms": synthetic(tiles_v, "graph_ms"),
                "fine11k_bound_ms": synthetic(ours, "bound_ms"),
                "fine11k_library_graph_ms": synthetic("xla", "graph_ms"),
                "timed_as": f"sum of one mapping iteration's {len(real)} "
                            f"calls on the real index stream, {timed_as}"
                            f"buckets of {CL} x {T} rows; tiles_ms: the "
                            f"tile design of the first port, T = {TT}"}

    bucket_entry = entry("scatter_add_rows_bucketed",
                         "scatter_rows_bucketed.cu",
                         "tools/prof_scatter_bucketed.py:82", "bucket",
                         "bucket_plain", bucket_ms, "route included, ")
    ours = f"bucketT{T}C{CL}_presorted"
    bucket_entry.update(
        route_ms=real_sum("route"), route_tiles_ms=real_sum("route_tiles"),
        presorted_ms=real_sum(ours),
        presorted_graph_ms=real_sum(ours, "graph_ms"),
        tiles_presorted_ms=real_sum(f"bucketT{TT}_presorted"),
        presorted_ms_by_config=presorted_ms,
        fine11k_presorted_graph_ms=synthetic(ours, "graph_ms"),
        fine11k_tiles_presorted_graph_ms=synthetic(
            f"bucketT{TT}_presorted", "graph_ms"))
    return {
        "seconds": seconds,
        "scatter_add_rows": {
            "per_warp_ms": {u: real_sum(f"serialU{u}") for u in (8, 16, 32)},
            "probe_ms": real_sum("kernel1")},
        "corr_window": {
            "probe_ms": corr["kernel2+skip"]["ms"],
            "probe_rows_ms": corr["kernel2rows+skip"]["ms"],
            "probe_box_share": corr["box_share"],
            "unroll_ms": {u: corr[f"kernel2+skip u{u}"]["ms"]
                          for u in prof_corr.UNROLLS},
            "unroll_equal_to_rows": not unequal},
        "corr_window_mma": {
            "probe_ms": corr["kernel2b+skip"]["ms"],
            "probe_rows_ms": corr["kernel2brows+skip"]["ms"]},
        "scatter_add_rows_blocked": entry(
            "scatter_add_rows_blocked", "scatter_rows_blocked.cu",
            "tools/prof_pallas_scatter.py:61", "blocked", "blocked_plain",
            blocked_ms, ""),
        "scatter_add_rows_bucketed": bucket_entry,
    }


# ---------------------------------------------------------------------------
# 12. multi-agent collaboration
# ---------------------------------------------------------------------------

# 12c: two agents' segments of one box-room trajectory of MA_FRAMES frames;
# the shared frames give exact cross-agent descriptor matches. 28 frames
# each: past the frontend window of 25, so loop BA runs
MA_FRAMES = 42
MA_SEGMENTS = ((0, 28), (14, 42))
# phase 12's printed budget (not a failure when over)
COLLAB_BUDGET_S = 240.0
# 12b: the oracle alignment's perturbation and learning rates
# (tests/test_multiagent.py:375-386)
ORACLE_DAA = (0.06, -0.04, 0.05)
ORACLE_DT = (0.08, -0.06, 0.05)
ORACLE_LR = 0.01


class FrameCache:
    """A dataset whose frames are rendered once and kept: the synthetic
    box room ray-casts each 680 x 1200 frame on the host, and the agents
    read a frame up to five times (tracking, mapping, the filler, the
    pose table and the observed space at terminate)."""

    def __init__(self, ds):
        self.ds, self.items = ds, {}
        self.num_rays_to_save = ds.num_rays_to_save

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        if i not in self.items:
            self.items[i] = self.ds[i]
        return dict(self.items[i])


class Slice:
    """Trajectory segment view of a dataset (start_index / end_index), as
    tests/test_multiagent.py:405-415: frame ids restart at 0."""

    def __init__(self, ds, lo, hi):
        self.ds, self.lo, self.n = ds, lo, hi - lo
        self.num_rays_to_save = ds.num_rays_to_save

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        item = self.ds[self.lo + i]
        item["frame_id"] = i
        return item


def collab_parity():
    """12a: the multi-agent layer's functions on phase 3's tiny config, GPU
    against CPU on the same converted inputs -> dict of differences and
    kernel-1 launches (alignment, distillation)."""
    import numpy as np
    import torch

    from mneslam_tpu_torch.agents import fusion, netvlad
    from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
    from mneslam_tpu_torch.mapping.mapper import Mapper, make_optimizer
    from mneslam_tpu_torch.models.droid_net import map_params
    from mneslam_tpu_torch.models.scene_rep import SceneRep, param_leaves
    from mneslam_tpu_torch.ops import rotations
    from mneslam_tpu_torch.utils.convert import (params_from_jax,
                                                 params_to_numpy)

    cfg = tiny_config(os.path.join(RUN_OUT, "collab_parity"))
    ds = SyntheticBoxDataset(cfg, num_frames=8)
    out = {}
    # the stub descriptor of a frame
    img = torch.as_tensor(ds[4]["rgb"])
    d = {dev: netvlad.stub_descriptor(img.to(dev)).cpu()
         for dev in ("cpu", "cuda")}
    out["stub_max_abs"] = float((d["cuda"] - d["cpu"]).abs().max())
    # NetVLAD, random weights, no whitening, a 64 x 80 image
    nv = netvlad.init_netvlad_random(torch.Generator().manual_seed(0),
                                     whiten=False)
    x = torch.rand((1, 3, 64, 80), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = netvlad.netvlad_apply(nv, x)
        got = netvlad.netvlad_apply(map_params(nv, lambda t: t.cuda()),
                                    x.cuda()).cpu()
    out["netvlad_max_rel"] = float(((got - ref).abs() / (ref.abs() + 1e-6))
                                   .max())
    out["netvlad_ok"] = bool(torch.allclose(got, ref, rtol=1e-4, atol=1e-6))

    # a map trained on the CPU (40 steps on frame 4), on both devices
    scene_cpu = SceneRep(cfg, "cpu")
    m = Mapper(cfg, scene_cpu, num_kf=2, rays_per_kf=ds.num_rays_to_save)
    g = torch.Generator().manual_seed(0)
    st = m.init_state(g)
    frame = {k: torch.as_tensor(ds[4][k]) for k in ("direction", "rgb",
                                                    "depth")}
    frame["frame_id"] = 4
    m.first_frame_mapping(st, frame, torch.as_tensor(ds[4]["c2w"]), g,
                          iters=40)
    trained = params_to_numpy(st.params)
    student0 = params_to_numpy(scene_cpu.init_params(
        torch.Generator().manual_seed(3)))

    base = np.asarray(ds[4]["c2w"], np.float32)
    perturb = rotations.rot_trans_to_transform(
        torch.tensor(ORACLE_DAA), torch.tensor(ORACLE_DT)).numpy()
    target = (perturb @ base).astype(np.float32)
    rng = np.random.default_rng(0)
    dirs = np.asarray(ds[0]["direction"], np.float32).reshape(-1, 3)
    rays = dirs[rng.integers(0, len(dirs), 256)]
    iters, K, r = 3, 2, 64
    poses = np.stack([ds[i]["c2w"] for i in (3, 5)]).astype(np.float32)
    idx = rng.integers(0, len(dirs), (iters, K, r))
    u = rng.uniform(size=(iters, K * r, 17)).astype(np.float32)
    res = {}
    for dev in ("cpu", "cuda"):
        def t(a):
            return torch.as_tensor(a, device=dev)

        scene = SceneRep(cfg, dev)
        p = params_from_jax(trained, device=dev)
        reset_launches()
        best, best_loss, init_loss = fusion.align_pose_by_render(
            scene, p, scene, p, t(base), t(target), t(rays), iters=10,
            lr_rot=0.01, lr_trans=0.01)
        align_launches = read_launches()["scatter_add_rows"]
        mapper = Mapper(cfg, scene, num_kf=2,
                        rays_per_kf=ds.num_rays_to_save)
        state = mapper.init_state(torch.Generator(device=dev).manual_seed(0))
        state.params = params_from_jax(student0, device=dev)
        state.optimizer = make_optimizer(cfg, state.params)
        reset_launches()
        _, loss = fusion.distill(scene, p, mapper, state, t(poses), t(dirs),
                                 iters=iters, rays_per_kf=r, idx=t(idx),
                                 u=t(u))
        if dev == "cuda":
            torch.cuda.synchronize()
        res[dev] = {"best": best.cpu(), "best_loss": float(best_loss),
                    "init_loss": float(init_loss), "loss": float(loss),
                    "params": [q.detach().cpu()
                               for q in param_leaves(state.params)],
                    "align_launches": align_launches,
                    "distill_launches": read_launches()["scatter_add_rows"]}
    c, gpu = res["cpu"], res["cuda"]
    out["align_best_c2w_max_abs"] = float((gpu["best"] - c["best"]).abs()
                                          .max())
    out["align_best_loss_rel"] = abs(gpu["best_loss"] - c["best_loss"]) / \
        abs(c["best_loss"])
    out["align_init_loss_rel"] = abs(gpu["init_loss"] - c["init_loss"]) / \
        abs(c["init_loss"])
    out["align_losses_gpu"] = [gpu["init_loss"], gpu["best_loss"]]
    out["distill_param_max_abs"] = max(
        float((a - b).abs().max()) for a, b in zip(gpu["params"],
                                                   c["params"]))
    out["distill_loss_rel"] = abs(gpu["loss"] - c["loss"]) / abs(c["loss"])
    out["align_launches"] = gpu["align_launches"]
    out["distill_launches"] = gpu["distill_launches"]
    out["distill_iters"] = iters
    return out


def oracle_alignment(slam, card):
    """12b: phase 7's room0 map, keyframe 5's pose perturbed by
    ORACLE_DAA / ORACLE_DT and aligned back by rendering at
    `mapping.sample` rays for `mapping.loop_iters` iterations at the JAX
    test's learning rate ORACLE_LR, then 5 iterations under the profiler
    (chiprun_out/chip_smoke/align_profile.txt) -> dict."""
    import numpy as np
    import torch

    from mneslam_tpu_torch.agents import fusion
    from mneslam_tpu_torch.ops import rotations

    cfg = slam.config
    kf = int(slam.mapped_timestamps[1])
    base = torch.as_tensor(np.asarray(slam.dataset[kf]["c2w"], np.float32),
                           device="cuda")
    perturb = rotations.rot_trans_to_transform(
        torch.tensor(ORACLE_DAA, device="cuda"),
        torch.tensor(ORACLE_DT, device="cuda"))
    target = perturb @ base
    dirs = np.asarray(slam.dataset[0]["direction"], np.float32).reshape(-1, 3)
    sample = int(cfg["mapping"]["sample"])
    rays = torch.as_tensor(
        dirs[np.random.default_rng(0).integers(0, len(dirs), sample)],
        device="cuda")
    iters = int(cfg["mapping"]["loop_iters"])
    kw = dict(iters=iters, lr_rot=ORACLE_LR, lr_trans=ORACLE_LR,
              rgb_weight=float(cfg["training"]["rgb_weight"]),
              depth_weight=float(cfg["training"]["depth_weight"]),
              rot_rep=cfg["training"]["rot_rep"])
    p = slam.map_state.params
    fusion.align_pose_by_render(slam.scene, p, slam.scene, p, base, target,
                                rays, **dict(kw, iters=2))   # warm-up
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best, best_loss, init_loss = fusion.align_pose_by_render(
        slam.scene, p, slam.scene, p, base, target, rays, **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    err0 = float((target[:3, 3] - base[:3, 3]).norm())
    err1 = float((best[:3, 3] - base[:3, 3]).norm())
    launches = read_launches()["scatter_add_rows"]
    _, dev_ms, count, top = profiled(
        lambda: fusion.align_pose_by_render(
            slam.scene, p, slam.scene, p, base, target, rays,
            **dict(kw, iters=5)),
        1, os.path.join(OUT, "align_profile.txt"),
        f"5 render-alignment iterations at room0 widths ({sample} rays)",
        card)
    return {"keyframe": kf, "rays": sample, "iters": iters,
            "lr": [kw["lr_rot"], kw["lr_trans"]],
            "trans_err_m": [err0, err1], "init_loss": float(init_loss),
            "best_loss": float(best_loss), "seconds": sec,
            "ms_per_iter": 1e3 * sec / iters,
            "profile_kernel_ms_per_iter": dev_ms / 5,
            "profile_launches_per_iter": count / 5,
            "idle_share": 1.0 - dev_ms / 5 / (1e3 * sec / iters),
            "profile_top_kernels": top, "scatter_launches": launches}


def multiagent_slam():
    """12c: two agents under `MultiAgentRunner.run_slam` with
    `InMemoryComms`, each on a segment of one box-room trajectory, at room0
    widths with the ROOM0 collaboration keys -> (agents, runner, results,
    seconds, launches, records). The trackers' updates get ground-truth
    reprojection targets (as phases 5-6): with the update net's random
    weights the key poses leave room0's bound (up to 262 m on the H100),
    no keyframe lies in the agents' overlap and nothing is distilled
    (PERF.md section 6)."""
    import torch

    from mneslam_tpu_torch.agents import fusion
    from mneslam_tpu_torch.agents.comms import InMemoryComms
    from mneslam_tpu_torch.agents.runner import MultiAgentRunner
    from mneslam_tpu_torch.config import make_config
    from mneslam_tpu_torch.configs import ROOM0
    from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
    from mneslam_tpu_torch.slam import MNESLAM

    def config():
        cfg = make_config(ROOM0)
        cfg["dataset"] = "synthetic"
        cfg["data"]["output"] = RUN_OUT
        cfg["data"]["exp_name"] = "multiagent"
        cfg["tracking"]["motion_filter"]["thresh"] = -1.0
        cfg["tracking"]["frontend"]["keyframe_thresh"] = -1.0
        # the meshes (terminate's and the fused one) over the box's bound
        cfg["mapping"]["marching_cubes_bound"] = \
            [[-BOX_HALF - 0.05, BOX_HALF + 0.05]] * 3
        return cfg

    cfgs = [config() for _ in MA_SEGMENTS]
    frames = FrameCache(SyntheticBoxDataset(cfgs[0], num_frames=MA_FRAMES,
                                            half=BOX_HALF))
    agents = []
    for r, (cfg, (lo, hi)) in enumerate(zip(cfgs, MA_SEGMENTS)):
        seg = Slice(frames, lo, hi)
        cam = cfg["cam"]   # no edge band in ROOM0
        sx, sy = cam["W_out"] / cam["W"], cam["H_out"] / cam["H"]
        update_fn, agg_fn = oracle_fns(seg, [
            cam["fx"] * sx / 8, cam["fy"] * sy / 8, cam["cx"] * sx / 8,
            cam["cy"] * sy / 8])
        agents.append(MNESLAM(cfg, seg, rank=r, world_size=len(MA_SEGMENTS),
                              device="cuda", update_fn=update_fn,
                              agg_fn=agg_fn))
    runner = MultiAgentRunner(agents, comms=InMemoryComms())
    rec = {"batches": [[] for _ in agents], "hook": [[] for _ in agents],
           "align": [], "distill": [], "fused_mesh": [], "loops": [],
           "distill_args": None}

    def counter(a):
        return lambda: (a.tracker.counter,)

    for i, (a, c) in enumerate(zip(agents, runner.collabs)):
        _timed(a.tracker, "run_batch", rec["batches"][i], counter(a))
        _timed(c, "on_keyframe_mapped", rec["hook"][i], counter(a))
        _timed(c, "_save_fused_mesh", rec["fused_mesh"], counter(a))

        def detect(kf, agent, rgb, orig=c.loop_detector.detect_and_add):
            info = orig(kf, agent, rgb)
            if info is not None:
                rec["loops"].append((agent, kf, int(info["match_agent_id"]),
                                     int(info["match_kf_id"]),
                                     info["similarity"]))
            return info
        c.loop_detector.detect_and_add = detect

    align, distill = fusion.align_pose_by_render, fusion.distill

    def timed_align(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = align(*a, **k)
        torch.cuda.synchronize()
        rec["align"].append((time.perf_counter() - t0, k["iters"]))
        return out

    def timed_distill(*a, **k):
        rec["distill_args"] = (a, dict(k))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = distill(*a, **k)
        torch.cuda.synchronize()
        rec["distill"].append((time.perf_counter() - t0, k["iters"]))
        return out

    fusion.align_pose_by_render, fusion.distill = timed_align, timed_distill
    try:
        reset_launches()
        t0 = time.perf_counter()
        results = runner.run_slam()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
    finally:
        fusion.align_pose_by_render, fusion.distill = align, distill
        for a, c in zip(agents, runner.collabs):
            for obj, name in ((a.tracker, "run_batch"),
                              (c, "on_keyframe_mapped"),
                              (c, "_save_fused_mesh")):
                delattr(obj, name)
    return agents, runner, results, seconds, launches, rec


def spawn_on_card():
    """12d: `python -m mneslam_tpu_torch.cli --num_agents 2 --spawn` on
    phase 3's tiny config (the children run on the card, the default
    device) -> (exit code, seconds, missing outputs, the log's tail)."""
    import yaml

    out_dir = os.path.join(RUN_OUT, "spawn")
    cfg = tiny_config(out_dir)
    cfg["dataset"] = "synthetic"
    cfg["data"].update(exp_name="mp", num_frames=6)
    cfg["mapping"].update(loop_iters=20, distill_iters=20)
    cfg["meshing"]["resolution"] = 0.25
    cfg["loop_detection"].update(enabled=True, sim_threshold=0.95,
                                 min_time_diff=100, loop_launch_th=2)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "mneslam_tpu_torch.cli",
                        "--config", path, "--num_agents", "2", "--spawn"],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=300)
    sec = time.perf_counter() - t0
    root = os.path.join(out_dir, "mp")
    missing = []
    for rank in (0, 1):
        d = os.path.join(root, f"agent_{rank}")
        for name in ("key_est_poses.npy", "key_timestamps.npy",
                     "latest_checkpoint.npz", "metrics.jsonl",
                     "final_checkpoint.npz"):
            if not os.path.exists(os.path.join(d, name)):
                missing.append(f"agent_{rank}/{name}")
        ddir = os.path.join(d, "descriptors")
        if not (os.path.isdir(ddir) and any(
                f.endswith(".npz") for f in os.listdir(ddir))):
            missing.append(f"agent_{rank}/descriptors/*.npz")
    return r.returncode, sec, missing, (r.stdout[-1500:], r.stderr[-1500:])


def profiled(fn, n, path, title, card):
    """fn() run n times under torch.profiler -> (wall ms, kernel ms,
    launches, top kernels) per run; the table, headed by the card's line,
    goes to `path`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    top_s = "; ".join(
        f"{e.key[:60]} {1e-3 * e.self_device_time_total / n:.3f}"
        for e in top[:6])
    with open(path, "w") as f:
        f.write(f"{card}: {title}\n"
                + events.table(sort_by="self_cuda_time_total",
                               row_limit=40))
    return wall, dev_ms, count, top_s


def multiagent_phase(card):
    """12c: the multi-agent SLAM path at room0 widths, its checks and its
    times -> launch counts. Raises SystemExit on a failed check."""
    import numpy as np

    from mneslam_tpu_torch.agents import fusion as fusion_mod

    log(f"multi-agent SLAM path: room0 widths and collaboration keys, "
        f"random DROID weights in bf16 with ground-truth reprojection "
        f"targets in place of the update net's, two agents on frames "
        f"{MA_SEGMENTS[0][0]}-{MA_SEGMENTS[0][1] - 1} and "
        f"{MA_SEGMENTS[1][0]}-{MA_SEGMENTS[1][1] - 1} of a {MA_FRAMES}-frame "
        f"box-room trajectory, meshes over the box's bound")
    ma_agents, ma_runner, ma_res, ma_sec, ma_launches, ma_rec = \
        multiagent_slam()
    ma_n_map = [len(a.mapped_timestamps) for a in ma_agents]
    ma_iters = [int(a.config["mapping"]["first_iters"])
                + (n - 1) * int(a.config["mapping"]["iters"])
                for a, n in zip(ma_agents, ma_n_map)]
    ma_distill_iters = sum(it for _, it in ma_rec["distill"])
    ma_lookups = sum(lookups(a) for a in ma_agents)
    db_keys = sorted((int(e["agent_id"]), int(e["kf_id"]))
                     for e in ma_runner.comms.descriptors())
    want_keys = sorted((a.rank, int(t)) for a in ma_agents
                       for t in a.mapped_timestamps)
    cross = [lp for lp in ma_rec["loops"] if lp[0] != lp[2]]
    collabs = ma_runner.collabs
    ma_files = {f"agent_{a.rank}/{name}": os.path.exists(
        os.path.join(a.out_dir, name)) for a in ma_agents
        for name in ("est_poses.npy", "mesh/final_mesh.ply",
                     "mesh/final_mesh_culled.ply", "mesh/fused_mesh.ply")}
    pos = [np.abs(np.load(os.path.join(a.out_dir, "key_est_poses.npy"))[
        :, :3, 3]).max() for a in ma_agents]
    log(f"multi-agent SLAM path: {MA_FRAMES} frames in two segments in "
        f"{ma_sec:.2f} s; largest camera-centre coordinate of the key "
        f"poses {[round(float(v), 3) for v in pos]} m (the room0 bound "
        f"{ma_agents[0].config['mapping']['bound']}); keyframes tracked "
        f"{[a.tracker.counter for a in ma_agents]}, mapped {ma_n_map} "
        f"({ma_iters} mapping iterations); descriptor DB "
        f"{len(db_keys)} entries; loops detected {len(ma_rec['loops'])} "
        f"({len(cross)} across agents), alignments "
        f"{[c.alignments for c in collabs]}, closures accepted "
        f"{[c.closures_accepted for c in collabs]} rejected "
        f"{[c.closures_rejected for c in collabs]}; distillations "
        f"{[c.distillations for c in collabs]} ({ma_distill_iters} "
        f"iterations); {ma_lookups} lookups; launches "
        f"{json.dumps(ma_launches)}; files {json.dumps(ma_files)}; APE(sim3) "
        f"rmse {[round(r['ate']['rmse'], 4) for r in ma_res]} m (printed, "
        f"not checked)")
    want_scatter = SCATTERS_PER_ITER * (sum(ma_iters) + ma_distill_iters)
    problems = [msg for msg, ok in (
        ("a terminate output is missing", all(ma_files.values())),
        (f"the descriptor DB {db_keys} is not every mapped keyframe "
         f"{want_keys}", db_keys == want_keys),
        ("no cross-agent loop detected and aligned",
         cross and sum(c.alignments for c in collabs) >= 1),
        ("an agent distilled from no other",
         all(c.distillations >= 1 for c in collabs)),
        (f"kernel 1 launches {ma_launches['scatter_add_rows']} != "
         f"{SCATTERS_PER_ITER} x ({sum(ma_iters)} mapping + "
         f"{ma_distill_iters} distillation iterations)",
         ma_launches["scatter_add_rows"] == want_scatter),
        (f"kernel 2 launches {ma_launches['corr_window']} != {ma_lookups} "
         f"lookups", ma_launches["corr_window"] == ma_lookups),
        ("kernel 2b or 3 launched", not (ma_launches["corr_window_mma"]
                                         or ma_launches[
                                             "corr_window_per_level"])),
        ("non-finite trajectory", all(
            math.isfinite(r["ate"]["rmse"]) for r in ma_res)))
        if not ok]
    if problems:
        raise SystemExit(f"multi-agent SLAM path: {problems}")
    ma_times = []
    for i, a in enumerate(ma_agents):
        frames_n = sum(after[0] - before[0]
                       for _, before, after in ma_rec["batches"][i])
        track_ms = 1e3 * sum(s for s, _, _ in ma_rec["batches"][i]) \
            / max(frames_n, 1)
        hook_s = sum(s for s, _, _ in ma_rec["hook"][i])
        stages = a.timers.summary()
        map_ms = 1e3 * (stages["map_keyframe"]["total_s"] - hook_s) \
            / ma_n_map[i]
        ma_times.append({
            "agent": a.rank, "ms_per_tracked_frame": track_ms,
            "frames": frames_n, "ms_per_mapped_keyframe": map_ms,
            "hook_ms_per_keyframe": 1e3 * hook_s / ma_n_map[i],
            "fill_trajectory_s": stages["fill_trajectory"]["total_s"],
            "terminate_mesh_s": stages["mesh"]["total_s"]})
    al_ms = [1e3 * s for s, _ in ma_rec["align"]]
    di_ms = [1e3 * s for s, _ in ma_rec["distill"]]
    fused_s = [s for s, _, _ in ma_rec["fused_mesh"]]
    log(f"multi-agent times (host clock, each call between two "
        f"synchronisations, {card}): {json.dumps(ma_times)}; "
        f"{len(al_ms)} alignments, mean {sum(al_ms) / max(len(al_ms), 1):.1f}"
        f" ms ({sum(al_ms) / max(sum(it for _, it in ma_rec['align']), 1):.3f}"
        f" ms per iteration); {len(di_ms)} distillations, mean "
        f"{sum(di_ms) / max(len(di_ms), 1):.1f} ms "
        f"({sum(di_ms) / max(ma_distill_iters, 1):.3f} ms per iteration); "
        f"fused mesh s {[round(s, 3) for s in fused_s]}; phase 12c "
        f"{ma_sec:.2f} s")
    d_args, d_kw = ma_rec["distill_args"]
    path = os.path.join(OUT, "distill_profile.txt")
    d_wall, d_dev, d_launches, d_top = profiled(
        lambda: fusion_mod.distill(*d_args, **dict(d_kw, iters=5)), 1, path,
        f"5 distillation iterations at room0 widths "
        f"({d_kw['rays_per_kf']} rays x {d_args[4].shape[0]} keyframes)",
        card)
    iter_ms = sum(di_ms) / max(ma_distill_iters, 1)
    log(f"distillation profile: per iteration {d_launches / 5:.0f} kernel "
        f"launches, {d_dev / 5:.3f} ms of kernels, wall {d_wall / 5:.3f} ms "
        f"under the profiler; against the {iter_ms:.3f} ms of an iteration "
        f"timed without it the device idles "
        f"{100 * (1 - d_dev / 5 / iter_ms):.1f}%; top kernels (ms per 5 "
        f"iterations): {d_top}; table in {path}")
    del ma_agents, ma_runner, d_args
    return ma_launches


def collaboration(slam, card):
    """Phase 12 (12a-12d) on phase 7's map `slam` -> (12a's results, 12c's
    launch counts). Raises SystemExit on a failed check."""
    t12 = time.perf_counter()
    # 12a. parity of the collaboration functions, GPU vs CPU
    cp = collab_parity()
    log(f"collab parity (tiny config, GPU vs CPU; stub 1e-6, NetVLAD rtol "
        f"1e-4 / atol 1e-6, alignment c2w 1e-4 and losses rtol 1e-4, "
        f"distilled parameters {PARAM_TOL}): {json.dumps(cp)}")
    bad = [name for name, ok in (
        ("stub_descriptor", cp["stub_max_abs"] <= 1e-6),
        ("netvlad_apply", cp["netvlad_ok"]),
        ("align_pose_by_render", cp["align_best_c2w_max_abs"] <= 1e-4
         and cp["align_best_loss_rel"] <= 1e-4
         and cp["align_init_loss_rel"] <= 1e-4),
        ("distill", cp["distill_param_max_abs"] < PARAM_TOL)) if not ok]
    if bad:
        raise SystemExit(f"collab parity: GPU and CPU disagree on {bad}")
    if (cp["align_launches"] != 0 or cp["distill_launches"]
            != SCATTERS_PER_ITER * cp["distill_iters"]):
        raise SystemExit(f"collab parity: kernel 1 launched "
                         f"{cp['align_launches']} times in the alignment "
                         f"(expected 0) and {cp['distill_launches']} in "
                         f"the distillation (expected "
                         f"{SCATTERS_PER_ITER} x {cp['distill_iters']})")

    # 12b. oracle alignment on phase 7's room0 map
    oa = oracle_alignment(slam, card)
    log(f"oracle alignment (room0 mapping-only map, {card}): "
        f"{json.dumps(oa)}")
    e0, e1 = oa["trans_err_m"]
    if not (e1 < 0.5 * e0 and oa["best_loss"] < 0.25 * oa["init_loss"]):
        raise SystemExit(f"oracle alignment: translation error {e0} -> {e1} "
                         f"m, loss {oa['init_loss']} -> {oa['best_loss']}")
    if oa["scatter_launches"]:
        raise SystemExit("oracle alignment launched kernel 1")

    # 12c. the multi-agent SLAM path at room0 widths
    ma_launches = multiagent_phase(card)

    # 12d. one process per agent on the card
    rc, sp_sec, missing, tail = spawn_on_card()
    log(f"spawn (--num_agents 2 --spawn, phase 3's tiny config, children on "
        f"the card): exit {rc} in {sp_sec:.1f} s; missing {missing}")
    if rc != 0 or missing:
        raise SystemExit(f"spawn: exit {rc}, missing {missing}; {tail}")
    t12 = time.perf_counter() - t12
    log(f"phase 12 {t12:.1f} s of its budget of {COLLAB_BUDGET_S:.0f} s"
        + (": OVER BUDGET, shorten the segments" if t12 > COLLAB_BUDGET_S
           else ""))
    return cp, ma_launches


# ---------------------------------------------------------------------------
# 13. the shipped single-device configs on files
# ---------------------------------------------------------------------------

TUM_CONFIG = os.path.join("configs", "TUM", "fr1_desk.yaml")
FAST_CONFIG = os.path.join("configs", "Replica", "room0_fast.yaml")
# 13b: TUM frames of the box room, past the tracker's warmup of 12, so the
# frontend updates; under its window of 25 (no backend)
TUM_FRAMES = 24
# 13c: frames of the room0_fast mapping-only run, as phase 7
FAST_FRAMES = 11
# 13c's GPU-vs-CPU bf16 parity (3 mapper steps of the tiny config): the
# loss within rtol 1e-4 and the parameters within 5e-4 (the CPU tests'
# bf16 bound, tests/test_torch_render_bf16.py: cuBLAS and the CPU round
# their bf16 products' sums at other points, and Adam's first steps turn a
# small gradient change into a step change of up to the learning rate)
BF16_LOSS_RTOL = 1e-4
BF16_PARAM_ATOL = 5e-4
# phase 13's printed budget (not a failure when over)
FILES_BUDGET_S = 180.0


def image_io_check() -> dict:
    """13a: which image packages the machine has, and the port's PNG codec
    on it: 8-bit RGB and 16-bit depth at 480 x 640 written with each
    filter type and read back bit for bit; where cv2 is there, its reader
    against the port's on those files and the port's reader on a file cv2
    wrote. Raises SystemExit on a mismatch."""
    import importlib

    import numpy as np

    from mneslam_tpu_torch.data import image_io

    have = {}
    for name in ("cv2", "PIL"):
        try:
            mod = importlib.import_module(name)
            have[name] = getattr(mod, "__version__", "present")
        except ImportError:
            have[name] = None
    out = os.path.join(RUN_OUT, "image_io")
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(13)
    yy, xx = np.mgrid[:480, :640]
    images = {
        "rgb8": np.stack([(xx + yy) % 256, (3 * xx) % 256, (xx ^ yy) % 256],
                         -1).astype(np.uint8),
        "depth16": (1000 + 9 * xx + 5 * yy).astype(np.uint16)}
    images["rgb8"][::7] = rng.integers(0, 256, images["rgb8"][::7].shape)
    images["depth16"][::11] = rng.integers(0, 65536,
                                           images["depth16"][::11].shape)
    res = {"packages": have, "files": 0, "cv2_files": 0, "read_ms": {}}
    bad = []
    for name, img in images.items():
        for ft in range(5):
            path = os.path.join(out, f"{name}_{ft}.png")
            image_io.write_png(path, img, filter_type=ft)
            t0 = time.perf_counter()
            back = image_io.read_png(path)
            res["read_ms"][f"{name}_{ft}"] = 1e3 * (time.perf_counter() - t0)
            res["files"] += 1
            if back.dtype != img.dtype or not np.array_equal(back, img):
                bad.append(path)
            if have["cv2"]:
                import cv2

                if not np.array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                      back):
                    bad.append(f"cv2:{path}")
        if have["cv2"]:
            import cv2

            path = os.path.join(out, f"{name}_cv2.png")
            cv2.imwrite(path, img)
            res["cv2_files"] += 1
            if not np.array_equal(image_io.read_png(path),
                                  cv2.imread(path, cv2.IMREAD_UNCHANGED)):
                bad.append(path)
    if bad:
        raise SystemExit(f"image I/O: the PNG codec disagrees on {bad}")
    return res


def corr_at(slam) -> dict:
    """Kernel 2 (box design) at a SLAM path's frontend inputs (its graph's
    edges topped up to 75 real in the frontend's 91 slots, reprojected
    centres), against its plain version, timed in turns with its row
    design, beside its bound and its box-path share; the keys of a case of
    `corr_kernels`' "corr_window"."""
    from mneslam_tpu_torch.kernels.corr_window import (
        box_path_share, corr_window_multilevel, corr_window_multilevel_plain,
        corr_window_multilevel_rows)
    from mneslam_tpu_torch.tools.measure import corr_bound_ms, cuda_ms

    f1, levels, ii, jj, xs, w2ps, mc = corr_path_inputs(slam)
    W = slam.tracker.state.fmaps.shape[3]
    args = (f1, levels, ii, jj, xs, w2ps)
    ref = corr_window_multilevel_plain(*args, mask=mc)
    mag = corr_window_multilevel_plain(
        f1.abs(), [lv.abs() for lv in levels], ii, jj, xs, w2ps, mask=mc)
    err, ratio = check_corr(corr_window_multilevel(*args, W, mask=mc), ref,
                            mag, mc)
    err_r, ratio_r = check_corr(corr_window_multilevel_rows(*args, mask=mc),
                                ref, mag, mc, what="corr_window_rows vs its "
                                "plain version")
    del ref, mag
    ms, rows_ms = ab_ms(lambda: corr_window_multilevel(*args, W, mask=mc),
                        lambda: corr_window_multilevel_rows(*args, mask=mc))
    plain = cuda_ms(lambda: corr_window_multilevel_plain(*args, mask=mc),
                    reps=5, warmup=1)
    bound, by, nbytes, flops = corr_bound_ms(*args[:5], mc)
    H = xs.shape[1] // W
    return {"ms": ms, "rows_ms": rows_ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by,
            "box_share": box_path_share(xs, [lv.shape[1] for lv in levels],
                                        w2ps, W, mc),
            "max_abs_err": max(err, err_r), "err_ratio": ratio,
            "rows_err_ratio": ratio_r, "edges": xs.shape[0],
            "real": int(mc.sum()), "grid": [H, W],
            "level_rows": [lv.shape[1] for lv in levels]}


def tum_files_path(card) -> dict:
    """13b: the TUM path on files at configs/TUM/fr1_desk.yaml's widths.
    Before the clock: the box room rendered at its intrinsics and written
    as a TUM folder (`write_tum_sequence`, one colour frame without depth),
    and a yaml in OUT (beside the profile tables) that inherits it and sets
    data.datadir. Then the port's `validate_dataset --kind tum --no-smoke`
    (exit 0), and `cli.main --config <yaml> --mode slam` on the card with
    the oracle update (`validate_dataset.OracleMNESLAM` as slam.MNESLAM),
    the counts set to 0 just before and read just after. Raises SystemExit
    on a failed check."""
    import numpy as np
    import torch
    import yaml

    import mneslam_tpu_torch.slam as slam_mod
    from mneslam_tpu_torch import cli
    from mneslam_tpu_torch.config import (default_config, deep_update,
                                          load_config)
    from mneslam_tpu_torch.data.synthetic import (SyntheticBoxDataset,
                                                  write_tum_sequence)
    from mneslam_tpu_torch.tools import validate_dataset

    base = deep_update(default_config(), load_config(
        os.path.join(ROOT, TUM_CONFIG)))
    folder = os.path.join(RUN_OUT, "tum_files", "rgbd_dataset")
    if os.path.isdir(folder):
        import shutil

        shutil.rmtree(folder)
    t0 = time.perf_counter()
    written = write_tum_sequence(
        SyntheticBoxDataset(base, num_frames=TUM_FRAMES, half=BOX_HALF),
        folder, png_depth_scale=base["cam"]["png_depth_scale"])
    write_s = time.perf_counter() - t0
    path = os.path.join(OUT, "tum_fr1_desk_files.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({
            "inherit_from": os.path.join(ROOT, TUM_CONFIG),
            "data": {"datadir": folder, "output": RUN_OUT,
                     "exp_name": "tum_files"},
            # random DROID weights: admit every frame (as phase 8)
            "tracking": {"motion_filter": {"thresh": -1.0},
                         "frontend": {"keyframe_thresh": -1.0}},
            # the terminate meshes over the box's bound (as phases 9, 12c)
            "mapping": {"marching_cubes_bound":
                        [[-BOX_HALF - 0.05, BOX_HALF + 0.05]] * 3}}, f)

    t0 = time.perf_counter()
    try:
        validate_dataset.main([folder, "--kind", "tum", "--config", path,
                               "--no-smoke"])
        vcode = 0
    except SystemExit as e:
        vcode = int(e.code or 0)
    validate_s = time.perf_counter() - t0
    if vcode != 0:
        raise SystemExit(f"validate_dataset on the TUM folder: exit {vcode}")

    made, batches = [], []

    class Recorded(validate_dataset.OracleMNESLAM):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)
            _timed(self.tracker, "run_batch", batches,
                   lambda: (self.tracker.counter,))

    real = slam_mod.MNESLAM
    slam_mod.MNESLAM = Recorded
    try:
        reset_launches()
        t0 = time.perf_counter()
        res = cli.main(["--config", path, "--mode", "slam"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
    finally:
        slam_mod.MNESLAM = real
    slam = made[0]
    del slam.tracker.run_batch
    n_map = len(slam.mapped_timestamps)
    n_frames = sum(after[0] - before[0] for _, before, after in batches)
    stages = slam.timers.summary()
    mesh_dir = os.path.join(slam.out_dir, "mesh")
    out = {
        "card": card, "frames_written": written["frames"],
        "rgb_lines": written["rgb_lines"], "gt_lines": written["gt_lines"],
        "associated": len(slam.dataset), "write_s": write_s,
        "validate_s": validate_s, "seconds": seconds,
        "keyframes": slam.tracker.counter, "mapped": n_map,
        "lookups": lookups(slam), "launches": launches,
        "ape_sim3_m": res["ate"]["rmse"],
        "tracked_frame_ms": 1e3 * sum(s for s, _, _ in batches)
        / max(n_frames, 1),
        "mapped_keyframe_ms": 1e3 * stages["map_keyframe"]["total_s"]
        / max(n_map, 1),
        "mesh_s": stages["mesh"]["total_s"],
        "mesh_verts": res.get("mesh_verts"),
        "mesh_verts_culled": res.get("mesh_verts_culled"),
        "meshes": all(os.path.exists(os.path.join(mesh_dir, n)) for n in
                      ("final_mesh.ply", "final_mesh_culled.ply")),
        "est_poses_finite": bool(np.isfinite(np.load(os.path.join(
            slam.out_dir, "est_poses.npy"))).all())}
    bad = [what for what, ok in (
        ("association", out["associated"] == TUM_FRAMES
         and out["rgb_lines"] == TUM_FRAMES + 1),
        ("APE", out["ape_sim3_m"] < ATE_TOL_M),
        ("kernel 2 launches", launches["corr_window"] == out["lookups"] > 0
         and not launches["corr_window_mma"]
         and not launches["corr_window_per_level"]),
        ("kernel 1 launches", launches["scatter_add_rows"] > 0
         and not launches["scatter_add_rows_bf16"]),
        ("meshes", out["meshes"] and (out["mesh_verts"] or 0) > 0),
        ("poses", out["est_poses_finite"])) if not ok]
    out["corr"] = corr_at(slam)
    if bad:
        raise SystemExit(f"TUM path on files: {bad}: {json.dumps(out)}")
    return out


def bf16_mapping(card, fp32_iter_ms, fp32_kf_ms) -> dict:
    """13c: the mapping-only path with configs/Replica/room0_fast.yaml's
    own keys (its iterations, depth samples and render_dtype bfloat16) over
    ROOM0, on phase 7's box room, the counts set to 0 just before and read
    just after; its steady-state times beside phase 7's fp32 ones; kernel 1
    on bf16 values at its shapes; the tiny config's GPU-vs-CPU parity in
    bf16. Raises SystemExit on a failed check."""
    import torch
    import yaml

    from mneslam_tpu_torch.config import deep_update, make_config
    from mneslam_tpu_torch.configs import ROOM0
    from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
    from mneslam_tpu_torch.kernels.scatter_add_rows import (
        scatter_add_rows, scatter_add_rows_plain)
    from mneslam_tpu_torch.slam import MNESLAM
    from mneslam_tpu_torch.tools.measure import (FP32_FLOPS,
                                                 HBM_BYTES_PER_S, cuda_ms)

    with open(os.path.join(ROOT, FAST_CONFIG)) as f:
        keys = yaml.safe_load(f)
    keys.pop("inherit_from")
    cfg = deep_update(make_config(ROOM0), keys)
    cfg["dataset"] = "synthetic"
    cfg["mode"] = "mapping"
    cfg["data"].update(output=RUN_OUT, exp_name="room0_fast_bf16")
    ds = SyntheticBoxDataset(cfg, num_frames=FAST_FRAMES, half=BOX_HALF)
    slam = MNESLAM(cfg, ds, rank=0, device="cuda")
    reset_launches()
    t0 = time.perf_counter()
    metrics = slam.run_mapping_only(log_every=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    mp = cfg["mapping"]
    iters = int(mp["first_iters"]) + (len(metrics) - 1) * int(mp["iters"])
    out = {"keys": keys, "keyframes": len(metrics), "iterations": iters,
           "seconds": seconds, "launches": launches,
           "psnr_last": float(metrics[-1]["psnr"]),
           "finite": all(math.isfinite(v) for m in metrics
                         for v in m.values())}

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    frame, pose = slam._frame_for_mapping(int(slam.mapped_timestamps[-1]))
    slam.mapper.optimize(slam.map_state, frame, pose, gen, iters=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam.mapper.optimize(slam.map_state, frame, pose, gen,
                         iters=int(mp["iters"]))
    torch.cuda.synchronize()
    out["keyframe_ms"] = 1e3 * (time.perf_counter() - t0)
    out["iter_ms"] = out["keyframe_ms"] / int(mp["iters"])
    out["fp32_iter_ms"], out["fp32_keyframe_ms"] = fp32_iter_ms, fp32_kf_ms

    # kernel 1 on bf16 values at this path's shapes: one iteration's six
    # calls, the values cast to bf16
    calls = [(name, idx, vals.to(torch.bfloat16), n_rows)
             for name, idx, vals, n_rows in path_scatter_inputs(slam, gen)]
    k = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
         "bytes": 0, "max_abs_err": 0.0, "err_ratio": 0.0, "updates": []}
    for name, idx, vals, n_rows in calls:
        err, ratio = check_scatter(idx, vals, n_rows)
        nu, width = vals.shape
        k["max_abs_err"] = max(k["max_abs_err"], err)
        k["err_ratio"] = max(k["err_ratio"], ratio)
        k["ms"] += cuda_ms(lambda: scatter_add_rows(idx, vals, n_rows))
        k["plain_ms"] += cuda_ms(
            lambda: scatter_add_rows_plain(idx, vals, n_rows))
        # one call: index_add_ into a bf16 table (it sums in bf16)
        k["library_ms"] += cuda_ms(lambda: torch.zeros(
            (n_rows, width), dtype=torch.bfloat16,
            device="cuda").index_add_(0, idx, vals))
        # bytes: the bf16 values and the indices read once, the bf16
        # table written once; operations: one fp32 add per value
        nbytes = nu * width * 2 + nu * idx.element_size() \
            + n_rows * width * 2
        k["bytes"] += nbytes
        k["bound_ms"] += 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                   nu * width / FP32_FLOPS)
        k["updates"].append([name, nu, n_rows])
    out["kernel1_bf16"] = k

    # the tiny config in bf16, GPU vs CPU
    losses, rel, pdiff = small_parity("bfloat16")
    out["parity"] = {"losses": losses, "max_rel_loss_diff": rel,
                     "max_param_diff": pdiff}
    n = SCATTERS_PER_ITER * iters
    bad = [what for what, ok in (
        ("kernel 1 bf16 launches", launches["scatter_add_rows_bf16"] == n
         and launches["scatter_add_rows"] == n),
        ("PSNR", out["psnr_last"] > PSNR_FLOOR),
        ("finite", out["finite"]),
        ("bf16 parity", rel < BF16_LOSS_RTOL and pdiff < BF16_PARAM_ATOL))
        if not ok]
    if bad:
        raise SystemExit(f"bf16 mapping path: {bad}: {json.dumps(out)}")
    return out


def files_phase(card, fp32_iter_ms, fp32_kf_ms) -> dict:
    """Phase 13 (13a-13c) -> their results. Raises SystemExit on a failed
    check."""
    t13 = time.perf_counter()
    io_res = image_io_check()
    log(f"image I/O on this machine: {json.dumps(io_res)}")

    tum = tum_files_path(card)
    c = tum["corr"]
    log(f"TUM on files ({TUM_CONFIG} widths: 480 x 640, tracking 240 x 320, "
        f"buffer 300; {TUM_FRAMES} box-room frames written in "
        f"{tum['write_s']:.2f} s, the association keeps {tum['associated']} "
        f"of {tum['rgb_lines']} colour frames; validate_dataset exit 0 in "
        f"{tum['validate_s']:.2f} s): cli.main --mode slam with the oracle "
        f"update in {tum['seconds']:.2f} s, {tum['keyframes']} keyframes, "
        f"{tum['mapped']} mapped; APE(sim3) rmse {tum['ape_sim3_m']:.3e} m "
        f"(limit {ATE_TOL_M} m); {tum['lookups']} lookups, launches "
        f"{json.dumps(tum['launches'])}; {tum['tracked_frame_ms']:.1f} ms "
        f"per tracked frame, {tum['mapped_keyframe_ms']:.1f} ms per mapped "
        f"keyframe (mean, the first with 500 iterations); terminate mesh "
        f"step {tum['mesh_s']} s, mesh_verts {tum['mesh_verts']}, culled "
        f"{tum['mesh_verts_culled']}, on {card}")
    log(f"corr tum_frontend: grid {c['grid']} (levels {c['level_rows']} "
        f"rows), E {c['edges']} ({c['real']} real), box path share by level "
        f"{[round(v, 4) for v in c['box_share']]}; kernel 2 box "
        f"{c['ms']:.4f} ms, row design {c['rows_ms']:.4f} ms, plain "
        f"{c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms by "
        f"{c['bound_by']}, err / tolerance {c['err_ratio']:.3f} (rows "
        f"{c['rows_err_ratio']:.3f})")

    fast = bf16_mapping(card, fp32_iter_ms, fp32_kf_ms)
    k = fast["kernel1_bf16"]
    log(f"bf16 mapping-only ({FAST_CONFIG} keys {json.dumps(fast['keys'])} "
        f"over ROOM0, {FAST_FRAMES} box-room frames): {fast['keyframes']} "
        f"keyframes, {fast['iterations']} iterations in "
        f"{fast['seconds']:.2f} s; last PSNR {fast['psnr_last']:.2f} dB "
        f"(floor {PSNR_FLOOR}); launches {json.dumps(fast['launches'])}; "
        f"{fast['iter_ms']:.3f} ms per iteration, {fast['keyframe_ms']:.1f} "
        f"ms per keyframe ({fast['keys']['mapping']['iters']} iterations) "
        f"against fp32 "
        f"{fp32_iter_ms:.3f} / {fp32_kf_ms:.1f} ms (phase 7, 50 "
        f"iterations), on {card}")
    log(f"scatter_add_rows bf16, one bf16 iteration's 6 calls: kernel "
        f"{k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, index_add_ (bf16 "
        f"table) {k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
        f"({k['bytes']} bytes at 3.35 TB/s), max abs err "
        f"{k['max_abs_err']:.3e}, err / tolerance {k['err_ratio']:.3f} "
        f"(+ one bf16 ulp); updates {k['updates']}")
    p = fast["parity"]
    log(f"bf16 parity (tiny config, 3 mapper steps, GPU vs CPU): losses "
        f"{p['losses']}; max rel loss diff {p['max_rel_loss_diff']:.3e} "
        f"(limit {BF16_LOSS_RTOL:g}), max param diff "
        f"{p['max_param_diff']:.3e} (limit {BF16_PARAM_ATOL:g})")
    t13 = time.perf_counter() - t13
    log(f"phase 13 {t13:.1f} s of its budget of {FILES_BUDGET_S:.0f} s"
        + (": OVER BUDGET, cut frames" if t13 > FILES_BUDGET_S else ""))
    return {"image_io": io_res, "tum": tum, "fast": fast, "seconds": t13}


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
                                                 cuda_ms)
    from mneslam_tpu_torch.tools.prof_corr import corr_impl
    from mneslam_tpu_torch.tools.prof_determinism import (
        deterministic, repeat_diff, tracking_parity_run)

    resolve_device("cuda")  # TF32 off
    os.makedirs(OUT, exist_ok=True)

    # 1. card
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    libs = build.build_all(host=build.HOST_SOURCES)
    log(f"build: {len(libs)} libraries (CUDA kernels and the host "
        f"polygoniser) in {time.perf_counter() - t0:.2f} s: {sorted(libs)}")

    # 3. small parity, GPU vs CPU
    losses, rel, pdiff = small_parity()
    log(f"parity: losses cuda {losses['cuda']} cpu {losses['cpu']}; "
        f"max rel loss diff {rel:.3e}, max param diff {pdiff:.3e}")
    if not (rel < 1e-4 and pdiff < PARAM_TOL):
        raise SystemExit("parity: GPU and CPU mapper steps disagree")

    # 3b. mesh parity: the same tiny map meshed on the GPU and on the CPU
    mp = mesh_parity()
    log(f"mesh parity (tiny config, {MESH_PARITY_STEPS} identical mapper "
        f"steps, extract_mesh with the keyframe's observed space): "
        f"{json.dumps(mp)}")
    if not mp["sdf_err_ratio"] <= 1.0:
        raise SystemExit(
            f"mesh parity: the GPU and CPU SDF volumes differ beyond rtol "
            f"{MESH_PARITY_SDF_RTOL:g} / atol {MESH_PARITY_SDF_ATOL:g}")
    if not abs(mp["verts_gpu"] - mp["verts_cpu"]) <= MESH_PARITY_VERTS:
        raise SystemExit(f"mesh parity: the vertex counts differ by more "
                         f"than {MESH_PARITY_VERTS}")
    bad = [k for k in ("accuracy_cm", "completion_cm")
           if not mp["eval_gpu_vs_cpu"][k] <= MESH_PARITY_CM]
    if bad or not (mp["native_raw_equal"] and mp["native_faces_equal"]
                   and mp["native_verts_max_diff"] <= 1e-5):
        raise SystemExit(f"mesh parity: GPU and CPU meshes differ on {bad} "
                         f"(limit {MESH_PARITY_CM} cm), or the native and "
                         f"numpy polygonisers do")

    # 4. tracking parity, GPU vs CPU: the GPU side twice by default (its
    #    sums are not deterministic; printed) and twice with deterministic
    #    algorithms throughout: those two must be bit-identical and hold
    #    TRACK_TOL against the CPU
    t0 = time.perf_counter()
    cpu = tracking_parity_run("cpu")
    runs = [tracking_parity_run("cuda") for _ in range(2)]
    log(f"tracking parity, GPU by default: run 1 vs CPU "
        f"{json.dumps(repeat_diff(runs[0], cpu))}; run 2 vs CPU "
        f"{json.dumps(repeat_diff(runs[1], cpu))}; run 1 vs run 2 "
        f"{json.dumps(repeat_diff(*runs))}")
    with deterministic(True, True) as caught:
        runs = [tracking_parity_run("cuda") for _ in range(2)]
    diffs = repeat_diff(runs[0], cpu)
    same = repeat_diff(*runs)
    log(f"tracking parity (2 frontend updates, fp32, deterministic GPU vs "
        f"CPU): max abs differences {json.dumps(diffs)}; tolerances "
        f"{json.dumps(TRACK_TOL)}; the two deterministic GPU runs differ by "
        f"{json.dumps(same)}; warnings "
        f"{json.dumps(sorted({str(x.message)[:160] for x in caught}))}; "
        f"phase {time.perf_counter() - t0:.1f} s")
    if any(v != 0.0 for v in same.values()):
        raise SystemExit("tracking parity: the deterministic GPU runs differ")
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
    t0 = time.perf_counter()
    res = slam.terminate()
    log(f"terminate: {res}; {time.perf_counter() - t0:.2f} s, of which the "
        f"mesh step {slam.timers.summary()['mesh']['total_s']} s")

    # 7b. the mesh at room0 widths, step by step, and at mesh.voxel_eval
    mesh = mesh_room0(slam, res)
    log(f"room0 mesh (mapping-only map, {card}): {json.dumps(mesh)}")
    # 7c. a render panel of the last keyframe
    panel = render_panel(slam)
    log(f"render panel: {json.dumps(panel)}"
        + ("" if panel["matplotlib"] else
           "; matplotlib is not installed: no jpg written (the render ran)"))
    if not panel["finite"]:
        raise SystemExit("render_image_rays gave non-finite values")

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

    # 7d. full-state checkpoint and resume on the card
    resume = resume_check()
    log(f"resume (tiny config, interrupted after keyframes 0 and 3, the "
        f"full state loaded by a fresh agent that maps keyframe 6): "
        f"{json.dumps(resume)}; parameter tolerance {PARAM_TOL}")
    if not resume["max_param_diff"] < PARAM_TOL:
        raise SystemExit("resume: the resumed run's parameters differ from "
                         "the uninterrupted run's")
    if resume["launches_after_resume"] != resume["expected_launches"]:
        raise SystemExit("resume: kernel 1 launches after the resume "
                         f"{resume['launches_after_resume']}")

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
    s_mesh_dir = os.path.join(slam_s.out_dir, "mesh")
    mesh_steps = {k: v["total_s"] for k, v in stages.items()
                  if k.startswith("mesh/")}
    log(f"SLAM terminate mesh step: {stages['mesh']['total_s']} s for "
        f"{n_map} keyframes, by step (s) {json.dumps(mesh_steps)}; "
        f"mesh_verts {sres.get('mesh_verts')}, culled "
        f"{sres.get('mesh_verts_culled')}")
    if not (sres.get("mesh_verts", 0) > 0
            and sres.get("mesh_verts_culled", 0) > 0
            and all(os.path.exists(os.path.join(s_mesh_dir, n)) for n in
                    ("final_mesh.ply", "final_mesh_culled.ply"))):
        raise SystemExit("the SLAM path's terminate wrote no mesh")

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
            f"edges)", card)
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
        f"one global-BA step over {tracker.counter} keyframes", card)
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
    # (its terminate meshes the box room's bound only: phase 8 meshes the
    # whole room0 bound)
    with corr_impl("pallas_mxu"):
        mslam, _, mres, mseconds, mlaunches, mrec = slam_main_path(
            MXU_FRAMES, "room0_slam_mxu",
            mesh_bound=[[-BOX_HALF - 0.05, BOX_HALF + 0.05]] * 3)
    m_lookups = lookups(mslam)
    mbe = mslam.tracker.backend
    log(f"pallas_mxu path: {MXU_FRAMES} frames, {mslam.tracker.counter} "
        f"keyframes in {mseconds:.2f} s; {mbe.loop_bas} loop BAs, "
        f"{mbe.dense_bas} global BAs; {m_lookups} lookups; launches "
        f"{json.dumps(mlaunches)}; APE(sim3) rmse "
        f"{mres['ate']['rmse']:.4f} m; terminate mesh step "
        f"{mslam.timers.summary()['mesh']['total_s']} s (box bound), "
        f"mesh_verts {mres.get('mesh_verts')}")
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

    # (c) kernels 2, 2b and 3 (box design) against their plain versions,
    #     timed in turns with their row design of the first port
    corr = corr_kernels(slam_s)

    # 11. the TPU probes on the H100, with the counts set to 0 just before
    #     and read just after
    real = [(f"real:{name}", idx, vals, n_rows)
            for name, idx, vals, n_rows in path_scatter_inputs(slam, gen)]
    os.makedirs(RUN_OUT, exist_ok=True)
    torch.save([(tag, idx.cpu(), n_rows) for tag, idx, _, n_rows in real],
               os.path.join(RUN_OUT, "real_stream.pt"))
    reset_launches()
    probes = tpu_probes(real, card)
    probe_launches = read_launches()
    del real
    log(f"TPU probes on the H100: {probes['seconds']:.1f} s; launches "
        f"{json.dumps(probe_launches)}")
    for name in ("scatter_add_rows_blocked", "scatter_add_rows_bucketed"):
        probes[name]["launches"] = probe_launches[name]
        probes[name]["launches_by_path"] = {"probes": probe_launches[name]}
        probes[name]["tiles_launches"] = probe_launches[f"{name}_tiles"]
    log(f"probe phase {probes['seconds']:.1f} s of its budget of 90 s"
        + (": OVER BUDGET, trim the sweep" if probes["seconds"] > 90
           else ""))

    # 12. multi-agent collaboration
    cp, ma_launches = collaboration(slam, card)

    # 13. the shipped configs on files: image I/O, the TUM path, the bf16
    #     mapping path
    files = files_phase(card, iter_ms, kf_ms)
    tum, fast = files["tum"], files["fast"]
    corr["corr_window"]["tum_frontend"] = tum["corr"]

    kernels = [{
        "name": "scatter_add_rows",
        "route": "cuda",
        "source": "mneslam_tpu_torch/kernels/csrc/scatter_add_rows.cu",
        "replaces": "mneslam_tpu/ops/pallas_kernels.py:283",
        "launches": slaunches["scatter_add_rows"],
        "launches_by_path": {"slam": slaunches["scatter_add_rows"],
                             "mapping": map_launches,
                             "after_resume": resume["launches_after_resume"],
                             "probes": probe_launches["scatter_add_rows"],
                             "multiagent": ma_launches["scatter_add_rows"],
                             "collab_parity_distill":
                                 cp["distill_launches"],
                             "tum_files": tum["launches"]["scatter_add_rows"],
                             "mapping_bf16":
                                 fast["launches"]["scatter_add_rows_bf16"]},
        "bf16": {**fast["kernel1_bf16"],
                 "launches": fast["launches"]["scatter_add_rows_bf16"],
                 "fp32_launches": fast["launches"]["scatter_add_rows"]
                 - fast["launches"]["scatter_add_rows_bf16"],
                 "bound_by": "bytes",
                 "timed_as": "sum of one bf16 mapping iteration's 6 calls",
                 "library": "index_add_ into a bf16 table (sums in bf16)",
                 "iter_ms": fast["iter_ms"],
                 "keyframe_ms": fast["keyframe_ms"]},
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
    }, corr_entry(
        corr, "corr_window", "corr_window", "corr_window.cu", ":176",
        slaunches["corr_window"],
        {"slam": slaunches["corr_window"],
         "oracle_backend": b_launches["corr_window"], "mapping": 0,
         "multiagent": ma_launches["corr_window"],
         "tum_files": tum["launches"]["corr_window"]},
        CORR_RTOL, **probes["corr_window"],
        probe_launches=probe_launches["corr_window"],
        frontend_update_ms=upd_ms, frontend_update_device_ms=upd_dev_ms,
        tracked_frame_ms_before_window=pre_ms,
        tracked_frame_ms_after_window=post_ms, loop_ba_ms=loop_ms,
        global_ba_ms=global_ms,
        global_ba_step_profile={"wall_ms": gba_ms, "device_ms": gba_dev_ms},
        filler_s=fill_s, filler_stage_s=fill_stage_s,
        render_frames_s=render_s,
        tum_tracked_frame_ms=tum["tracked_frame_ms"],
        tum_mapped_keyframe_ms=tum["mapped_keyframe_ms"]),
        corr_entry(
        corr, "corr_window_mma", "corr_window_mma", "corr_window_mma.cu",
        ":114", mlaunches["corr_window_mma"],
        {"slam_pallas_mxu": mlaunches["corr_window_mma"]}, MMA_RTOL,
        **probes["corr_window_mma"],
        probe_launches=probe_launches["corr_window_mma"]),
        corr_entry(
        corr, "corr_window_per_level", "corr_window_per_level",
        "corr_window.cu", ":241", o_launches["corr_window_per_level"],
        {"oracle_pallas_per_level": o_launches["corr_window_per_level"]},
        CORR_RTOL),
        corr_entry(
        corr, "corr_window_rows", "corr_window", "corr_window.cu", ":176",
        probe_launches["corr_window_rows"],
        {"probes": probe_launches["corr_window_rows"],
         "unrolled_probes": probe_launches["corr_window_unrolled"]},
        CORR_RTOL, rows=True),
        corr_entry(
        corr, "corr_window_mma_rows", "corr_window_mma", "corr_window_mma.cu",
        ":114", probe_launches["corr_window_mma_rows"],
        {"probes": probe_launches["corr_window_mma_rows"]}, MMA_RTOL,
        rows=True),
        probes["scatter_add_rows_blocked"],
        probes["scatter_add_rows_bucketed"]]
    idle = [k["name"] for k in kernels if not k["launches"] >= 1]
    if idle:
        raise SystemExit(f"kernels never launched on their path: {idle}")
    unmeasured = [f"{k['name']}.{key}" for k in kernels
                  for key in ("ms", "plain_ms", "bound_ms", "max_abs_err")
                  if k[key] is None]
    if unmeasured:
        raise SystemExit(f"kernel numbers not measured: {unmeasured}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
