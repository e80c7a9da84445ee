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
  9. the same path with MNESLAM_CORR_IMPL=pallas_mxu for 26 frames (the
     fewest past the frontend window: loop BA and one global BA): every
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
     collaboration keys, on frames 0-19 and 14-33 of one 42-frame
     box-room trajectory (bf16 DROID encoders with random weights, the
     update's flow and weights replaced by ground-truth reprojection
     targets as in phases 5-6, every frame admitted; with the random
     update net the key poses leave the room's bound and nothing is
     distilled): both terminates' outputs, the descriptor DB holding every
     mapped keyframe, a cross-agent loop aligned and at least one
     cross-agent closure accepted (the trajectory deformation ran), a
     distillation by each agent and its fused mesh, kernel 1's launches =
     6 x (mapping + distillation iterations), kernel 2's = the agents'
     lookups; times per tracked frame, mapped keyframe, alignment,
     distillation and fused mesh, and a torch.profiler table of 5
     distillation iterations (chiprun_out/chip_smoke/distill_profile.txt);
     12d. `python -m
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
     iteration and keyframe beside phase 7's fp32 ones; kernel 1's bf16
     route (workspace, two launches) on the six real calls of one bf16
     iteration: against the plain version (and the staged route too),
     untouched rows +0.0, the workspace zero after each call, two kernels
     and no memset in a call (profiler), timed in turns with the staged
     route, each staged step (zero fill, kernel, cast) alone, both in a
     CUDA graph, the plain version, `index_add_` into a bf16 table and
     the bound (the index stream saved for tools/scatter_bf16_ablation.py);
     and the tiny config's 3 mapper steps in bf16, GPU vs CPU (loss rtol
     1e-4, parameters 5e-4). The phase's time is printed beside its budget
     of 180 s;
 14. the row-sharded mapper and the mesh fleet (`mneslam_tpu_torch/
     parallel/`): configs/Replica/room0_v5e8.yaml's keys (bf16 render,
     shard_plane_rows) over room0 widths, the box-room frames rendered
     once here and handed to the ranks in a file, the ranks child
     processes of this script (`--shard-rank`, a timeout each). 14a. one
     rank over NCCL: the row-sharded `Mapper.optimize` (shard_gather_every
     1) on map calls of 20, 10 and 10 iterations (room0's 500 / 50 cut)
     against the plain mapper from the same seeds (the same batches and
     uniforms): losses rtol 1e-4, parameters 5e-4 (13c's bf16 bounds),
     kernel 1 six launches per iteration; 14b. 4 ranks on cuda:0 over
     gloo (through host memory): the gradient of one batch
     (`Mapper.gradients`) against the plain mapper's, per leaf within
     1e-4 of its largest element in fp32 (fold "after" and "before"; and
     with `grid.oneGrid: false`, the colour planes through the seam, 12
     kernel-1 launches per iteration) and
     2e-2 in bf16, then the optimize in fp32 on calls of 1 and 2
     iterations (cut to fit the budget): the sync seam and fold "before"
     against the plain mapper, shard_gather_every 8 against one rank's
     (14a), losses rtol 1e-4, parameters 5e-4 on the elements whose
     Adam second moment is not at the level of the sums' rounding
     (SHARD_LOSS_RTOL's comment; the rest's share printed, beside the
     same readings of the plain mapper against itself and of one rank
     against it); kernel 1 six launches per iteration on every rank and
     the ranks' maps equal in every run; ms per iteration by rank (gloo
     through host memory on one card: not a collective's speed); 14c.
     `torchrun --nproc_per_node=2` of `cli.main` (each rank through
     `--cli-rank`, which writes its launch counts after `cli.main`)
     on room0_v5e8.yaml over 6 box-room frames (fp32, the sync seam,
     first_iters 2, iters 1): `parallel/mesh.init_world` on every rank
     picks gloo on cuda:0, rank 0 leads `MNESLAM` and writes the outputs,
     rank 1 follows its map calls; its per-keyframe losses within rtol
     1e-4 of a one-process `cli.main` of the same config (the plain
     mapper), kernel 1 six launches per iteration on both ranks; 14d.
     `MeshAgentFleet.run_mapping_only`, two agents at room0 widths on the
     first 11 frames of 12c's segments (first_iters 20, iters 20,
     loop_iters 10,
     fusion off), against `MultiAgentRunner.run_mapping_only`, which runs
     twice: the same keyframes, every keyframe's loss within rtol 1e-4 of
     the runner's, the parameters' distance printed beside the runner's
     from itself (the card's run-to-run spread), every mapped keyframe in
     the descriptor DB, kernel 1 six launches per iteration; then
     `MeshAgentFleet.run_slam` for two oracle agents on phase 5's tiny
     config (kernel 2 once per lookup, kernel 1 six times per mapping
     iteration, finite trajectories) and `python -m mneslam_tpu_torch.cli
     --device_mesh --num_agents 2` on phase 3's tiny config (exit 0, both
     agents' outputs); 14e. the composed fleet: `torchrun
     --nproc_per_node=4` of `cli.main --num_agents 2 --device_mesh` (each
     rank through `--cli-rank`, its agent on a segment of a box-room
     trajectory; 2 agents x 2 row ranks on cuda:0 over gloo; rank r runs
     agent r // 2, the slice's first rank leads it, the other follows its
     map calls): configs/Replica/room0_v5e8_fleet.yaml's keys (row
     sharding, shard_gather_every 1) on 14d's segments (3 keyframes an
     agent, first_iters 2 and iters 1, fp32 render as in 14c) against
     the one-slice fleet in this process, which runs twice (every
     keyframe's loss rtol 1e-4, parameters 5e-4 on all but 1e-6 of the
     elements beside the one-slice fleet's spread against itself; both
     leaders' outputs and nothing else; each leader's descriptor DB holds
     every mapped keyframe of both agents); phase 5's tiny config in SLAM
     mode with the oracle update on 14d's SLAM segments (trajectories
     finite and within 5 cm of 14d's one-slice fleet's); and
     tests/test_torch_fleet.py:94's tiny setup with loop detection on (the
     one-slice fleet's alignments, closures and distillations, a peer map
     fetched across slices, the maps after the fusion within 5e-4 of the
     one-slice fleet's on all but 1e-6 of the elements, beside its spread
     against itself). In every world every rank exits 0, each follower
     returns nothing, kernel 1 launches six times per iteration of its
     slice's map calls (and of its distillations on a leader) on every
     rank, kernel 2 once per lookup on a leader and never on a follower;
     seconds per world and ms per iteration by rank. 14d's runs and 14e's
     references in this process go first, on a quiet card; then the
     child processes of 14b, 14c, 14d's CLI and 14e run at the same time.
     The phase's time is printed beside its budget of 210 s;
 15. the options the shipped configs leave off (colour planes
     `grid.oneGrid: false`, `training.n_importance`, the smoothness term
     `training.smooth_weight`, `MNESLAM_PLANE_SAMPLER`, the encodings and
     the hash grid, `MNESLAM_GRU_IMPL=fused`, the tracker extras): 15a.
     phase 3's tiny config with colour planes, 8 importance samples and
     the smoothness term, 3 mapper steps GPU vs CPU through the u seam for
     each sampler (packed, merged, rows) in fp32 and packed in bf16
     (losses rtol 1e-4, parameters 5e-4), kernel 1 exactly 30 / 15 / 0
     launches per iteration (24 of the 30 on bf16 values under bf16);
     15b. `cli.main --mode mapping` on a yaml that inherits
     configs/Replica/room0.yaml with the options on (width uncut, 6
     box-room frames, first_iters and iters cut to 150 and 25): last PSNR
     above 16 dB, kernel 1 30 launches per iteration, both meshes, their
     vertex colours the map's and moved by its colour planes, ms per
     iteration beside phase 7's; kernel 1 on one iteration's six
     colour-plane calls against its plain version, timed beside its bound
     and `index_add_`; 15c. the encodings and the hash grid at its
     defaults GPU vs CPU (indices equal, features, the table's gradient),
     the fused GRU against the reference in bf16 at the frontend's shapes
     (2^-4), phase 5's tiny oracle SLAM run under MNESLAM_GRU_IMPL=fused
     with the DROID update's GRU running (key poses within 5 cm), then
     `depth_filter`, `upsample_disps` and `keyframe_selection_overlap` on
     its state GPU vs CPU, and `maybe_profile` writing a trace. The
     phase's time is printed beside its budget of 90 s.
Every phase prints its seconds. Phase 13b maps 18 TUM frames (24 before
phase 15) and 14d's fleet first_iters 20 and iters 20 (50 and 50 before):
the depth that pays for phase 15.
Prints the kernels' JSON line, then as the last line
{"ok": true, "device": {...}}. Needs torch with CUDA and nvcc; imports
nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
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
# the pallas_mxu run: the fewest frames that take it past the frontend
# window of 25 with every frame admitted, so that loop BA runs (at the
# 26th keyframe) and one global BA (after the last batch: 26 keyframes
# > 25); 32 before 14e was added
MXU_FRAMES = 26
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
        scatter_add_rows, scatter_add_rows_bf16_staged,
        scatter_add_rows_per_warp)
    from mneslam_tpu_torch.kernels.scatter_rows_blocked import (
        scatter_add_rows_blocked, scatter_add_rows_blocked_tiles)
    from mneslam_tpu_torch.kernels.scatter_rows_bucketed import (
        scatter_add_rows_bucketed, scatter_add_rows_bucketed_tiles)

    return {"scatter_add_rows": scatter_add_rows,
            "corr_window": corr_window_multilevel,
            "corr_window_mma": corr_window_multilevel_mma,
            "corr_window_per_level": corr_window,
            "scatter_add_rows_per_warp": scatter_add_rows_per_warp,
            "scatter_add_rows_bf16_staged": scatter_add_rows_bf16_staged,
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


def path_scatter_inputs(slam, generator, plane_shapes=None, prefix=""):
    """The six (idx, vals, n_rows) scatter inputs of one mapping iteration
    at the trained state: indices from a real ray batch (its first render
    pass), values random; of the geometry planes, or of the planes of
    `plane_shapes` (the colour planes), their names after `prefix`."""
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
    for lvl, shapes in enumerate(plane_shapes or scene.plane_shapes):
        for name, dims in (("xy", [0, 1]), ("xz", [0, 2]), ("yz", [1, 2])):
            C, Hp, Wp = shapes[name]
            idx, _, _ = interp._cell(p_nor[:, dims], Hp, Wp)
            vals = torch.randn((idx.shape[0], 4 * C), generator=generator,
                               device="cuda")
            out.append((f"{prefix}{'coarse' if lvl == 0 else 'fine'}_"
                        f"{name}", idx, vals, Hp * Wp))
    return out


def check_scatter(idx, vals, n_rows, fn=None):
    """Kernel (`fn`, by default `scatter_add_rows`) vs plain version on the
    same inputs; -> (max abs error, max error / tolerance). Raises
    SystemExit past the tolerance. For bf16 values both sides round an fp32
    sum to bf16, so one bf16 ulp (2^-7 of the plain result) is added to the
    tolerance."""
    import torch

    from mneslam_tpu_torch.kernels.scatter_add_rows import (
        scatter_add_rows, scatter_add_rows_plain)

    got = (fn or scatter_add_rows)(idx, vals, n_rows).float()
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
# the shared frames give exact cross-agent descriptor matches. 20 frames
# each (28 before 14e was added, past the frontend window, so loop BA
# ran there;
# phases 6 and 8 hold loop BA): the descriptor DB reaches
# loop_detection.loop_launch_th (20) at the 10th keyframe of each, and
# what comes before is as on longer segments (agent 1's first alignment
# there, the one accepted on 24-frame segments); 6 frames are shared
MA_FRAMES = 42
MA_SEGMENTS = ((0, 20), (14, 34))
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
        ("no cross-agent closure accepted (the trajectory deformation "
         "did not run)", sum(c.closures_accepted for c in collabs) >= 1),
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
# frontend updates; under its window of 25 (no backend); 24 before phase
# 15, cut to pay for it
TUM_FRAMES = 18
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


def device_ops(fn) -> list:
    """Names of the device operations (kernels, memsets, copies) that one
    call of fn() runs, each as often as it ran, from torch.profiler (CPU
    and CUDA activities, as `profiled` reads it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            for _ in range(e.count)]


def bf16_ops_in_child(stream: str, width: int) -> list:
    """`device_ops` of one bf16 `scatter_add_rows` call on the largest table
    of a saved index stream (values from a seed), in a child process: late
    in a whole run of this script the profiler recorded no device
    operation at all (on an H100), while a fresh process reads it."""
    code = (
        "import json, sys, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import chip_smoke as c\n"
        "from mneslam_tpu_torch.kernels.scatter_add_rows import "
        "scatter_add_rows\n"
        f"_, idx, n = max(torch.load({stream!r}), key=lambda x: x[2])\n"
        "g = torch.Generator(device='cuda').manual_seed(0)\n"
        f"vals = torch.randn((idx.numel(), {width}), generator=g, "
        "device='cuda').to(torch.bfloat16)\n"
        "idx = idx.cuda()\n"
        "scatter_add_rows(idx, vals, n)\n"
        "print(json.dumps(c.device_ops(lambda: scatter_add_rows(idx, vals, "
        "n))))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    if r.returncode != 0:
        raise SystemExit(f"kernel 1 bf16: the profiling child failed:\n"
                         f"{r.stdout}{r.stderr}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def kernel1_bf16(calls, stream: str) -> dict:
    """Kernel 1's bf16 route (workspace, two launches) on the six calls of
    one bf16 mapping iteration: each held against the plain version (and
    the staged route too), its untouched rows +0.0 bit for bit, the
    workspace all zero after it; then, summed over the calls, the route
    timed in turns with the staged route (zero fill, kernel, cast; each
    step also timed alone), both also as device time in a CUDA graph, the
    plain version, `index_add_` into a bf16 table, the bound; the device
    operations of one call and the workspace's size. Raises SystemExit on
    a failed check. `stream`: the calls' saved index stream."""
    import torch

    from mneslam_tpu_torch.kernels.scatter_add_rows import (
        BF16_LAUNCHES_PER_CALL, accumulate_into, bf16_workspace,
        scatter_add_rows, scatter_add_rows_bf16_staged,
        scatter_add_rows_plain)
    from mneslam_tpu_torch.tools.measure import (FP32_FLOPS,
                                                 HBM_BYTES_PER_S, cuda_ms,
                                                 graph_ms)

    k = {"ms": 0.0, "staged_ms": 0.0, "graph_ms": 0.0,
         "staged_graph_ms": 0.0,
         "staged_split": {"zero_fill_ms": 0.0, "kernel_ms": 0.0,
                          "cast_ms": 0.0},
         "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "bytes": 0,
         "max_abs_err": 0.0, "err_ratio": 0.0, "staged_err_ratio": 0.0,
         "updates": []}
    for name, idx, vals, n_rows in calls:
        err, ratio = check_scatter(idx, vals, n_rows)
        k["max_abs_err"] = max(k["max_abs_err"], err)
        k["err_ratio"] = max(k["err_ratio"], ratio)
        k["staged_err_ratio"] = max(k["staged_err_ratio"], check_scatter(
            idx, vals, n_rows, scatter_add_rows_bf16_staged)[1])
        got = scatter_add_rows(idx, vals, n_rows)
        touched = torch.zeros(n_rows, dtype=torch.bool, device="cuda")
        touched[idx] = True
        rows, flags = bf16_workspace("cuda")
        if got[~touched].view(torch.int16).any():
            raise SystemExit(f"kernel 1 bf16 ({name}): an untouched row is "
                             f"not +0.0")
        if rows.any() or flags.any():
            raise SystemExit(f"kernel 1 bf16 ({name}): the workspace is not "
                             f"zero after the call")
        nu, width = vals.shape
        new_ms, staged_ms = ab_ms(
            lambda: scatter_add_rows(idx, vals, n_rows),
            lambda: scatter_add_rows_bf16_staged(idx, vals, n_rows))
        k["ms"] += new_ms
        k["staged_ms"] += staged_ms
        # device time without the host: 10 calls in one CUDA graph
        k["graph_ms"] += graph_ms(
            lambda: scatter_add_rows(idx, vals, n_rows), 10)
        k["staged_graph_ms"] += graph_ms(
            lambda: scatter_add_rows_bf16_staged(idx, vals, n_rows), 10)
        split = k["staged_split"]
        split["zero_fill_ms"] += cuda_ms(lambda: torch.zeros(
            (n_rows, width), dtype=torch.float32, device="cuda"))
        table = torch.zeros((n_rows, width), dtype=torch.float32,
                            device="cuda")
        split["kernel_ms"] += cuda_ms(
            lambda: accumulate_into(table, idx, vals))
        split["cast_ms"] += cuda_ms(lambda: table.to(torch.bfloat16))
        del table
        k["plain_ms"] += cuda_ms(
            lambda: scatter_add_rows_plain(idx, vals, n_rows))
        # one call: index_add_ into a bf16 table (it sums in bf16: another
        # function)
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
    # the device operations of one call (the largest table's)
    ops = bf16_ops_in_child(stream, calls[0][2].shape[1])
    k["device_ops_per_call"] = ops
    k["launches_per_call"] = len(ops)
    rows, flags = bf16_workspace("cuda")
    k["workspace_bytes"] = (rows.numel() * rows.element_size()
                            + flags.numel() * flags.element_size())
    if (len(ops) != BF16_LAUNCHES_PER_CALL
            or any("memset" in op.lower() for op in ops)):
        raise SystemExit(f"kernel 1 bf16: expected "
                         f"{BF16_LAUNCHES_PER_CALL} kernels and no memset "
                         f"per call, the profiler saw {ops}")
    return k


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
    from mneslam_tpu_torch.slam import MNESLAM

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
    # the index stream (also for tools/scatter_bf16_ablation.py)
    stream = os.path.join(RUN_OUT, "real_stream_bf16.pt")
    os.makedirs(RUN_OUT, exist_ok=True)
    torch.save([(name, idx.cpu(), n_rows) for name, idx, _, n_rows in calls],
               stream)
    out["kernel1_bf16"] = kernel1_bf16(calls, stream)

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
    sp = k["staged_split"]
    log(f"scatter_add_rows bf16, one bf16 iteration's 6 calls: workspace "
        f"route {k['ms']:.4f} ms ({k['launches_per_call']} device "
        f"operations a call, profiled in a child process: "
        f"{k['device_ops_per_call']}; workspace "
        f"{k['workspace_bytes']} bytes), staged route {k['staged_ms']:.4f} "
        f"ms (in turns with it); in a CUDA graph {k['graph_ms']:.4f} / "
        f"{k['staged_graph_ms']:.4f} ms; plain {k['plain_ms']:.4f} ms, "
        f"index_add_ (bf16 table, sums in bf16) {k['library_ms']:.4f} ms, "
        f"bound "
        f"{k['bound_ms']:.4f} ms ({k['bytes']} bytes at 3.35 TB/s; "
        f"{100 * k['bound_ms'] / k['ms']:.1f}% of it), max abs err "
        f"{k['max_abs_err']:.3e}, err / tolerance {k['err_ratio']:.3f} "
        f"(staged {k['staged_err_ratio']:.3f}; + one bf16 ulp); untouched "
        f"rows +0.0, workspace zero after each call; updates "
        f"{k['updates']}, on {card}")
    log(f"scatter_add_rows bf16 staged route, each step alone over the 6 "
        f"calls: zero fill {sp['zero_fill_ms']:.4f} ms, kernel "
        f"{sp['kernel_ms']:.4f} ms, cast {sp['cast_ms']:.4f} ms, sum "
        f"{sum(sp.values()):.4f} ms; the route {k['staged_ms']:.4f} ms")
    p = fast["parity"]
    log(f"bf16 parity (tiny config, 3 mapper steps, GPU vs CPU): losses "
        f"{p['losses']}; max rel loss diff {p['max_rel_loss_diff']:.3e} "
        f"(limit {BF16_LOSS_RTOL:g}), max param diff "
        f"{p['max_param_diff']:.3e} (limit {BF16_PARAM_ATOL:g})")
    t13 = time.perf_counter() - t13
    log(f"phase 13 {t13:.1f} s of its budget of {FILES_BUDGET_S:.0f} s"
        + (": OVER BUDGET, cut frames" if t13 > FILES_BUDGET_S else ""))
    return {"image_io": io_res, "tum": tum, "fast": fast, "seconds": t13}


# ---------------------------------------------------------------------------
# 14. the row-sharded mapper and the mesh fleet
# ---------------------------------------------------------------------------

# phase 14's printed budget (not a failure when over): 150 s before 14e,
# raised by the 60 s that 14e's worlds add beside 14b, 14c and 14d's CLI
SHARD_BUDGET_S = 210.0
# 14a: (frame, iterations) per map call; room0's first_iters 500 and
# iters 50 cut to 20 and 10
SHARD_SCHEDULE = ((0, 20), (5, 10), (10, 10))
# 14b: cut further to fit the budget (gloo through host memory moves
# every packed table, 0.26 GB in bf16 and 0.52 GB in fp32, per iteration);
# two iterations in the second call, so its loss is taken after a step
# of the Adam state carried from the first
SHARD_B_SCHEDULE = ((0, 1), (5, 2))
SHARD_RANKS = 4             # 14b: ranks on cuda:0 over gloo
SHARD_CHILD_TIMEOUT_S = 300.0
# 14a (one rank) against the plain mapper: 13c's bf16 bounds, loss rtol
# 1e-4 and parameters 5e-4. Over several ranks a sum's order changes: the
# ranks' partial gradients are summed across ranks (in bf16 rounded to
# bf16 first, as in the JAX package), so the decoder and the planes
# differ from the plain mapper's by a few ulps after a step. An element
# first touched with a gradient at the level of that difference (or zero
# in one run and not in the other) takes Adam's first step, about the
# learning rate (5e-3) whatever the gradient's size, in one run only or
# in the other direction. On the card that moves a few of the 64.4M
# elements of 4 ranks' map past 5e-4 (up to 7e-3; the 14b lines print how
# many, how many the first batch left untouched and how many lie at a
# block's edge; PERF.md, PR 13), and none of the plain mapper's against
# itself. So the parameters hold 5e-4 on all but SHARD_PARAM_SHARE of the
# elements, and every element within SHARD_PARAM_STEPS learning rates per
# iteration (the most two runs of Adam put between one element; it
# catches a diverged or non-finite map). One batch's gradient is held per
# leaf (max |error| over max |reference|, tests/test_parallel.py:528-531):
# 1e-4 in fp32, and in bf16 SHARD_GRAD_TOL_BF16, 5 bf16 ulps (the four
# ranks' bf16 partials are rounded, then summed in bf16), beside the
# plain mapper's bf16 gradient against itself and one rank's against it.
SHARD_LOSS_RTOL = 1e-4
SHARD_PARAM_TOL = 5e-4
SHARD_PARAM_SHARE = 1e-6
SHARD_PARAM_STEPS = 2
SHARD_GRAD_TOL = 1e-4
SHARD_GRAD_TOL_BF16 = 2e-2
# 14d: the first FLEET_FRAMES frames of each of 12c's segments
FLEET_FRAMES = 11
FLEET_FIRST_ITERS = 20      # room0's 500 cut (50 before phase 15)
FLEET_ITERS = 20            # room0's 50 cut (phase 15 pays with it)
FLEET_LOOP_ITERS = 10       # room0's loop_iters 100 cut (alignments)


def shard_config():
    """configs/Replica/room0_v5e8.yaml (its keys over room0.yaml: bf16
    render, shard_plane_rows, shard_gather_every 8) on the synthetic box
    room."""
    from mneslam_tpu_torch.config import (default_config, deep_update,
                                          load_config)

    cwd = os.getcwd()
    os.chdir(ROOT)      # the configs' inherit_from paths are relative
    try:
        cfg = deep_update(default_config(), load_config(
            "configs/Replica/room0_v5e8.yaml"))
    finally:
        os.chdir(cwd)
    cfg["dataset"] = "synthetic"
    cfg["data"]["output"] = RUN_OUT
    return cfg


def params_of(state) -> list:
    from mneslam_tpu_torch.models.scene_rep import param_leaves

    return [t.detach().float().cpu() for t in param_leaves(state.params)]


def max_param_diff(a: list, b: list) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def param_stats(params: list, ref: list, grads=None, ranks=1) -> dict:
    """`params` against `ref`: the largest difference, and the count and
    share of elements beyond SHARD_PARAM_TOL (non-finite ones counted);
    with `grads` (the first batch's gradient), how many of those the first
    batch left untouched, and how many of the planes' lie on the first or
    last y-row of one of `ranks` row blocks."""
    import torch

    over, n, untouched, edge = 0, 0, 0, 0
    for i, (p, r) in enumerate(zip(params, ref)):
        beyond = ~((p - r).abs() <= SHARD_PARAM_TOL)
        over += int(beyond.sum())
        n += p.numel()
        if grads is not None and bool(beyond.any()):
            untouched += int((grads[i][beyond] == 0).sum())
            if p.dim() == 3:
                hb = -(-p.shape[1] // ranks)
                y = torch.nonzero(beyond)[:, 1] % hb
                edge += int(((y == 0) | (y == hb - 1)).sum())
    out = {"max_param_diff": max_param_diff(params, ref),
           "n_beyond": over, "share_beyond": over / n}
    if grads is not None:
        out.update(beyond_untouched_by_first_batch=untouched,
                   beyond_at_block_edge=edge)
    return out


def shard_run(spec: dict, run: dict, mesh, device) -> dict:
    """One row-sharded mapping run on this rank: the schedule's keyframes
    added and optimized from the agent's seeds -> losses, ms per iteration
    by call, kernel-1 launches, and (rank 0) the parameters against the
    reference file's."""
    import torch

    from mneslam_tpu_torch.device import make_generator
    from mneslam_tpu_torch.kernels.scatter_add_rows import scatter_add_rows
    from mneslam_tpu_torch.mapping.mapper import Mapper
    from mneslam_tpu_torch.models.scene_rep import SceneRep
    from mneslam_tpu_torch.parallel import mesh as pm

    cfg = run["config"]
    scene = SceneRep(cfg, device)
    mapper = Mapper(cfg, scene, num_kf=spec["num_kf"],
                    rays_per_kf=spec["rays_per_kf"], mesh=mesh,
                    shard_plane_rows=True)
    state = mapper.init_state(make_generator(device, 42))
    gen = make_generator(device, 1000)
    torch.cuda.synchronize()
    scatter_add_rows.launches = 0
    if run.get("grads"):
        return shard_grads(spec, run, mapper, state, gen, device)
    losses, ms, iters = [], [], 0
    for fi, n in run["schedule"]:
        frame = {k: torch.as_tensor(v, device=device)
                 for k, v in spec["frames"][fi].items()}
        pose = torch.as_tensor(spec["poses"][fi], device=device)
        frame["frame_id"] = fi
        state = mapper.add_keyframe(state, fi, frame, pose, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = mapper.optimize(state, frame, pose, gen, iters=n)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0) / n)
        losses.append(float(met["loss"]))
        iters += n
        print(f"  frame {fi}: {n} iterations, {ms[-1]:.1f} ms each, loss "
              f"{losses[-1]}", flush=True)
    launches = scatter_add_rows.launches
    # every rank's replica against rank 0's
    group = mapper.group
    replica_diff = 0.0
    for t in params_of(state):
        t0_ = pm.broadcast(t.to(device), group)
        replica_diff = max(replica_diff, float((t0_.cpu() - t).abs().max()))
    mp = cfg["mapping"]
    out = {"losses": losses, "ms_per_iter": ms, "launches": launches,
           "iters": iters, "replica_diff": replica_diff,
           "lr": max(float(mp["lr_embed"]), float(mp["lr_decoder"])),
           "n_global": mapper.n_global, "n_cur": mapper.n_cur,
           "transport": group.transport, "ranks": group.size}
    if group.index == 0:
        params = params_of(state)
        if run.get("save"):
            torch.save(params, run["save"])
        if run.get("ref"):
            out.update(param_stats(
                params, torch.load(run["ref"]), ranks=group.size,
                grads=torch.load(run["g1"]) if run.get("g1") else None))
    if run.get("profile"):
        # 3 more iterations of the last call under the profiler (after
        # the counts and the comparison): kernel time and launches
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            mapper.optimize(state, frame, pose, gen, iters=3)
            torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / 3
        events = prof.key_averages()
        kern = [e for e in events if e.device_type == DeviceType.CUDA
                and not e.is_user_annotation]
        dev_ms = 1e-3 * sum(e.self_device_time_total for e in kern) / 3
        with open(run["profile"], "w") as f:
            f.write(f"3 row-sharded iterations on rank {group.index} of "
                    f"{group.size}\n" + events.table(
                        sort_by="self_cuda_time_total", row_limit=30))
        out["profile"] = {"wall_ms": wall, "device_ms": dev_ms,
                          "launches": sum(e.count for e in kern) / 3}
    return out


def first_keyframe(spec, mapper, state, gen, device):
    """Frame 0 added as the first keyframe -> (state, frame, pose)."""
    import torch

    frame = {k: torch.as_tensor(v, device=device)
             for k, v in spec["frames"][0].items()}
    pose = torch.as_tensor(spec["poses"][0], device=device)
    frame["frame_id"] = 0
    return mapper.add_keyframe(state, 0, frame, pose, gen), frame, pose


def grad_rel_err(got: list, ref: list) -> float:
    """Per leaf max |error| over max |reference|, the largest over the
    leaves (tests/test_parallel.py:528-531's measure)."""
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(got, ref))


def shard_grads(spec, run, mapper, state, gen, device) -> dict:
    """The gradient of the first keyframe's first batch on this rank
    (`Mapper.gradients`, no step), every rank's against rank 0's and
    (rank 0) against the reference file's."""
    import torch

    from mneslam_tpu_torch.kernels.scatter_add_rows import scatter_add_rows
    from mneslam_tpu_torch.parallel import mesh as pm

    state, frame, pose = first_keyframe(spec, mapper, state, gen, device)
    grads = mapper.gradients(state, frame, pose, gen)
    torch.cuda.synchronize()
    group = mapper.group
    replica = max(float((pm.broadcast(g, group) - g).abs().max())
                  for g in grads)
    out = {"launches": scatter_add_rows.launches, "iters": 1,
           "replica_diff": replica, "losses": [], "ranks": group.size,
           "transport": group.transport}
    if group.index == 0:
        out["grad_rel_err"] = grad_rel_err(
            [g.float().cpu() for g in grads], torch.load(run["grads"]))
    return out


def shard_rank_main(argv) -> int:
    """A rank of phase 14 (`chip_smoke.py --shard-rank SPEC RANK WORLD
    BACKEND STORE OUT`): joins the world through the file store, runs the
    spec's runs, writes its results."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from mneslam_tpu_torch.device import resolve_device
    from mneslam_tpu_torch.parallel import mesh as pm

    spec_path, rank, world, backend, store, out = argv
    device = resolve_device("cuda:0")
    torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=int(rank), world_size=int(world),
                            timeout=datetime.timedelta(seconds=120))
    try:
        spec = torch.load(spec_path, weights_only=False)
        mesh = pm.make_mesh(1)
        print(f"rank {rank}: {mesh}", flush=True)
        results = [shard_run(spec, run, mesh, device)
                   for run in spec["runs"]]
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(results, f)
    return 0


def spawn_ranks(tag: str, spec: dict, world: int, backend: str) -> list:
    """`world` ranks of `shard_rank_main` on cuda:0, started together ->
    each rank's results. Raises SystemExit when a rank fails or outlives
    SHARD_CHILD_TIMEOUT_S."""
    import torch

    os.makedirs(RUN_OUT, exist_ok=True)
    spec_path = os.path.join(RUN_OUT, f"{tag}_spec.pt")
    torch.save(spec, spec_path)
    store = os.path.join(RUN_OUT, f"{tag}_store")
    if os.path.exists(store):
        os.remove(store)
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = []
    for rank in range(world):
        out = os.path.join(RUN_OUT, f"{tag}_rank{rank}.json")
        if os.path.exists(out):
            os.remove(out)
        logf = open(os.path.join(OUT, f"{tag}_rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--shard-rank", spec_path, str(rank), str(world), backend,
             store, out], cwd=ROOT, env=env, stdout=logf,
            stderr=subprocess.STDOUT), out, logf))
    deadline = time.monotonic() + SHARD_CHILD_TIMEOUT_S
    try:
        for p, _, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, _, logf in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            logf.close()
    codes = [p.returncode for p, _, _ in procs]
    if any(codes):
        tails = [open(logf.name).read()[-2000:] for _, _, logf in procs]
        raise SystemExit(f"phase 14 {tag}: rank exit codes {codes} (killed "
                         f"after {SHARD_CHILD_TIMEOUT_S:.0f} s if negative)"
                         f"\n" + "\n".join(tails))
    results = []
    for _, out, _ in procs:
        with open(out) as f:
            results.append(json.load(f))
    return results


def check_shard(tag: str, r: dict, ref_losses, n_ranks: int,
                param_share=None, loss_rtol=SHARD_LOSS_RTOL,
                grad_tol=None, per_iter=SCATTERS_PER_ITER) -> float:
    """A sharded run's checks: kernel 1 `per_iter` times (six, twelve with
    colour planes) per iteration, the
    replicas equal, the losses within `loss_rtol` (None: printed only),
    the parameters within SHARD_PARAM_TOL on all but `param_share` of
    the elements (None: printed only; see SHARD_LOSS_RTOL), and a
    gradient within `grad_tol` (None: printed only) -> the max relative
    loss difference."""
    if r["launches"] != per_iter * r["iters"]:
        raise SystemExit(f"{tag}: kernel-1 launches {r['launches']} != "
                         f"{per_iter} x {r['iters']} iterations")
    if r["replica_diff"] != 0.0:
        raise SystemExit(f"{tag}: the ranks' maps differ by "
                         f"{r['replica_diff']}")
    if r["ranks"] != n_ranks:
        raise SystemExit(f"{tag}: {r['ranks']} ranks, expected {n_ranks}")
    rel = [abs(a - b) / max(abs(b), 1e-12)
           for a, b in zip(r["losses"], ref_losses)]
    if len(rel) != len(ref_losses):
        raise SystemExit(f"{tag}: {len(r['losses'])} calls, expected "
                         f"{len(ref_losses)}")
    if loss_rtol is not None and rel and not max(rel) <= loss_rtol:
        raise SystemExit(f"{tag}: losses {r['losses']} against {ref_losses}"
                         f" (rtol {loss_rtol})")
    lr = r.get("lr")
    if param_share is not None and "max_param_diff" in r and not (
            r["share_beyond"] <= param_share and r["max_param_diff"]
            <= SHARD_PARAM_STEPS * r["iters"] * lr):
        raise SystemExit(f"{tag}: {r['n_beyond']} parameter elements "
                         f"({r['share_beyond']:.3e}) beyond "
                         f"{SHARD_PARAM_TOL} (limit {param_share:g}), "
                         f"the largest {r['max_param_diff']} (limit "
                         f"{SHARD_PARAM_STEPS} x {r['iters']} x {lr})")
    if (grad_tol is not None and "grad_rel_err" in r
            and not r["grad_rel_err"] <= grad_tol):
        raise SystemExit(f"{tag}: the gradient differs by "
                         f"{r['grad_rel_err']} of its largest element "
                         f"(limit {grad_tol})")
    return max(rel) if rel else 0.0


def plain_gradients(cfg, spec, save: str):
    """The plain mapper's gradient of the first keyframe's first batch,
    from the agent's seeds, saved to `save`."""
    import torch

    from mneslam_tpu_torch.device import make_generator
    from mneslam_tpu_torch.mapping.mapper import Mapper
    from mneslam_tpu_torch.models.scene_rep import SceneRep

    scene = SceneRep(cfg, "cuda")
    mapper = Mapper(cfg, scene, num_kf=spec["num_kf"],
                    rays_per_kf=spec["rays_per_kf"])
    state = mapper.init_state(make_generator(scene.device, 42))
    gen = make_generator(scene.device, 1000)
    state, frame, pose = first_keyframe(spec, mapper, state, gen, "cuda")
    grads = mapper.gradients(state, frame, pose, gen)
    torch.save([g.float().cpu() for g in grads], save)
    return save


def plain_reference(cfg, spec, schedule, save: str) -> dict:
    """The plain (unsharded) mapper on `schedule` from the agent's seeds:
    the same batches and uniforms the sharded runs draw -> losses and ms
    per iteration per call, kernel-1 launches; the parameters after the
    last call saved to `save`."""
    import torch

    from mneslam_tpu_torch.device import make_generator
    from mneslam_tpu_torch.kernels.scatter_add_rows import scatter_add_rows
    from mneslam_tpu_torch.mapping.mapper import Mapper
    from mneslam_tpu_torch.models.scene_rep import SceneRep

    scene = SceneRep(cfg, "cuda")
    mapper = Mapper(cfg, scene, num_kf=spec["num_kf"],
                    rays_per_kf=spec["rays_per_kf"])
    state = mapper.init_state(make_generator(scene.device, 42))
    gen = make_generator(scene.device, 1000)
    reset_launches()
    losses, ms = [], []
    for fi, n in schedule:
        frame = {key: torch.as_tensor(v, device="cuda")
                 for key, v in spec["frames"][fi].items()}
        pose = torch.as_tensor(spec["poses"][fi], device="cuda")
        frame["frame_id"] = fi
        state = mapper.add_keyframe(state, fi, frame, pose, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = mapper.optimize(state, frame, pose, gen, iters=n)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0) / n)
        losses.append(float(met["loss"]))
    torch.save(params_of(state), save)
    return {"losses": losses, "ms_per_iter": ms, "save": save,
            "launches": scatter_add_rows.launches,
            "iters": sum(n for _, n in schedule)}


def fleet_check(card) -> tuple:
    """14d: `MeshAgentFleet.run_mapping_only` for two agents at room0
    widths on the first FLEET_FRAMES frames of 12c's segments, against
    `MultiAgentRunner.run_mapping_only` on the same agents, which runs
    twice: its distance from itself is the card's run-to-run spread ->
    (the frames, kept for 14e, and the numbers printed)."""
    import copy

    import torch

    from mneslam_tpu_torch.agents.runner import MultiAgentRunner
    from mneslam_tpu_torch.config import make_config
    from mneslam_tpu_torch.configs import ROOM0
    from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
    from mneslam_tpu_torch.parallel.fleet import MeshAgentFleet
    from mneslam_tpu_torch.slam import MNESLAM

    def config(exp):
        cfg = make_config(copy.deepcopy(ROOM0))
        cfg["dataset"] = "synthetic"
        cfg["mode"] = "mapping"
        cfg["data"].update(output=RUN_OUT, exp_name=exp)
        cfg["mapping"].update(first_iters=FLEET_FIRST_ITERS,
                              iters=FLEET_ITERS, loop_iters=FLEET_LOOP_ITERS)
        # the fleet reads a peer's live map where the runner reads its
        # last published one, so a distillation differs by design
        cfg["distillation"]["use_bound_overlap"] = False
        return cfg

    frames = FrameCache(SyntheticBoxDataset(config("x"),
                                            num_frames=MA_FRAMES,
                                            half=BOX_HALF))
    segs = [(lo, lo + FLEET_FRAMES) for lo, _ in MA_SEGMENTS]

    def agents(exp):
        return [MNESLAM(config(exp), Slice(frames, lo, hi), rank=r,
                        world_size=len(segs), device="cuda")
                for r, (lo, hi) in enumerate(segs)]

    t0 = time.perf_counter()
    for lo, hi in segs:
        for i in range(lo, hi):
            frames[i]
    render_s = time.perf_counter() - t0
    seq = agents("fleet_seq")
    t0 = time.perf_counter()
    MultiAgentRunner(seq).run_mapping_only()
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    again = agents("fleet_seq_again")
    MultiAgentRunner(again).run_mapping_only()
    fl_agents = agents("fleet_mesh")
    fleet = MeshAgentFleet(fl_agents)
    reset_launches()
    t0 = time.perf_counter()
    fleet.run_mapping_only()
    torch.cuda.synchronize()
    fleet_s = time.perf_counter() - t0
    launches = read_launches()
    n_map = [len(a.mapped_timestamps) for a in fl_agents]
    iters = sum(FLEET_FIRST_ITERS + (n - 1) * int(a.config["mapping"]
                                                   ["iters"])
                for a, n in zip(fl_agents, n_map))
    def params_vs_runner(agents):
        st = [param_stats(params_of(a.map_state), params_of(b.map_state))
              for a, b in zip(agents, seq)]
        return {"max_param_diff": max(x["max_param_diff"] for x in st),
                "n_beyond": sum(x["n_beyond"] for x in st)}

    db_keys = sorted((int(e["agent_id"]), int(e["kf_id"]))
                     for e in fleet.comms.descriptors())
    want = sorted((a.rank, int(t)) for a in fl_agents
                  for t in a.mapped_timestamps)
    def loss_rel(xs, ys):
        return max(abs(float(mx["loss"]) - float(my["loss"]))
                   / abs(float(my["loss"]))
                   for x, y in zip(xs, ys)
                   for mx, my in zip(x.metrics_log, y.metrics_log))

    return frames, {"mesh": fleet.mesh.shape, "mapped": n_map,
                    "iters": iters,
            "max_rel_loss_diff_vs_runner": loss_rel(fl_agents, seq),
            "runner_vs_itself_rel_loss": loss_rel(again, seq),
            "params_vs_runner": params_vs_runner(fl_agents),
            "runner_vs_itself_params": params_vs_runner(again),
            "descriptor_db": len(db_keys),
            "descriptor_db_complete": db_keys == want,
            "launches": launches["scatter_add_rows"],
            "alignments": [c.alignments for c in fleet.collabs],
            "render_frames_s": render_s, "runner_s": seq_s,
            "fleet_s": fleet_s,
            "fleet_ms_per_iter": 1e3 * fleet_s / iters,
            "mapped_same": [a.mapped_timestamps for a in seq]
            == [a.mapped_timestamps for a in fl_agents]}


# 14c: `cli.main` under torchrun (`python -m torch.distributed.run
# --standalone --nproc_per_node=CLI_RANKS`, each rank `chip_smoke.py
# --cli-rank`, which calls `cli.main` and writes its launch counts): one
# agent over a world of ranks on cuda:0 (gloo: NCCL refuses two ranks on
# one GPU), rank 0 leading, the others following its map calls.
# configs/Replica/room0_v5e8.yaml over the synthetic box room, keyframes
# 0 and 5 of CLI_FRAMES frames, room0's first_iters 500 and iters 50 cut
# to CLI_ITERS ((3, 2) before 14e), terminate's mesh at CLI_MESH_RES m
# (room0's 0.02 cut); the
# sync seam in fp32 (the yaml's gather_every 8 reads stale tables and its
# bf16 sums round per rank: 14a-14b hold those), so the leader's
# per-keyframe losses hold rtol 1e-4 against a one-process `cli.main` of
# the same config, which maps with the plain mapper
CLI_RANKS = 2
CLI_FRAMES = 6
CLI_ITERS = (2, 1)
CLI_MESH_RES = 0.1
# 14d: the fleet's SLAM path on phase 5's tiny config (oracle update)
FLEET_SLAM_FRAMES = 16
FLEET_SLAM_SEGMENTS = ((0, 10), (6, 16))


def cli_rank_main(argv) -> int:
    """A rank of 14c / 14e under torchrun (`chip_smoke.py --cli-rank PREFIX
    ARGS...`): with PREFIX.setup.json (14e) its agent on a segment of one
    box-room trajectory (`install_fleet_setup`); `cli.main(ARGS)`; then
    this rank's kernel launches, the result's keyframe count and its
    agent's record (`agent_record`) to PREFIX.rank<RANK>.json."""
    sys.path.insert(0, ROOT)
    from mneslam_tpu_torch import cli

    prefix, args = argv[0], argv[1:]
    built, timing = [], {"optimize_s": 0.0, "iters": 0}
    if os.path.exists(prefix + ".setup.json"):
        with open(prefix + ".setup.json") as f:
            install_fleet_setup(json.load(f), built, timing)
    result = cli.main(args)
    with open(f"{prefix}.rank{os.environ['RANK']}.json", "w") as f:
        json.dump({"launches": read_launches(),
                   "keyframes": None if result is None
                   else result["keyframes"],
                   "agents": [agent_record(a) for a in built],
                   "optimize_ms_per_iter": 1e3 * timing["optimize_s"]
                   / max(timing["iters"], 1)}, f)
    return 0


def install_fleet_setup(setup: dict, built: list, timing: dict):
    """14e's ranks: `cli.main` builds this rank's agent (rank // ranks a
    slice) on its segment of one box-room trajectory (`setup`: frames,
    half, segments) rendered on demand and kept, as an `OracleMNESLAM`
    on a SLAM leader (`setup["oracle"]`), recorded in `built`; the
    mapper's `optimize` calls are timed into `timing` (a synchronisation
    on each side)."""
    import torch

    from mneslam_tpu_torch import slam as slam_mod
    from mneslam_tpu_torch.data import datasets
    from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
    from mneslam_tpu_torch.mapping.mapper import Mapper
    from mneslam_tpu_torch.tools.validate_dataset import OracleMNESLAM

    segs = setup["segments"]
    per_slice = int(os.environ["WORLD_SIZE"]) // len(segs)
    rank = int(os.environ["RANK"])
    lo, hi = segs[rank // per_slice]

    def get_dataset(cfg):
        return Slice(FrameCache(SyntheticBoxDataset(
            cfg, num_frames=setup["frames"], half=setup["half"])), lo, hi)

    base = (OracleMNESLAM if setup["oracle"] and rank % per_slice == 0
            else slam_mod.MNESLAM)

    class Recorded(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    optimize = Mapper.optimize

    def timed(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = optimize(self, *args, **kwargs)
        torch.cuda.synchronize()
        timing["optimize_s"] += time.perf_counter() - t0
        timing["iters"] += int(kwargs["iters"])
        return out

    datasets.get_dataset = get_dataset
    slam_mod.MNESLAM = Recorded
    Mapper.optimize = timed


def agent_record(a) -> dict:
    """A 14e rank's agent: its role and, on a leader, its keyframes,
    losses, mapping and distillation iterations, lookups, collaboration
    counters, peer maps received and descriptor DB."""
    rec = {"agent": a.rank, "follower": a.follower, "out_dir": a.out_dir}
    if a.follower:
        return rec
    mp, c = a.config["mapping"], a.collab
    n = len(a.mapped_timestamps)
    rec.update(
        mapped=list(a.mapped_timestamps),
        losses=[float(m["loss"]) for m in a.metrics_log],
        map_iters=int(mp["first_iters"]) + (n - 1) * int(mp["iters"])
        if n else 0,
        distill_iters=c.distillations * int(mp["distill_iters"]),
        lookups=lookups(a) if a.tracker is not None else 0,
        alignments=c.alignments, accepted=c.closures_accepted,
        rejected=c.closures_rejected, distillations=c.distillations,
        maps_received=c.comms.maps_received,
        db=sorted([int(e["agent_id"]), int(e["kf_id"])]
                  for e in c.comms.descriptors()))
    return rec


def torchrun_world(tag: str, n_ranks: int, cli_args: list,
                   setup=None) -> dict:
    """`cli.main(cli_args)` on `n_ranks` ranks under `python -m
    torch.distributed.run --standalone` (each `chip_smoke.py --cli-rank`,
    which picks gloo on cuda:0), with 14e's `setup` -> {"code" (0, an exit
    code or "killed after ..."), "seconds", "log", "ranks": each rank's
    record, or None}. The log goes to chiprun_out/chip_smoke/<tag>.log."""
    import signal

    prefix = os.path.join(RUN_OUT, tag, "counts")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    for r in range(n_ranks):
        if os.path.exists(f"{prefix}.rank{r}.json"):
            os.remove(f"{prefix}.rank{r}.json")
    if setup is not None:
        with open(prefix + ".setup.json", "w") as f:
            json.dump(setup, f)
    log_path = os.path.join(OUT, f"{tag}.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as logf:
        p = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc_per_node={n_ranks}",
             os.path.join(ROOT, "chip_smoke.py"), "--cli-rank", prefix]
            + cli_args, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
            stdout=logf, stderr=subprocess.STDOUT, start_new_session=True)
        try:
            code = p.wait(timeout=SHARD_CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
            code = f"killed after {SHARD_CHILD_TIMEOUT_S:.0f} s"
    seconds = time.perf_counter() - t0
    with open(log_path) as f:
        text = f.read()
    ranks = None
    if code == 0:
        ranks = []
        for r in range(n_ranks):
            with open(f"{prefix}.rank{r}.json") as f:
                ranks.append(json.load(f))
    return {"code": code, "seconds": seconds, "log": text, "ranks": ranks}


def metric_losses(agent_dir: str) -> list:
    """The per-keyframe losses of an agent's metrics.jsonl."""
    with open(os.path.join(agent_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [r["loss"] for r in rows
            if r.get("kind") == "metric" and "loss" in r]


def cli_world_check() -> dict:
    """14c: the one-process `cli.main` (no world: the plain mapper), then
    the same config under torchrun on CLI_RANKS ranks -> the numbers
    printed. Raises SystemExit on a failed check."""
    import shutil

    import torch
    import yaml

    from mneslam_tpu_torch import cli

    out_dir = os.path.join(RUN_OUT, "cli_world")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    path = os.path.join(out_dir, "world.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({
            "inherit_from": "configs/Replica/room0_v5e8.yaml",
            "dataset": "synthetic", "mode": "mapping",
            "data": {"num_frames": CLI_FRAMES, "exp_name": "world"},
            "mapping": {"first_iters": CLI_ITERS[0],
                        "iters": CLI_ITERS[1], "shard_gather_every": 1},
            "training": {"render_dtype": "float32"},
            "meshing": {"resolution": CLI_MESH_RES}}, f)
    one, world = os.path.join(out_dir, "one"), os.path.join(out_dir, "world")
    cwd = os.getcwd()
    os.chdir(ROOT)      # the configs' inherit_from paths are relative
    try:
        reset_launches()
        t0 = time.perf_counter()
        ref = cli.main(["--config", path, "--output", one])
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        one_launches = read_launches()["scatter_add_rows"]
    finally:
        os.chdir(cwd)
    w = torchrun_world("cli_world", CLI_RANKS,
                       ["--config", path, "--output", world])
    world_s, text = w["seconds"], w["log"]
    if w["code"] != 0:
        raise SystemExit(f"14c torchrun cli.main: exit {w['code']}\n"
                         f"{text[-3000:]}")
    counts = w["ranks"]
    kf = counts[0]["keyframes"]
    iters = CLI_ITERS[0] + (kf - 1) * CLI_ITERS[1]
    leader = os.path.join(world, "world", "agent_0")
    losses = metric_losses(leader)
    ref_losses = metric_losses(os.path.join(one, "world", "agent_0"))
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    worlds = [f"[rank {r}] world of {CLI_RANKS} ranks: backend gloo, "
              f"transport host, device cuda:0" for r in range(CLI_RANKS)]
    files = {name: os.path.exists(os.path.join(leader, name))
             for name in ("metrics.jsonl", "final_checkpoint.npz",
                          "mesh/final_mesh.ply")}
    res = {"world_s": world_s, "one_process_s": one_s, "keyframes": kf,
           "iters": iters, "losses": losses, "one_process_losses":
           ref_losses, "max_rel_loss_diff": max(rel) if rel else None,
           "launches_by_rank": [c["launches"]["scatter_add_rows"]
                                for c in counts],
           "one_process_launches": one_launches, "files": files,
           "followers_return": [c["keyframes"] for c in counts[1:]]}
    problems = [msg for msg, ok in (
        ("a rank did not start the world init_world prints (gloo, host, "
         "cuda:0)", all(w in text for w in worlds)),
        (f"{kf} keyframes (one process: {ref['keyframes']}), expected 2",
         kf == ref["keyframes"] == 2),
        ("a leader's output is missing", all(files.values())),
        (f"losses {losses} against one process's {ref_losses} (rtol "
         f"{SHARD_LOSS_RTOL})", len(losses) == kf == len(ref_losses)
         and max(rel) <= SHARD_LOSS_RTOL),
        (f"kernel-1 launches by rank {res['launches_by_rank']}, one "
         f"process {one_launches}: expected {SCATTERS_PER_ITER} x {iters}",
         all(n == SCATTERS_PER_ITER * iters
             for n in res["launches_by_rank"] + [one_launches])),
        ("a follower returned a result", all(
            k is None for k in res["followers_return"])))
        if not ok]
    if problems:
        raise SystemExit(f"14c torchrun cli.main: {problems}\n"
                         f"{text[-2000:]}")
    return res


def fleet_slam_check() -> dict:
    """14d: `MeshAgentFleet.run_slam` for two agents on phase 5's tiny
    config with the oracle update -> the numbers printed (with the
    trajectories, "est_poses", for 14e). Raises
    SystemExit unless kernel 2 ran once per lookup, kernel 1 six times
    per mapping iteration, and both agents' outputs are written and
    finite."""
    import copy

    import numpy as np
    import torch

    from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
    from mneslam_tpu_torch.parallel.fleet import MeshAgentFleet
    from mneslam_tpu_torch.tools.validate_dataset import OracleMNESLAM

    cfg = tiny_slam_config(os.path.join(RUN_OUT, "fleet_slam"),
                           exp_name="fleet_slam")
    cfg["distillation"]["use_bound_overlap"] = False
    frames = FrameCache(SyntheticBoxDataset(cfg,
                                            num_frames=FLEET_SLAM_FRAMES))
    agents = [OracleMNESLAM(copy.deepcopy(cfg), Slice(frames, lo, hi),
                            rank=r, world_size=len(FLEET_SLAM_SEGMENTS),
                            device="cuda")
              for r, (lo, hi) in enumerate(FLEET_SLAM_SEGMENTS)]
    fleet = MeshAgentFleet(agents)
    reset_launches()
    t0 = time.perf_counter()
    res = fleet.run_slam()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = read_launches()
    mp = cfg["mapping"]
    iters = sum(int(mp["first_iters"]) + (a.map_counter - 1)
                * int(mp["iters"]) for a in agents)
    n_look = sum(lookups(a) for a in agents)
    est = [np.load(os.path.join(a.out_dir, "est_poses.npy")) for a in agents]
    out = {"seconds": sec, "keyframes": [a.tracker.counter for a in agents],
           "mapped": [a.map_counter for a in agents], "iters": iters,
           "lookups": n_look, "launches": launches,
           "ate_rmse": [r["ate"]["rmse"] for r in res], "est_poses": est}
    problems = [msg for msg, ok in (
        (f"kernel 2 launches {launches['corr_window']} != {n_look} lookups",
         launches["corr_window"] == n_look >= 1),
        ("kernel 2b or 3 launched", not (launches["corr_window_mma"]
                                         or launches[
                                             "corr_window_per_level"])),
        (f"kernel-1 launches {launches['scatter_add_rows']} != "
         f"{SCATTERS_PER_ITER} x {iters}",
         launches["scatter_add_rows"] == SCATTERS_PER_ITER * iters),
        ("an agent mapped fewer than two keyframes",
         all(a.map_counter >= 2 for a in agents)),
        ("non-finite trajectory", all(np.isfinite(e).all() for e in est)
         and all(math.isfinite(r["ate"]["rmse"]) for r in res)))
        if not ok]
    if problems:
        raise SystemExit(f"14d fleet SLAM: {problems}: {out}")
    return out


# 14e: the composed fleet, `cli.main --num_agents 2 --device_mesh` under
# torchrun on FLEET_RANKS ranks (2 agents x 2 row ranks, gloo on cuda:0):
# configs/Replica/room0_v5e8_fleet.yaml's keys on 14d's box-room segments
# (keyframe_every 5: 3 keyframes an agent), room0's first_iters 500 and
# iters 50 cut to FLEET_E_ITERS, terminate's mesh at CLI_MESH_RES, the
# render in fp32 as in 14c (over several ranks the bf16 partials round
# per rank: 14a-14b hold the bf16 sums); phase 5's tiny config in SLAM
# mode with the oracle update on 14d's SLAM segments, row-sharded; and
# test_torch_fleet.py:94's tiny two-agent setup with loop detection on,
# row-sharded. Each against the one-slice fleet in this process; maps
# with 14b's bound (SHARD_PARAM_TOL on all but SHARD_PARAM_SHARE of the
# elements) beside the one-slice fleet's spread against itself.
FLEET_RANKS = 4
FLEET_E_ITERS = (2, 1)
# 14e's SLAM run maps with phase 5's first_iters 60 and iters 10 cut to
# these (its check is the oracle trajectory and the launches)
FLEET_E_SLAM_ITERS = (4, 1)
FLEET_LOOP_FRAMES = 10
FLEET_LOOP_SEGMENTS = ((0, 6), (4, 10))


def load_yaml_config(path: str, out: str) -> dict:
    """`cli.main`'s config of a yaml (inherit_from read from the
    repository's root), its outputs under `out`."""
    from mneslam_tpu_torch.config import (default_config, deep_update,
                                          load_config)

    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        cfg = deep_update(default_config(), load_config(path))
    finally:
        os.chdir(cwd)
    cfg["data"]["output"] = out
    return cfg


def loop_config(out_dir):
    """tests/test_torch_fleet.py:94's setup (its fleet_overrides with loop
    detection on, meshing at 0.3 m), row-sharded."""
    from mneslam_tpu_torch.config import make_config

    return make_config({
        "mode": "mapping", "dataset": "synthetic",
        "data": {"output": out_dir, "exp_name": "loop"},
        "mapping": {
            "bound": [[-2.2, 2.2]] * 3,
            "marching_cubes_bound": [[-2.1, 2.1]] * 3,
            "sample": 256, "min_pixels_cur": 48, "first_iters": 20,
            "iters": 4, "keyframe_every": 2, "loop_iters": 6,
            "distill_iters": 4, "lr_rot": 0.01, "lr_trans": 0.01,
            "shard_plane_rows": True},
        "planes_res": {"coarse": 0.44, "fine": 0.22,
                       "bound_dividable": 0.22},
        "cam": {"H": 40, "W": 56, "fx": 35.0, "fy": 35.0, "cx": 27.5,
                "cy": 19.5, "near": 0.0, "far": 8.0},
        "training": {"n_range_d": 9, "n_samples_d": 8, "range_d": 0.25,
                     "trunc": 0.15},
        "model": {"c_dim": 16, "input_ch": 32, "input_ch_pos": 48,
                  "truncation": 0.15},
        "loop_detection": {"enabled": True, "sim_threshold": 0.9,
                           "min_time_diff": 50, "loop_launch_th": 2,
                           "min_matches_for_fusion": 1},
        "loop_bound": {"bound_0": [[-2.2, 2.2]] * 3,
                       "bound_1": [[-2.2, 2.2]] * 3},
        "meshing": {"resolution": 0.3}})


def one_slice_fleet(cfg, frames, segments) -> dict:
    """`MeshAgentFleet.run_mapping_only` in this process on the card ->
    per agent its mapped keyframes, losses, collaboration counters and
    parameters (on the host, with their checkpoint keys)."""
    import copy

    from mneslam_tpu_torch.models.scene_rep import checkpoint_key, param_items
    from mneslam_tpu_torch.parallel.fleet import MeshAgentFleet
    from mneslam_tpu_torch.slam import MNESLAM

    agents = [MNESLAM(copy.deepcopy(cfg), Slice(frames, lo, hi), rank=r,
                      world_size=len(segments), device="cuda")
              for r, (lo, hi) in enumerate(segments)]
    fleet = MeshAgentFleet(agents)
    fleet.run_mapping_only()
    return [{"mapped": list(a.mapped_timestamps),
             "losses": [float(m["loss"]) for m in a.metrics_log],
             "alignments": c.alignments, "accepted": c.closures_accepted,
             "rejected": c.closures_rejected,
             "distillations": c.distillations,
             "params": params_of(a.map_state),
             "keys": [checkpoint_key(path)
                      for path, _ in param_items(a.map_state.params)]}
            for a, c in zip(agents, fleet.collabs)]


def composed_fleet_refs(frames) -> dict:
    """14e's references in this process, before the ranks start: the
    one-slice fleet twice on the room0_v5e8_fleet run and twice on the
    loop run (its distance from itself is the card's run-to-run spread);
    the worlds' yamls and setups."""
    import yaml

    from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset

    out_dir = os.path.join(RUN_OUT, "fleet14e")
    os.makedirs(out_dir, exist_ok=True)
    segs = [(lo, lo + FLEET_FRAMES) for lo, _ in MA_SEGMENTS]
    path = os.path.join(out_dir, "fleet.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({
            "inherit_from": "configs/Replica/room0_v5e8_fleet.yaml",
            "dataset": "synthetic", "mode": "mapping",
            "data": {"exp_name": "fleet"},
            "mapping": {"first_iters": FLEET_E_ITERS[0],
                        "iters": FLEET_E_ITERS[1]},
            "training": {"render_dtype": "float32"},
            "meshing": {"resolution": CLI_MESH_RES}}, f)
    cfg = load_yaml_config(path, os.path.join(out_dir, "ref"))
    refs = {"map": {"yaml": path, "cfg_keys": {
        k: cfg["mapping"][k] for k in ("shard_plane_rows",
                                       "shard_gather_every",
                                       "keyframe_every")},
        "setup": {"frames": MA_FRAMES, "half": BOX_HALF, "segments": segs,
                  "oracle": False},
        "ref": one_slice_fleet(cfg, frames, segs),
        "again": one_slice_fleet(cfg, frames, segs)}}
    lcfg = loop_config(os.path.join(out_dir, "loop_ref"))
    lframes = FrameCache(SyntheticBoxDataset(lcfg,
                                             num_frames=FLEET_LOOP_FRAMES))
    lpath = os.path.join(out_dir, "loop.yaml")
    with open(lpath, "w") as f:
        yaml.safe_dump(loop_config(out_dir), f)
    refs["loop"] = {"yaml": lpath, "setup": {
        "frames": FLEET_LOOP_FRAMES, "half": 2.0,
        "segments": FLEET_LOOP_SEGMENTS, "oracle": False},
        "ref": one_slice_fleet(lcfg, lframes, FLEET_LOOP_SEGMENTS),
        "again": one_slice_fleet(lcfg, lframes, FLEET_LOOP_SEGMENTS)}
    scfg = tiny_slam_config(out_dir, exp_name="fleet_slam")
    scfg["distillation"]["use_bound_overlap"] = False
    scfg["mapping"].update(shard_plane_rows=True,
                           first_iters=FLEET_E_SLAM_ITERS[0],
                           iters=FLEET_E_SLAM_ITERS[1])
    scfg["dataset"] = "synthetic"
    spath = os.path.join(out_dir, "slam.yaml")
    with open(spath, "w") as f:
        yaml.safe_dump(scfg, f)
    refs["slam"] = {"yaml": spath, "setup": {
        "frames": FLEET_SLAM_FRAMES, "half": 2.0,
        "segments": FLEET_SLAM_SEGMENTS, "oracle": True}}
    return refs


def composed_world(tag: str, spec: dict, extra=()) -> dict:
    """One of 14e's worlds -> its ranks' records with the leaders' files.
    Raises SystemExit unless every rank exits 0, each leader returns its
    result and each follower None, and every rank's kernel-1 launches
    are six per iteration of its slice's map calls (and of its own
    distillations on a leader), kernel 2's its leader's lookups on a
    leader and none on a follower."""
    out = os.path.join(RUN_OUT, "fleet14e", tag)
    w = torchrun_world(f"fleet14e_{tag}", FLEET_RANKS,
                       ["--config", spec["yaml"], "--num_agents", "2",
                        "--device_mesh", "--output", out] + list(extra),
                       spec["setup"])
    if w["code"] != 0:
        raise SystemExit(f"14e {tag}: torchrun exit {w['code']}\n"
                         f"{w['log'][-4000:]}")
    ranks = w["ranks"]
    per = FLEET_RANKS // 2
    problems = []
    for r, rec in enumerate(ranks):
        a, = rec["agents"]
        lead = ranks[r - r % per]["agents"][0]
        if a["agent"] != r // per or a["follower"] != bool(r % per) \
                or (rec["keyframes"] is None) != a["follower"]:
            problems.append(f"rank {r}: agent {a['agent']}, follower "
                            f"{a['follower']}, result {rec['keyframes']}")
        want1 = SCATTERS_PER_ITER * (lead["map_iters"] + (
            0 if a["follower"] else lead["distill_iters"]))
        want2 = 0 if a["follower"] else lead["lookups"]
        got = rec["launches"]
        if got["scatter_add_rows"] != want1 or got["corr_window"] != want2:
            problems.append(f"rank {r}: kernel-1 launches "
                            f"{got['scatter_add_rows']} (expected {want1}),"
                            f" kernel-2 {got['corr_window']} (expected "
                            f"{want2})")
    files = sorted(os.path.relpath(os.path.join(d, f), out)
                   for d, _, fs in os.walk(out) for f in fs)
    if problems:
        raise SystemExit(f"14e {tag}: {problems}\n{w['log'][-3000:]}")
    return {"seconds": w["seconds"], "ranks": ranks, "out": out,
            "files": files, "leaders": [ranks[0]["agents"][0],
                                        ranks[per]["agents"][0]],
            "ms_per_iter_by_rank": [round(rec["optimize_ms_per_iter"], 1)
                                    for rec in ranks]}


def checkpoint_params(path: str, keys: list) -> list:
    """A final_checkpoint.npz's parameters under `keys`, in that order."""
    import numpy as np
    import torch

    with np.load(path) as data:
        return [torch.as_tensor(data[k]).float() for k in keys]


def composed_fleet_check(refs: dict, fs_est: list) -> dict:
    """14e: the three worlds, at the same time, against their one-slice
    references (`refs`, and the trajectories `fs_est` of 14d's SLAM run)
    -> the numbers printed. Raises SystemExit on a failed check (once
    every world has ended)."""
    import numpy as np

    t0 = time.perf_counter()
    res = {}
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(composed_world, "map", refs["map"]),
                pool.submit(composed_world, "slam", refs["slam"],
                            ["--mode", "slam"]),
                pool.submit(composed_world, "loop", refs["loop"])]
        m, sl, lp = [j.result() for j in jobs]
    # mapping-only, room0_v5e8_fleet.yaml's keys
    ref, again = refs["map"]["ref"], refs["map"]["again"]
    problems, stats, self_stats, rels = [], [], [], []
    for i, lead in enumerate(m["leaders"]):
        params = checkpoint_params(
            os.path.join(lead["out_dir"], "final_checkpoint.npz"),
            ref[i]["keys"])
        stats.append(param_stats(params, ref[i]["params"]))
        self_stats.append(param_stats(again[i]["params"], ref[i]["params"]))
        rels += [abs(a - b) / abs(b) for a, b in zip(lead["losses"],
                                                    ref[i]["losses"])]
        if lead["mapped"] != ref[i]["mapped"] or len(lead["mapped"]) != 3:
            problems.append(f"agent {i} mapped {lead['mapped']}, the "
                            f"one-slice fleet {ref[i]['mapped']}")
        want_db = sorted([j, int(t)] for j, r in enumerate(ref)
                         for t in r["mapped"])
        if lead["db"] != want_db:
            problems.append(f"agent {i}'s descriptor DB {lead['db']}")
    n_el = sum(int(t.numel()) for t in ref[0]["params"])
    share = sum(st["n_beyond"] for st in stats) / (2 * n_el)
    exp = os.path.relpath(os.path.dirname(m["leaders"][0]["out_dir"]),
                          m["out"])
    leaders = tuple(os.path.join(exp, f"agent_{i}", "") for i in (0, 1))
    expect = {f"{d}{name}" for d in leaders
              for name in ("metrics.jsonl", "final_checkpoint.npz",
                           "mesh/final_mesh.ply")}
    if not expect <= set(m["files"]) or any(
            not f.startswith(leaders) for f in m["files"]):
        problems.append(f"files {m['files']}")
    if not rels or max(rels) > SHARD_LOSS_RTOL:
        problems.append(f"losses beyond rtol {SHARD_LOSS_RTOL}: {rels}")
    if share > SHARD_PARAM_SHARE:
        problems.append(f"parameters beyond {SHARD_PARAM_TOL}: {stats}")
    res["map"] = {"seconds": m["seconds"], "keys": refs["map"]["cfg_keys"],
                  "mapped": [ld["mapped"] for ld in m["leaders"]],
                  "max_rel_loss_diff": max(rels) if rels else None,
                  "params": [{k: st[k] for k in ("max_param_diff",
                                                 "n_beyond")}
                             for st in stats],
                  "one_slice_vs_itself": [{k: st[k] for k in (
                      "max_param_diff", "n_beyond")} for st in self_stats],
                  "share_beyond": share, "files": m["files"],
                  "launches_by_rank": [r["launches"]["scatter_add_rows"]
                                       for r in m["ranks"]],
                  "ms_per_iter_by_rank": m["ms_per_iter_by_rank"]}
    if problems:
        raise SystemExit(f"14e mapping-only: {problems}: {res['map']}")

    # SLAM with the oracle update, against 14d's one-slice fleet
    moved = []
    for i, lead in enumerate(sl["leaders"]):
        est = np.load(os.path.join(lead["out_dir"], "est_poses.npy"))
        ref_est = fs_est[i]
        if not np.isfinite(est).all() or est.shape != ref_est.shape:
            raise SystemExit(f"14e SLAM: agent {i}'s trajectory {est.shape}"
                             f" against {ref_est.shape}")
        moved.append(float(np.abs(est[:, :3, 3] - ref_est[:, :3, 3]).max()))
    res["slam"] = {"seconds": sl["seconds"],
                   "keyframes": [ld["mapped"] for ld in sl["leaders"]],
                   "lookups": [ld["lookups"] for ld in sl["leaders"]],
                   "launches_by_rank": [
                       {k: r["launches"][k] for k in ("scatter_add_rows",
                                                      "corr_window")}
                       for r in sl["ranks"]],
                   "max_trans_diff_vs_one_slice_m": moved,
                   "mapping_iters_cut_to": list(FLEET_E_SLAM_ITERS),
                   "ms_per_iter_by_rank": sl["ms_per_iter_by_rank"]}
    if max(moved) > ORACLE_TOL_M:
        raise SystemExit(f"14e SLAM: trajectories {moved} m from the "
                         f"one-slice fleet's (limit {ORACLE_TOL_M})")

    # loop detection on: peer maps fetched across slices, distillations
    lref, lagain = refs["loop"]["ref"], refs["loop"]["again"]
    problems, lstats, lself = [], [], []
    for i, lead in enumerate(lp["leaders"]):
        for k in ("mapped", "alignments", "accepted", "rejected",
                  "distillations"):
            if lead[k] != lref[i][k]:
                problems.append(f"agent {i} {k} {lead[k]}, the one-slice "
                                f"fleet {lref[i][k]}")
        params = checkpoint_params(
            os.path.join(lead["out_dir"], "final_checkpoint.npz"),
            lref[i]["keys"])
        lstats.append(param_stats(params, lref[i]["params"]))
        lself.append(param_stats(lagain[i]["params"], lref[i]["params"]))
    received = [ld["maps_received"] for ld in lp["leaders"]]
    if sum(received) < 1 or min(ld["distillations"]
                                for ld in lp["leaders"]) < 1:
        problems.append(f"peer maps received {received}, distillations "
                        f"{[ld['distillations'] for ld in lp['leaders']]}")
    if any(st["share_beyond"] > SHARD_PARAM_SHARE for st in lstats):
        problems.append(f"maps after the fusion beyond {SHARD_PARAM_TOL} "
                        f"of the one-slice fleet's: {lstats}")
    res["loop"] = {"seconds": lp["seconds"], "maps_received": received,
                   **{k: [ld[k] for ld in lp["leaders"]] for k in (
                       "alignments", "accepted", "rejected",
                       "distillations")},
                   "params_after_fusion": [
                       {k: st[k] for k in ("max_param_diff", "n_beyond")}
                       for st in lstats],
                   "one_slice_vs_itself": [
                       {k: st[k] for k in ("max_param_diff", "n_beyond")}
                       for st in lself],
                   "launches_by_rank": [r["launches"]["scatter_add_rows"]
                                        for r in lp["ranks"]]}
    if problems:
        raise SystemExit(f"14e loop run: {problems}: {res['loop']}")
    res["seconds"] = time.perf_counter() - t0
    return res


def device_mesh_cli() -> tuple:
    """14d: `python -m mneslam_tpu_torch.cli --device_mesh --num_agents 2`
    on phase 3's tiny config, on the card -> (exit code, seconds, missing
    outputs, the log's tail)."""
    import yaml

    out_dir = os.path.join(RUN_OUT, "device_mesh")
    cfg = tiny_config(out_dir)
    cfg["dataset"] = "synthetic"
    cfg["data"].update(exp_name="fleet", num_frames=6)
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
                        "--config", path, "--num_agents", "2",
                        "--device_mesh"], capture_output=True, text=True,
                       cwd=ROOT, env=env, timeout=300)
    sec = time.perf_counter() - t0
    missing = [f"agent_{rank}/{name}" for rank in (0, 1)
               for name in ("metrics.jsonl", "final_checkpoint.npz")
               if not os.path.exists(os.path.join(out_dir, "fleet",
                                                  f"agent_{rank}", name))]
    return r.returncode, sec, missing, (r.stdout[-1500:], r.stderr[-1500:])


def shard_phase(card) -> dict:
    """Phase 14 -> kernel-1 launches by path and the numbers printed.
    Raises SystemExit on a failed check."""
    import numpy as np
    import torch

    from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset

    t14 = time.perf_counter()
    os.makedirs(RUN_OUT, exist_ok=True)
    cfg = shard_config()
    keys = {k: cfg["mapping"][k] for k in ("shard_plane_rows",
                                           "shard_gather_every")}
    log(f"phase 14 (row-sharded mapper and mesh fleet): "
        f"configs/Replica/room0_v5e8.yaml's keys {json.dumps(keys)}, "
        f"render_dtype {cfg['training']['render_dtype']}, c_dim "
        f"{cfg['model']['c_dim']}, {cfg['mapping']['sample']} + "
        f"{cfg['mapping']['min_pixels_cur']} rays x "
        f"{cfg['training']['n_range_d'] + cfg['training']['n_samples_d']} "
        f"samples; map calls (frame, iterations) {list(SHARD_SCHEDULE)}: "
        f"room0's first_iters {cfg['mapping']['first_iters']} and iters "
        f"{cfg['mapping']['iters']} cut to 20 and 10")
    # the frames rendered once, here, and handed to the ranks in a file
    t0 = time.perf_counter()
    ds = SyntheticBoxDataset(cfg, num_frames=11, half=BOX_HALF)
    fids = sorted({fi for fi, _ in SHARD_SCHEDULE})
    items = {fi: ds[fi] for fi in fids}
    spec = {"num_kf": len(SHARD_SCHEDULE) + 1,
            "rays_per_kf": ds.num_rays_to_save,
            "frames": {fi: {k: np.asarray(items[fi][k], np.float32)
                            for k in ("direction", "rgb", "depth")}
                       for fi in fids},
            "poses": {fi: np.asarray(items[fi]["c2w"], np.float32)
                      for fi in fids}}
    render_s = time.perf_counter() - t0

    cfg32 = {**cfg, "training": {**cfg["training"],
                                 "render_dtype": "float32"}}
    ref = os.path.join(RUN_OUT, "shard_{}.pt").format
    plain = plain_reference(cfg, spec, SHARD_SCHEDULE, ref("plain_bf16"))
    plain32 = plain_reference(cfg32, spec, SHARD_B_SCHEDULE,
                              ref("plain_fp32_b"))
    # controls: the plain mapper against itself (the card's run-to-run
    # spread), in fp32 on 14b's schedule and for one bf16 gradient
    again32 = plain_reference(cfg32, spec, SHARD_B_SCHEDULE,
                              ref("plain_fp32_b_again"))
    plain_self = param_stats(torch.load(again32["save"]),
                             torch.load(plain32["save"]))
    plain_self["max_rel_loss_diff"] = max(
        abs(a - b) / abs(b) for a, b in zip(again32["losses"],
                                            plain32["losses"]))
    g32 = plain_gradients(cfg32, spec, ref("grads_fp32"))
    # 14b's colour-plane batch: grid.oneGrid false (replica.yaml's
    # c_planes_res 0.08 / 0.02) through the seam, fp32
    cfg32c = {**cfg32, "grid": {"oneGrid": False}}
    g32c = plain_gradients(cfg32c, spec, ref("grads_fp32_colour"))
    g16 = plain_gradients(cfg, spec, ref("grads_bf16"))
    g16_self = grad_rel_err(
        torch.load(plain_gradients(cfg, spec, ref("grads_bf16_again"))),
        torch.load(g16))
    log(f"14 plain mapper (reference, bf16): losses {plain['losses']}, ms "
        f"per iteration by call "
        f"{[round(v, 3) for v in plain['ms_per_iter']]}, kernel-1 launches "
        f"{plain['launches']} for {plain['iters']} iterations; frames "
        f"rendered in {render_s:.2f} s; 14b's reference on "
        f"{list(SHARD_B_SCHEDULE)} (14b's cut), fp32: losses "
        f"{plain32['losses']}; controls, the plain mapper against itself: "
        f"fp32 on 14b's schedule {json.dumps(plain_self)}, one bf16 "
        f"gradient {g16_self:.3e} of the largest element per leaf")

    def run(c, schedule, ge, fold="after", save=None, ref=None):
        c = {**c, "mapping": {**c["mapping"], "shard_gather_every": ge,
                              "shard_fold": fold}}
        return {"config": c, "schedule": schedule, "save": save, "ref": ref}

    steps = {"references": time.perf_counter() - t14}
    ge8_path = ref("1rank_ge8_fp32")
    # 14a: one rank over NCCL: the sync seam in bf16 on the whole
    # schedule; on 14b's schedule in fp32 the sync seam (a control) and
    # gather_every 8 (14b's reference); one bf16 gradient (a control)
    a_spec = dict(spec, runs=[
        dict(run(cfg, SHARD_SCHEDULE, 1, ref=plain["save"]),
             profile=os.path.join(OUT, "shard14a_profile.txt")),
        run(cfg32, SHARD_B_SCHEDULE, 8, save=ge8_path),
        run(cfg32, SHARD_B_SCHEDULE, 1, ref=plain32["save"]),
        dict(run(cfg, (), 1), grads=g16)])
    (a_sync, a_ge8, a_sync32, a_g16), = spawn_ranks("shard14a", a_spec, 1,
                                                     "nccl")
    steps["14a"] = time.perf_counter() - t14 - sum(steps.values())
    a_rel = check_shard("14a (1 rank, NCCL)", a_sync, plain["losses"], 1,
                        param_share=0.0)
    if a_sync["transport"] != "device":
        raise SystemExit(f"14a: transport {a_sync['transport']}")
    check_shard("14a gather_every 8 (fp32)", a_ge8, a_ge8["losses"], 1)
    check_shard("14a sync seam (fp32, 14b's schedule)", a_sync32,
                plain32["losses"], 1, param_share=0.0)
    check_shard("14a gradient (bf16)", a_g16, [], 1,
                grad_tol=SHARD_GRAD_TOL_BF16)
    log(f"14a one rank over NCCL (transport {a_sync['transport']}), bf16: "
        f"losses {a_sync['losses']}, max rel loss diff vs plain "
        f"{a_rel:.3e} (rtol {SHARD_LOSS_RTOL}), parameters "
        f"{a_sync['max_param_diff']:.3e} from the plain mapper's, "
        f"{a_sync['n_beyond']} elements beyond {SHARD_PARAM_TOL}; "
        f"kernel-1 launches "
        f"{a_sync['launches']} = {SCATTERS_PER_ITER} x {a_sync['iters']}; "
        f"ms per iteration by call "
        f"{[round(v, 3) for v in a_sync['ms_per_iter']]} (plain "
        f"{[round(v, 3) for v in plain['ms_per_iter']]}) on {card}; "
        f"gather_every 8 on one rank (fp32, 14b's reference): losses "
        f"{a_ge8['losses']}; controls on one rank: the sync seam in fp32 "
        f"on 14b's schedule against the plain mapper: losses "
        f"{a_sync32['losses']}, parameters {a_sync32['max_param_diff']:.3e}"
        f", {a_sync32['n_beyond']} elements beyond; one bf16 gradient "
        f"{a_g16['grad_rel_err']:.3e} of the largest element per leaf "
        f"(limit {SHARD_GRAD_TOL_BF16}); profile of 3 more iterations: "
        f"{json.dumps(a_sync['profile'])} (table in "
        f"{os.path.join(OUT, 'shard14a_profile.txt')})")

    # 14b's runs, SHARD_RANKS ranks on cuda:0 over gloo, in turn: one
    # batch's gradient (fp32 both fold orders, bf16), then the optimize
    # (fp32: the sync seam, gather_every 8, fold before)
    G = SHARD_GRAD_TOL
    P = SCATTERS_PER_ITER
    # (name, run, reference losses, gradient bound, kernel-1 launches per
    # iteration)
    b_runs = (("gradient, fold after (fp32)",
               dict(run(cfg32, (), 1), grads=g32), [], G, P),
              ("gradient, fold before (fp32)",
               dict(run(cfg32, (), 1, fold="before"), grads=g32), [], G, P),
              ("gradient, fold after (bf16)",
               dict(run(cfg, (), 1), grads=g16), [], SHARD_GRAD_TOL_BF16, P),
              ("gradient, colour planes (fp32)",
               dict(run(cfg32c, (), 1), grads=g32c), [], G, 2 * P),
              ("optimize, gather_every 1, fold after (fp32)",
               dict(run(cfg32, SHARD_B_SCHEDULE, 1, ref=plain32["save"]),
                    g1=g32), plain32["losses"], None, P),
              ("optimize, gather_every 8 (fp32)",
               dict(run(cfg32, SHARD_B_SCHEDULE, 8, ref=ge8_path), g1=g32),
               a_ge8["losses"], None, P),
              ("optimize, fold before (fp32)",
               dict(run(cfg32, SHARD_B_SCHEDULE, 1, fold="before",
                        ref=plain32["save"]), g1=g32),
               plain32["losses"], None, P))
    # 14d's runs in this process first, on a quiet card (they are
    # timed): the fleet, mapping-only against the runner, and SLAM
    log(f"14d mesh fleet: two agents at room0 widths on frames "
        f"{MA_SEGMENTS[0][0]}-{MA_SEGMENTS[0][0] + FLEET_FRAMES - 1} and "
        f"{MA_SEGMENTS[1][0]}-{MA_SEGMENTS[1][0] + FLEET_FRAMES - 1} of "
        f"12c's trajectory, first_iters cut to {FLEET_FIRST_ITERS}, iters "
        f"to {FLEET_ITERS}, "
        f"loop_iters to {FLEET_LOOP_ITERS}, fusion off")
    frames, fl = fleet_check(card)
    log(f"14d fleet vs runner: {json.dumps(fl)} on {card}")
    problems = [msg for msg, ok in (
        (f"losses beyond rtol {SHARD_LOSS_RTOL} of the runner's",
         fl["max_rel_loss_diff_vs_runner"] <= SHARD_LOSS_RTOL),
        ("the fleet and the runner mapped different keyframes",
         fl["mapped_same"]),
        ("the descriptor DB misses keyframes", fl["descriptor_db_complete"]),
        (f"kernel-1 launches {fl['launches']} != {SCATTERS_PER_ITER} x "
         f"{fl['iters']}", fl["launches"] == SCATTERS_PER_ITER * fl["iters"]))
        if not ok]
    if problems:
        raise SystemExit(f"14d fleet: {problems}")
    fs = fleet_slam_check()
    fs_est = fs.pop("est_poses")
    log(f"14d fleet SLAM (phase 5's tiny config, oracle update, two agents "
        f"on frames {FLEET_SLAM_SEGMENTS} of {FLEET_SLAM_FRAMES}): "
        f"{json.dumps(fs)}")
    steps["14d in process"] = time.perf_counter() - t14 - sum(
        steps.values())
    # 14e's one-slice references, on the quiet card too
    refs = composed_fleet_refs(frames)
    del frames
    steps["14e references"] = time.perf_counter() - t14 - sum(
        steps.values())

    # then the child processes of 14b, 14c, 14d's CLI and 14e, all at
    # once (their times are no speeds: gloo through host memory, process
    # starts); a failed job raises here once every job has ended
    torch.cuda.empty_cache()
    b_spec = dict(spec, runs=[r for _, r, _, _, _ in b_runs])
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        jobs = [pool.submit(spawn_ranks, "shard14b", b_spec, SHARD_RANKS,
                            "gloo"),
                pool.submit(cli_world_check), pool.submit(device_mesh_cli),
                pool.submit(composed_fleet_check, refs, fs_est)]
        b, cw, (code, cli_s, missing, tail), ce = [j.result()
                                                   for j in jobs]
    steps["14b, 14c, 14d cli, 14e"] = time.perf_counter() - t14 - sum(
        steps.values())
    b_out = {}
    for j, (name, _, ref_losses, gtol, per_iter) in enumerate(b_runs):
        rels = [check_shard(f"14b {name} rank {k}", ranks[j], ref_losses,
                            SHARD_RANKS, param_share=SHARD_PARAM_SHARE,
                            grad_tol=gtol, per_iter=per_iter)
                for k, ranks in enumerate(b)]
        r0 = b[0][j]
        if r0["transport"] != "host":
            raise SystemExit(f"14b: transport {r0['transport']}")
        out = {"launches_by_rank": [ranks[j]["launches"] for ranks in b],
               "iters": r0["iters"]}
        if "grad_rel_err" in r0:
            out.update(grad_rel_err=r0["grad_rel_err"], grad_tol=gtol)
            what = (f"gradient error {r0['grad_rel_err']:.3e} of the "
                    f"largest element per leaf (limit {gtol})")
        else:
            out.update(
                losses=r0["losses"], reference_losses=ref_losses,
                max_rel_loss_diff=max(rels),
                **{k: r0[k] for k in (
                    "max_param_diff", "n_beyond", "share_beyond",
                    "beyond_untouched_by_first_batch",
                    "beyond_at_block_edge")},
                ms_per_iter_by_rank=[[round(v, 1) for v in
                                      ranks[j]["ms_per_iter"]]
                                     for ranks in b])
            what = (f"losses {r0['losses']} (reference {ref_losses}), max "
                    f"rel loss diff {max(rels):.3e} (rtol "
                    f"{SHARD_LOSS_RTOL}); parameters "
                    f"{r0['max_param_diff']:.3e} from the reference's, "
                    f"{r0['n_beyond']} elements ({r0['share_beyond']:.3e}) "
                    f"beyond {SHARD_PARAM_TOL} (limit {SHARD_PARAM_SHARE:g}"
                    f", see SHARD_LOSS_RTOL), of them untouched by the "
                    f"first batch {r0['beyond_untouched_by_first_batch']}, "
                    f"on a block's first or last y-row "
                    f"{r0['beyond_at_block_edge']}; ms per iteration by "
                    f"rank and call "
                    f"{out['ms_per_iter_by_rank']} (gloo through host "
                    f"memory on one card: not a collective's speed)")
        b_out[name] = out
        log(f"14b {SHARD_RANKS} ranks on cuda:0 over gloo, {name}: {what}; "
            f"kernel-1 launches by rank {out['launches_by_rank']} = "
            f"{per_iter} x {r0['iters']} each")

    # 14c: cli.main under torchrun, a world of CLI_RANKS ranks
    log(f"14c torchrun --nproc_per_node={CLI_RANKS} -m mneslam_tpu_torch."
        f"cli (cli.main on each rank, beside 14b and 14d's CLI): "
        f"{json.dumps(cw)} on {card}")
    log(f"14d cli --device_mesh --num_agents 2 (tiny config, on the card): "
        f"exit {code} in {cli_s:.1f} s (beside 14b and 14c); missing "
        f"outputs {missing}")
    if code != 0 or missing:
        raise SystemExit(f"14d cli --device_mesh failed: exit {code}, "
                         f"missing {missing}\n{tail[0]}\n{tail[1]}")
    log(f"14e torchrun --nproc_per_node={FLEET_RANKS} -m mneslam_tpu_torch."
        f"cli --num_agents 2 --device_mesh (2 agents x 2 row ranks on "
        f"cuda:0 over gloo, beside 14b, 14c and 14d's CLI; ms per iteration "
        f"by rank: gloo through host memory, not a collective's speed): "
        f"configs/Replica/room0_v5e8_fleet.yaml's keys on 14d's segments, "
        f"first_iters and iters cut to {list(FLEET_E_ITERS)}, fp32 render: "
        f"{json.dumps(ce['map'])}; SLAM on phase 5's tiny config (oracle "
        f"update) against 14d's one-slice fleet: {json.dumps(ce['slam'])}; "
        f"loop detection on (test_torch_fleet.py:94's setup): "
        f"{json.dumps(ce['loop'])}; 14e {ce['seconds']:.1f} s on {card}")
    t14 = time.perf_counter() - t14
    log(f"phase 14 {t14:.1f} s of its budget of {SHARD_BUDGET_S:.0f} s"
        + (": OVER BUDGET, cut its iterations or frames"
           if t14 > SHARD_BUDGET_S else "")
        + f"; s by step "
        f"{json.dumps({k: round(v, 1) for k, v in steps.items()})}")
    return {"seconds": t14, "steps": steps, "plain": plain,
            "plain32": plain32,
            "plain_self": plain_self, "a": a_sync, "a_ge8": a_ge8,
            "a_sync32": a_sync32, "b": b_out, "cli_world": cw, "fleet": fl,
            "fleet_slam": fs, "cli_s": cli_s, "composed": ce,
            "launches": {"row_sharded_1rank_nccl": a_sync["launches"]
                         + a_ge8["launches"] + a_sync32["launches"]
                         + a_g16["launches"],
                         "row_sharded_4ranks_gloo_by_rank": [
                             sum(r["launches"] for r in ranks)
                             for ranks in b],
                         "row_sharded_cli_world_by_rank":
                             cw["launches_by_rank"],
                         "cli_one_process": cw["one_process_launches"],
                         "mesh_fleet": fl["launches"],
                         "mesh_fleet_slam": fs["launches"][
                             "scatter_add_rows"],
                         "composed_fleet_by_rank": [
                             a + b + c for a, b, c in zip(
                                 ce["map"]["launches_by_rank"],
                                 [r["scatter_add_rows"] for r in
                                  ce["slam"]["launches_by_rank"]],
                                 ce["loop"]["launches_by_rank"])],
                         "plain_references": plain["launches"]
                         + plain32["launches"] + again32["launches"]},
            "corr_launches": {"mesh_fleet_slam":
                              fs["launches"]["corr_window"],
                              "composed_fleet_slam_by_rank": [
                                  r["corr_window"] for r in
                                  ce["slam"]["launches_by_rank"]]}}


# ---------------------------------------------------------------------------
# 15. the rest of the scene representation and tracker
# ---------------------------------------------------------------------------

# phase 15's printed budget (not a failure when over)
OPTIONS_BUDGET_S = 90.0
# kernel-1 calls per mapping iteration with colour planes, importance
# resampling and the smoothness term, by plane sampler: per query pass 6
# (packed) or 3 (merged, one [8C] table per orientation) for the geometry
# and 6 / 3 for the colour planes, two passes, and 6 / 3 for the
# smoothness term; the rows sampler's backward is plain autograd
OPTIONS_SCATTERS = {"packed": 30, "merged": 15, "rows": 0}
# of the packed sampler's 30 under render_dtype bfloat16, the render's
# are on bf16 values; the smoothness term's 6 stay fp32
OPTIONS_SCATTERS_BF16 = 24
OPTIONS_STEPS = 3
# 15b: room0.yaml's keys with the options on, through cli.main on phase
# 7's box room; frames 0 and 5 map (keyframe_every 5), room0's first_iters
# 500 and iters 50 cut to 150 and 25
OPTIONS_FRAMES = 6
OPTIONS_ITERS = (150, 25)
OPTIONS_KEYS = {"grid": {"oneGrid": False},
                "training": {"n_importance": 8, "smooth_weight": 1e-6}}
# 15c: the fused GRU in bf16 against the reference GRU in bf16 (and each
# against the fp32 GRU): the gates' pre-activations (sums of a few units)
# round to bf16 at other points (3 convolutions and 2 adds against one
# convolution over the concatenated input), a few bf16 ulps of the
# outputs in (-1, 1)
GRU_BF16_ATOL = 2.0 ** -4
GRU_EDGES = 16              # 15c: edges of the frontend's net [E, 128, 40, 80]
# 15c: the hash grid at its defaults (16 levels, 2^16 rows of 2 features)
HASH_POINTS = 8192


def options_config(out_dir, render_dtype="float32"):
    """Phase 3's tiny config with colour planes (at the planes'
    resolutions), 8 importance samples and the smoothness term."""
    cfg = tiny_config(out_dir)
    cfg["grid"]["oneGrid"] = False
    cfg["c_planes_res"] = {"coarse": 0.44, "fine": 0.22}
    cfg["training"].update(n_importance=8, smooth_weight=0.01,
                           render_dtype=render_dtype)
    return cfg


def options_parity(sampler: str, render_dtype: str) -> dict:
    """15a: OPTIONS_STEPS mapper steps of `options_config` with
    MNESLAM_PLANE_SAMPLER=`sampler`, GPU vs CPU from the same weights and
    the same uniforms (the u seam: perturbation, importance samples, the
    smoothness grid's offset and jitter), the counts set to 0 just before
    the GPU steps and read just after -> losses, max relative loss and
    parameter differences, launches."""
    import numpy as np
    import torch

    from mneslam_tpu_torch.mapping.mapper import Mapper, make_optimizer
    from mneslam_tpu_torch.models import scene_rep as psr
    from mneslam_tpu_torch.models.scene_rep import SceneRep, param_leaves
    from mneslam_tpu_torch.utils.convert import (params_from_jax,
                                                 params_to_numpy)

    cfg = options_config(os.path.join(RUN_OUT, "options"), render_dtype)
    old = psr._PLANE_SAMPLER
    psr._PLANE_SAMPLER = sampler
    try:
        runs = {}
        for dev in ("cpu", "cuda"):
            scene = SceneRep(cfg, dev)
            mapper = Mapper(cfg, scene, num_kf=2, rays_per_kf=16)
            runs[dev] = (mapper, mapper.init_state(
                torch.Generator(device=dev).manual_seed(0)))
        params_np = params_to_numpy(runs["cpu"][1].params)
        for dev, (mapper, state) in runs.items():
            state.params = params_from_jax(params_np, device=dev)
            state.optimizer = make_optimizer(cfg, state.params)
        rng = np.random.default_rng(1)
        n, S = 448, 17
        batches = []
        for _ in range(OPTIONS_STEPS):
            o = rng.normal(0, 0.1, (n, 3)).astype(np.float32)
            d = rng.normal(size=(n, 3)).astype(np.float32)
            d /= np.linalg.norm(d, axis=-1, keepdims=True)
            u = {"perturb": rng.uniform(size=(n, S)),
                 "importance": rng.uniform(size=(n, 8)),
                 "smooth_offset": rng.uniform(size=3),
                 "smooth_jitter": rng.uniform(size=3)}
            batches.append((o, d, rng.uniform(size=(n, 3)),
                            0.5 + rng.uniform(size=(n, 1)),
                            {k: v.astype(np.float32) for k, v in u.items()}))
        losses, launches = {}, None
        for dev, (mapper, state) in runs.items():
            if dev == "cuda":
                reset_launches()
            losses[dev] = []
            for o, d, rgb, td, u in batches:
                t = [torch.as_tensor(np.asarray(a, np.float32), device=dev)
                     for a in (o, d, rgb, td)]
                m = mapper.step(state, *t, u={
                    k: torch.as_tensor(v, device=dev) for k, v in u.items()})
                losses[dev].append(float(m["loss"]))
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = read_launches()
    finally:
        psr._PLANE_SAMPLER = old
    rel = max(abs(a - b) / max(abs(b), 1e-12)
              for a, b in zip(losses["cuda"], losses["cpu"]))
    pdiff = max(float((a.detach().cpu() - b.detach()).abs().max())
                for a, b in zip(param_leaves(runs["cuda"][1].params),
                                param_leaves(runs["cpu"][1].params)))
    return {"sampler": sampler, "render_dtype": render_dtype,
            "losses": losses, "max_rel_loss_diff": rel,
            "max_param_diff": pdiff,
            "scatter_add_rows": launches["scatter_add_rows"],
            "scatter_add_rows_bf16": launches["scatter_add_rows_bf16"],
            "per_iteration": launches["scatter_add_rows"] / OPTIONS_STEPS}


def check_options_parity(r: dict):
    """15a's checks: losses rtol 1e-4, parameters 5e-4, kernel 1's calls
    per iteration exactly (24 of the packed sampler's 30 on bf16 values
    under bfloat16)."""
    want = OPTIONS_SCATTERS[r["sampler"]] * OPTIONS_STEPS
    want_bf16 = (OPTIONS_SCATTERS_BF16 * OPTIONS_STEPS
                 if r["render_dtype"] == "bfloat16" else 0)
    bad = [what for what, ok in (
        ("losses", r["max_rel_loss_diff"] < BF16_LOSS_RTOL),
        ("parameters", r["max_param_diff"] < BF16_PARAM_ATOL),
        (f"kernel-1 launches {r['scatter_add_rows']} != {want}",
         r["scatter_add_rows"] == want),
        (f"bf16 launches {r['scatter_add_rows_bf16']} != {want_bf16}",
         r["scatter_add_rows_bf16"] == want_bf16)) if not ok]
    if bad:
        raise SystemExit(f"15a {r['sampler']} {r['render_dtype']}: {bad}: "
                         f"{json.dumps(r)}")


def scatter_call_times(calls) -> dict:
    """Each (name, idx, vals, n_rows) kernel-1 call against its plain
    version (`check_scatter`), then timed (CUDA events) beside the plain
    version, `index_add_` and its bound (bytes: each input read once, the
    table written once; operations: one fp32 add per value) -> the max
    error, the sums over the calls and one line per call."""
    import torch

    from mneslam_tpu_torch.kernels.scatter_add_rows import (
        scatter_add_rows, scatter_add_rows_plain)
    from mneslam_tpu_torch.tools.measure import (FP32_FLOPS,
                                                 HBM_BYTES_PER_S, cuda_ms)

    out = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
           "bound_ms": 0.0, "max_abs_err": 0.0, "err_ratio": 0.0,
           "lines": []}
    for name, idx, vals, n_rows in calls:
        err, ratio = check_scatter(idx, vals, n_rows)
        nu, width = vals.shape
        ms = cuda_ms(lambda: scatter_add_rows(idx, vals, n_rows))
        plain = cuda_ms(lambda: scatter_add_rows_plain(idx, vals, n_rows))
        lib = cuda_ms(lambda: torch.zeros(
            (n_rows, width), device="cuda").index_add_(0, idx, vals))
        nbytes = nu * width * 4 + nu * idx.element_size() + n_rows * width * 4
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, nu * width / FP32_FLOPS)
        out["lines"].append(
            f"scatter_add_rows {name}: n_rows {n_rows} nu {nu} width "
            f"{width}: kernel {ms:.4f} ms, plain {plain:.4f} ms, index_add_ "
            f"{lib:.4f} ms, bound {1e3 * bound:.1f} us ({nbytes} bytes at "
            f"3.35 TB/s), max abs err {err:.3e}, err / tolerance "
            f"{ratio:.3f}")
        out["ms"] += ms
        out["plain_ms"] += plain
        out["library_ms"] += lib
        out["bytes"] += nbytes
        out["bound_ms"] += bound
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["err_ratio"] = max(out["err_ratio"], ratio)
    return out


class _Recorded:
    """A context that makes `slam.MNESLAM` record the agents it builds
    (`built`) and `datasets.get_dataset` give phase 7's box room, for a
    `cli.main` in this process."""

    def __init__(self, num_frames):
        self.num_frames = num_frames
        self.built = []

    def __enter__(self):
        from mneslam_tpu_torch import slam as slam_mod
        from mneslam_tpu_torch.data import datasets
        from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset

        built, n = self.built, self.num_frames
        self._saved = (slam_mod.MNESLAM, datasets.get_dataset)

        class Recorded(slam_mod.MNESLAM):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                built.append(self)

        slam_mod.MNESLAM = Recorded
        datasets.get_dataset = lambda cfg: SyntheticBoxDataset(
            cfg, num_frames=n, half=BOX_HALF)
        return self

    def __exit__(self, *exc):
        from mneslam_tpu_torch import slam as slam_mod
        from mneslam_tpu_torch.data import datasets

        slam_mod.MNESLAM, datasets.get_dataset = self._saved
        return False


def options_room0(card, fp32_iter_ms) -> dict:
    """15b: `cli.main --mode mapping` on a yaml written here that inherits
    configs/Replica/room0.yaml (width uncut) with OPTIONS_KEYS, on phase
    7's box room (OPTIONS_FRAMES frames, OPTIONS_ITERS iterations, the
    terminate's meshes over the box's bound), the counts set to 0 just
    before and read just after; then the final mesh's vertex colours
    against the map with and without its colour planes, the steady-state
    ms per iteration, and kernel 1 on one iteration's colour-plane calls.
    Raises SystemExit on a failed check."""
    import copy

    import numpy as np
    import torch
    import yaml

    from mneslam_tpu_torch import cli
    from mneslam_tpu_torch.mapping import mesher
    from mneslam_tpu_torch.ops import mc

    keys = copy.deepcopy(OPTIONS_KEYS)
    keys.update(
        dataset="synthetic", mode="mapping",
        data={"output": RUN_OUT, "exp_name": "room0_options",
              "num_frames": OPTIONS_FRAMES},
        mapping={"first_iters": OPTIONS_ITERS[0],
                 "iters": OPTIONS_ITERS[1],
                 "marching_cubes_bound":
                     [[-BOX_HALF - 0.05, BOX_HALF + 0.05]] * 3})
    path = os.path.join(OUT, "room0_options.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"inherit_from": os.path.join(
            ROOT, "configs", "Replica", "room0.yaml"), **keys}, f)
    cwd = os.getcwd()
    os.chdir(ROOT)      # the configs' inherit_from paths are relative
    try:
        with _Recorded(OPTIONS_FRAMES) as rec:
            reset_launches()
            t0 = time.perf_counter()
            res = cli.main(["--config", path, "--mode", "mapping",
                            "--device", "cuda"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = read_launches()
    finally:
        os.chdir(cwd)
    slam = rec.built[0]
    cfg, scene = slam.config, slam.scene
    metrics = slam.metrics_log
    mp = cfg["mapping"]
    n_kf = len(slam.mapped_timestamps)
    iters = int(mp["first_iters"]) + (n_kf - 1) * int(mp["iters"])
    mesh_dir = os.path.join(slam.out_dir, "mesh")
    out = {"keys": keys, "c_plane_shapes": scene.c_plane_shapes,
           "keyframes": n_kf, "iterations": iters, "seconds": seconds,
           "launches": launches, "psnr_last": float(metrics[-1]["psnr"]),
           "finite": all(math.isfinite(v) for m in metrics
                         for v in m.values()),
           "mesh_verts": res.get("mesh_verts"),
           "mesh_verts_culled": res.get("mesh_verts_culled"),
           "meshes": all(os.path.exists(os.path.join(mesh_dir, n)) for n in
                         ("final_mesh.ply", "final_mesh_culled.ply"))}
    # the written vertex colours are the map's (colour planes in), and
    # the colour planes move them
    params = slam.map_state.params
    verts, faces, colors = mc.load_ply(os.path.join(mesh_dir,
                                                    "final_mesh.ply"))
    with torch.no_grad():
        again = mesher.vertex_colors(scene, params, cfg, verts, faces)
        no_c = dict(params, c_planes={
            k: [torch.zeros_like(t) for t in v]
            for k, v in params["c_planes"].items()})
        without = mesher.vertex_colors(scene, no_c, cfg, verts, faces)
    out["colors_vs_map"] = float(np.abs(colors - again).max())
    out["colors_moved_by_c_planes"] = float(np.abs(again - without).mean())

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    frame, pose = slam._frame_for_mapping(int(slam.mapped_timestamps[-1]))
    slam.mapper.optimize(slam.map_state, frame, pose, gen, iters=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam.mapper.optimize(slam.map_state, frame, pose, gen,
                         iters=int(mp["iters"]))
    torch.cuda.synchronize()
    out["iter_ms"] = 1e3 * (time.perf_counter() - t0) / int(mp["iters"])
    out["fp32_iter_ms"] = fp32_iter_ms

    # kernel 1 on one iteration's six colour-plane calls (real indices of
    # the first pass, random values)
    out["kernel1_colour"] = scatter_call_times(path_scatter_inputs(
        slam, gen, scene.c_plane_shapes, "c_planes_"))
    n = OPTIONS_SCATTERS["packed"] * iters
    bad = [what for what, ok in (
        (f"kernel-1 launches {launches['scatter_add_rows']} != {n}",
         launches["scatter_add_rows"] == n
         and not launches["scatter_add_rows_bf16"]),
        ("no other kernel", not any(v for k, v in launches.items()
                                    if not k.startswith("scatter_add_rows"))),
        ("PSNR", out["psnr_last"] > PSNR_FLOOR),
        ("finite", out["finite"]),
        ("meshes", out["meshes"] and (out["mesh_verts"] or 0) > 0),
        # the PLY stores each colour truncated to 1/255
        ("vertex colours from the map",
         out["colors_vs_map"] <= 1.0 / 255 + 1e-4),
        ("vertex colours move with the colour planes",
         out["colors_moved_by_c_planes"] > 1.0 / 255)) if not ok]
    if bad:
        shown = {k: v for k, v in out.items() if k != "kernel1_colour"}
        raise SystemExit(f"15b room0 with the options: {bad}: "
                         f"{json.dumps(shown)}")
    return out


def encodings_check() -> dict:
    """15c: every encoding and the hash grid at its defaults, GPU against
    CPU on the same inputs: values rtol 1e-5 / atol 1e-5 (sin / cos of
    arguments up to 2^11 pi), the hash grid's features atol 1e-9 (values
    near 1e-4), its corner indices equal at every level and its table's
    gradient rtol 1e-5 / atol 1e-6 (atomic sums on the card)."""
    import torch

    from mneslam_tpu_torch.ops import encodings, hashgrid

    g = torch.Generator().manual_seed(3)
    x = torch.rand((4096, 3), generator=g)
    x[:64] = 1.0 - 1e-4 * torch.rand((64, 3), generator=g)
    dirs = torch.nn.functional.normalize(torch.randn((4096, 3), generator=g),
                                         dim=-1)
    out = {}
    for name, kw, inp in (("OneBlob", {"n_bins": 16}, x),
                          ("Frequency", {"n_frequencies": 12}, x),
                          ("SphericalHarmonics", {"degree": 4}, dirs),
                          ("Identity", {}, x)):
        fn, dim = encodings.get_encoder(name, **kw)
        a, b = fn(inp.cuda()).cpu(), fn(inp)
        if not (a.shape[-1] == dim and torch.allclose(a, b, rtol=1e-5,
                                                      atol=1e-5)):
            raise SystemExit(f"15c encoding {name}: GPU and CPU differ by "
                             f"{float((a - b).abs().max())}")
        out[name] = float((a - b).abs().max())

    params, res = hashgrid.init_hash_grid(g)
    T = params["table"].shape[1]
    gpu = {"table": params["table"].detach().cuda().requires_grad_(True)}
    w = torch.randn((4096, 2 * len(res)), generator=g)
    fa = hashgrid.hash_grid_encode(gpu, x.cuda(), res)
    fb = hashgrid.hash_grid_encode(params, x, res)
    (fa * w.cuda()).sum().backward()
    (fb * w).sum().backward()
    hashed = [r for r in res if (r + 1) ** 3 > T]
    c = (x * res[-1]).floor().long()
    idx_equal = all(torch.equal(
        hashgrid.corner_index(*(c[:, i].cuda() for i in range(3)), r,
                              T).cpu(),
        hashgrid.corner_index(*(c[:, i] for i in range(3)), r, T))
        for r in res)
    out["hash_grid"] = {
        "levels": len(res), "rows": T, "hashed_levels": len(hashed),
        "features_err": float((fa.detach().cpu() - fb.detach()).abs().max()),
        "grad_err": float((gpu["table"].grad.cpu()
                           - params["table"].grad).abs().max()),
        "indices_equal": idx_equal}
    h = out["hash_grid"]
    if not (idx_equal and h["features_err"] <= 1e-9 and torch.allclose(
            gpu["table"].grad.cpu(), params["table"].grad, rtol=1e-5,
            atol=1e-6) and hashed):
        raise SystemExit(f"15c hash grid: GPU and CPU differ: {h}")
    return out


def gru_check() -> dict:
    """15c: `gru_apply_fused` against `gru_apply` at the frontend's shapes
    (net [GRU_EDGES, 128, 40, 80], inp [.., 320, ..]) in bf16, each also
    against the fp32 reference GRU; within GRU_BF16_ATOL; both timed."""
    import torch

    from mneslam_tpu_torch.models import droid_net
    from mneslam_tpu_torch.tools.measure import cuda_ms

    g = torch.Generator(device="cuda").manual_seed(5)
    p32 = droid_net.init_gru(g, device="cuda")
    p16 = droid_net.cast_params(p32, torch.bfloat16)
    net = torch.tanh(torch.randn((GRU_EDGES, 128, 40, 80), generator=g,
                                 device="cuda"))
    inp = torch.relu(torch.randn((GRU_EDGES, 320, 40, 80), generator=g,
                                 device="cuda"))
    with torch.no_grad():
        ref32 = droid_net.gru_apply(p32, net, inp).float()
        n16, i16 = net.bfloat16(), inp.bfloat16()
        ref = droid_net.gru_apply(p16, n16, i16).float()
        fused = droid_net.gru_apply_fused(p16, n16, i16).float()
        out = {"fused_vs_ref": float((fused - ref).abs().max()),
               "fused_vs_fp32": float((fused - ref32).abs().max()),
               "ref_vs_fp32": float((ref - ref32).abs().max()),
               "ref_ms": cuda_ms(lambda: droid_net.gru_apply(p16, n16, i16)),
               "fused_ms": cuda_ms(
                   lambda: droid_net.gru_apply_fused(p16, n16, i16))}
    if not max(out["fused_vs_ref"], out["fused_vs_fp32"]) <= GRU_BF16_ATOL:
        raise SystemExit(f"15c fused GRU (bf16): {out}, limit "
                         f"{GRU_BF16_ATOL}")
    return out


def fused_gru_slam() -> dict:
    """15c: phase 5's tiny oracle SLAM run under MNESLAM_GRU_IMPL=fused,
    its tracker update the DROID update (the fused GRU, random weights)
    with the oracle's targets in place of its flow: key poses within 5 cm;
    then `depth_filter`, `upsample_disps` and
    `keyframe_selection_overlap` on that run's state, GPU against CPU, and
    `maybe_profile` writing a trace of one frontend update."""
    import numpy as np
    import torch

    from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
    from mneslam_tpu_torch.data.rays import rays_from_pose
    from mneslam_tpu_torch.mapping import keyframe as kf_lib
    from mneslam_tpu_torch.models import droid_net
    from mneslam_tpu_torch.slam import MNESLAM
    from mneslam_tpu_torch.tracking import video as video_lib
    from mneslam_tpu_torch.utils import metrics as metrics_lib

    cfg = tiny_slam_config(os.path.join(RUN_OUT, "oracle"),
                           exp_name="oracle_fused_gru")
    ds = SyntheticBoxDataset(cfg, num_frames=16)
    intr8 = [60.0 / 8, 60.0 / 8, 47.5 / 8, 31.5 / 8]
    oracle, agg_fn = oracle_fns(ds, intr8)

    def update_fn(params, state, ii, jj, net, corr, motion, coords1):
        net, _, _ = droid_net.update_apply(params["update"], net,
                                           state.inps[ii], corr, motion)
        _, delta, weight = oracle(params, state, ii, jj, net, corr, motion,
                                  coords1)
        return net, delta, weight

    calls = []
    real = droid_net.gru_apply_fused

    def counted(*a):
        calls.append(1)
        return real(*a)

    saved = os.environ.get("MNESLAM_GRU_IMPL")
    os.environ["MNESLAM_GRU_IMPL"] = "fused"
    droid_net.gru_apply_fused = counted
    try:
        slam = MNESLAM(cfg, ds, device="cuda", update_fn=update_fn,
                       agg_fn=agg_fn)
        slam.run_slam()
        torch.cuda.synchronize()
    finally:
        droid_net.gru_apply_fused = real
        if saved is None:
            os.environ.pop("MNESLAM_GRU_IMPL")
        else:
            os.environ["MNESLAM_GRU_IMPL"] = saved
    key = np.load(os.path.join(slam.out_dir, "key_est_poses.npy"))
    ts = np.load(os.path.join(slam.out_dir, "key_timestamps.npy"))
    ref = np.stack([ds[int(t)]["c2w"] for t in ts])
    err = float(np.linalg.norm(key[:, :3, 3] - ref[:, :3, 3], axis=-1).max())
    out = {"keyframes": len(ts), "pose_err_m": err,
           "fused_gru_calls": len(calls)}

    # the run's keyframe buffer, GPU against CPU
    tr = slam.tracker
    n = tr.counter
    st = tr.state
    st_cpu = video_lib.VideoState(*(t.cpu() for t in st))
    intr = tr.intrinsics.cuda()
    inds = torch.arange(n, device="cuda")
    thresh = torch.full((n,), 0.05, device="cuda")
    ca = video_lib.depth_filter(st, intr, inds, thresh).cpu()
    cb = video_lib.depth_filter(st_cpu, intr.cpu(), inds.cpu(), thresh.cpu())
    diff = (ca - cb).abs()
    out["depth_filter"] = {"frames": n, "mean_count": float(ca.mean()),
                           "pixels_differing": float((diff > 0).float()
                                                     .mean()),
                           "max_diff": float(diff.max())}
    ht, wd = st.disps.shape[1:]
    mask = torch.randn((n, 576, ht, wd), device="cuda")
    ua = video_lib.upsample_disps(st, inds, mask).cpu()
    ub = video_lib.upsample_disps(st_cpu, inds.cpu(), mask.cpu())
    out["upsample_disps"] = {"shape": list(ua.shape),
                             "max_err": float((ua - ub).abs().max())}
    item = ds[int(ts[-1])]
    c2w = torch.as_tensor(np.asarray(item["c2w"], np.float32))
    d = torch.as_tensor(np.asarray(item["direction"], np.float32)
                        ).reshape(-1, 3)
    depth = torch.as_tensor(np.asarray(item["depth"], np.float32)
                            ).reshape(-1)
    ro, rd = rays_from_pose(d, c2w)
    poses = torch.as_tensor(key, dtype=torch.float32)
    K = torch.tensor([60.0, 60.0, 47.5, 31.5])
    H, W = cfg["cam"]["H"], cfg["cam"]["W"]
    oa = kf_lib.keyframe_selection_overlap(poses.cuda(), ro.cuda(),
                                           rd.cuda(), depth.cuda(),
                                           K.cuda(), H, W).cpu()
    ob = kf_lib.keyframe_selection_overlap(poses, ro, rd, depth, K, H, W)
    out["overlap"] = {"ratios": [round(float(v), 4) for v in oa],
                      "max_diff": float((oa - ob).abs().max()),
                      "rays": int(ro.shape[0])}

    # the trace hook: one frontend update traced to OUT/trace/<tag>
    trace = os.path.join(OUT, "trace")
    os.environ["MNESLAM_TRACE_DIR"] = trace
    try:
        with metrics_lib.maybe_profile("frontend_update"):
            with torch.no_grad():
                tr.frontend.graph.update(tr.state, use_inactive=True)
            torch.cuda.synchronize()
    finally:
        os.environ.pop("MNESLAM_TRACE_DIR")
    files = os.listdir(os.path.join(trace, "frontend_update"))
    out["trace_files"] = files
    out["trace_bytes"] = sum(os.path.getsize(os.path.join(
        trace, "frontend_update", f)) for f in files)
    bad = [what for what, ok in (
        ("key poses", err < ORACLE_TOL_M),
        ("the fused GRU ran", len(calls) > 0),
        ("depth_filter", out["depth_filter"]["max_diff"] <= 1.0
         and out["depth_filter"]["pixels_differing"] <= 0.005
         and out["depth_filter"]["mean_count"] > 0),
        ("upsample_disps", out["upsample_disps"]["max_err"] <= 1e-5),
        ("overlap", out["overlap"]["max_diff"] <= 2.0 / ro.shape[0]
         and max(out["overlap"]["ratios"]) > 0.5),
        ("trace", len(files) == 1 and out["trace_bytes"] > 0)) if not ok]
    if bad:
        raise SystemExit(f"15c fused-GRU SLAM and tracker extras: {bad}: "
                         f"{json.dumps(out)}")
    return out


def options_phase(card, fp32_iter_ms) -> dict:
    """Phase 15 (15a-15c) -> its results. Raises SystemExit on a failed
    check."""
    t15 = time.perf_counter()
    steps = {}
    parity = [options_parity(smp, dt) for smp, dt in (
        ("packed", "float32"), ("merged", "float32"), ("rows", "float32"),
        ("packed", "bfloat16"))]
    for r in parity:
        check_options_parity(r)
        log(f"15a tiny config with colour planes, 8 importance samples and "
            f"the smoothness term, sampler {r['sampler']}, "
            f"{r['render_dtype']}, {OPTIONS_STEPS} mapper steps GPU vs CPU: "
            f"losses cuda {r['losses']['cuda']} cpu {r['losses']['cpu']}; "
            f"max rel loss diff {r['max_rel_loss_diff']:.3e} (limit "
            f"{BF16_LOSS_RTOL:g}), max param diff {r['max_param_diff']:.3e} "
            f"(limit {BF16_PARAM_ATOL:g}); kernel-1 launches "
            f"{r['scatter_add_rows']} ({r['per_iteration']:g} per "
            f"iteration, {r['scatter_add_rows_bf16']} on bf16 values)")
    steps["15a"] = time.perf_counter() - t15

    room = options_room0(card, fp32_iter_ms)
    k = room["kernel1_colour"]
    log(f"15b cli.main --mode mapping, configs/Replica/room0.yaml with "
        f"{json.dumps(OPTIONS_KEYS)} (colour planes "
        f"{json.dumps(room['c_plane_shapes'])}), {OPTIONS_FRAMES} box-room "
        f"frames, first_iters and iters cut to {list(OPTIONS_ITERS)}: "
        f"{room['keyframes']} keyframes, {room['iterations']} iterations in "
        f"{room['seconds']:.2f} s; last PSNR {room['psnr_last']:.2f} dB "
        f"(floor {PSNR_FLOOR}); launches {json.dumps(room['launches'])} = "
        f"{OPTIONS_SCATTERS['packed']} x {room['iterations']}; meshes "
        f"{room['mesh_verts']} / {room['mesh_verts_culled']} vertices, "
        f"their colours {room['colors_vs_map']:.4f} from the map's, moved "
        f"{room['colors_moved_by_c_planes']:.4f} on average by the colour "
        f"planes; {room['iter_ms']:.3f} ms per iteration against phase 7's "
        f"fp32 {fp32_iter_ms:.3f} ms, on {card}")
    for line in k["lines"]:
        log(f"  15b colour planes: {line}")
    log(f"15b kernel 1, one iteration's 6 colour-plane calls: kernel "
        f"{k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, index_add_ "
        f"{k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
        f"({k['bytes']} bytes), max abs err {k['max_abs_err']:.3e}, err / "
        f"tolerance {k['err_ratio']:.3f}, on {card}")
    steps["15b"] = time.perf_counter() - t15 - sum(steps.values())

    enc = encodings_check()
    gru = gru_check()
    slam = fused_gru_slam()
    log(f"15c encodings GPU vs CPU (max abs diff): {json.dumps(enc)}")
    log(f"15c fused GRU bf16 at net [{GRU_EDGES}, 128, 40, 80]: "
        f"{json.dumps(gru)} (limit {GRU_BF16_ATOL}), on {card}")
    log(f"15c tiny oracle SLAM under MNESLAM_GRU_IMPL=fused: "
        f"{json.dumps(slam)} (limit {ORACLE_TOL_M} m)")
    steps["15c"] = time.perf_counter() - t15 - sum(steps.values())
    t15 = time.perf_counter() - t15
    log(f"phase 15 {t15:.1f} s of its budget of {OPTIONS_BUDGET_S:.0f} s"
        + (": OVER BUDGET, cut its frames or iterations"
           if t15 > OPTIONS_BUDGET_S else "")
        + f"; s by step "
        f"{json.dumps({k: round(v, 1) for k, v in steps.items()})}")
    return {"seconds": t15, "parity": parity, "room0": room,
            "encodings": enc, "gru": gru, "slam": slam}


def main():
    import numpy as np
    import torch

    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from mneslam_tpu_torch.device import resolve_device
    from mneslam_tpu_torch.kernels import build
    from mneslam_tpu_torch.kernels.scatter_add_rows import scatter_add_rows
    from mneslam_tpu_torch.tools.prof_corr import corr_impl
    from mneslam_tpu_torch.tools.prof_determinism import (
        deterministic, repeat_diff, tracking_parity_run)

    resolve_device("cuda")  # TF32 off
    os.makedirs(OUT, exist_ok=True)
    phase_s, t_mark = {}, [time.perf_counter()]

    def phase_done(name):
        """Print and keep phase `name`'s seconds (since the last mark)."""
        now = time.perf_counter()
        phase_s[name] = now - t_mark[0]
        t_mark[0] = now
        log(f"phase {name}: {phase_s[name]:.1f} s")

    # 1. card
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    libs = build.build_all(host=build.HOST_SOURCES)
    log(f"build: {len(libs)} libraries (CUDA kernels and the host "
        f"polygoniser) in {time.perf_counter() - t0:.2f} s: {sorted(libs)}")

    phase_done("2")
    # 3. small parity, GPU vs CPU
    losses, rel, pdiff = small_parity()
    log(f"parity: losses cuda {losses['cuda']} cpu {losses['cpu']}; "
        f"max rel loss diff {rel:.3e}, max param diff {pdiff:.3e}")
    if not (rel < 1e-4 and pdiff < PARAM_TOL):
        raise SystemExit("parity: GPU and CPU mapper steps disagree")

    phase_done("3")
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

    phase_done("3b")
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

    phase_done("4")
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

    phase_done("5")
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

    phase_done("6")
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

    phase_done("7")
    # 7b. the mesh at room0 widths, step by step, and at mesh.voxel_eval
    mesh = mesh_room0(slam, res)
    log(f"room0 mesh (mapping-only map, {card}): {json.dumps(mesh)}")
    phase_done("7b")
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

    phase_done("7c")
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

    phase_done("7d")
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

    phase_done("8")
    # 9. the same path with MNESLAM_CORR_IMPL=pallas_mxu: kernel 2b
    # (its terminate meshes the box room's bound only: phase 8 meshes the
    # whole room0 bound)
    t9 = time.perf_counter()
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
    log(f"phase 9 {time.perf_counter() - t9:.1f} s for {MXU_FRAMES} frames "
        f"(32 before 14e was added)")

    phase_done("9")
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
    totals = scatter_call_times(calls)
    for line in totals["lines"]:
        log(line)
    max_err = max(max_err, totals["max_abs_err"])
    bound_ms = totals["bound_ms"]
    log(f"scatter_add_rows, one iteration's {len(calls)} calls: kernel "
        f"{totals['ms']:.4f} ms, plain {totals['plain_ms']:.4f} ms, "
        f"index_add_ {totals['library_ms']:.4f} ms, bound "
        f"{1e3 * bound_ms:.1f} us ({totals['bytes']} bytes)")

    # (c) kernels 2, 2b and 3 (box design) against their plain versions,
    #     timed in turns with their row design of the first port
    corr = corr_kernels(slam_s)

    phase_done("10")
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

    phase_done("11")
    # 12. multi-agent collaboration
    cp, ma_launches = collaboration(slam, card)

    phase_done("12")
    # 13. the shipped configs on files: image I/O, the TUM path, the bf16
    #     mapping path
    files = files_phase(card, iter_ms, kf_ms)
    tum, fast = files["tum"], files["fast"]
    corr["corr_window"]["tum_frontend"] = tum["corr"]

    phase_done("13")
    # 14. the row-sharded mapper (1 rank over NCCL, 4 ranks over gloo) and
    #     the mesh fleet
    shard = shard_phase(card)

    phase_done("14")
    # 15. the rest of the scene representation and tracker: colour planes,
    #     importance resampling, the smoothness term, the samplers, the
    #     encodings and the hash grid, the fused GRU, the tracker extras
    opts = options_phase(card, iter_ms)
    colour = opts["room0"]["kernel1_colour"]

    phase_done("15")
    log(f"seconds by phase: "
        f"{json.dumps({k: round(v, 1) for k, v in phase_s.items()})}")

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
                                 fast["launches"]["scatter_add_rows_bf16"],
                             **shard["launches"],
                             "options_room0": opts["room0"]["launches"][
                                 "scatter_add_rows"],
                             "options_parity": {
                                 f"{r['sampler']}_{r['render_dtype']}":
                                     r["scatter_add_rows"]
                                 for r in opts["parity"]}},
        "colour_planes": {
            "timed_as": "sum of one room0 iteration's 6 colour-plane calls "
                        "(c_planes_res 0.08 / 0.02)",
            **{k: colour[k] for k in ("ms", "plain_ms", "library_ms",
                                      "bound_ms", "bytes", "max_abs_err",
                                      "err_ratio")},
            "bound_by": "bytes",
            "launches_per_iteration": OPTIONS_SCATTERS,
            "iter_ms": opts["room0"]["iter_ms"]},
        "bf16": {**fast["kernel1_bf16"],
                 "route": "workspace: accumulate + emit",
                 "launches": fast["launches"]["scatter_add_rows_bf16"],
                 "fp32_launches": fast["launches"]["scatter_add_rows"]
                 - fast["launches"]["scatter_add_rows_bf16"],
                 "bound_by": "bytes",
                 "timed_as": "sum of one bf16 mapping iteration's 6 calls",
                 "library": "none computes the same function; library_ms "
                            "is index_add_ into a bf16 table, which sums "
                            "in bf16",
                 "iter_ms": fast["iter_ms"],
                 "keyframe_ms": fast["keyframe_ms"]},
        "max_abs_err": max(max_err, colour["max_abs_err"]),
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
         "tum_files": tum["launches"]["corr_window"],
         **shard["corr_launches"]},
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
    log(f"chip_smoke.py {time.perf_counter() - t_all:.1f} s in all, the "
        f"build included (before phase 15: 801.2 s, phase 14 164.6 s; "
        f"PERF.md section 6)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-rank"]:
        sys.exit(shard_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--cli-rank"]:
        sys.exit(cli_rank_main(sys.argv[2:]))
    sys.exit(main())
