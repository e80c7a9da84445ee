"""Mapping-only quality and throughput on the box room at Replica-like scale.

    python -m mneslam_tpu_torch.tools.eval_synthetic [--fast] [--bf16] \
        [--device cuda|cpu]

The synthetic box room seen by a Replica-like camera (340 x 600, fx 300),
the reference mapping workload (2048 + 100 rays, 50 iterations a keyframe,
c_dim 32, 0.04 / 0.02 m planes, 500 iterations on the first frame), 60
keyframes (frames 0, 2, ..., 118). Prints one JSON report: PSNR and depth
L1 on the held-out frames 31, 61 and 91, the mesh's accuracy against the
analytic box, and the rates. `--fast`: 8 depth samples and 25 iterations (the
equal-quality fast profile); `--bf16`: `training.render_dtype: bfloat16`.
Runs on the GPU unless `--device cpu` is given.

Port of the repository's `tools/eval_synthetic.py`, in three parts:
`config` (its overrides), `run` (its mapping, renders and mesh on any
keyframe ids) and `main` (its own ids).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import make_config

HALF = 2.0
NUM_FRAMES = 120
KEYFRAME_IDS = tuple(range(2, NUM_FRAMES, 2))
HELD_OUT = (31, 61, 91)


def config(fast: bool = False, bf16: bool = False):
    """The tool's configuration: room bound 2.2 m, meshing 2.05 m at 0.02 m."""
    return make_config({
        "mapping": {"bound": [[-2.2, 2.2]] * 3,
                    "marching_cubes_bound": [[-2.05, 2.05]] * 3,
                    "sample": 2048, "min_pixels_cur": 100, "first_iters": 500,
                    "iters": iters_for(fast)},
        "planes_res": {"coarse": 0.04, "fine": 0.02, "bound_dividable": 0.04},
        "cam": {"H": 340, "W": 600, "fx": 300.0, "fy": 300.0, "cx": 299.5,
                "cy": 169.5, "near": 0.0, "far": 8.0, "depth_trunc": 100.0},
        "training": {"n_range_d": 11, "n_samples_d": 8 if fast else 32,
                     "range_d": 0.1, "trunc": 0.1,
                     "render_dtype": "bfloat16" if bf16 else "float32"},
        "model": {"c_dim": 32, "input_ch": 64, "input_ch_pos": 48,
                  "truncation": 0.1},
        "meshing": {"resolution": 0.02},
    })


def iters_for(fast: bool) -> int:
    return 25 if fast else 50


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg, ds, keyframe_ids, held_out, iters: int, device="cuda",
        seed: int = 0, fast: bool = False, bf16: bool = False) -> dict:
    """Map frame 0 (`mapping.first_iters` iterations), then each of
    `keyframe_ids` (`iters` each); render the `held_out` frames whole and
    mesh the map -> the tool's report. `ds`: a box room of half-width
    `ds.half`; `seed`: the generators' (the map's init, the ray draws)."""
    from ..data.rays import rays_from_pose
    from ..device import make_generator, resolve_device
    from ..mapping.mapper import Mapper
    from ..mapping.mesher import extract_mesh
    from ..models.scene_rep import SceneRep

    device = resolve_device(device)
    scene = SceneRep(cfg, device)
    mapper = Mapper(cfg, scene, num_kf=len(keyframe_ids) + 1,
                    rays_per_kf=ds.num_rays_to_save)
    state = mapper.init_state(make_generator(device, seed))
    gen = make_generator(device, seed + 1)

    def frame(fid):
        it = ds[fid]
        fr = {k: torch.as_tensor(it[k], device=device)
              for k in ("direction", "rgb", "depth")}
        fr["frame_id"] = fid
        return fr, torch.as_tensor(it["c2w"], device=device)

    f0, c2w0 = frame(0)
    _sync(device)
    t_first = time.perf_counter()
    state, _ = mapper.first_frame_mapping(state, f0, c2w0, gen)
    _sync(device)
    t_first = time.perf_counter() - t_first

    t_map = time.perf_counter()
    for fid in keyframe_ids:
        fr, c2w = frame(fid)
        state = mapper.add_keyframe(state, fid, fr, c2w, gen)
        state, _ = mapper.optimize(state, fr, c2w, gen, iters=iters)
    _sync(device)
    t_map = time.perf_counter() - t_map
    n_kf = len(keyframe_ids)

    psnrs, l1s = [], []
    with torch.no_grad():
        for fid in held_out:
            fr, c2w = frame(fid)
            ro, rd = rays_from_pose(fr["direction"].reshape(-1, 3), c2w)
            depth, rgb = scene.render_image_rays(
                state.params, ro, rd, fr["depth"].reshape(-1), chunk=8192)
            it = ds[fid]
            rgb = rgb.float().cpu().numpy()
            depth = depth.float().cpu().numpy()
            mse = float(np.mean(np.square(rgb - it["rgb"].reshape(-1, 3))))
            psnrs.append(-10 * np.log10(mse))
            l1s.append(float(np.mean(np.abs(depth - it["depth"].reshape(-1))))
                       * 100)

    t_mesh = time.perf_counter()
    verts, _, _ = extract_mesh(scene, state.params, cfg, save_path=None)
    t_mesh = time.perf_counter() - t_mesh

    # mesh accuracy against the analytic box: each vertex's distance to
    # its nearest wall plane
    d_face = ds.half - np.max(np.abs(verts), axis=1)
    acc_cm = float(np.mean(np.abs(d_face))) * 100 if len(verts) else \
        float("nan")
    return {
        "keyframes": n_kf + 1, "fast": fast, "bf16": bf16,
        "first_frame_s": round(t_first, 1),
        "map_s_per_kf": round(t_map / max(n_kf, 1), 2),
        "map_kf_hz": round(n_kf / t_map, 3),
        "map_iters_per_s": round(iters * n_kf / t_map, 1),
        "novel_view_psnr_db": round(float(np.mean(psnrs)), 2),
        "novel_view_depth_l1_cm": round(float(np.mean(l1s)), 2),
        "mesh_verts": len(verts),
        "mesh_wall_accuracy_cm": round(acc_cm, 2),
        "mesh_extract_s": round(t_mesh, 1),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)

    from ..data.synthetic import SyntheticBoxDataset
    from ..device import resolve_device

    device = resolve_device(args.device)
    cfg = config(args.fast, args.bf16)
    ds = SyntheticBoxDataset(cfg, num_frames=NUM_FRAMES, half=HALF)
    report = run(cfg, ds, KEYFRAME_IDS, HELD_OUT, iters_for(args.fast),
                 device, fast=args.fast, bf16=args.bf16)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
