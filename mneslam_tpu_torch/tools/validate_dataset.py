"""Dataset onboarding: check a dataset folder, then smoke-run the port on it.

    python -m mneslam_tpu_torch.tools.validate_dataset /data/Replica/room0 \
        --kind replica
    python -m mneslam_tpu_torch.tools.validate_dataset /data/scene0000_00 \
        --config configs/ScanNet/scene0000.yaml
    python -m mneslam_tpu_torch.tools.validate_dataset /data/tum/fr1_desk \
        --kind tum --no-smoke

The port's own copy of the repository's `tools/validate_dataset.py`, with
the same checks, PASS / WARN / FAIL rows, closing JSON line and exit codes
(0: ready; 1: a check failed), so the two tools agree on the same folder:

- structure and file counts per kind (Replica / Outdoor results/ and
  traj.txt, ScanNet color/depth/pose, Indoor depth_holefilling, TUM's
  three lists);
- TUM's timestamp association: the share of colour frames with a depth
  frame and a pose within 0.08 s;
- intrinsics against the loaded frames (principal point inside the image,
  the files' resolution equal to cam.H / W less the crop);
- a few frames: finite colour in [0, 1], non-negative depth, the depth
  scale plausible for `png_depth_scale` (Indoor: / 65535 x 100);
- poses: finite (ScanNet's inf poses warn), proper and orthonormal
  rotations after the OpenGL flips, trajectory continuity;
- the smoke (skipped by `--no-smoke`): the first finite-pose frames at 64 x
  96 through the port's `MNESLAM.run_slam` on `--device` (default cuda;
  cpu only when asked), the tracker's update given reprojection targets
  from the dataset's own poses in place of trained DROID weights: finite
  poses, the APE against the loader's poses, a sane mapping loss.

Frames load through `data/datasets.py` (PNG decoded by the port itself,
JPEG through cv2).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

from ..slam import MNESLAM

PASS, WARN, FAIL = "PASS", "WARN", "FAIL"


class Report:
    def __init__(self):
        self.rows = []
        self.n_fail = 0
        self.n_warn = 0

    def add(self, status, check, detail=""):
        self.rows.append((status, check, detail))
        if status == FAIL:
            self.n_fail += 1
        elif status == WARN:
            self.n_warn += 1
        print(f"[{status}] {check}" + (f": {detail}" if detail else ""),
              flush=True)

    def require(self, ok, check, detail=""):
        self.add(PASS if ok else FAIL, check, detail if not ok else "")
        return bool(ok)


# ---------------------------------------------------------------------------
# structure checks


def check_structure(rep: Report, basedir: str, kind: str) -> bool:
    if not rep.require(os.path.isdir(basedir), "dataset directory exists",
                       basedir):
        return False

    def count(pattern):
        return len(glob.glob(os.path.join(basedir, pattern)))

    if kind in ("replica", "outdoor"):
        n_img = count("results/frame*.jpg")
        n_dep = count("results/depth*.png")
        ok = rep.require(n_img > 0, "results/frame*.jpg present",
                         "no color frames found")
        ok &= rep.require(n_dep > 0, "results/depth*.png present",
                          "no depth frames found")
        ok &= rep.require(n_img == n_dep, "color/depth counts match",
                          f"{n_img} color vs {n_dep} depth")
        traj = os.path.join(basedir, "traj.txt")
        if rep.require(os.path.isfile(traj), "traj.txt present", traj):
            with open(traj) as f:
                n_pose = sum(1 for line in f if line.strip())
            ok &= rep.require(n_pose >= n_img, "traj.txt covers all frames",
                              f"{n_pose} pose lines vs {n_img} frames")
        else:
            ok = False
        return ok
    if kind == "scannet":
        n_img = count("color/*.jpg")
        n_dep = count("depth/*.png")
        n_pose = count("pose/*.txt")
        ok = rep.require(n_img > 0, "color/*.jpg present", "none found")
        ok &= rep.require(n_img == n_dep == n_pose,
                          "color/depth/pose counts match",
                          f"{n_img}/{n_dep}/{n_pose}")
        return ok
    if kind == "indoor":
        n_img = count("color/*.jpg")
        n_dep = count("depth_holefilling/*.png")
        ok = rep.require(n_img > 0, "color/*.jpg present", "none found")
        ok &= rep.require(n_dep == n_img,
                          "depth_holefilling/*.png counts match",
                          f"{n_img} color vs {n_dep} depth")
        traj = os.path.join(basedir, "traj.txt")
        ok &= rep.require(os.path.isfile(traj), "traj.txt present", traj)
        return ok
    if kind == "tum":
        ok = True
        for name in ("rgb.txt", "depth.txt", "groundtruth.txt"):
            ok &= rep.require(os.path.isfile(os.path.join(basedir, name)),
                              f"{name} present", name)
        return ok
    rep.add(FAIL, "kind", f"unknown dataset kind {kind!r}")
    return False


def check_tum_association(rep: Report, basedir: str, max_dt: float = 0.08):
    """Coverage of the greedy nearest-timestamp association the loader
    performs — large gaps mean dropped frames the user should know about."""
    def stamps(name):
        ts = []
        with open(os.path.join(basedir, name)) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                ts.append(float(line.split()[0]))
        return np.asarray(ts)

    rgb_t, dep_t, gt_t = stamps("rgb.txt"), stamps("depth.txt"), stamps(
        "groundtruth.txt")
    if not rep.require(len(rgb_t) and len(dep_t) and len(gt_t),
                       "tum lists non-empty",
                       f"rgb {len(rgb_t)} depth {len(dep_t)} gt {len(gt_t)}"):
        return
    dd = np.abs(dep_t[None, :] - rgb_t[:, None]).min(axis=1)
    dg = np.abs(gt_t[None, :] - rgb_t[:, None]).min(axis=1)
    keep = (dd <= max_dt) & (dg <= max_dt)
    frac = keep.mean()
    rep.add(PASS if frac >= 0.9 else (WARN if frac >= 0.5 else FAIL),
            "tum association coverage",
            f"{keep.sum()}/{len(rgb_t)} rgb frames associate within "
            f"{max_dt}s (depth max gap {dd.max():.3f}s, gt {dg.max():.3f}s)")


# ---------------------------------------------------------------------------
# loaded-frame checks


def check_intrinsics(rep: Report, ds, cfg):
    cam = cfg["cam"]
    H, W = ds.H, ds.W
    fx, fy, cx, cy = ds.fx, ds.fy, ds.cx, ds.cy
    rep.require(fx > 0 and fy > 0, "fx/fy positive", f"fx={fx} fy={fy}")
    rep.require(0 < cx < W and 0 < cy < H,
                "principal point inside image",
                f"cx={cx} cy={cy} vs W={W} H={H}")
    if not 0.5 < fx / fy < 2.0:
        rep.add(WARN, "fx/fy aspect", f"unusual ratio {fx / fy:.3f}")
    if abs(cx - W / 2) > 0.25 * W or abs(cy - H / 2) > 0.25 * H:
        rep.add(WARN, "principal point near center",
                f"cx={cx} cy={cy} far from ({W / 2}, {H / 2})")
    e = cam.get("crop_edge", 0)
    want_hw = (cam["H"] // cfg["data"].get("downsample", 1) - 2 * e,
               cam["W"] // cfg["data"].get("downsample", 1) - 2 * e)
    item = ds[0]
    rep.require(item["rgb"].shape[:2] == item["depth"].shape,
                "rgb/depth shapes agree",
                f"{item['rgb'].shape} vs {item['depth'].shape}")
    rep.require(item["depth"].shape == want_hw,
                "raw file resolution matches cam.H/W",
                f"loaded {item['depth'].shape}, config implies {want_hw} — "
                "ray directions are built from cam intrinsics, so this "
                "mismatch corrupts every ray")
    rep.require(item["direction"].shape[:2] == want_hw,
                "direction grid matches frames",
                f"{item['direction'].shape} vs {want_hw}")


def check_frames(rep: Report, ds, kind: str, n_sample: int = 5):
    n = len(ds)
    idxs = sorted(set(np.linspace(0, n - 1, min(n_sample, n)).astype(int)))
    depth_valid_frac, depth_p95 = [], []
    for i in idxs:
        item = ds[int(i)]
        rgb, depth = item["rgb"], item["depth"]
        if not rep.require(np.isfinite(rgb).all(), f"rgb finite (frame {i})"):
            continue
        rep.require(0.0 <= rgb.min() and rgb.max() <= 1.0,
                    f"rgb in [0,1] (frame {i})",
                    f"range [{rgb.min():.3f}, {rgb.max():.3f}]")
        d = depth[np.isfinite(depth)]
        rep.require(d.size > 0 and (d >= 0).all(),
                    f"depth nonnegative (frame {i})",
                    f"min {d.min() if d.size else 'nan'}")
        valid = d[d > 0]
        depth_valid_frac.append(valid.size / max(depth.size, 1))
        if valid.size:
            depth_p95.append(np.percentile(valid, 95))
    if depth_p95:
        p95 = float(np.median(depth_p95))
        vf = float(np.mean(depth_valid_frac))
        status = PASS
        detail = f"p95 {p95:.2f} m, valid fraction {vf:.2f}"
        if p95 > 120.0:
            status, detail = FAIL, (detail + " — depth decodes to >120 m; "
                                    "png_depth_scale is almost certainly "
                                    "wrong for this data")
        elif p95 < 0.05:
            status, detail = FAIL, (detail + " — depth decodes to <5 cm; "
                                    "png_depth_scale likely too large")
        elif vf < 0.3:
            status, detail = WARN, detail + " — mostly empty depth"
        rep.add(status, f"depth scaling plausible ({kind})", detail)
    else:
        rep.add(FAIL, "depth scaling", "no valid depth pixels in any "
                "sampled frame")


def check_poses(rep: Report, ds, kind: str):
    n = len(ds)
    poses, bad_inf = [], []
    for i in range(n):
        c2w = np.asarray(ds.poses[i], np.float64)
        if not np.isfinite(c2w).all():
            bad_inf.append(i)
            continue
        poses.append((i, c2w))
    if bad_inf:
        # the reference ScanNet split carries inf-pose frames; anywhere
        # else a non-finite pose is corrupt data
        status = WARN if kind == "scannet" else FAIL
        rep.add(status, "non-finite poses",
                f"{len(bad_inf)}/{n} frames (first: {bad_inf[:5]}) — "
                + ("ScanNet ships such frames; the tracker skips them"
                   if kind == "scannet" else "corrupt pose data"))
    if not rep.require(len(poses) >= 2, "enough finite poses",
                       f"only {len(poses)} finite of {n}"):
        return
    det_errs, orth_errs = [], []
    for _, c2w in poses:
        R = c2w[:3, :3]
        det_errs.append(abs(np.linalg.det(R) - 1.0))
        orth_errs.append(np.abs(R @ R.T - np.eye(3)).max())
    rep.require(max(det_errs) < 1e-2,
                "rotations proper (det(R)=+1 after OpenGL flips)",
                f"max |det-1| = {max(det_errs):.2e} — pose matrices are "
                "not rigid transforms (wrong layout/convention?)")
    rep.require(max(orth_errs) < 1e-2, "rotations orthonormal",
                f"max |R R^T - I| = {max(orth_errs):.2e}")
    t = np.stack([c2w[:3, 3] for _, c2w in poses])
    steps = np.linalg.norm(np.diff(t, axis=0), axis=1)
    if len(steps):
        med = float(np.median(steps))
        big = int((steps > max(10 * med, 0.5)).sum())
        detail = f"median step {med * 100:.1f} cm, max {steps.max():.2f} m"
        if steps.max() > 5.0:
            rep.add(WARN, "trajectory continuity",
                    detail + f" — {big} jump(s); row/column-major mixups "
                    "or teleports produce exactly this")
        else:
            rep.add(PASS, "trajectory continuity", detail)


# ---------------------------------------------------------------------------
# smoke: downsampled few-frame track+map through the port's SLAM pipeline


class _DownsampledSlice:
    """First-N-finite-pose frames resized to a tiny tracker-friendly grid
    with consistently scaled intrinsics (ray directions rebuilt): colour
    bilinear (cv2 INTER_LINEAR), depth nearest (cv2 INTER_NEAREST)."""

    def __init__(self, ds, frame_ids, H, W):
        import torch
        import torch.nn.functional as F

        from ..data.image_io import resize_linear
        from ..data.rays import get_camera_rays

        self.frames = []
        self.poses = []
        sy, sx = None, None
        for k, i in enumerate(frame_ids):
            item = ds[int(i)]
            h0, w0 = item["depth"].shape
            sy, sx = H / h0, W / w0
            rgb = resize_linear(item["rgb"], W, H)
            depth = F.interpolate(torch.from_numpy(item["depth"])[None, None],
                                  size=(H, W), mode="nearest")[0, 0].numpy()
            self.frames.append({"frame_id": k, "rgb": rgb, "depth": depth,
                                "c2w": item["c2w"]})
            self.poses.append(item["c2w"])
        self.H, self.W = H, W
        self.fx, self.fy = ds.fx * sx, ds.fy * sy
        self.cx, self.cy = ds.cx * sx, ds.cy * sy
        self.num_rays_to_save = int(H * W * 0.1)
        dirs = get_camera_rays(H, W, self.fx, self.fy, self.cx,
                               self.cy).numpy()
        for f in self.frames:
            f["direction"] = dirs

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return self.frames[i]


# the stored camera axes to OpenGL (and back): Y and Z negated
FLIP = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


def oracle_fns(ds, intr8, device):
    """update_fn / agg_fn of a tracker whose update gets ground-truth
    reprojection targets in place of the DROID update (the stand-in for
    droid.pth of tests/test_slam_full.py): the poses of `ds` (its `poses`
    where it has them, else its items') relative to its first frame;
    intr8: the intrinsics at 1/8 of the tracking resolution."""
    import torch

    from ..ops import lie, projective

    poses = getattr(ds, "poses", None)
    if poses is None:
        poses = [ds[i]["c2w"] for i in range(len(ds))]
    G0 = np.asarray(poses[0], np.float64)
    gt = torch.stack([lie.from_matrix(torch.tensor(np.linalg.inv(
        FLIP @ np.linalg.inv(G0) @ np.asarray(c2w, np.float64)
        @ FLIP).astype(np.float32))) for c2w in poses]).to(device)
    intr8 = torch.as_tensor(intr8, dtype=torch.float32, device=device)

    def update_fn(params, state, ii, jj, net, corr, motion, coords1):
        idx = state.timestamps.long().clamp(0, len(gt) - 1)
        tgt, valid = projective.projective_transform(
            gt[idx], state.disps_sens, intr8, ii, jj)
        return net, tgt - coords1, valid.expand(tgt.shape)

    def agg_fn(params, net, ii, mask, n):
        h, w = net.shape[2:]
        return (1e-4 * torch.ones((net.shape[0], h, w), device=device),
                torch.zeros((net.shape[0], 576, h, w), device=device))

    return update_fn, agg_fn


class OracleMNESLAM(MNESLAM):
    """`MNESLAM` with `oracle_fns` as its tracker update, built from its
    own config (the edge-aware tracking intrinsics at 1/8) and dataset.
    Set `slam.MNESLAM` to it to run `cli.main` with the oracle."""

    def __init__(self, config, dataset, device="cuda", **kw):
        from ..device import resolve_device

        cam = config["cam"]
        he, we = int(cam.get("H_edge", 0)), int(cam.get("W_edge", 0))
        sx = (cam["W_out"] + 2 * we) / cam["W"]
        sy = (cam["H_out"] + 2 * he) / cam["H"]
        intr8 = [cam["fx"] * sx / 8, cam["fy"] * sy / 8,
                 (cam["cx"] * sx - we) / 8, (cam["cy"] * sy - he) / 8]
        update_fn, agg_fn = oracle_fns(dataset, intr8,
                                       resolve_device(device))
        super().__init__(config, dataset, device=device,
                         update_fn=update_fn, agg_fn=agg_fn, **kw)


def run_smoke(rep: Report, ds, n_frames: int, out_dir: str, device):
    from ..config import make_config

    finite = [i for i in range(len(ds))
              if np.isfinite(np.asarray(ds.poses[i])).all()][:n_frames]
    if not rep.require(len(finite) >= 3, "smoke: enough usable frames",
                       f"{len(finite)} finite-pose frames"):
        return

    # smallest grid the tracker's 4-level correlation pyramid supports
    # (1/8-res 8x12 halves down to 1x1; anything narrower hits an empty
    # level)
    H, W = 64, 96
    sub = _DownsampledSlice(ds, finite, H, W)

    # scene bound from the actual data: camera positions + backprojected
    # depth extents, padded; a wrong bound is the most common config error
    pts = []
    for f in sub.frames:
        c2w = np.asarray(f["c2w"], np.float64)
        pts.append(c2w[:3, 3])
        d = f["depth"]
        m = np.isfinite(d) & (d > 0)
        if m.any():
            ray = f["direction"][m] * d[m][..., None]
            pts.append((c2w[:3, :3] @ ray.T + c2w[:3, 3:4]).T)
    pts = np.concatenate([np.atleast_2d(p) for p in pts], axis=0)
    lo, hi = pts.min(axis=0) - 0.5, pts.max(axis=0) + 0.5
    extent = float((hi - lo).max())
    fine = max(extent / 24.0, 0.02)
    bound = [[float(a), float(b)] for a, b in zip(lo, hi)]

    cfg = make_config({
        "mode": "slam",
        "data": {"output": out_dir, "exp_name": "smoke"},
        "mapping": {
            "bound": bound, "marching_cubes_bound": bound,
            "sample": 192, "min_pixels_cur": 48, "first_iters": 40,
            "iters": 8, "keyframe_every": 1, "global_ba_every": 1000,
        },
        "planes_res": {"coarse": 2 * fine, "fine": fine,
                       "bound_dividable": 2 * fine},
        "cam": {"H": H, "W": W, "fx": sub.fx, "fy": sub.fy,
                "cx": sub.cx, "cy": sub.cy, "H_out": H, "W_out": W,
                "near": 0.0, "far": float(extent * 2)},
        "training": {"n_range_d": 9, "n_samples_d": 8, "range_d": 0.25,
                     "trunc": max(0.15, fine * 4)},
        "model": {"c_dim": 16, "input_ch": 32, "input_ch_pos": 48,
                  "truncation": max(0.15, fine * 4)},
        "meshing": {"resolution": max(extent / 20.0, 0.1)},
        "tracking": {
            "buffer": max(len(sub) + 4, 12), "warmup": 3, "upsample": False,
            "motion_filter": {"thresh": -1.0},
            "frontend": {"enable_loop": False, "keyframe_thresh": -1.0,
                         "window": 8, "radius": 1, "max_factors": 24,
                         "nms": 0, "thresh": 25.0},
        },
        "loop_detection": {"enabled": False},
    })
    slam = OracleMNESLAM(cfg, sub, rank=0, device=device)
    results = slam.run_slam()

    rep.require(slam.tracker.counter >= min(3, len(sub)),
                "smoke: keyframes tracked",
                f"only {slam.tracker.counter}")
    rep.require(slam.map_counter >= 1, "smoke: keyframes mapped",
                f"{slam.map_counter}")
    poses = slam.tracker.state.poses[:slam.tracker.counter].cpu().numpy()
    rep.require(np.isfinite(poses).all(), "smoke: tracked poses finite")
    ate = results.get("ate", {}).get("rmse", np.inf)
    rep.add(PASS if ate < 0.10 else (WARN if ate < 0.5 else FAIL),
            "smoke: trajectory vs dataset GT",
            f"ATE RMSE {ate * 100:.1f} cm (oracle targets — validates the "
            "data path, not the learned tracker)")
    losses = [float(m["loss"]) for m in slam.metrics_log if "loss" in m]
    if len(losses) >= 2:
        rep.require(np.isfinite(losses).all() and losses[-1] < losses[0] * 2,
                    "smoke: mapping loss sane",
                    f"first {losses[0]:.4f} -> last {losses[-1]:.4f}")


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("datadir", help="dataset directory")
    ap.add_argument("--kind",
                    choices=["replica", "scannet", "indoor", "outdoor",
                             "tum"],
                    help="dataset layout (or pass --config)")
    ap.add_argument("--config", help="scene yaml — supplies intrinsics, "
                    "depth scale, crop; its dataset:/datadir: are "
                    "overridden by the CLI args")
    ap.add_argument("--smoke-frames", type=int, default=5)
    ap.add_argument("--no-smoke", action="store_true",
                    help="structure/convention checks only")
    ap.add_argument("--out", default=os.path.join("output",
                                                  "validate_dataset"),
                    help="smoke output directory")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the smoke (default cuda; cpu only "
                         "when asked)")
    args = ap.parse_args(argv)

    from ..config import default_config, deep_update, load_config
    from ..data import datasets
    from ..data.image_io import imread_unchanged

    rep = Report()
    if args.config:
        cfg = deep_update(default_config(), load_config(args.config))
    else:
        cfg = default_config()
    kind = args.kind or cfg.get("dataset")
    if kind in (None, "synthetic"):
        rep.add(FAIL, "kind", "pass --kind or a --config whose dataset: "
                "names a real loader")
        sys.exit(1)
    cfg["dataset"] = kind
    cfg.setdefault("data", {})["datadir"] = args.datadir

    ok = check_structure(rep, args.datadir, kind)
    if kind == "tum" and ok:
        check_tum_association(rep, args.datadir)

    ds = None
    if ok:
        if not args.config:
            # infer cam geometry from the first frame so structure-only
            # runs work without a yaml (intrinsics default to a centered
            # pinhole — fine for checks, reported so nobody trusts them)
            probe = {
                "replica": "results/depth*.png", "outdoor":
                "results/depth*.png", "scannet": "depth/*.png",
                "indoor": "depth_holefilling/*.png",
            }
            if kind == "tum":
                with open(os.path.join(args.datadir, "depth.txt")) as f:
                    rel = next(line.split()[1] for line in f
                               if line.strip() and not line.startswith("#"))
                first = os.path.join(args.datadir, rel)
            else:
                first = sorted(glob.glob(os.path.join(args.datadir,
                                                      probe[kind])))[0]
            h0, w0 = imread_unchanged(first).shape[:2]
            cfg["cam"].update({"H": h0, "W": w0, "fx": 0.6 * w0,
                               "fy": 0.6 * w0, "cx": w0 / 2 - 0.5,
                               "cy": h0 / 2 - 0.5})
            rep.add(WARN, "intrinsics", "no --config given — using a "
                    f"centered-pinhole placeholder (fx {0.6 * w0:.0f}); "
                    "pass your scene yaml to validate real intrinsics")
        try:
            ds = datasets.get_dataset(cfg)
        except Exception as e:  # loader-level structural failure
            rep.add(FAIL, "loader", f"{type(e).__name__}: {e}")
    if ds is not None and len(ds) == 0:
        rep.add(FAIL, "loader", "dataset resolved to 0 frames "
                "(index window? file patterns?)")
        ds = None
    if ds is not None:
        rep.add(PASS, "loader", f"{len(ds)} frames")
        check_intrinsics(rep, ds, cfg)
        check_frames(rep, ds, kind)
        check_poses(rep, ds, kind)
        if not args.no_smoke and rep.n_fail == 0:
            from ..device import resolve_device

            run_smoke(rep, ds, args.smoke_frames, args.out,
                      resolve_device(args.device))
        elif not args.no_smoke:
            rep.add(WARN, "smoke", "skipped — fix the failures above first")

    print(json.dumps({"failures": rep.n_fail, "warnings": rep.n_warn,
                      "checks": len(rep.rows)}))
    if rep.n_fail:
        print(f"NOT READY: {rep.n_fail} failure(s)", file=sys.stderr)
        sys.exit(1)
    print("READY: dataset validates" + ("" if args.no_smoke
                                        else " and smoke-runs") + " cleanly")
    return rep


if __name__ == "__main__":
    main()
