"""Inter-agent loop-closure traffic: render alignments between two maps.

Each step is one closure as `agents/runner.AgentCollaboration.
handle_loop_closure` makes it: `agents/fusion.align_pose_by_render` with
`mapping.sample` camera rays drawn for the closure, `mapping.loop_iters`
iterations, the configuration's `lr_rot`, `lr_trans`, `rgb_weight`,
`depth_weight` and `rot_rep`, then the caller's readback of the aligned
pose. The two frozen maps (agent 0's, the base, and agent 1's, the
target) are drawn from the seed at the configuration's table shapes, with
the shape of a trained map of one room: the SDF decoder's first two
hidden units carry an SDF that is positive inside an ellipsoid inscribed
in the mapping bound and negative outside it (`room_sdf`), through the
OneBlob encoding, so that every ray from inside crosses the surface once;
everything else (planes, the colour decoder, the other hidden units) is
random. Agent 1's planes are agent 0's plus a quarter of an independent
draw, so the alignment has its minimum near the true pose. On maps that
are random throughout the loss rose on about half of the 100 steps and
the aligned pose followed rounding (see PERF.md). The closures cycle
through `pairs` base / target keyframe pairs made in set-up: base poses
on agent 0's loop through the box room, each target pose the base pose
perturbed by a rotation of `rot_perturb_rad` about a random axis and a
translation of `trans_perturb_m` in a random direction, more than Adam
can close in `loop_iters` steps of `lr_rot` / `lr_trans`.

After the window the reference aligns `check_closures` of the window's
closures, drawn from the seed, and each is compared: the largest element
gap of the aligned pose, and the relative gaps of the best and the first
loss.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..harness import derive_seed
from ..reference import closure as ref_closure
from ..reference import mapping as ref_mapping
from ..reference import scene as ref_scene
from ..roofline import counts
from ..scene import boxroom, maps

SEED_BASE, SEED_TARGET, SEED_PAIRS, SEED_RAYS, SEED_CHECK = 11, 12, 13, \
    14, 15
TARGET_NOISE = 0.25
FAULTS = ("state_unchanged", "half_batch", "answer_altered")


def port_params(weights: Dict[str, torch.Tensor]) -> Dict:
    """{"planes/xy/0": t, ...} -> the port's tree {"planes": {"xy": [..]},
    "decoder": {"sdf": [..], "color": [..]}}."""
    tree: Dict = {}
    for path in sorted(weights):
        group, name, i = path.split("/")
        tree.setdefault(group, {}).setdefault(name, []).append(
            (int(i), weights[path]))
    return {g: {n: [t for _, t in sorted(lst)] for n, lst in d.items()}
            for g, d in tree.items()}


def _rotation(axis: np.ndarray, angle: float) -> np.ndarray:
    a = axis / np.linalg.norm(axis)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + math.sin(angle) * K + (1 - math.cos(angle)) * K @ K


def make_pairs(ctx):
    """[(base c2w, target c2w, camera directions [sample, 3])] on the
    device, from the seed."""
    cfg, tr = ctx.cfg, ctx.traffic
    n = int(tr["pairs"])
    bound = np.asarray(cfg["mapping"]["bound"], np.float64)
    scene = ctx.assumed["scene"]
    rng = np.random.default_rng(derive_seed(ctx.seed, SEED_PAIRS))
    centre = torch.tensor(bound.mean(1), dtype=torch.float32)
    base = boxroom.loop_poses(n, centre, float(scene["radius_m"]),
                              float(rng.uniform(0, 2 * math.pi)), "cpu")
    cam = cfg["cam"]
    dirs = boxroom.camera_dirs(int(cam["H"]), int(cam["W"]),
                               float(cam["fx"]), float(cam["fy"]),
                               float(cam["cx"]), float(cam["cy"]),
                               ctx.device).reshape(-1, 3)
    rays = np.random.default_rng(derive_seed(ctx.seed, SEED_RAYS))
    pairs = []
    for k in range(n):
        b = base[k].double().numpy()
        t = b.copy()
        t[:3, :3] = _rotation(rng.normal(size=3),
                              float(tr["rot_perturb_rad"])) @ b[:3, :3]
        d = rng.normal(size=3)
        t[:3, 3] += float(tr["trans_perturb_m"]) * d / np.linalg.norm(d)
        idx = torch.as_tensor(rays.integers(0, dirs.shape[0],
                                            int(cfg["mapping"]["sample"])),
                              device=ctx.device)
        pairs.append((torch.tensor(b, dtype=torch.float32,
                                   device=ctx.device),
                      torch.tensor(t, dtype=torch.float32,
                                   device=ctx.device),
                      dirs[idx].contiguous()))
    return pairs


def room_sdf(cfg, w: Dict[str, torch.Tensor]):
    """Give the SDF decoder of `w` (in place) an ellipsoidal room: hidden
    unit 0 = sum over axes and OneBlob bins of (1/3 - ((centre of the bin
    - centre of the bound) / (0.9 half extent))^2) x the bin's encoding,
    hidden unit 1 its negative, and the SDF output relu(unit 0) -
    relu(unit 1) = unit 0; about 1 - |scaled offset|^2, as the OneBlob
    bins sum to about 1."""
    C = int(cfg["model"]["c_dim"])
    n_bins = int(cfg["pos"]["n_bins"])
    bound = torch.tensor(cfg["mapping"]["bound"], dtype=torch.float64)
    lo, hi = bound[:, 0], bound[:, 1]
    centre, half = 0.5 * (lo + hi), 0.45 * (hi - lo)
    t = (torch.arange(n_bins, dtype=torch.float64) + 0.5) / n_bins
    at = lo[:, None] + t[None, :] * (hi - lo)[:, None]        # [3, bins]
    coef = (1.0 / 3.0 - ((at - centre[:, None]) / half[:, None]) ** 2)
    w0, w1 = w["decoder/sdf/0"], w["decoder/sdf/1"]
    unit = torch.zeros(w0.shape[0], dtype=torch.float64)
    unit[2 * C:2 * C + 3 * n_bins] = coef.reshape(-1)
    w0[:, 0] = unit.to(w0)
    w0[:, 1] = -unit.to(w0)
    w1[:, 0] = 0.0
    w1[0, 0], w1[1, 0] = 1.0, -1.0


def maps_for(ctx):
    shapes = ref_scene.param_shapes(ctx.cfg)
    base = maps.draw(shapes, derive_seed(ctx.seed, SEED_BASE), ctx.device)
    room_sdf(ctx.cfg, base)
    noise = maps.draw(shapes, derive_seed(ctx.seed, SEED_TARGET), ctx.device)
    target = {k: base[k] + TARGET_NOISE * noise[k] if k.startswith("planes/")
              else base[k] for k in base}
    return base, target


def setup(ctx):
    from mneslam_tpu_torch.agents import fusion
    from mneslam_tpu_torch.models.scene_rep import SceneRep
    from mneslam_tpu_torch.device import resolve_device

    ref_mapping.check_supported(ctx.cfg)
    resolve_device(ctx.device)
    w_base, w_target = maps_for(ctx)
    state = {"scene_b": SceneRep(ctx.cfg, ctx.device),
             "scene_t": SceneRep(ctx.cfg, ctx.device),
             "params_b": port_params(w_base),
             "params_t": port_params(w_target),
             "pairs": make_pairs(ctx), "next": 0, "results": [],
             "align": fusion.align_pose_by_render}
    plant(ctx, state)
    return state


def plant(ctx, state):
    """Tests and calibration: break the timed path underneath."""
    align = state["align"]
    if ctx.fault == "answer_altered":
        def altered(*a, **k):
            c2w, best, init = align(*a, **k)
            c2w = c2w.clone()
            c2w[:3, 3] += 1e-3
            return c2w, best, init
        state["align"] = altered
    elif ctx.fault == "half_batch":
        def half(sb, pb, st, pt, base, target, dirs, **k):
            return align(sb, pb, st, pt, base, target,
                         dirs[:dirs.shape[0] // 2], **k)
        state["align"] = half
    elif ctx.fault == "state_unchanged":
        def frozen_pose(*a, **k):
            return align(*a, **dict(k, lr_rot=0.0, lr_trans=0.0))
        state["align"] = frozen_pose
    elif ctx.fault is not None:
        raise ValueError(f"no fault {ctx.fault!r} for closure traffic")


def _args(ctx):
    cfg = ctx.cfg
    return dict(iters=int(cfg["mapping"]["loop_iters"]),
                lr_rot=float(cfg["mapping"]["lr_rot"]),
                lr_trans=float(cfg["mapping"]["lr_trans"]),
                rgb_weight=float(cfg["training"]["rgb_weight"]),
                depth_weight=float(cfg["training"]["depth_weight"]),
                rot_rep=cfg["training"]["rot_rep"])


def step(ctx, state) -> int:
    """One closure, read back as the caller reads it -> 1."""
    k = state["next"] % len(state["pairs"])
    base, target, dirs = state["pairs"][k]
    c2w, best, init = state["align"](
        state["scene_b"], state["params_b"], state["scene_t"],
        state["params_t"], base, target, dirs, **_args(ctx))
    state["results"].append((k, c2w.detach().cpu().numpy(), float(best),
                             float(init)))
    state["next"] += 1
    return 1


def full(ctx, state) -> bool:
    return False


def end_to_end(ctx, state, work, steps, window_s) -> Dict[str, float]:
    return {"closure_ms": 1e3 * window_s / steps}


def outcome(ctx, state, steps) -> Tuple[int, int]:
    """(closures in the window, those whose pose or loss is not finite)."""
    window = state["window"] = state["results"][-steps:] if steps else []
    return steps, sum(1 for r in window if not (np.isfinite(r[1]).all()
                                               and math.isfinite(r[2])))


def trace_begin(ctx, state):
    """A span around the teacher render (the base map's `render_rays`)."""
    scene_b = state["scene_b"]
    render = scene_b.render_rays

    def spanned(*a, **k):
        with ctx.spans.span("teacher"):
            return render(*a, **k)

    scene_b.render_rays = spanned


def trace_end(ctx, state) -> Dict:
    state["scene_b"].__dict__.pop("render_rays")
    per = counts.alignment_flops(ctx.cfg, int(ctx.cfg["mapping"]["sample"]),
                                 int(ctx.cfg["mapping"]["loop_iters"]))
    return {"flops_per_work": per,
            "iterations_per_step": int(ctx.cfg["mapping"]["loop_iters"])}


def release(ctx, state) -> Dict:
    """Free the program; keep the window's closures and their inputs."""
    keep = {"window": state["window"], "pairs": state["pairs"]}
    state.clear()
    return keep


def reference(ctx, kept, k: int, tf32: bool = False) -> Dict:
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        w_base, w_target = maps_for(ctx)
        base, target, dirs = kept["pairs"][k]
        a = _args(ctx)
        return ref_closure.align(
            ctx.cfg, ref_scene.Scene(ctx.cfg, ctx.device),
            w_base, w_target, base, target, dirs, a["rgb_weight"],
            a["depth_weight"], a["iters"], a["lr_rot"], a["lr_trans"])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def compare(got, ref: Dict) -> Dict[str, float]:
    """pose_gap: the largest element gap of the aligned c2w (rotation
    entries, translation in m); best_loss_gap and init_loss_gap: relative
    gaps of the losses."""
    _, c2w, best, init = got
    return {"pose_gap": float(np.abs(c2w - ref["c2w"].numpy()).max()),
            "best_loss_gap": abs(best - ref["best_loss"])
            / abs(ref["best_loss"]),
            "init_loss_gap": abs(init - ref["init_loss"])
            / abs(ref["init_loss"])}


def check_sample(ctx, kept):
    """The window's closures that the reference replays, drawn from the
    seed (all of them when there are fewer)."""
    results = kept["window"]
    n = min(int(ctx.traffic["check_closures"]), len(results))
    rng = np.random.default_rng(derive_seed(ctx.seed, SEED_CHECK))
    return [results[i] for i in sorted(rng.choice(len(results), n,
                                                  replace=False))]


def check(ctx, kept) -> Dict[str, float]:
    worst: Dict[str, float] = {}
    for got in check_sample(ctx, kept):
        for name, v in compare(got, reference(ctx, kept, got[0])).items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst


def control(ctx) -> Dict[str, float]:
    """The control: the reference in TF32 in the program's place, on the
    first `check_closures` pairs."""
    kept = {"pairs": make_pairs(ctx)}
    worst: Dict[str, float] = {}
    for k in range(min(int(ctx.traffic["check_closures"]),
                       len(kept["pairs"]))):
        low = reference(ctx, kept, k, tf32=True)
        got = (k, low["c2w"].numpy(), low["best_loss"], low["init_loss"])
        for name, v in compare(got, reference(ctx, kept, k)).items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst
