"""Mapping-only traffic: keyframes at their ground-truth poses.

Drives `mneslam_tpu_torch.slam.MNESLAM` in `mode: mapping` the way
`run_mapping_only` does, one keyframe at a time through `_map_keyframe`
(`Mapper.add_keyframe`, `Mapper.optimize` for `mapping.iters` iterations,
the late readback of the previous keyframe's metrics and the bookkeeping),
on box-room frames made on the device in set-up and handed over as the
port's datasets hand them (every `keyframe_every`-th frame is a keyframe).

Two keyframes are checked, each by what its first three Adam steps
produced: each step's loss, the first gradient as Adam got it, and each
leaf's change after three steps. Set-up maps the first keyframe
(`mapping.first_iters` iterations) from weights and a generator drawn from
the seed, its database one slot. After the window (and the peak memory's
reading) one more keyframe goes through the same call, its database every
keyframe mapped so far, each slot with its own pose: the check keyframe.
The reference replays the first keyframe from the seed's weights, and the
check keyframe from the map and Adam's moments as the program had them
when it started (the reference cannot follow the window's thousands of
steps), with the database rebuilt from the seed's frames and draws.

Traffic keys: `distinct_keyframes` frames on a closed loop, used in turn;
`capacity_keyframes` slots in the keyframe database (the window ends when
all but the check keyframe's are full); `trace_steps` keyframes in a
traced window.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..harness import derive_seed
from ..reference import mapping as ref_mapping
from ..reference import scene as ref_scene
from ..roofline import counts
from ..scene import boxroom, maps

CAPTURED = 3      # the first steps the reference replays
SEED_FRAMES, SEED_WEIGHTS, SEED_DRAWS = 1, 2, 3
FAULTS = ("state_unchanged", "half_batch")


class Frames:
    """The dataset the port's `MNESLAM` is built with (its length and
    `num_rays_to_save`); every frame id maps to one of the distinct frames
    made in set-up, handed to `_map_keyframe` on the device."""

    def __init__(self, frames: Dict[str, torch.Tensor], every: int,
                 capacity: int, rays_to_save: int):
        self.frames = frames
        self.every = every
        self.n = frames["rgb"].shape[0]
        self.length = every * capacity
        self.num_rays_to_save = rays_to_save

    def __len__(self):
        return self.length

    def device_frame(self, idx: int):
        k = (idx // self.every) % self.n
        return ({"direction": self.frames["direction"],
                 "rgb": self.frames["rgb"][k],
                 "depth": self.frames["depth"][k]}, self.frames["c2w"][k])


def leaf_paths(params) -> Dict[str, torch.Tensor]:
    """The port's parameter tree as {"planes/xy/0": leaf, ...}."""
    from mneslam_tpu_torch.models.scene_rep import param_items

    return {"/".join(str(k) for k in path): leaf
            for path, leaf in param_items(params)}


def load_weights(params, weights: Dict[str, torch.Tensor]):
    leaves = leaf_paths(params)
    if sorted(leaves) != sorted(weights) or any(
            tuple(leaves[k].shape) != tuple(weights[k].shape)
            for k in leaves):
        raise ValueError(
            "the program's map does not have the configuration's shapes: "
            f"{ {k: tuple(v.shape) for k, v in leaves.items()} } against "
            f"{ {k: tuple(v.shape) for k, v in weights.items()} }")
    with torch.no_grad():
        for k, leaf in leaves.items():
            leaf.copy_(weights[k])


def snapshot(slam) -> Dict[str, Dict]:
    """The map and Adam's moments as they stand, by leaf (copies)."""
    opt = slam.map_state.optimizer
    leaves = leaf_paths(slam.map_state.params)
    out = {"weights": {k: p.detach().clone() for k, p in leaves.items()}}
    if all(p in opt.state for p in leaves.values()):
        for key in ("exp_avg", "exp_avg_sq"):
            out[key] = {k: opt.state[p][key].clone()
                        for k, p in leaves.items()}
        out["step"] = {k: int(float(opt.state[p]["step"]))
                       for k, p in leaves.items()}
    return out


class Capture:
    """The first CAPTURED steps of the next keyframe's `optimize`: each
    step's loss (device scalars), the first gradient's norm per leaf as
    Adam gets it (the L2 term of its group added), and each leaf's change
    from `weights` after the last captured step."""

    def __init__(self, slam, weights):
        self.losses, self.grad_norm, self.change_norm = [], {}, {}
        self.mapper = slam.mapper
        self.opt = slam.map_state.optimizer
        self.leaves = leaf_paths(slam.map_state.params)
        self.w0 = weights
        self.n = 0
        step = self.mapper.step

        def recording_step(*a, **k):
            out = step(*a, **k)
            if len(self.losses) < CAPTURED:
                self.losses.append(out["loss"].detach().clone())
            return out

        self.mapper.step = recording_step
        self.pre = self.opt.register_step_pre_hook(self._before_step)
        self.hook = self.opt.register_step_post_hook(self._after_step)

    def _before_step(self, opt, args, kwargs):
        self.pre.remove()
        decay = {id(p): g["weight_decay"] for g in opt.param_groups
                 for p in g["params"]}
        with torch.no_grad():
            for k, p in self.leaves.items():
                self.grad_norm[k] = (p.grad + decay[id(p)] * p).norm()

    def _after_step(self, opt, args, kwargs):
        self.n += 1
        if self.n == CAPTURED:
            with torch.no_grad():
                for k, p in self.leaves.items():
                    self.change_norm[k] = (p - self.w0[k]).norm()
            self.hook.remove()

    def finish(self) -> Dict:
        del self.mapper.step
        self.pre.remove()
        self.hook.remove()
        return {"loss": [float(x) for x in self.losses],
                "grad_norm": {k: float(v) for k, v in self.grad_norm.items()},
                "change_norm": {k: float(v)
                                for k, v in self.change_norm.items()}}


def plant(ctx, slam):
    """Tests and calibration: break the timed path underneath."""
    if ctx.fault == "state_unchanged":
        opt = slam.map_state.optimizer
        saved = {}

        def before(o, a, k):
            saved["p"] = [p.detach().clone() for g in o.param_groups
                          for p in g["params"]]

        def after(o, a, k):
            with torch.no_grad():
                for p, q in zip((p for g in o.param_groups
                                 for p in g["params"]), saved["p"]):
                    p.copy_(q)

        opt.register_step_pre_hook(before)
        opt.register_step_post_hook(after)
    elif ctx.fault == "half_batch":
        build = slam.mapper._build_rays

        def half(*a, **k):
            batch = build(*a, **k)
            n = batch[0].shape[0] // 2
            return tuple(t[:n] for t in batch)

        slam.mapper._build_rays = half
    elif ctx.fault is not None:
        raise ValueError(f"no fault {ctx.fault!r} for mapping traffic")


def setup(ctx):
    from mneslam_tpu_torch.slam import MNESLAM

    cfg, tr = ctx.cfg, ctx.traffic
    cfg["mode"] = "mapping"
    cfg["data"]["output"] = ctx.out_dir
    ref_mapping.check_supported(cfg)
    every = int(cfg["mapping"]["keyframe_every"])
    frames = boxroom.make_frames(cfg, ctx.assumed["scene"],
                                 int(tr["distinct_keyframes"]),
                                 derive_seed(ctx.seed, SEED_FRAMES), ctx.device)
    ds = Frames(frames, every, int(tr["capacity_keyframes"]),
                ref_mapping.rays_per_keyframe(cfg))
    slam = MNESLAM(cfg, ds, device=ctx.device)
    weights = maps.draw(ref_scene.param_shapes(cfg),
                        derive_seed(ctx.seed, SEED_WEIGHTS), ctx.device)
    load_weights(slam.map_state.params, weights)
    slam.generator = torch.Generator(device=ctx.device)
    slam.generator.manual_seed(derive_seed(ctx.seed, SEED_DRAWS))
    plant(ctx, slam)
    capture = Capture(slam, weights)
    frame, pose = ds.device_frame(0)
    slam._map_keyframe(0, frame, pose, first=True)
    captured = capture.finish()
    del weights, capture
    return {"slam": slam, "ds": ds, "next": 1, "captured": captured}


def step(ctx, state) -> int:
    """One keyframe -> its mapping iterations."""
    i = state["next"]
    frame, pose = state["ds"].device_frame(i * state["ds"].every)
    state["slam"]._map_keyframe(i * state["ds"].every, frame, pose,
                                first=False)
    state["next"] = i + 1
    return int(ctx.cfg["mapping"]["iters"])


def full(ctx, state) -> bool:
    db = state["slam"].map_state.db
    return db.count >= db.rays.shape[0] - 1     # the check keyframe's slot


def end_to_end(ctx, state, work, steps, window_s) -> Dict[str, float]:
    return {"map_iters_per_s": work / window_s}


def outcome(ctx, state, steps) -> Tuple[int, int]:
    """(keyframes mapped in the window, those whose loss is not finite)."""
    slam = state["slam"]
    slam._flush_metrics()
    log = slam.metrics_log[-steps:] if steps else []
    return steps, sum(1 for m in log if not np.isfinite(m["loss"]))


def trace_begin(ctx, state):
    """Spans around `Mapper.optimize` (into whichever `ctx.spans` is
    current), and each kernel-1 call's index and widths kept with the
    spans it ran under (references only: nothing is launched), for its
    bound."""
    from mneslam_tpu_torch.ops import interp

    mapper = state["slam"].mapper
    optimize = mapper.optimize

    def spanned(*a, **k):
        with ctx.spans.span("optimize"):
            return optimize(*a, **k)

    mapper.optimize = spanned
    calls = state["calls"] = []
    scatter = interp.scatter_add_rows

    def recording(idx, vals, n_rows):
        calls.append((ctx.spans, idx, vals.shape[1], vals.element_size(),
                      idx.element_size()))
        return scatter(idx, vals, n_rows)

    interp.scatter_add_rows = recording
    state["restore"] = lambda: (setattr(interp, "scatter_add_rows", scatter),
                                mapper.__dict__.pop("optimize"))


def trace_end(ctx, state) -> Dict:
    state.pop("restore")()
    slam = state["slam"]
    n_params = sum(p.numel() for p in leaf_paths(
        slam.map_state.params).values())
    k1 = []
    for spans, idx, width, vb, ib in state.pop("calls"):
        if spans is not ctx.spans:        # not the profiled phase's
            continue
        touched = int(torch.unique(idx).numel())
        k1.append(counts.scatter_rows_bytes(idx.numel(), width, vb, ib,
                                            touched))
    per_iter = counts.mapping_iteration_flops(ctx.cfg, n_params)
    return {"k1_bytes": k1, "flops_per_work": per_iter,
            "iterations_per_step": int(ctx.cfg["mapping"]["iters"])}


def release(ctx, state) -> Dict:
    """Map the check keyframe through the window's call, capturing its
    first steps; then free the program and keep the captured numbers."""
    slam = state["slam"]
    index = state["next"]
    start = snapshot(slam)
    capture = Capture(slam, start["weights"])
    step(ctx, state)
    keep = {"captured": state["captured"], "late": capture.finish(),
            "late_start": start, "late_index": index}
    slam.timers.close()
    state.clear()
    return keep


def slot_frames(ctx, index: int):
    """The distinct frame of each database slot up to keyframe `index`."""
    n = int(ctx.traffic["distinct_keyframes"])
    return [j % n for j in range(index + 1)]


def reference(ctx, kept, frames, late: bool, tf32: bool = False) -> Dict:
    """The reference's first steps on the first keyframe (from the seed's
    weights) or on the check keyframe (from the program's map and moments
    as it started), on the seed's frames and draws (with `tf32`: the
    control, the reference in TF32)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        if late:
            start, slots = kept["late_start"], slot_frames(
                ctx, kept["late_index"])
        else:
            start = {"weights": maps.draw(ref_scene.param_shapes(ctx.cfg),
                                          derive_seed(ctx.seed, SEED_WEIGHTS),
                                          ctx.device)}
            slots = [0]
        return ref_mapping.keyframe_steps(ctx.cfg, start, frames, slots,
                                          derive_seed(ctx.seed, SEED_DRAWS),
                                          CAPTURED)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def seed_frames(ctx):
    return boxroom.make_frames(ctx.cfg, ctx.assumed["scene"],
                               int(ctx.traffic["distinct_keyframes"]),
                               derive_seed(ctx.seed, SEED_FRAMES), ctx.device)


def compare(got: Dict, ref: Dict, prefix: str = "") -> Dict[str, float]:
    """loss_gap: the largest relative gap of a step's loss; grad_gap and
    change_gap: the largest gap between a leaf's norm and the reference's,
    over the larger of that leaf's norm and the median leaf's. Leaves
    whose reference gradient is under a thousandth of the median leaf's
    move by round-off alone and are left out of change_gap."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["loss"],
                                                       ref["loss"])) \
        if len(got["loss"]) == len(ref["loss"]) else float("inf")

    def gap(a, b, keys):
        if not keys or any(k not in a for k in keys):
            return float("inf")
        med = ref_mapping.median([b[k] for k in keys])
        return max(abs(a[k] - b[k]) / max(b[k], med) for k in keys)

    g_ref = ref["grad_norm"]
    g_med = ref_mapping.median(list(g_ref.values()))
    moving = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    return {prefix + "loss_gap": loss_gap,
            prefix + "grad_gap": gap(got["grad_norm"], g_ref, list(g_ref)),
            prefix + "change_gap": gap(got["change_norm"], ref["change_norm"],
                                       moving)}


def check(ctx, kept) -> Dict[str, float]:
    """The first keyframe's numbers, and the check keyframe's (late_*)."""
    frames = seed_frames(ctx)
    return {**compare(kept["captured"], reference(ctx, kept, frames, False)),
            **compare(kept["late"], reference(ctx, kept, frames, True),
                      "late_")}


def control(ctx, window_steps: int = 2) -> Dict[str, float]:
    """The control: the reference in TF32 in the program's place, on the
    first keyframe and on a check keyframe after `window_steps` keyframes
    of the window (the program runs to give the check keyframe's start)."""
    state = setup(ctx)
    for _ in range(1 + window_steps):             # the warm step, the window
        step(ctx, state)
    kept = release(ctx, state)
    del state
    frames = seed_frames(ctx)
    out = {}
    for late, prefix in ((False, ""), (True, "late_")):
        out.update(compare(reference(ctx, kept, frames, late, tf32=True),
                           reference(ctx, kept, frames, late), prefix))
    return out
