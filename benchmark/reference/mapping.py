"""The plain reference of the mapper's first steps on a keyframe.

Each keyframe stores a sample of its pixels as rays (direction, colour,
depth) in the next slot of the keyframe database, with its pose; each
iteration draws `mapping.sample` rays uniformly over every stored ray of
every slot and `mapping.min_pixels_cur` pixels of the current frame,
samples depths along them (`scene.depth_guided_z`, jittered), renders them
(a stored ray from the pose of its slot) and takes one Adam step on the
loss. Adam (betas 0.9 / 0.99) has two groups: the decoder at `lr_decoder`
with an L2 term of 1e-6 added to the gradient and eps 1e-8, the planes at
`lr_embed` with eps 1e-15; its moments and step count carry over from one
keyframe to the next.

The draws come from a generator seeded as the program's, in the order the
method takes them: for each keyframe its pixels, then for each of its
iterations (`first_iters` on the first keyframe, `iters` after) the global
rays, the current pixels and the jitter uniforms. The draws of the
keyframes before the replayed one are made again, not computed with.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import scene as scene_lib

BETAS = (0.9, 0.99)
DECODER_L2 = 1e-6


def check_supported(cfg):
    """The options this reference implements; anything else raises."""
    tr = cfg["training"]
    need = {"grid.oneGrid": bool(cfg["grid"]["oneGrid"]),
            "training.is_co_sdf": bool(tr.get("is_co_sdf", True)),
            "training.n_importance == 0": int(tr.get("n_importance", 0)) == 0,
            "training.smooth_weight == 0":
                float(tr.get("smooth_weight", 0)) == 0,
            "render_dtype float32":
                str(tr.get("render_dtype", "float32")) == "float32",
            "pos.enc OneBlob": "blob" in str(cfg["pos"]["enc"]).lower(),
            "mapping.filter_depth off":
                not bool(cfg["mapping"].get("filter_depth", False))}
    bad = [k for k, ok in need.items() if not ok]
    if bad:
        raise ValueError(f"the reference does not implement: {bad}")


def rays_per_keyframe(cfg) -> int:
    return int(cfg["cam"]["H"] * cfg["cam"]["W"] * cfg["mapping"]["n_pixels"])


def adam(params, grads, m, v, steps, groups):
    """One Adam step in place on lists of tensors; `steps[i]` = leaf i's
    step count with this step, `groups[i]` = (lr, eps, l2) of leaf i."""
    b1, b2 = BETAS
    for i, p in enumerate(params):
        lr, eps, l2 = groups[i]
        g = grads[i] + l2 * p if l2 else grads[i]
        m[i].mul_(b1).add_(g, alpha=1 - b1)
        v[i].mul_(b2).addcmul_(g, g, value=1 - b2)
        c1, c2 = 1 - b1 ** steps[i], 1 - b2 ** steps[i]
        denom = (v[i] / c2).sqrt() + eps
        p.sub_(lr / c1 * m[i] / denom)


def keyframe_steps(cfg, start: Dict, frames: Dict, slot_frames: List[int],
                   gen_seed: int, steps: int = 3) -> Dict:
    """Replay the first `steps` iterations of the keyframe in the last of
    `len(slot_frames)` database slots -> {"loss": [per step],
    "grad_norm": {leaf: norm of the first gradient (the L2 term included,
    as Adam sees it)}, "change_norm": {leaf: norm of the change after
    `steps` steps}}.

    `start`: the map as the keyframe starts it, {"weights": {leaf: tensor}}
    and, after the first keyframe, Adam's {"exp_avg", "exp_avg_sq",
    "step"} by leaf. `frames`: direction [H, W, 3], rgb [N, H, W, 3], depth
    [N, H, W], c2w [N, 4, 4]; `slot_frames[j]`: the frame of slot j."""
    check_supported(cfg)
    mp = cfg["mapping"]
    dev = frames["c2w"].device
    sc = scene_lib.Scene(cfg, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(int(gen_seed))
    N = frames["rgb"].shape[0]
    dirs = frames["direction"].reshape(-1, 3)
    n_pix = dirs.shape[0]
    R = rays_per_keyframe(cfg)
    n_g, n_c = int(mp["sample"]), int(mp["min_pixels_cur"])
    S = int(cfg["training"]["n_samples_d"]) + int(cfg["training"]["n_range_d"])

    def draw(count):
        gi = torch.randint(0, max(count * R, 1), (n_g,), generator=g,
                           device=dev)
        ci = torch.randint(0, n_pix, (n_c,), generator=g, device=dev)
        return gi, ci, torch.rand((n_g + n_c, S), generator=g, device=dev)

    K = len(slot_frames)
    pix = []
    for j in range(K):
        pix.append(torch.randint(0, n_pix, (R,), generator=g, device=dev))
        if j < K - 1:
            for _ in range(int(mp["first_iters"] if j == 0 else mp["iters"])):
                draw(j + 1)
    pix = torch.stack(pix)                                   # [K, R]
    fi = torch.tensor(slot_frames, device=dev, dtype=torch.long)
    kf_dirs = dirs[pix]
    kf_rgb = frames["rgb"].reshape(N, -1, 3)[fi[:, None], pix]
    kf_depth = frames["depth"].reshape(N, -1)[fi[:, None], pix]
    kf_pose = frames["c2w"][fi]
    cur = int(slot_frames[-1])
    pose = kf_pose[-1]
    rgb = frames["rgb"][cur].reshape(-1, 3)
    depth = frames["depth"][cur].reshape(-1)

    names = sorted(start["weights"])
    w0 = {k: start["weights"][k].detach().clone() for k in names}
    params = [w0[k].clone().requires_grad_(True) for k in names]
    groups = [(float(mp["lr_decoder"]), 1e-8, DECODER_L2)
              if k.startswith("decoder/") else
              (float(mp["lr_embed"]), 1e-15, 0.0) for k in names]
    if "exp_avg" in start:
        m = [start["exp_avg"][k].clone() for k in names]
        v = [start["exp_avg_sq"][k].clone() for k in names]
        done = [int(start["step"][k]) for k in names]
    else:
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        done = [0] * len(names)
    losses, grad_norm = [], {}
    for step in range(1, steps + 1):
        gi, ci, u = draw(K)
        slot, r = gi // R, gi % R
        d_cam = torch.cat([kf_dirs[slot, r], dirs[ci]])
        t_rgb = torch.cat([kf_rgb[slot, r], rgb[ci]])
        t_d = torch.cat([kf_depth[slot, r], depth[ci]])
        rot = torch.cat([kf_pose[slot, :3, :3],
                         pose[:3, :3].expand(n_c, 3, 3)])
        rays_d = (rot * d_cam[:, None, :]).sum(-1)
        rays_o = torch.cat([kf_pose[slot, :3, 3], pose[:3, 3].expand(n_c, 3)])
        z = scene_lib.depth_guided_z(cfg, t_d, u)
        w = dict(zip(names, params))
        out_rgb, out_d, sdf = sc.render(w, rays_o, rays_d, z)
        loss = scene_lib.mapping_loss(cfg, out_rgb, out_d, sdf, z, t_rgb,
                                      t_d)
        grads = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if step == 1:
                for k, p, gr, (_, _, l2) in zip(names, params, grads,
                                                groups):
                    grad_norm[k] = float((gr + l2 * p).norm())
            adam(params, grads, m, v, [d + step for d in done], groups)
    with torch.no_grad():
        change = {k: float((p - w0[k]).norm()) for k, p in zip(names,
                                                                params)}
    return {"loss": losses, "grad_norm": grad_norm, "change_norm": change}


def median(values) -> float:
    s = sorted(values)
    n = len(s)
    return 0.5 * (s[(n - 1) // 2] + s[n // 2]) if n else math.nan
