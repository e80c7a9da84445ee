"""The plain reference of an inter-agent loop closure's render alignment.

The base map renders a teacher colour and depth along sampled camera rays
at the base pose; the target pose, as an axis-angle rotation and a
translation, is then fitted by Adam (betas 0.9 / 0.999, eps 1e-8, one
learning rate for the rotation and one for the translation) so that the
target map's renders along the same camera rays match the teacher's:
loss = rgb_weight * colour MSE + depth_weight * depth MSE. Every render
takes `training.n_samples` depths evenly in [near, far], without jitter.
Each iteration's loss is that of the pose before its update; the best pose
is the one with the lowest such loss (the first pose on ties).
"""

from __future__ import annotations

from typing import Dict

import torch

from . import scene as scene_lib


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [3] -> rotation [3, 3] (a Taylor series near zero)."""
    th2 = (aa * aa).sum()
    th = th2.clamp(min=1e-30).sqrt()
    small = th2 < 1e-8
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2)
    x, y, z = aa[0], aa[1], aa[2]
    zero = torch.zeros_like(x)
    K = torch.stack([torch.stack([zero, -z, y]), torch.stack([z, zero, -x]),
                     torch.stack([-y, x, zero])])
    return torch.eye(3, device=aa.device, dtype=aa.dtype) + a * K \
        + b * (K @ K)


def log_rotation(R: torch.Tensor) -> torch.Tensor:
    """Rotation [3, 3] -> axis-angle [3] (angle below pi), in float64."""
    R = R.double()
    cos = ((R.trace() - 1.0) / 2.0).clamp(-1.0, 1.0)
    th = torch.arccos(cos)
    w = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if float(th) < 1e-6:
        return 0.5 * w
    return th / (2.0 * torch.sin(th)) * w


def align(cfg, scene: scene_lib.Scene, w_base: Dict, w_target: Dict,
          base_c2w: torch.Tensor, target_init: torch.Tensor,
          dirs_cam: torch.Tensor, rgb_weight: float, depth_weight: float,
          iters: int, lr_rot: float, lr_trans: float) -> Dict:
    """-> {"c2w": best pose [4, 4] on the CPU, "best_loss", "init_loss"}.
    `dirs_cam` [S, 3] camera-frame directions."""
    dev = dirs_cam.device
    tr, cam = cfg["training"], cfg["cam"]
    S = dirs_cam.shape[0]
    z = torch.linspace(float(cam["near"]), float(cam["far"]),
                       int(tr["n_samples"]), device=dev)[None].expand(S, -1)
    with torch.no_grad():
        t_rgb, t_d, _ = scene.render(w_base, base_c2w[:3, 3].expand(S, 3),
                                     dirs_cam @ base_c2w[:3, :3].T, z)
    rot = log_rotation(target_init[:3, :3]).float().to(dev)
    trans = target_init[:3, 3].clone()
    params = [rot.requires_grad_(True), trans.requires_grad_(True)]
    lrs = [lr_rot, lr_trans]
    m = [torch.zeros(3, device=dev) for _ in params]
    v = [torch.zeros(3, device=dev) for _ in params]
    b1, b2, eps = 0.9, 0.999, 1e-8
    best, best_c2w, init = None, None, None
    for step in range(1, iters + 1):
        R = rodrigues(params[0])
        c2w = torch.eye(4, device=dev)
        c2w = torch.cat([torch.cat([R, params[1][:, None]], 1), c2w[3:]], 0)
        rgb, depth, _ = scene.render(w_target, params[1].expand(S, 3),
                                     dirs_cam @ R.T, z)
        loss = rgb_weight * ((rgb - t_rgb) ** 2).mean() \
            + depth_weight * ((depth - t_d) ** 2).mean()
        grads = torch.autograd.grad(loss, params)
        lv = float(loss.detach())
        if init is None:
            init = lv
        if best is None or lv < best:
            best, best_c2w = lv, c2w.detach().cpu()
        with torch.no_grad():
            for i, p in enumerate(params):
                m[i].mul_(b1).add_(grads[i], alpha=1 - b1)
                v[i].mul_(b2).addcmul_(grads[i], grads[i], value=1 - b2)
                denom = (v[i] / (1 - b2 ** step)).sqrt() + eps
                p.sub_(lrs[i] / (1 - b1 ** step) * m[i] / denom)
    return {"c2w": best_c2w, "best_loss": best, "init_loss": init}
