"""The benchmark's textured box room, ray-cast on the device.

A frozen PyTorch rewrite of the box room of
`mneslam_tpu_torch/data/synthetic.py` (the same wall colours and the same
z-buffer depth from a ray-box intersection), so that a change to the
program cannot move the yardstick. The room is an axis-aligned box given
by its corners, the camera moves on a closed loop around the box's centre,
and the frames are ray-cast on the device a few at a time. The seed sets
the loop's phase and a small offset of its centre; every seed gets the
same number of frames at the same size.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

CHUNK = 8   # frames ray-cast in one call


def camera_dirs(H: int, W: int, fx: float, fy: float, cx: float, cy: float,
                device) -> torch.Tensor:
    """Camera-frame ray directions [H, W, 3], OpenGL (x right, y up, the
    camera looks down -z): ((i - cx) / fx, -(j - cy) / fy, -1)."""
    j = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    x = ((i - cx) / fx).expand(H, W)
    y = (-(j - cy) / fy).expand(H, W)
    return torch.stack([x, y, -torch.ones_like(x)], dim=-1)


def wall_colour(pts: torch.Tensor, centre: torch.Tensor,
                half: torch.Tensor) -> torch.Tensor:
    """Smooth colour pattern of the walls at hit points [..., 3], tinted by
    the axis of the wall that was hit."""
    base = torch.stack([0.5 + 0.45 * torch.sin(2.1 * pts[..., 0] + 0.7),
                        0.5 + 0.45 * torch.sin(1.7 * pts[..., 1] + 2.9),
                        0.5 + 0.45 * torch.sin(2.5 * pts[..., 2] + 1.3)], -1)
    axis = torch.argmax(((pts - centre) / half).abs(), dim=-1)
    tint = torch.tensor([[1.0, 0.7, 0.7], [0.7, 1.0, 0.7], [0.7, 0.7, 1.0]],
                        device=pts.device)
    return torch.clamp(base * tint[axis], 0.0, 1.0)


def loop_poses(n: int, centre: torch.Tensor, radius: float, phase: float,
               device) -> torch.Tensor:
    """c2w poses [n, 4, 4] (OpenGL) on a closed loop: a full turn of yaw,
    a pitch swing of 0.15 rad and a circular translation of `radius` m
    about `centre`."""
    t = torch.arange(n, dtype=torch.float64, device=device) / n
    yaw = 2.0 * math.pi * t + phase
    pitch = 0.15 * torch.sin(2.0 * math.pi * t)
    cy, sy, cp, sp = torch.cos(yaw), torch.sin(yaw), torch.cos(pitch), \
        torch.sin(pitch)
    zero, one = torch.zeros_like(yaw), torch.ones_like(yaw)
    Ry = torch.stack([torch.stack([cy, zero, sy], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([-sy, zero, cy], -1)], -2)
    Rx = torch.stack([torch.stack([one, zero, zero], -1),
                      torch.stack([zero, cp, -sp], -1),
                      torch.stack([zero, sp, cp], -1)], -2)
    pos = torch.stack([radius * torch.cos(yaw),
                       0.4 * radius * torch.sin(2.0 * yaw),
                       radius * torch.sin(yaw)], -1)
    c2w = torch.eye(4, dtype=torch.float64, device=device).repeat(n, 1, 1)
    c2w[:, :3, :3] = Ry @ Rx
    c2w[:, :3, 3] = pos + centre.double()
    return c2w.float()


def render(dirs_cam: torch.Tensor, c2w: torch.Tensor, lo: torch.Tensor,
           hi: torch.Tensor):
    """Frames seen from poses c2w [n, 4, 4] inside the box [lo, hi] ->
    (rgb [n, H, W, 3] in [0, 1], depth [n, H, W]: the z-buffer depth,
    equal to the hit distance since the camera z of every direction is
    -1)."""
    dirs = torch.einsum("hwc,nrc->nhwr", dirs_cam, c2w[:, :3, :3])
    o = c2w[:, None, None, :3, 3]
    inf = torch.full_like(dirs, float("inf"))
    safe = torch.where(dirs == 0, torch.ones_like(dirs), dirs)
    t_exit = torch.where(dirs > 0, (hi - o) / safe,
                         torch.where(dirs < 0, (lo - o) / safe, inf))
    t_hit = t_exit.min(dim=-1).values
    pts = o + dirs * t_hit[..., None]
    centre, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    return wall_colour(pts, centre, half), t_hit


def make_frames(config: Dict, scene: Dict, n: int, seed: int,
                device) -> Dict[str, torch.Tensor]:
    """`n` frames of the box room for `config["cam"]`, the room's corners
    the mapping bound inset by `scene["inset_m"]`, the loop's radius
    `scene["radius_m"]`. The seed draws the loop's phase and an offset of
    its centre of up to `scene["jitter_m"]` -> {"direction" [H, W, 3],
    "rgb" [n, H, W, 3], "depth" [n, H, W], "c2w" [n, 4, 4]}, float32 on
    `device`."""
    cam = config["cam"]
    bound = torch.tensor(config["mapping"]["bound"], dtype=torch.float32,
                         device=device)
    lo = bound[:, 0] + float(scene["inset_m"])
    hi = bound[:, 1] - float(scene["inset_m"])
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed) % (2 ** 63))
    u = torch.rand(4, generator=g, dtype=torch.float64)
    phase = 2.0 * math.pi * float(u[0])
    centre = 0.5 * (lo + hi) + float(scene["jitter_m"]) * (
        2.0 * u[1:].float().to(device) - 1.0)
    dirs = camera_dirs(int(cam["H"]), int(cam["W"]), float(cam["fx"]),
                       float(cam["fy"]), float(cam["cx"]), float(cam["cy"]),
                       device)
    c2w = loop_poses(n, centre, float(scene["radius_m"]), phase, device)
    rgb = torch.empty((n, *dirs.shape), device=device)
    depth = torch.empty((n, *dirs.shape[:2]), device=device)
    for s in range(0, n, CHUNK):   # a few frames at a time: a small peak
        rgb[s:s + CHUNK], depth[s:s + CHUNK] = render(
            dirs, c2w[s:s + CHUNK], lo, hi)
    return {"direction": dirs, "rgb": rgb, "depth": depth, "c2w": c2w}
