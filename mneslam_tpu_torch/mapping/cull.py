"""Frustum and occlusion culling of a mesh against the mapped keyframes.

Port of `mneslam_tpu/mapping/cull.py`: a vertex is kept when it projects
inside some keyframe's image with positive depth and, given the observed
depths, lies no further than the observed depth plus `eps`. The counts run
on the device, chunked over vertices and batched over keyframes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


@torch.no_grad()
def visible_counts(verts: torch.Tensor, c2w: torch.Tensor,
                   intrinsics: torch.Tensor, depths: Optional[torch.Tensor],
                   H: int, W: int, eps: float = 0.08,
                   chunk: int = 16384) -> torch.Tensor:
    """How many keyframes see each vertex -> int32 [V].

    verts [V, 3] world points; c2w [K, 4, 4] keyframe poses (OpenGL, -z
    forward); intrinsics [4] fx fy cx cy at full resolution; depths
    [K, H, W] observed depths (<= 0: no depth) or None. Vertices go in
    chunks of `chunk`, the last one padded with zero points."""
    fx, fy, cx, cy = (intrinsics[i] for i in range(4))
    w2c = torch.linalg.inv(c2w)
    R, t = w2c[:, :3, :3], w2c[:, :3, 3]
    n = verts.shape[0]
    n_pad = (chunk - n % chunk) % chunk
    p = torch.cat([verts, verts.new_zeros((n_pad, 3))])
    counts = []
    for s in range(0, n + n_pad, chunk):
        cam = p[None, s:s + chunk] @ R.transpose(1, 2) + t[:, None]  # [K,c,3]
        z = -cam[..., 2]
        u = fx * (cam[..., 0] / torch.clamp(z, min=1e-6)) + cx
        v = -fy * (cam[..., 1] / torch.clamp(z, min=1e-6)) + cy
        inb = (z > 0.01) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        if depths is not None:
            ui = torch.clamp(u.to(torch.int32), 0, W - 1).long()
            vi = torch.clamp(v.to(torch.int32), 0, H - 1).long()
            k = torch.arange(c2w.shape[0], device=verts.device)[:, None]
            obs = depths[k, vi, ui]
            inb = inb & ((obs <= 0) | (z <= obs + eps))
        counts.append(inb.to(torch.int32).sum(0, dtype=torch.int32))
    return torch.cat(counts)[:n]


def cull_mesh(verts: np.ndarray, faces: np.ndarray, c2w: np.ndarray,
              intrinsics: np.ndarray, H: int, W: int,
              depths: Optional[np.ndarray] = None,
              colors: Optional[np.ndarray] = None, eps: float = 0.08, *,
              device) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Keep the vertices some keyframe sees and the faces whose every
    vertex is kept (indices remapped); the counts run on `device`."""
    if len(verts) == 0:
        return verts, faces, colors

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    counts = visible_counts(dev(verts), dev(c2w), dev(intrinsics),
                            None if depths is None else dev(depths), H, W,
                            eps=eps).cpu().numpy()
    keep_v = counts > 0
    keep_f = keep_v[faces].all(axis=1)
    remap = -np.ones(len(verts), np.int64)
    remap[keep_v] = np.arange(int(keep_v.sum()))
    new_faces = remap[faces[keep_f]]
    new_colors = colors[keep_v] if colors is not None else None
    return verts[keep_v], new_faces, new_colors
