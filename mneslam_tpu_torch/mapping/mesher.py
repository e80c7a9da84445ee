"""Mesh extraction: the SDF grid on the device, marching tetrahedra on the
host.

Port of `mneslam_tpu/mapping/mesher.py`. The SDF is evaluated on a dense
grid over `mapping.marching_cubes_bound` in chunks of 65536 points (the
last one padded with zero points, as the JAX package pads), only the three
axes are sent to the device and each chunk's points are formed there, and
the volume comes back to the host once. The isosurface comes from the
truncation-aware marching-tetrahedra polygoniser (`ops/mc.py`); vertex
colours from point queries or, with `mesh.render_color`, from a composite
along each vertex normal. Everything here runs without autograd.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.scene_rep import SceneRep
from ..ops import mc
from . import cull


@torch.no_grad()
def sdf_volume(scene: SceneRep, params: Dict, bound: np.ndarray,
               voxel_size: float, chunk: int = 65536
               ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Dense SDF volume over `bound` [3, 2] on the scene's device ->
    (volume [nx, ny, nz] tensor, origin [3], spacing [3]). Each axis has a
    step of at most `voxel_size` and at least 2 nodes (float32
    `np.linspace`, as the JAX package's grid)."""
    bound = np.asarray(bound, np.float32)
    sizes = [max(int(np.ceil((bound[i, 1] - bound[i, 0]) / voxel_size)) + 1,
                 2) for i in range(3)]
    axes = [np.linspace(bound[i, 0], bound[i, 1], sizes[i], dtype=np.float32)
            for i in range(3)]
    nx, ny, nz = sizes
    dev = scene.device
    ax, ay, az = (torch.as_tensor(a, device=dev) for a in axes)
    tables = scene.query_tables(params)
    n = nx * ny * nz
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    for s in range(0, n, chunk):
        i = torch.arange(s, s + chunk, device=dev)
        m = min(chunk, n - s)
        if m < chunk:
            i[m:] = 0
        pts = torch.stack([ax[i // (ny * nz)], ay[(i // nz) % ny],
                           az[i % nz]], dim=-1)
        if m < chunk:
            pts[m:] = 0.0
        out[s:s + m] = scene.query_sdf(params, pts, tables)[:m]
    origin = bound[:, 0].copy()
    spacing = np.asarray([a[1] - a[0] for a in axes], np.float32)
    return out.reshape(nx, ny, nz), origin, spacing


def sdf_grid(scene: SceneRep, params: Dict, bound: np.ndarray,
             voxel_size: float, chunk: int = 65536
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense SDF volume over `bound` [3, 2] -> (volume [nx, ny, nz] numpy,
    origin, spacing)."""
    vol, origin, spacing = sdf_volume(scene, params, bound, voxel_size, chunk)
    return vol.cpu().numpy(), origin, spacing


@torch.no_grad()
def _query_chunked(fn, pts: np.ndarray, device, chunk: int,
                   normals: Optional[np.ndarray] = None) -> np.ndarray:
    """fn(points[, normals]) -> [chunk, 3] over `pts` [N, 3] in chunks,
    the last one padded with zeros; -> [N, 3] numpy."""
    n = pts.shape[0]
    n_pad = (chunk - n % chunk) % chunk
    pad = np.zeros((n_pad, 3), np.float32)
    p = torch.as_tensor(np.concatenate([pts, pad]), device=device)
    nr = None if normals is None else torch.as_tensor(
        np.concatenate([normals.astype(np.float32), pad]), device=device)
    out = [fn(p[s:s + chunk]) if nr is None else
           fn(p[s:s + chunk], nr[s:s + chunk])
           for s in range(0, n + n_pad, chunk)]
    return torch.cat(out)[:n].cpu().numpy()


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals: face normals scaled by face area,
    summed per vertex, normalised."""
    v = verts.astype(np.float64)
    fn = np.cross(v[faces[:, 1]] - v[faces[:, 0]], v[faces[:, 2]] - v[faces[:, 0]])
    out = np.zeros_like(v)
    for k in range(3):
        np.add.at(out, faces[:, k], fn)
    norm = np.linalg.norm(out, axis=1, keepdims=True)
    return (out / np.maximum(norm, 1e-12)).astype(np.float32)


def vertex_colors(scene: SceneRep, params: Dict, config, verts: np.ndarray,
                  faces: np.ndarray) -> np.ndarray:
    """[V, 3] colours in [0, 1]: point queries in chunks of 65536, or with
    `mesh.render_color` a composite along each vertex normal in chunks of
    16384."""
    tables = scene.query_tables(params)
    verts = np.asarray(verts, np.float32)
    if config.get("mesh", {}).get("render_color", False):
        return _query_chunked(
            lambda p, n: scene.render_surface_color(params, p, n, tables),
            verts, scene.device, 16384, vertex_normals(verts, faces))
    return _query_chunked(lambda p: scene.query_color(params, p, tables),
                          verts, scene.device, 65536)


def _stage(timers, name: str):
    return contextlib.nullcontext() if timers is None else timers.stage(name)


def extract_mesh(scene: SceneRep, params: Dict, config,
                 voxel_size: Optional[float] = None, color: bool = True,
                 save_path: Optional[str] = None, observed=None,
                 native: bool = True, timers=None):
    """Grid query -> marching tetrahedra -> observed-space filter ->
    vertex colours -> PLY; returns (verts, faces, colors or None).

    The truncation band is 3.0 in the SDF head's normalised units (the
    volume is already in units of the truncation distance). `observed`:
    (kf_poses [K, 4, 4] c2w, intrinsics [4], H, W, depths [K, H, W] or
    None, eps); faces with a vertex that no keyframe saw (outside every
    frustum, or behind the observed depth + eps + one voxel diagonal) are
    dropped after extraction, so the mesh holds no geometry that no camera
    saw. `native`: the C++ polygoniser and weld (raise when they cannot
    be built), else the numpy path. `timers` (a `StageTimers`): each step
    timed as a stage "mesh/<step>" (the grid's stage waits for the
    device)."""
    bound = np.asarray(config["mapping"]["marching_cubes_bound"],
                       np.float32) * config["scale"]
    if voxel_size is None:
        voxel_size = float(config["meshing"]["resolution"])
    with _stage(timers, "mesh/sdf_grid"):
        vol, origin, spacing = sdf_volume(scene, params, bound, voxel_size)
        if timers is not None and vol.is_cuda:
            torch.cuda.synchronize(vol.device)
    with _stage(timers, "mesh/to_host"):
        vol = vol.cpu().numpy()
    with _stage(timers, "mesh/polygonize"):
        tri_verts = mc.polygonize(
            vol, float(config["meshing"].get("level_set", 0.0)), 3.0,
            native=native)
    with _stage(timers, "mesh/weld"):
        verts, faces = mc.weld(tri_verts, native=native)
    verts = verts * spacing + origin
    if observed is not None and len(verts):
        kf_poses, intr, H, W, depths, eps = observed
        diag = float(np.linalg.norm(spacing))
        with _stage(timers, "mesh/observed_filter"):
            verts, faces, _ = cull.cull_mesh(
                verts, faces, kf_poses, intr, int(H), int(W), depths=depths,
                eps=float(eps) + diag, device=scene.device)
    colors = None
    if color and len(verts):
        with _stage(timers, "mesh/vertex_color"):
            colors = vertex_colors(scene, params, config, verts, faces)
    if save_path is not None and len(verts):
        mc.save_ply(save_path, verts, faces, colors)
    return verts, faces, colors
