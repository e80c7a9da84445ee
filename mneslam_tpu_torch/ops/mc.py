"""Isosurface extraction on the host: marching tetrahedra, weld, PLY IO.

Port of `mneslam_tpu/ops/mc.py`. Each cube of a dense volume splits into 6
tetrahedra sharing the main diagonal, and each tetrahedron is polygonised
from a 16-case table (at most 2 triangles). Cubes that touch a corner with
|v - isovalue| >= truncation, or a non-finite corner, are skipped.

Two polygonisers give the same triangles: the native one
(`kernels/csrc/mc_native.cpp`, built with g++ at first use and bound with
ctypes; `native=True`, the default, raises when it cannot be built) and
the numpy slab path below (`native=False`), its plain version. The weld
likewise: the native one gives `_weld`'s result bit for bit with one sort
in place of `np.unique` over the rows. The SDF grid itself is evaluated on
the device (`mapping/mesher.py`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

# Cube corners by binary (dx, dy, dz); main diagonal v0 -> v7.
_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], dtype=np.int64
)
# v index bits: x + 2y + 4z. Equator walk around the 0-7 diagonal.
_TETS = np.array(
    [[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
     [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]], dtype=np.int64
)

# Tetra edges as (vertex, vertex) local indices.
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64
)

# 16-case table: per case up to 2 triangles of edge ids (-1 = unused).
# Case bit i set <=> tet vertex i is inside (value < isovalue).
_TET_TRIS = -np.ones((16, 2, 3), dtype=np.int64)
_TET_TRIS[0b0001, 0] = [0, 1, 2]
_TET_TRIS[0b0010, 0] = [0, 4, 3]
_TET_TRIS[0b0100, 0] = [1, 3, 5]
_TET_TRIS[0b1000, 0] = [2, 5, 4]
_TET_TRIS[0b0011] = [[1, 2, 4], [1, 4, 3]]
_TET_TRIS[0b0101] = [[0, 2, 5], [0, 5, 3]]
_TET_TRIS[0b1001] = [[0, 1, 5], [0, 5, 4]]
_TET_TRIS[0b0110] = [[0, 4, 5], [0, 5, 1]]
_TET_TRIS[0b1010] = [[0, 3, 5], [0, 5, 2]]
_TET_TRIS[0b1100] = [[1, 3, 4], [1, 4, 2]]
_TET_TRIS[0b0111, 0] = [2, 4, 5]
_TET_TRIS[0b1011, 0] = [1, 5, 3]
_TET_TRIS[0b1101, 0] = [0, 3, 4]
_TET_TRIS[0b1110, 0] = [0, 2, 1]


def marching_cubes(
    volume: np.ndarray,
    isovalue: float = 0.0,
    truncation: Optional[float] = None,
    origin: Optional[np.ndarray] = None,
    spacing: Optional[np.ndarray] = None,
    slab: int = 32,
    native: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Isosurface of a dense volume [Nx, Ny, Nz] -> (verts [V, 3], faces
    [F, 3]), verts in index coordinates unless origin / spacing are given.
    `native`: the C++ polygoniser (raises when it cannot be built), else
    the numpy slab path."""
    tri_verts = polygonize(volume, isovalue, truncation, slab=slab,
                           native=native)
    verts, faces = weld(tri_verts, native=native)
    if spacing is not None:
        verts = verts * np.asarray(spacing, np.float32)
    if origin is not None:
        verts = verts + np.asarray(origin, np.float32)
    return verts, faces


def polygonize(volume: np.ndarray, isovalue: float = 0.0,
               truncation: Optional[float] = None, slab: int = 32,
               native: bool = True) -> np.ndarray:
    """Raw triangle vertices [3F, 3] (consecutive triplets are triangles)
    in index coordinates."""
    volume = np.asarray(volume, dtype=np.float32)
    if native:
        return _polygonize_native(volume, isovalue, truncation)
    nz = volume.shape[2]
    all_verts = []
    for z0 in range(0, nz - 1, slab):
        z1 = min(z0 + slab, nz - 1)
        v = _polygonize_slab(volume[:, :, z0: z1 + 1], isovalue, truncation)
        if v.size:
            v[:, 2] += z0
            all_verts.append(v)
    return (np.concatenate(all_verts, axis=0) if all_verts
            else np.zeros((0, 3), np.float32))


def _native_lib():
    from ..kernels.build import load_host

    lib = load_host("mc_native")
    f32 = ctypes.POINTER(ctypes.c_float)
    i64 = ctypes.POINTER(ctypes.c_int64)
    lib.mtet_polygonize.restype = ctypes.c_int64
    lib.mtet_polygonize.argtypes = [f32, ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_float,
                                    ctypes.c_float, f32, ctypes.c_int64]
    lib.mtet_weld.restype = ctypes.c_int64
    lib.mtet_weld.argtypes = [f32, ctypes.c_int64, i64, i64]
    return lib


def _polygonize_native(volume: np.ndarray, isovalue: float,
                       truncation: Optional[float]) -> np.ndarray:
    """The C++ polygoniser; it returns how many vertices the surface needs,
    so a buffer that was too small is grown once and the call repeated."""
    fn = _native_lib().mtet_polygonize
    vol = np.ascontiguousarray(volume, np.float32)
    nx, ny, nz = vol.shape
    trunc = float(truncation) if truncation is not None else -1.0
    band = np.abs(vol - isovalue) < (trunc if trunc > 0 else np.inf)
    cap = max(1024, 8 * int(np.count_nonzero(band)))
    ptr = ctypes.POINTER(ctypes.c_float)
    for _ in range(2):
        out = np.empty((cap, 3), np.float32)
        n = int(fn(vol.ctypes.data_as(ptr), nx, ny, nz, float(isovalue),
                   trunc, out.ctypes.data_as(ptr), cap))
        if n <= cap:
            return out[:n]
        cap = n
    raise RuntimeError(f"mtet_polygonize asked for {n} vertices twice")


def _polygonize_slab(vol, isovalue, truncation):
    nx, ny, nz = vol.shape
    # corner values per cube: [8, cx, cy, cz]
    cx, cy, cz = nx - 1, ny - 1, nz - 1
    vals = np.stack(
        [vol[dx: dx + cx, dy: dy + cy, dz: dz + cz] for dx, dy, dz in _CORNERS]
    )

    finite = np.all(np.isfinite(vals), axis=0)
    if truncation is not None:
        finite &= np.all(np.abs(vals - isovalue) < truncation, axis=0)
    # sign change somewhere in the cube
    inside = vals < isovalue
    active = finite & inside.any(axis=0) & (~inside.all(axis=0))
    cube_idx = np.argwhere(active)  # [M, 3]
    if cube_idx.shape[0] == 0:
        return np.zeros((0, 3), np.float32)

    cube_vals = vals[:, active].T         # [M, 8]
    base = cube_idx.astype(np.float32)    # [M, 3]

    out = []
    for tet in _TETS:
        f = cube_vals[:, tet]                              # [M, 4]
        case = ((f < isovalue) << np.arange(4)).sum(1)     # [M]
        tris = _TET_TRIS[case]                             # [M, 2, 3] edge ids
        pos = _CORNERS[tet].astype(np.float32)             # [4, 3] local corners

        for t in range(2):
            e = tris[:, t]                                 # [M, 3]
            has = e[:, 0] >= 0
            if not has.any():
                continue
            ei = e[has]                                    # [K, 3]
            fk = f[has]                                    # [K, 4]
            bk = base[has]                                 # [K, 3]
            va = _TET_EDGES[ei, 0]                         # [K, 3] local verts
            vb = _TET_EDGES[ei, 1]
            fa = np.take_along_axis(fk, va, axis=1)        # [K, 3]
            fb = np.take_along_axis(fk, vb, axis=1)
            tpar = (isovalue - fa) / np.where(np.abs(fb - fa) < 1e-12, 1e-12,
                                              fb - fa)
            tpar = np.clip(tpar, 0.0, 1.0)[..., None]      # [K, 3, 1]
            pa = pos[va]                                   # [K, 3, 3]
            pb = pos[vb]
            pts = bk[:, None, :] + pa + tpar * (pb - pa)   # [K, 3, 3]
            out.append(pts.reshape(-1, 3))

    if not out:
        return np.zeros((0, 3), np.float32)
    return np.concatenate(out, axis=0).astype(np.float32)


def weld(tri_verts: np.ndarray, native: bool = True):
    """Raw triangle vertices [3F, 3] -> (verts [V, 3], faces [F', 3]):
    vertices whose coordinates agree to 5 decimals merge into the first
    of them, in the order of their rounded coordinates; degenerate faces
    are dropped. `native`: the C++ weld, else `_weld` (numpy)."""
    tri_verts = np.ascontiguousarray(tri_verts, np.float32)
    if tri_verts.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    if not native:
        return _weld(tri_verts)
    n = tri_verts.shape[0]
    inv = np.empty(n, np.int64)
    first = np.empty(n, np.int64)
    i64 = ctypes.POINTER(ctypes.c_int64)
    n_u = _native_lib().mtet_weld(
        tri_verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        inv.ctypes.data_as(i64), first.ctypes.data_as(i64))
    return _faces(tri_verts[first[:n_u]], inv)


def _faces(verts: np.ndarray, inv: np.ndarray):
    """Faces = consecutive triplets of `inv`, the degenerate ones
    dropped."""
    faces = inv.reshape(-1, 3)
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return verts.astype(np.float32), faces[ok]


def _weld(tri_verts: np.ndarray, decimals: int = 5):
    """The numpy weld (the plain version of the native one): np.unique
    over the rounded rows, the first occurrence of each key kept."""
    keys = np.round(tri_verts, decimals)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    # representative positions: first occurrence of each unique key
    first = np.full(len(uniq), len(inv), dtype=np.int64)
    np.minimum.at(first, inv, np.arange(len(inv)))
    return _faces(tri_verts[first], inv)


# ---------------------------------------------------------------------------
# PLY IO
# ---------------------------------------------------------------------------

def save_ply(path: str, verts: np.ndarray, faces: np.ndarray,
             colors: Optional[np.ndarray] = None) -> None:
    """Write a binary little-endian PLY (colors in [0, 1] as uchar)."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    n_v, n_f = len(verts), len(faces)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {n_v}",
               "property float x", "property float y", "property float z"]
        if colors is not None:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr += [f"element face {n_f}",
                "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        if colors is not None:
            c = np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
            rec = np.zeros(n_v, dtype=[("xyz", np.float32, 3),
                                       ("rgb", np.uint8, 3)])
            rec["xyz"] = verts
            rec["rgb"] = c
            f.write(rec.tobytes())
        else:
            f.write(verts.tobytes())
        frec = np.zeros(n_f, dtype=[("n", np.uint8), ("idx", np.int32, 3)])
        frec["n"] = 3
        frec["idx"] = faces
        f.write(frec.tobytes())


def load_ply(path: str):
    """Read a binary little-endian PLY as written by `save_ply` -> (verts,
    faces, colors or None)."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode().splitlines()
    if not any("binary_little_endian" in line for line in header):
        raise ValueError("ascii PLY not supported")
    n_v = n_f = 0
    has_color = False
    for line in header:
        if line.startswith("element vertex"):
            n_v = int(line.split()[-1])
        elif line.startswith("element face"):
            n_f = int(line.split()[-1])
        elif line.startswith("property uchar red"):
            has_color = True
    body = data[head_end:]
    if has_color:
        rec = np.frombuffer(body, dtype=[("xyz", np.float32, 3),
                                         ("rgb", np.uint8, 3)], count=n_v)
        verts = rec["xyz"].copy()
        colors = rec["rgb"].astype(np.float32) / 255.0
        off = rec.nbytes
    else:
        verts = np.frombuffer(body, dtype=np.float32,
                              count=n_v * 3).reshape(n_v, 3).copy()
        colors = None
        off = n_v * 12
    frec = np.frombuffer(body[off:], dtype=[("n", np.uint8),
                                            ("idx", np.int32, 3)], count=n_f)
    return verts, frec["idx"].copy(), colors
