"""Reconstruction metrics: accuracy, completion, completion ratio.

Port of `mneslam_tpu/eval/recon.py`: area-weighted surface sampling of
both meshes (200k points by default) and nearest-neighbour distances with
scipy's cKDTree (imported when a metric runs; its queries use every host
core, with the same distances). Accuracy and completion in centimetres,
completion ratio as the percentage of ground-truth samples within
`dist_th` (5 cm). Host numpy; no device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Area-weighted uniform sampling of a triangle mesh -> [n, 3]."""
    rng = rng or np.random.default_rng(0)
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    total = areas.sum()
    if total <= 0 or len(faces) == 0:
        return verts[rng.integers(0, max(len(verts), 1), n)]
    probs = areas / total
    tri = rng.choice(len(faces), size=n, p=probs)
    u = rng.random((n, 1))
    v = rng.random((n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    return v0[tri] + u * (v1[tri] - v0[tri]) + v * (v2[tri] - v0[tri])


def _tree(points: np.ndarray):
    from scipy.spatial import cKDTree

    return cKDTree(points)


def completion_ratio(gt: np.ndarray, rec: np.ndarray, dist_th: float = 0.05) -> float:
    d, _ = _tree(rec).query(gt, k=1, workers=-1)
    return float(np.mean(d < dist_th))


def accuracy(gt: np.ndarray, rec: np.ndarray) -> float:
    d, _ = _tree(gt).query(rec, k=1, workers=-1)
    return float(np.mean(d))


def completion(gt: np.ndarray, rec: np.ndarray) -> float:
    d, _ = _tree(rec).query(gt, k=1, workers=-1)
    return float(np.mean(d))


def icp_align(
    src: np.ndarray, dst: np.ndarray,
    threshold: float = 0.1,
    max_iters: int = 50,
    tol: float = 1e-7,
) -> np.ndarray:
    """Rigid point-to-point ICP: the [4, 4] transform taking `src` onto
    `dst` (identity init, correspondence cutoff `threshold`)."""
    T = np.eye(4)
    cur = src.copy()
    tree = _tree(dst)
    prev_err = np.inf
    for _ in range(max_iters):
        d, idx = tree.query(cur, k=1, workers=-1)
        mask = d < threshold
        if mask.sum() < 3:
            break
        p, q = cur[mask], dst[idx[mask]]
        mu_p, mu_q = p.mean(0), q.mean(0)
        H = (p - mu_p).T @ (q - mu_q)
        U, _, Vt = np.linalg.svd(H)
        S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
        R = Vt.T @ S @ U.T
        t = mu_q - R @ mu_p
        step = np.eye(4)
        step[:3, :3], step[:3, 3] = R, t
        T = step @ T
        cur = cur @ R.T + t
        err = float(d[mask].mean())
        if abs(prev_err - err) < tol:
            break
        prev_err = err
    return T


def eval_mesh(
    rec_verts: np.ndarray, rec_faces: np.ndarray,
    gt_verts: np.ndarray, gt_faces: np.ndarray,
    n_samples: int = 200_000,
    dist_th: float = 0.05,
    align: bool = False,
    icp_threshold: float = 0.1,
) -> Dict[str, float]:
    """Accuracy, completion (cm) and completion ratio (%) of a mesh against
    the ground-truth mesh; with `align=True` the reconstruction is first
    rigidly ICP-registered onto it."""
    rng = np.random.default_rng(0)
    if align and len(rec_verts) and len(gt_verts):
        T = icp_align(rec_verts, gt_verts, threshold=icp_threshold)
        rec_verts = rec_verts @ T[:3, :3].T + T[:3, 3]
    rec_pts = sample_surface(rec_verts, rec_faces, n_samples, rng)
    gt_pts = sample_surface(gt_verts, gt_faces, n_samples, rng)
    return {
        "accuracy_cm": accuracy(gt_pts, rec_pts) * 100.0,
        "completion_cm": completion(gt_pts, rec_pts) * 100.0,
        "completion_ratio_pct": completion_ratio(gt_pts, rec_pts, dist_th) * 100.0,
    }


def depth_l1(
    rendered: np.ndarray, gt: np.ndarray, max_depth: float = 10.0
) -> float:
    """Depth L1 in cm over pixels with 0 < gt < max_depth and a finite
    render."""
    valid = (gt > 0) & (gt < max_depth) & np.isfinite(rendered)
    if valid.sum() == 0:
        return float("nan")
    return float(np.mean(np.abs(rendered[valid] - gt[valid]))) * 100.0
