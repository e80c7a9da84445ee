"""Trajectory evaluation: ATE (Horn, SE(3)) and APE (Umeyama, Sim(3)).

The port's own copy of `mneslam_tpu/eval/ate.py` (numpy only): closed-form
Horn / Umeyama alignment and the metric dictionary (rmse / mean / median /
std / min / max, in the trajectory's units) that `metrics_traj.txt`
holds.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def associate(ts_a: np.ndarray, ts_b: np.ndarray,
              max_difference: float = 0.02) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy nearest-timestamp association (eval_ate.py:35-70)."""
    order = sorted((abs(a - b), i, j) for i, a in enumerate(ts_a)
                   for j, b in enumerate(ts_b) if abs(a - b) < max_difference)
    used_a, used_b, pairs = set(), set(), []
    for _, i, j in order:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            pairs.append((i, j))
    pairs.sort()
    if not pairs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ia, ib = zip(*pairs)
    return np.asarray(ia), np.asarray(ib)


def horn_align(model: np.ndarray, data: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """SE(3) alignment model -> data (Horn 1987): (R, t) minimising
    ||R model + t - data||; model, data [3, n]."""
    mu_m = model.mean(axis=1, keepdims=True)
    mu_d = data.mean(axis=1, keepdims=True)
    U, _, Vt = np.linalg.svd((data - mu_d) @ (model - mu_m).T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    return R, mu_d - R @ mu_m


def umeyama_align(model: np.ndarray, data: np.ndarray
                  ) -> Tuple[float, np.ndarray, np.ndarray]:
    """Sim(3) alignment model -> data (Umeyama 1991): (s, R, t)."""
    mu_m = model.mean(axis=1, keepdims=True)
    mu_d = data.mean(axis=1, keepdims=True)
    mc = model - mu_m
    dc = data - mu_d
    U, D, Vt = np.linalg.svd(dc @ mc.T / model.shape[1])
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_m = np.mean(np.sum(mc ** 2, axis=0))
    s = float(np.trace(np.diag(D) @ S) / max(var_m, 1e-12))
    return s, R, mu_d - s * R @ mu_m


def _stats(err: np.ndarray) -> Dict[str, float]:
    return {
        "rmse": float(np.sqrt(np.mean(err ** 2))),
        "mean": float(np.mean(err)),
        "median": float(np.median(err)),
        "std": float(np.std(err)),
        "min": float(np.min(err)),
        "max": float(np.max(err)),
        "n": int(len(err)),
    }


def evaluate_ate(gt_poses: np.ndarray, est_poses: np.ndarray,
                 gt_ts: Optional[np.ndarray] = None,
                 est_ts: Optional[np.ndarray] = None,
                 alignment: str = "se3") -> Dict[str, float]:
    """Translation error after a global alignment of est to gt (c2w
    [n, 4, 4] each): "se3" (Horn, ATE) or "sim3" (Umeyama, evo's APE).
    With both timestamp lists the poses are associated first."""
    if gt_ts is not None and est_ts is not None:
        ia, ib = associate(np.asarray(gt_ts, float),
                           np.asarray(est_ts, float), max_difference=0.5)
        gt_poses, est_poses = gt_poses[ia], est_poses[ib]
    n = min(len(gt_poses), len(est_poses))
    gt_xyz = np.asarray(gt_poses)[:n, :3, 3].T      # [3, n]
    est_xyz = np.asarray(est_poses)[:n, :3, 3].T
    if alignment == "sim3":
        s, R, t = umeyama_align(est_xyz, gt_xyz)
        aligned = s * R @ est_xyz + t
    else:
        R, t = horn_align(est_xyz, gt_xyz)
        aligned = R @ est_xyz + t
    return _stats(np.linalg.norm(aligned - gt_xyz, axis=0))


def save_trajectory_metrics(path: str, metrics: Dict[str, float],
                            label: str = "APE"):
    """Write metrics_traj.txt (the reference's output contract)."""
    with open(path, "w") as f:
        f.write(f"{label} translation statistics:\n")
        for k, v in metrics.items():
            f.write(f"  {k}: {v}\n")
