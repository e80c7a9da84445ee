"""Incremental frame-distance cache for the backend's edge proposal.

Port of `mneslam_tpu/tracking/dist_cache.py`. The reference recomputes the
full t x t `frame_distance` grid on every global or loop BA; this cache
keeps the distance matrix across proposals and recomputes only the pairs
whose endpoints changed:

- d(i, j) depends only on the two frames' poses and disparities (and the
  intrinsics and beta) and is exactly symmetric, so one [buffer, buffer]
  matrix holds it and each unordered pair is computed once; d(i, i) = 0.
- A frame is dirty when its pose moved more than `pose_tol` (L-inf over
  the 7-vector) or a disparity pixel more than `disp_tol` since the
  snapshot taken at its last refresh (tolerance 0: any bitwise change).
  One device reduction over the buffer finds the dirty frames, read back
  once per `distance_grid` call. Per-frame version counters stamp every
  entry, so an entry is reused only while both endpoints keep the stamped
  versions. The snapshot moves only for dirty frames, so drift below the
  tolerance cannot accumulate unseen.
"""

from __future__ import annotations

import numpy as np
import torch

from . import video as video_lib


def _dirty_flags(poses: torch.Tensor, disps: torch.Tensor,
                 snap_poses: torch.Tensor, snap_disps: torch.Tensor,
                 pose_tol: float, disp_tol: float) -> torch.Tensor:
    """Per-frame bool [buffer]: moved beyond tolerance since the snapshot;
    tolerance 0 means bitwise inequality (`!=` also catches a NaN)."""
    B = poses.shape[0]
    if pose_tol > 0:
        pose_dirty = (poses - snap_poses).abs().amax(dim=1) > pose_tol
    else:
        pose_dirty = (poses != snap_poses).any(dim=1)
    dd = (disps - snap_disps).reshape(B, -1)
    if disp_tol > 0:
        disp_dirty = dd.abs().amax(dim=1) > disp_tol
    else:
        disp_dirty = (disps != snap_disps).reshape(B, -1).any(dim=1)
    return pose_dirty | disp_dirty


class FrameDistanceCache:
    """Host-side coordinator; the distances and the change detection run
    on the device."""

    def __init__(self, buffer: int, pose_tol: float = 0.0,
                 disp_tol: float = 0.0, beta: float = 0.3):
        self.buffer = int(buffer)
        self.pose_tol = float(pose_tol)
        self.disp_tol = float(disp_tol)
        self.beta = float(beta)
        self.d = np.full((buffer, buffer), np.nan, np.float64)
        # per-frame version at which each entry's endpoints were computed
        self.stamp_i = np.full((buffer, buffer), -1, np.int64)
        self.stamp_j = np.full((buffer, buffer), -1, np.int64)
        self.version = np.zeros(buffer, np.int64)
        self.seen = np.zeros(buffer, bool)      # frame ever snapshotted
        self._snap_poses = None                 # device tensors
        self._snap_disps = None
        self.recomputed_pairs = 0
        self.requested_pairs = 0

    def _refresh_versions(self, state: video_lib.VideoState,
                          t_end: int) -> np.ndarray:
        """Bump the versions of the frames that moved since the snapshot
        and move their snapshot; one device reduction and one [buffer]
        readback."""
        if self._snap_poses is None:
            dirty = np.ones(self.buffer, bool)
        else:
            dirty = _dirty_flags(state.poses, state.disps, self._snap_poses,
                                 self._snap_disps, self.pose_tol,
                                 self.disp_tol).cpu().numpy()
        dirty |= ~self.seen
        dirty[t_end:] = False                   # slots past the counter
        self.version[dirty] += 1
        self.seen[:t_end] = True
        if self._snap_poses is None:
            self._snap_poses = state.poses.clone()
            self._snap_disps = state.disps.clone()
        elif dirty.any():
            m = torch.from_numpy(dirty).to(state.poses.device)
            self._snap_poses = torch.where(m[:, None], state.poses,
                                           self._snap_poses)
            self._snap_disps = torch.where(m[:, None, None], state.disps,
                                           self._snap_disps)
        return dirty

    def distance_grid(self, state: video_lib.VideoState,
                      intrinsics: torch.Tensor, ii: np.ndarray,
                      jj: np.ndarray, t_end: int) -> np.ndarray:
        """Distances for a pair list (the proposal's meshgrid), computing
        only the pairs whose endpoints changed -> float64 [len(ii)]."""
        ii = np.asarray(ii, np.int64)
        jj = np.asarray(jj, np.int64)
        self._refresh_versions(state, t_end)

        lo, hi = np.minimum(ii, jj), np.maximum(ii, jj)
        fresh = ((self.stamp_i[lo, hi] == self.version[lo])
                 & (self.stamp_j[lo, hi] == self.version[hi]))
        need = ~fresh & (ii != jj)
        # unique unordered pairs among the stale ones
        ukey = np.unique(lo[need] * self.buffer + hi[need])
        ui, uj = ukey // self.buffer, ukey % self.buffer
        if len(ui):
            d_new = video_lib.frame_distance_padded(
                state, intrinsics, ui, uj, beta=self.beta).astype(np.float64)
            self.d[ui, uj] = d_new
            self.d[uj, ui] = d_new
            self.stamp_i[ui, uj] = self.version[ui]
            self.stamp_j[ui, uj] = self.version[uj]
            self.stamp_i[uj, ui] = self.version[uj]
            self.stamp_j[uj, ui] = self.version[ui]
        diag = ii == jj
        if diag.any():
            self.d[ii[diag], ii[diag]] = 0.0
        self.recomputed_pairs = int(len(ui))
        self.requested_pairs = int(len(ii))
        return self.d[ii, jj].copy()
