"""Tracker facade: per-frame motion filtering plus frontend updates.

Port of `mneslam_tpu/tracking/tracker.py`. `run` / `run_batch` feed input
frames through the motion filter and, when admitted, the frontend;
`global_ba` runs the backend's dense BA over the tracked history. The
tracker owns the keyframe buffer, the host-side keyframe counter and the
backend (which the frontend's loop BA shares). The
tracker is inference only: its calls run under `torch.no_grad()`, so no
autograd graph is kept across frames while the mapper trains beside it.

Precision (tracker.py:30-39): `tracking.precision` unset means bf16
tracker nets on the GPU and fp32 on the CPU; correlation, geometry, BA
and the buffer's poses / disps stay fp32.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..models.droid_net import cast_params, params_dtype
from . import video as video_lib
from .backend import Backend
from .frontend import Frontend
from .motion_filter import MotionFilter


class Tracker:
    def __init__(self, config, params: Dict, intrinsics_full: np.ndarray,
                 device, update_fn=None, agg_fn=None):
        """intrinsics_full: (fx, fy, cx, cy) at the tracking resolution
        (cam.H_out x cam.W_out); kept at 1/8. `params` lie on `device`."""
        self.config = config
        self.device = torch.device(device)
        tr = config["tracking"]
        precision = tr.get("precision")
        if precision is None:
            precision = "float32" if self.device.type == "cpu" else "bfloat16"
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"tracking.precision {precision!r}: expected "
                             "float32 or bfloat16")
        params = cast_params(params, getattr(torch, precision))
        self.params = params
        self.buffer = tr["buffer"]
        H_out, W_out = config["cam"]["H_out"], config["cam"]["W_out"]
        self.ht, self.wd = H_out // 8, W_out // 8
        self.intrinsics = torch.tensor(
            np.asarray(intrinsics_full, np.float64) / 8.0, dtype=torch.float32,
            device=self.device)

        self.state = video_lib.init_video(self.buffer, self.ht, self.wd,
                                          device=self.device,
                                          feat_dtype=params_dtype(params))
        self.counter = 0
        self.motion_filter = MotionFilter(
            params, thresh=tr["motion_filter"]["thresh"])
        self.backend = Backend(params, self.intrinsics, config, self.buffer,
                               self.ht, self.wd, update_fn=update_fn,
                               agg_fn=agg_fn)
        self.frontend = Frontend(params, self.intrinsics, config, self.buffer,
                                 self.ht, self.wd, update_fn=update_fn,
                                 agg_fn=agg_fn, backend=self.backend)

    @torch.no_grad()
    def run(self, timestamp: float, image: torch.Tensor,
            depth: Optional[torch.Tensor] = None,
            gt_pose: Optional[torch.Tensor] = None) -> bool:
        """Track one frame (mp_slam/tracker.py:51-65) -> admitted?"""
        self.state, self.counter, admitted = self.motion_filter.track(
            self.state, self.counter, timestamp, image, depth, gt_pose)
        if admitted or self.frontend.is_initialized:
            self.state, self.counter = self.frontend(self.state, self.counter)
        return admitted

    @torch.no_grad()
    def run_batch(self, timestamps, images, depths, gt_poses=None):
        """A batch of frames through one motion-filter readback, then the
        frontend replayed as the per-frame loop would call it -> the
        per-frame admitted flags."""
        if self.counter + len(timestamps) > self.buffer:
            raise ValueError(
                f"keyframe buffer too small: {self.counter}+{len(timestamps)}"
                f" > {self.buffer}")
        self.state, _, admitted = self.motion_filter.track_batch(
            self.state, self.counter, timestamps, images, depths, gt_poses)
        cnt = self.counter
        for adm in admitted:
            if adm:
                cnt += 1
            if adm or self.frontend.is_initialized:
                self.state, cnt = self.frontend(self.state, cnt)
        self.counter = cnt
        return admitted

    @torch.no_grad()
    def global_ba(self, steps: int = 6):
        """Dense BA over the tracked history (mneslam_mp.py:51-87) ->
        (frames, edges)."""
        self.state, n, n_edges = self.backend.dense_ba(
            self.state, self.counter, steps=steps)
        return n, n_edges

    def poses_c2w(self, pose_compensate=None, first_gt=None) -> torch.Tensor:
        return video_lib.get_poses_c2w(self.state, self.counter,
                                       pose_compensate, first_gt)

    def keyframe_timestamps(self) -> np.ndarray:
        return self.state.timestamps[:self.counter].cpu().numpy()
