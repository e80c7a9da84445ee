"""Tracking frontend: initialisation, windowed updates, keyframe culling.

Port of `mneslam_tpu/tracking/frontend.py`: at `warmup` keyframes the graph
is seeded with neighbourhood and proximity factors and iterated 8 + 8
times; afterwards each new keyframe brings age-based eviction, proximity
factors, 4 GRU/BA updates, a redundancy test that may drop the previous
keyframe, and 2 more updates. The loop-BA branch (once the keyframe count
passes the frontend window with `enable_loop`) needs the backend, which is
not ported yet: it raises instead of being skipped.
"""

from __future__ import annotations

import numpy as np
import torch

from . import video as video_lib
from .graph import FactorGraph

LOOP_BA_TODO = ("the frontend's loop BA (Backend.loop_ba) is not ported yet "
                "(ROADMAP.md Queue 1 item 6); runs with tracking.frontend."
                "enable_loop stop at frontend.window keyframes")


class Frontend:
    def __init__(self, params, intrinsics, config, buffer: int, ht: int,
                 wd: int, update_fn=None, agg_fn=None):
        fe = config["tracking"]["frontend"]
        self.warmup = config["tracking"]["warmup"]
        self.beta = config["tracking"]["beta"]
        self.keyframe_thresh = fe["keyframe_thresh"]
        self.frontend_window = fe["window"]
        self.frontend_thresh = fe["thresh"]
        self.frontend_radius = fe["radius"]
        self.frontend_nms = fe["nms"]
        self.max_factors = fe["max_factors"]
        self.enable_loop = fe.get("enable_loop", False)

        window_cap = int(2 ** np.ceil(np.log2(max(self.frontend_window + 8,
                                                  16))))
        self.graph = FactorGraph(
            buffer, ht, wd, capacity=self.max_factors + 16, params=params,
            intrinsics=intrinsics, window=window_cap,
            max_factors=self.max_factors, update_fn=update_fn, agg_fn=agg_fn)

        self.t0 = 0
        self.t1 = 0
        self.is_initialized = False
        self.max_age = 25
        self.iters1 = 4
        self.iters2 = 2
        self.removed_count = 0  # keyframes culled (frontend.py:77-83)

    def _initialize(self, state: video_lib.VideoState, counter: int):
        """frontend.py:106-139."""
        self.t0, self.t1 = 0, counter
        self.graph.add_neighborhood_factors(state, self.t0, self.t1, r=3)
        for _ in range(8):
            state = self.graph.update(state, t0=1, use_inactive=True)
        self.graph.add_proximity_factors(
            state, t=counter, t0=0, t1=0, rad=2, nms=2,
            thresh=self.frontend_thresh, beta=self.beta, remove=False)
        for _ in range(8):
            state = self.graph.update(state, t0=1, use_inactive=True)
        state = video_lib.seed_next_frame(state, self.t1)
        self.is_initialized = True
        self.graph.rm_factors(self.graph.ii < self.warmup - 4, store=True)
        return state, counter

    def _update(self, state: video_lib.VideoState, counter: int):
        """frontend.py:51-104 -> (state, counter)."""
        self.t1 += 1
        if self.graph.n_active > 0:
            self.graph.rm_factors(self.graph.age > self.max_age, store=True)
        self.graph.add_proximity_factors(
            state, t=counter, t0=max(self.t1 - 5, 0),
            t1=max(self.t1 - self.frontend_window, 0),
            rad=self.frontend_radius, nms=self.frontend_nms,
            thresh=self.frontend_thresh, beta=self.beta, remove=True)

        # seed the new frame's disps from its sensor depth where present
        k = self.t1 - 1
        ds = state.disps_sens[k]
        state.disps[k] = torch.where(ds > 0, ds, state.disps[k])

        for _ in range(self.iters1):
            state = self.graph.update(state, use_inactive=True)

        # keyframe redundancy test (frontend.py:73-83): one host read
        dev = self.graph.device
        d = float(video_lib.frame_distance(
            state, self.graph.intrinsics,
            torch.tensor([self.t1 - 3], device=dev),
            torch.tensor([self.t1 - 2], device=dev), beta=self.beta)[0])
        if d < self.keyframe_thresh:
            state = self.graph.rm_keyframe(state, self.t1 - 2)
            counter -= 1
            self.t1 -= 1
            self.removed_count += 1
        else:
            if self.enable_loop and counter > self.frontend_window:
                raise NotImplementedError(LOOP_BA_TODO)
            for _ in range(self.iters2):
                state = self.graph.update(state, use_inactive=True)

        state = video_lib.seed_next_frame(state, self.t1)
        return state, counter

    def __call__(self, state: video_lib.VideoState, counter: int):
        """Per admitted keyframe (frontend.py:141-153)."""
        if not self.is_initialized and counter == self.warmup:
            return self._initialize(state, counter)
        if self.is_initialized and self.t1 < counter:
            return self._update(state, counter)
        return state, counter
