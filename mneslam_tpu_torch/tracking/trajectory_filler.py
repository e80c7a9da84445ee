"""Pose trajectory filler: a pose for every frame, not only the keyframes.

Port of `mneslam_tpu/tracking/trajectory_filler.py`: frames go in chunks of
16; each frame's pose is seeded by SE(3) interpolation between its
bracketing keyframes, then refined by 6 motion-only GRU / BA updates
against those keyframes. Each chunk runs in a small scratch buffer
[anchor keyframes | chunk frames], so the BA window covers every edge
wherever the anchors lie in the history. The keyframe timestamps are read
back once per chunk.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..models import droid_net
from ..ops import lie
from . import video as video_lib
from .graph import FactorGraph

CHUNK = 16


class PoseTrajectoryFiller:
    def __init__(self, params: Dict, intrinsics: torch.Tensor, update_fn=None,
                 agg_fn=None):
        self.params = params
        self.intrinsics = intrinsics
        self.update_fn = update_fn
        self.agg_fn = agg_fn
        self.lookups = 0    # correlation lookups of the chunks' updates

    def _fill_chunk(self, state: video_lib.VideoState, counter: int,
                    timestamps: np.ndarray, images: torch.Tensor
                    ) -> torch.Tensor:
        """w2c poses [M, 7] of one chunk of frames (images [M, 3, H, W])."""
        M = len(timestamps)
        dev = state.poses.device
        kf_ts = state.timestamps[:counter].cpu().numpy()

        # bracketing keyframes (trajectory_filler.py:48-57)
        t0 = np.asarray([max(int((kf_ts <= t).sum()) - 1, 0)
                         for t in timestamps])
        t1 = np.where(t0 < counter - 1, t0 + 1, t0)

        Ps = state.poses[:counter]
        t0_d = torch.from_numpy(t0).to(dev)
        t1_d = torch.from_numpy(t1).to(dev)
        dt = torch.from_numpy(
            (kf_ts[t1] - kf_ts[t0] + 1e-3).astype(np.float32)).to(dev)
        since = torch.from_numpy(
            (timestamps - kf_ts[t0]).astype(np.float32)).to(dev)
        dP = lie.mul(Ps[t1_d], lie.inv(Ps[t0_d]))
        v = lie.log(dP) / dt[:, None]
        seeds = lie.mul(lie.exp(v * since[:, None]), Ps[t0_d])   # [M, 7]

        fmaps = droid_net.feature_encoder(
            self.params, droid_net.normalize_images(images)).float()

        # scratch buffer: [unique anchors | chunk frames]
        anchors = np.unique(np.concatenate([t0, t1]))
        A = len(anchors)
        size = A + M
        ht, wd = state.disps.shape[1:]
        a_idx = torch.from_numpy(anchors).to(dev)
        mini = video_lib.init_video(size, ht, wd, device=dev)
        mini = mini._replace(
            poses=torch.cat([state.poses[a_idx], seeds]),
            disps=torch.cat([state.disps[a_idx],
                             torch.ones((M, ht, wd), device=dev)]),
            disps_sens=torch.cat([state.disps_sens[a_idx],
                                  torch.zeros((M, ht, wd), device=dev)]),
            fmaps=torch.cat([state.fmaps[a_idx].float(), fmaps]),
            nets=torch.cat([state.nets[a_idx].float(),
                            torch.zeros_like(fmaps)]),
            inps=torch.cat([state.inps[a_idx].float(),
                            torch.zeros_like(fmaps)]),
            timestamps=torch.cat([state.timestamps[a_idx],
                                  torch.from_numpy(timestamps.astype(
                                      np.float32)).to(dev)]))

        remap = {int(a): k for k, a in enumerate(anchors)}
        ii = np.asarray([remap[int(a)] for a in np.concatenate([t0, t1])])
        jj = np.concatenate([np.arange(A, A + M), np.arange(A, A + M)])

        window = int(2 ** np.ceil(np.log2(size + 1)))
        graph = FactorGraph(size, ht, wd, capacity=2 * M + 8,
                            params=self.params, intrinsics=self.intrinsics,
                            window=window, update_fn=self.update_fn,
                            agg_fn=self.agg_fn)
        graph.add_factors(mini, ii, jj)
        for _ in range(6):
            mini = graph.update(mini, t0=A, t1=size, iters=2,
                                motion_only=True)
        self.lookups += graph.lookups
        return mini.poses[A:A + M]

    @torch.no_grad()
    def __call__(self, state: video_lib.VideoState, counter: int,
                 frame_stream) -> torch.Tensor:
        """Fill every streamed (timestamp, image [3, H, W]) -> w2c poses
        [n_frames, 7]."""
        poses: List[torch.Tensor] = []
        ts_buf, img_buf = [], []
        for timestamp, image in frame_stream:
            ts_buf.append(float(timestamp))
            img_buf.append(image)
            if len(ts_buf) == CHUNK:
                poses.append(self._fill_chunk(state, counter,
                                              np.asarray(ts_buf),
                                              torch.stack(img_buf)))
                ts_buf, img_buf = [], []
        if ts_buf:
            poses.append(self._fill_chunk(state, counter, np.asarray(ts_buf),
                                          torch.stack(img_buf)))
        return torch.cat(poses)
