"""Motion filter: keyframe admission by learned flow magnitude.

Port of `mneslam_tpu/tracking/motion_filter.py`. Every input frame is
feature-encoded; one GRU update over the self-correlation with the last
keyframe estimates the mean flow, and the frame is admitted when it
exceeds `tracking.motion_filter.thresh`. `track_batch` keeps the JAX
package's design: the admission decision and the conditional append stay
on the device (device-side selects at a device-side slot counter), and the
host reads back one flags vector per batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..models import droid_net
from ..ops import correlation, lie
from . import video as video_lib


def encode_frame(params: Dict, image: torch.Tensor) -> torch.Tensor:
    """image [3, H, W] in [0, 1] -> fmap [128, H/8, W/8]."""
    x = droid_net.normalize_images(image[None])
    return droid_net.feature_encoder(params, x)[0]


def encode_context(params: Dict, image: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = droid_net.normalize_images(image[None])
    net, inp = droid_net.context_encoder(params, x)
    return net[0], inp[0]


def flow_magnitude(params: Dict, fmap_prev: torch.Tensor,
                   fmap_new: torch.Tensor, net: torch.Tensor,
                   inp: torch.Tensor) -> torch.Tensor:
    """Mean |delta| of one update on the self-correlation (a device
    scalar; motion_filter.py:70-74)."""
    corr = correlation.self_corr(fmap_prev, fmap_new)
    _, delta, _ = droid_net.update_apply(params["update"], net[None],
                                         inp[None], corr)
    return delta.norm(dim=-1).mean()


def encode_and_flow(params: Dict, fmap_prev: torch.Tensor, net: torch.Tensor,
                    inp: torch.Tensor, image: torch.Tensor):
    """Feature-encode a frame and estimate its flow to the last keyframe."""
    gmap = encode_frame(params, image)
    return gmap, flow_magnitude(params, fmap_prev, gmap, net, inp)


def _put(buf: torch.Tensor, slot: torch.Tensor, admit: torch.Tensor,
         new: torch.Tensor):
    """buf[slot] = new if admit else buf[slot], with a device-side slot
    (index_select / index_copy_: no host read of `slot`)."""
    old = buf.index_select(0, slot)[0]
    buf.index_copy_(0, slot, torch.where(admit, new.to(buf.dtype), old)[None])


def track_batch_step(params: Dict, state: video_lib.VideoState,
                     counter: torch.Tensor, fmap_kf: torch.Tensor,
                     net_kf: torch.Tensor, inp_kf: torch.Tensor,
                     images: torch.Tensor, depths: torch.Tensor,
                     timestamps: torch.Tensor, gts: torch.Tensor,
                     thresh: float):
    """Admit / append a batch of frames with no host readback.

    counter: [1] long, the next free keyframe slot; images [B, 3, H, W],
    depths [B, H, W], timestamps [B], gts [B, 4, 4]. The encoders run
    batched; the sequential decide-and-append runs frame by frame on the
    device (the JAX `lax.scan`). Returns (state, counter, fmap_kf, net_kf,
    inp_kf, admits [B] bool, deltas [B]); the state is written in place."""
    x = droid_net.normalize_images(images)
    gmaps = droid_net.feature_encoder(params, x)
    nets, inps = droid_net.context_encoder(params, x)
    admits, deltas = [], []
    for k in range(images.shape[0]):
        d = flow_magnitude(params, fmap_kf, gmaps[k], net_kf, inp_kf)
        admit = d > thresh
        disp = video_lib.sensor_disparity(depths[k])
        _put(state.timestamps, counter, admit,
             timestamps[k].to(state.timestamps.dtype))
        _put(state.fmaps, counter, admit, gmaps[k])
        _put(state.nets, counter, admit, nets[k])
        _put(state.inps, counter, admit, inps[k])
        _put(state.poses_gt, counter, admit, gts[k])
        _put(state.disps_sens, counter, admit, disp)
        _put(state.disps, counter, admit,
             torch.where(disp > 0, disp, torch.ones_like(disp)))
        counter = counter + admit.long()
        fmap_kf = torch.where(admit, gmaps[k], fmap_kf)
        net_kf = torch.where(admit, nets[k], net_kf)
        inp_kf = torch.where(admit, inps[k], inp_kf)
        admits.append(admit)
        deltas.append(d)
    return (state, counter, fmap_kf, net_kf, inp_kf, torch.stack(admits),
            torch.stack(deltas))


class MotionFilter:
    def __init__(self, params: Dict, thresh: float = 4.0):
        self.params = params
        self.thresh = thresh
        self.fmap = None  # features of the last admitted keyframe
        self.net = None
        self.inp = None
        self.count = 0
        # flow evaluations against the last keyframe (one self-correlation
        # lookup each)
        self.comparisons = 0

    def _first(self, state, timestamp, image, depth, gt):
        gmap = encode_frame(self.params, image)
        net, inp = encode_context(self.params, image)
        self.fmap, self.net, self.inp = gmap, net, inp
        return video_lib.append_frame(
            state, 0, timestamp, lie.identity(device=image.device), depth,
            gmap, net, inp, gt)

    def track(self, state: video_lib.VideoState, counter: int,
              timestamp: float, image: torch.Tensor,
              depth: Optional[torch.Tensor], gt_pose: Optional[torch.Tensor]
              ) -> Tuple[video_lib.VideoState, int, bool]:
        """One input frame -> (state, counter, admitted); one host read of
        the flow per frame."""
        gt = gt_pose if gt_pose is not None else torch.eye(
            4, device=image.device)
        if counter == 0:
            return self._first(state, timestamp, image, depth, gt), 1, True
        gmap, delta = encode_and_flow(self.params, self.fmap, self.net,
                                      self.inp, image)
        self.comparisons += 1
        if float(delta) > self.thresh:
            self.count = 0
            net, inp = encode_context(self.params, image)
            self.fmap, self.net, self.inp = gmap, net, inp
            state = video_lib.append_frame(state, counter, timestamp, None,
                                           depth, gmap, net, inp, gt)
            return state, counter + 1, True
        self.count += 1
        return state, counter, False

    def track_batch(self, state: video_lib.VideoState, counter: int,
                    timestamps: Sequence[float],
                    images: Sequence[torch.Tensor],
                    depths: Sequence[torch.Tensor],
                    gt_poses: Optional[Sequence[Optional[torch.Tensor]]] = None
                    ) -> Tuple[video_lib.VideoState, int, List[bool]]:
        """A batch of frames with one readback; the same admissions as
        `track` per frame (the first-ever frame still goes through
        `track`)."""
        n = len(timestamps)
        admitted: List[bool] = []
        i = 0
        dev = images[0].device
        if counter == 0:
            gt0 = gt_poses[0] if gt_poses is not None else None
            state, counter, adm = self.track(state, 0, timestamps[0],
                                             images[0], depths[0], gt0)
            admitted.append(adm)
            i = 1
        if i < n:
            gts = [gt_poses[k] if gt_poses is not None
                   and gt_poses[k] is not None else torch.eye(4, device=dev)
                   for k in range(i, n)]
            (state, counter_t, fmap, net, inp, admits, _) = track_batch_step(
                self.params, state,
                torch.tensor([counter], dtype=torch.long, device=dev),
                self.fmap, self.net, self.inp, torch.stack(list(images[i:])),
                torch.stack(list(depths[i:])),
                torch.tensor(list(timestamps[i:]), dtype=torch.float32,
                             device=dev),
                torch.stack(gts), self.thresh)
            self.comparisons += n - i
            # the one readback of the batch: flags and the new counter
            packed = torch.cat([admits.long(), counter_t]).cpu().tolist()
            flags, counter = packed[:-1], packed[-1]
            self.fmap, self.net, self.inp = fmap, net, inp
            admitted.extend(bool(a) for a in flags)
            run = 0
            for a in reversed(admitted):
                if a:
                    break
                run += 1
            self.count = run if any(admitted) else self.count + run
        return state, counter, admitted
