"""MNESLAM orchestrator: one agent, mapping-only or SLAM mode.

Port of the single-agent paths of `mneslam_tpu/slam.py`.

- `mode: mapping`: ground-truth poses from the dataset, one mapped
  keyframe every `mapping.keyframe_every` frames (`mapping.first_iters`
  steps on the first, `mapping.iters` on each later one).
- `mode: slam`: frames go through the tracker (motion filter, frontend,
  windowed dense BA) in batches of `tracking.motion_filter.batch`; the
  mapper trains each admitted keyframe at its tracked pose, staying one
  keyframe behind the tracker, and refreshes its keyframe poses from the
  tracker before each one.

Per-keyframe metrics stay on the device and are read back one keyframe
late, so the read overlaps the next keyframe's steps.

Outputs under `<data.output>/<data.exp_name>/agent_<rank>/`:
`metrics.jsonl` (one line per mapped keyframe) and, at `terminate`,
`final_checkpoint.npz` with the JAX package's key names, plus in SLAM mode
`key_est_poses.npy` and `key_timestamps.npy`.

Not ported yet (ROADMAP.md): the backend (the frontend's loop BA and the
periodic global BA raise when they would run, i.e. past
`tracking.frontend.window` keyframes), the trajectory filler, ATE and
`est_poses.npy`, mesh extraction at terminate, the render panels
(`mapping.vis`), periodic mesh snapshots and the multi-agent hooks.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .device import make_generator, resolve_device
from .mapping.mapper import Mapper
from .models import droid_net
from .models.scene_rep import SceneRep, param_items
from .tracking import video as video_lib
from .tracking.tracker import Tracker
from .utils.metrics import StageTimers


def checkpoint_key(path) -> str:
    """The JAX package's npz key for a parameter path, e.g.
    "['planes']/['xy']/[1]"."""
    return "/".join(f"[{k!r}]" for k in path)


def _refresh_kf_poses_batched(kf_poses: torch.Tensor,
                              mapped_ts: torch.Tensor,
                              video_state: video_lib.VideoState,
                              counter: int,
                              first_gt: torch.Tensor) -> torch.Tensor:
    """Mapper slot poses refreshed from the tracker by timestamp, all slots
    in one batched device op (slam.py:54-76). Slots whose timestamp has no
    live tracker row (culled keyframes, empty slots with timestamp -1)
    keep their pose."""
    T = video_state.poses.shape[0]
    all_poses = video_lib.get_poses_c2w(video_state, T, first_gt=first_gt)
    live = torch.arange(T, device=kf_poses.device) < counter
    m = ((mapped_ts[:, None] == video_state.timestamps[None, :])
         & live[None, :] & (mapped_ts >= 0.0)[:, None])
    row = m.to(torch.uint8).argmax(dim=1)
    return torch.where(m.any(dim=1)[:, None, None], all_poses[row], kf_poses)


class MNESLAM:
    def __init__(self, config: Dict, dataset, rank: int = 0,
                 device="cuda", droid_params: Optional[Dict] = None,
                 update_fn=None, agg_fn=None):
        self.device = resolve_device(device)
        self.config = config
        self.dataset = dataset
        self.rank = rank
        self.mode = config.get("mode", "slam")
        if self.mode not in ("mapping", "slam"):
            raise ValueError(f"mode {self.mode!r}: mneslam_tpu_torch runs "
                             "mode 'mapping' or 'slam'")

        out_root = config["data"].get("output", "output")
        exp = config["data"].get("exp_name", "exp")
        self.out_dir = os.path.join(out_root, exp, f"agent_{rank}")
        os.makedirs(self.out_dir, exist_ok=True)

        self.scene = SceneRep(config, self.device)
        if self.mode == "mapping":
            # mapping-only mode maps every keyframe_every-th frame
            num_kf = int(len(dataset) // config["mapping"]["keyframe_every"]
                         + 1)
        else:
            # SLAM mode maps every admitted keyframe
            num_kf = min(len(dataset), int(config["tracking"]["buffer"])) + 1
        self.mapper = Mapper(config, self.scene, num_kf=num_kf,
                             rays_per_kf=dataset.num_rays_to_save)
        self.map_state = self.mapper.init_state(
            make_generator(self.device, 42 + rank))
        self.generator = make_generator(self.device, 1000 + rank)
        self.timers = StageTimers(os.path.join(self.out_dir, "metrics.jsonl"))

        self.mapped_timestamps: list[float] = []
        self.first_frame_mapped = False
        self.metrics_log: list[Dict] = []
        self._metrics_flushed = 0  # log entries converted to host floats

        self.tracker = None
        if self.mode == "slam":
            self.tracker = Tracker(config, self._droid_params(droid_params),
                                   self._tracking_intrinsics(), self.device,
                                   update_fn=update_fn, agg_fn=agg_fn)
        self.map_counter = 0
        self.global_ba_every = int(config["mapping"].get("global_ba_every",
                                                         10))
        self._frame_cursor = 0
        self._last_global_ba = 0

    def _droid_params(self, droid_params: Optional[Dict]) -> Dict:
        """The given params, else `tracking.pretrained` when that file
        exists, else random weights from a fixed seed."""
        if droid_params is None:
            path = self.config["tracking"].get("pretrained")
            if path and os.path.exists(str(path)):
                if str(path).endswith(".npz"):
                    raise NotImplementedError(
                        "a .npz tracking.pretrained (utils/params_io) is not "
                        "ported yet; give the droid.pth state dict")
                droid_params = droid_net.load_droid_weights(str(path))
            else:
                droid_params = droid_net.init_droid_net(
                    make_generator(self.device, 7), device=self.device)
        return droid_net.map_params(
            droid_params, lambda t: t.detach().to(self.device))

    def _tracking_intrinsics(self) -> np.ndarray:
        """Edge-aware rescale (dataset_track.py:124-140): the image is
        resized to (H_out + 2 H_edge, W_out + 2 W_edge) and the edge band
        cropped, so the focal lengths scale with the padded size and the
        principal point shifts by the crop."""
        cam = self.config["cam"]
        he, we = int(cam.get("H_edge", 0)), int(cam.get("W_edge", 0))
        sx = (cam["W_out"] + 2 * we) / cam["W"]
        sy = (cam["H_out"] + 2 * he) / cam["H"]
        return np.asarray([cam["fx"] * sx, cam["fy"] * sy,
                           cam["cx"] * sx - we, cam["cy"] * sy - he])

    # ------------------------------------------------------------------

    def _frame_for_mapping(self, idx: int):
        item = self.dataset[idx]

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        frame = {"direction": dev(item["direction"]), "rgb": dev(item["rgb"]),
                 "depth": dev(item["depth"])}
        return frame, dev(item["c2w"])

    def _map_keyframe(self, frame_idx: int, frame: Dict,
                      pose_c2w: torch.Tensor, first: bool):
        with self.timers.stage("map_keyframe"):
            frame = dict(frame, frame_id=frame_idx)
            if first:
                self.map_state, metrics = self.mapper.first_frame_mapping(
                    self.map_state, frame, pose_c2w, self.generator)
                self.first_frame_mapped = True
            else:
                self.map_state = self.mapper.add_keyframe(
                    self.map_state, frame_idx, frame, pose_c2w,
                    self.generator)
                self.map_state, metrics = self.mapper.optimize(
                    self.map_state, frame, pose_c2w, self.generator,
                    iters=int(self.config["mapping"]["iters"]))
            self._post_map_bookkeeping(frame_idx, metrics)
        return metrics

    def _post_map_bookkeeping(self, frame_idx: int, metrics):
        """Log the keyframe. The new entry keeps its device scalars; the
        entries before it are read back and written to metrics.jsonl now,
        while this keyframe's steps may still run on the device."""
        self.mapped_timestamps.append(float(frame_idx))
        self.metrics_log.append(dict(metrics))
        self._flush_metrics(upto=len(self.metrics_log) - 1)

    def _flush_metrics(self, upto: Optional[int] = None):
        """Convert queued metrics_log entries to host floats and write them
        to metrics.jsonl; `upto` = flush entries with index < upto (default
        all)."""
        end = len(self.metrics_log) if upto is None else upto
        while self._metrics_flushed < end:
            i = self._metrics_flushed
            entry = {k: float(v) for k, v in self.metrics_log[i].items()}
            self.metrics_log[i] = entry
            self.timers.log_scalars(int(self.mapped_timestamps[i]), entry)
            self._metrics_flushed = i + 1

    # ------------------------------------------------------------------

    def run_mapping_only(self, log_every: int = 10):
        """Map every keyframe_every-th frame at its ground-truth pose."""
        every = int(self.config["mapping"]["keyframe_every"])
        t0 = time.time()
        for idx in range(0, len(self.dataset), every):
            frame, pose = self._frame_for_mapping(idx)
            self._map_keyframe(idx, frame, pose,
                               first=not self.first_frame_mapped)
            if (idx // every) % log_every == 0:
                m = self.metrics_log[-1]
                print(f"[agent {self.rank}] map kf {idx}: "
                      f"psnr={float(m['psnr']):.1f} "
                      f"loss={float(m['loss']):.4f}")
        self._flush_metrics()
        elapsed = time.time() - t0
        print(f"[agent {self.rank}] mapping-only done: "
              f"{len(self.mapped_timestamps)} kfs in {elapsed:.1f}s")
        return self.metrics_log

    # ------------------------------------------------------------------
    # SLAM mode
    # ------------------------------------------------------------------

    def _to_tracking_res(self, rgb: np.ndarray) -> torch.Tensor:
        """[H, W, 3] -> [3, H_out, W_out] on the device: bilinear resize to
        (H_out + 2 H_edge, W_out + 2 W_edge) without antialiasing (the
        reference loader's cv2 INTER_LINEAR), then the edge band cropped
        (datasets/dataset_track.py:101-142)."""
        cam = self.config["cam"]
        he, we = int(cam.get("H_edge", 0)), int(cam.get("W_edge", 0))
        Hp, Wp = cam["H_out"] + 2 * he, cam["W_out"] + 2 * we
        img = torch.as_tensor(np.asarray(rgb, np.float32),
                              device=self.device).permute(2, 0, 1)
        if img.shape[1:] != (Hp, Wp):
            img = F.interpolate(img[None], size=(Hp, Wp), mode="bilinear",
                                align_corners=False, antialias=False)[0]
        return img[:, he:Hp - he, we:Wp - we]

    def _depth_to_tracking_res(self, depth: np.ndarray) -> torch.Tensor:
        """[H, W] -> [H_out, W_out]: nearest with the source index
        floor(out_index * in / out) (torch's F.interpolate 'nearest', the
        reference loader), then the edge band cropped."""
        cam = self.config["cam"]
        he, we = int(cam.get("H_edge", 0)), int(cam.get("W_edge", 0))
        Hp, Wp = cam["H_out"] + 2 * he, cam["W_out"] + 2 * we
        d = torch.as_tensor(np.asarray(depth, np.float32), device=self.device)
        if d.shape != (Hp, Wp):
            f32 = dict(dtype=torch.float32, device=self.device)
            iy = torch.floor(torch.arange(Hp, **f32)
                             * (d.shape[0] / Hp)).long()
            ix = torch.floor(torch.arange(Wp, **f32)
                             * (d.shape[1] / Wp)).long()
            d = d[iy][:, ix]
        return d[he:Hp - he, we:Wp - we]

    def _tracked_pose_c2w(self, kf_index: int) -> torch.Tensor:
        """c2w of keyframe kf_index in the GT-aligned world frame
        (depth_video.py:185-218)."""
        st = self.tracker.state
        poses = video_lib.get_poses_c2w(st, st.poses.shape[0],
                                        first_gt=st.poses_gt[0])
        return poses[kf_index]

    def _refresh_mapped_poses(self):
        """Mapper keyframe poses <- the tracker's current poses, matched by
        timestamp, in one batched device op with no host readback (the
        reference reads poses fresh per mapping iteration,
        mp_slam/mapper.py:193-198)."""
        if not self.mapped_timestamps:
            return
        with self.timers.stage("pose_refresh"):
            num_kf = self.map_state.kf_poses.shape[0]
            mts = np.full((num_kf,), -1.0, np.float32)
            k = min(len(self.mapped_timestamps), num_kf)
            mts[:k] = self.mapped_timestamps[:k]
            st = self.tracker.state
            self.map_state.kf_poses = _refresh_kf_poses_batched(
                self.map_state.kf_poses,
                torch.as_tensor(mts, device=self.device), st,
                self.tracker.counter, st.poses_gt[0])

    def track_step(self) -> bool:
        """Track one motion-filter batch; False once the dataset is
        exhausted."""
        n_frames = len(self.dataset)
        if self._frame_cursor >= n_frames:
            return False
        batch = max(1, int(self.config["tracking"]["motion_filter"].get(
            "batch", 1)))
        idxs = list(range(self._frame_cursor,
                          min(self._frame_cursor + batch, n_frames)))
        self._frame_cursor = idxs[-1] + 1
        items = [self.dataset[i] for i in idxs]
        imgs = [self._to_tracking_res(it["rgb"]) for it in items]
        deps = [self._depth_to_tracking_res(it["depth"]) for it in items]
        gts = [torch.as_tensor(it["c2w"], dtype=torch.float32,
                               device=self.device) for it in items]
        with self.timers.stage("track_frame"):
            if batch == 1:
                self.tracker.run(float(idxs[0]), imgs[0], depth=deps[0],
                                 gt_pose=gts[0])
            else:
                self.tracker.run_batch([float(i) for i in idxs], imgs, deps,
                                       gts)
        return True

    @torch.no_grad()
    def pending_keyframe(self) -> Optional[Tuple[int, int, torch.Tensor]]:
        """The next tracked but unmapped keyframe as (slot, frame id, c2w),
        or None: the mapper stays at least one keyframe behind tracking
        (mp_slam/mapper.py:173-176)."""
        if self.tracker is None or not self.tracker.frontend.is_initialized:
            return None
        if self.map_counter >= self.tracker.counter - 1:
            return None
        kf_idx = self.map_counter
        ts = float(self.tracker.state.timestamps[kf_idx])
        self._refresh_mapped_poses()
        return kf_idx, int(ts), self._tracked_pose_c2w(kf_idx)

    def maybe_global_ba(self):
        """The periodic global BA (the reference's BundleAdjustment
        thread); it raises, not ported yet, when it would run."""
        if self.tracker is None:
            return
        if (self.tracker.counter - self._last_global_ba
                >= self.global_ba_every
                and self.tracker.counter
                > self.config["tracking"]["frontend"]["window"]):
            self.tracker.global_ba(steps=2)
            self._last_global_ba = self.tracker.counter

    def slam_step(self) -> bool:
        """Track one motion-filter batch, map the pending keyframes, run
        the periodic global BA; False once the dataset is exhausted."""
        if not self.track_step():
            return False
        while True:
            pending = self.pending_keyframe()
            if pending is None:
                break
            _, frame_id, pose = pending
            frame, _ = self._frame_for_mapping(frame_id)
            self._map_keyframe(frame_id, frame, pose,
                               first=not self.first_frame_mapped)
            self.map_counter += 1
        self.maybe_global_ba()
        return True

    def run_slam(self):
        """Batched tracking with lagged mapping to the end of the dataset,
        then `terminate`."""
        t0 = time.time()
        while self.slam_step():
            pass
        self._flush_metrics()
        print(f"[agent {self.rank}] slam done: {self.tracker.counter} "
              f"keyframes tracked, {len(self.mapped_timestamps)} mapped in "
              f"{time.time() - t0:.1f}s")
        return self.terminate()

    # ------------------------------------------------------------------

    def terminate(self):
        """Flush the metric log and write final_checkpoint.npz; in SLAM
        mode also key_est_poses.npy (GT-aligned c2w) and
        key_timestamps.npy."""
        self._flush_metrics()
        results = {"keyframes": len(self.mapped_timestamps)}
        if self.tracker is not None and self.tracker.counter > 1:
            n = self.tracker.counter
            st = self.tracker.state
            key_poses = video_lib.get_poses_c2w(st, n,
                                                first_gt=st.poses_gt[0])
            np.save(os.path.join(self.out_dir, "key_est_poses.npy"),
                    key_poses.cpu().numpy())
            np.save(os.path.join(self.out_dir, "key_timestamps.npy"),
                    self.tracker.keyframe_timestamps())
            results["tracked_keyframes"] = n
        path = os.path.join(self.out_dir, "final_checkpoint.npz")
        self.save_checkpoint(path)
        self.timers.close()
        results["checkpoint"] = path
        return results

    # ------------------------------------------------------------------

    def save_checkpoint(self, path: str):
        """Flat npz of the map params + keyframe poses, under the JAX
        package's key names."""
        arrays = {checkpoint_key(p): t.detach().cpu().numpy()
                  for p, t in param_items(self.map_state.params)}
        arrays["__kf_poses"] = self.map_state.kf_poses.cpu().numpy()
        arrays["__kf_count"] = np.asarray(self.map_state.db.count, np.int32)
        np.savez(path, **arrays)

    def load_checkpoint(self, path: str):
        """Load params and keyframe poses in place (the optimizer keeps its
        references to the parameter tensors)."""
        with np.load(path) as data, torch.no_grad():
            for p, t in param_items(self.map_state.params):
                t.copy_(torch.as_tensor(data[checkpoint_key(p)]))
            self.map_state.kf_poses.copy_(
                torch.as_tensor(data["__kf_poses"]))
