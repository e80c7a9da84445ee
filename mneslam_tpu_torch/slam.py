"""MNESLAM orchestrator, mapping-only mode.

Port of the mapping-only path of `mneslam_tpu/slam.py`: ground-truth poses
from the dataset, one mapped keyframe every `mapping.keyframe_every`
frames (`mapping.first_iters` steps on the first, `mapping.iters` on each
later one). Per-keyframe metrics stay on the device and are read back one
keyframe late, so the read overlaps the next keyframe's steps.

Outputs under `<data.output>/<data.exp_name>/agent_<rank>/`:
`metrics.jsonl` (one line per mapped keyframe) and, at `terminate`,
`final_checkpoint.npz` with the JAX package's key names.

Not ported yet (ROADMAP.md): tracking (`mode: slam`), mesh extraction at
terminate, the render panels (`mapping.vis`), periodic mesh snapshots and
the multi-agent hooks.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from .device import make_generator, resolve_device
from .mapping.mapper import Mapper
from .models.scene_rep import SceneRep, param_items
from .utils.metrics import StageTimers


def checkpoint_key(path) -> str:
    """The JAX package's npz key for a parameter path, e.g.
    "['planes']/['xy']/[1]"."""
    return "/".join(f"[{k!r}]" for k in path)


class MNESLAM:
    def __init__(self, config: Dict, dataset, rank: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.dataset = dataset
        self.rank = rank
        self.mode = config.get("mode", "slam")
        if self.mode != "mapping":
            raise ValueError(f"mode {self.mode!r} is not ported; "
                             "mneslam_tpu_torch runs mode 'mapping'")

        out_root = config["data"].get("output", "output")
        exp = config["data"].get("exp_name", "exp")
        self.out_dir = os.path.join(out_root, exp, f"agent_{rank}")
        os.makedirs(self.out_dir, exist_ok=True)

        self.scene = SceneRep(config, self.device)
        # mapping-only mode maps every keyframe_every-th frame
        num_kf = int(len(dataset) // config["mapping"]["keyframe_every"] + 1)
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

    def terminate(self):
        """Flush the metric log and write final_checkpoint.npz."""
        self._flush_metrics()
        path = os.path.join(self.out_dir, "final_checkpoint.npz")
        self.save_checkpoint(path)
        self.timers.close()
        return {"checkpoint": path,
                "keyframes": len(self.mapped_timestamps)}

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
