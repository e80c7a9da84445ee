"""Loop detection by global descriptors against the shared DB.

Port of `mneslam_tpu/agents/loop_detector.py`: a descriptor per mapped
keyframe, cosine-matched against every agent's published descriptors
(threshold `sim_threshold`; a match of the same agent needs
`min_time_diff` keyframes of separation; no matching until the DB holds
`loop_launch_th` entries), then the descriptor is published. The DB lives
on the host as numpy, as the comms exchange it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .comms import Comms


class LoopDetector:
    def __init__(self, config, comms: Comms, descriptor_fn):
        lc = config.get("loop_detection", {})
        self.loop_launch_th = lc.get("loop_launch_th", 20)
        self.min_time_diff = lc.get("min_time_diff", 20)
        self.sim_threshold = lc.get("sim_threshold", 0.8)
        self.comms = comms
        self.descriptor_fn = descriptor_fn

    def detect_and_add(self, current_kf_id: int, current_agent_id: int,
                       frame_rgb) -> Optional[Dict]:
        """frame_rgb [H, W, 3] in [0, 1] (tensor or array) -> the best
        match {match_kf_id, match_agent_id, similarity} or None; the
        frame's descriptor is published either way."""
        des = self.describe(frame_rgb)
        loop_info = self.match(des, current_kf_id, current_agent_id)
        self.comms.add_descriptor({"descriptor": des,
                                   "kf_id": int(current_kf_id),
                                   "agent_id": int(current_agent_id)})
        return loop_info

    def describe(self, frame_rgb) -> np.ndarray:
        """The frame's descriptor as a host array."""
        des = self.descriptor_fn(frame_rgb)
        if isinstance(des, torch.Tensor):
            des = des.detach().cpu().numpy()
        return np.asarray(des)

    def match(self, des: np.ndarray, current_kf_id: int,
              current_agent_id: int) -> Optional[Dict]:
        """The best match of a descriptor in the DB (`detect_and_add`'s
        search, which publishes nothing) or None."""
        loop_info = None
        db = self.comms.descriptors()
        if len(db) >= self.loop_launch_th:
            cand = np.stack([np.asarray(e["descriptor"]).reshape(-1)
                             for e in db])
            q = des.reshape(-1)
            sims = cand @ q / (np.linalg.norm(cand, axis=1)
                               * max(np.linalg.norm(q), 1e-12) + 1e-12)
            best_score, best_idx = -1.0, -1
            for i, s in enumerate(sims):
                if s < self.sim_threshold:
                    continue
                same_agent = db[i]["agent_id"] == current_agent_id
                if same_agent and abs(current_kf_id - db[i]["kf_id"]) \
                        < self.min_time_diff:
                    continue
                if s > best_score:
                    best_score, best_idx = float(s), i
            if best_idx >= 0:
                loop_info = {"match_kf_id": db[best_idx]["kf_id"],
                             "match_agent_id": db[best_idx]["agent_id"],
                             "similarity": best_score}
        return loop_info


def find_mutual_matches(local_descs, foreign_descs, sim_threshold: float):
    """Mutual-best cosine matches at or above the threshold, by falling
    similarity."""
    if not local_descs or not foreign_descs:
        return []
    L = np.stack([np.asarray(e["descriptor"]).reshape(-1)
                  for e in local_descs])
    Fd = np.stack([np.asarray(e["descriptor"]).reshape(-1)
                   for e in foreign_descs])
    Ln = L / np.maximum(np.linalg.norm(L, axis=1, keepdims=True), 1e-12)
    Fn = Fd / np.maximum(np.linalg.norm(Fd, axis=1, keepdims=True), 1e-12)
    sim = Ln @ Fn.T
    best_f = sim.argmax(axis=1)
    best_l = sim.argmax(axis=0)
    matches = []
    for i in range(len(local_descs)):
        j = best_f[i]
        if sim[i, j] < sim_threshold:
            continue
        if best_l[j] == i:
            matches.append({"local_kf_id": local_descs[i]["kf_id"],
                            "foreign_kf_id": foreign_descs[j]["kf_id"],
                            "similarity": float(sim[i, j])})
    return sorted(matches, key=lambda m: -m["similarity"])
