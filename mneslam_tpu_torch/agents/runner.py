"""Agent collaboration and the round-robin multi-agent runner.

Port of `mneslam_tpu/agents/runner.py`. `AgentCollaboration` gives one
`MNESLAM` agent its multi-agent behaviour: it publishes keyframes and
checkpoints after every mapped keyframe, detects loops against every
agent's descriptors, closes a loop by render-based pose alignment with
the acceptance gate (`loop_closure.mode`: "gated", the default, or
"reference") and trajectory deformation, and at the end fuses maps by
bound-overlap distillation and writes `mesh/fused_mesh.ply`.

`MultiAgentRunner` advances the agents round-robin in one process, on one
device, exchanging through `InMemoryComms` (or `FileComms`).
"""

from __future__ import annotations

import copy
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.scene_rep import SceneRep
from . import fusion
from .comms import Comms, InMemoryComms, unpack_params
from .loop_detector import LoopDetector, find_mutual_matches
from .netvlad import make_descriptor_fn


def load_agent_bounds(config, world_size: int) -> Dict[int, np.ndarray]:
    """Per-agent bound table from the `loop_bound` section
    (`bound_<rank>`, else `mapping.bound`)."""
    default = np.asarray(config["mapping"]["bound"], float)
    if world_size == 1:
        return {0: default}
    lb = config.get("loop_bound") or {}
    return {r: np.asarray(lb.get(f"bound_{r}", default), float)
            for r in range(world_size)}


class AgentCollaboration:
    def __init__(self, slam, comms: Comms, descriptor_fn=None):
        self.slam = slam
        self.comms = comms
        cfg = slam.config
        self.device = slam.device
        if descriptor_fn is None:
            descriptor_fn = make_descriptor_fn(cfg, self.device)
        self.loop_detector = LoopDetector(cfg, comms, descriptor_fn)
        # the reference's top-level enable_loop_detect key wins
        self.enable_loop_detect = bool(cfg.get(
            "enable_loop_detect",
            cfg.get("loop_detection", {}).get("enabled", True)))
        self.all_agent_bounds = load_agent_bounds(cfg, slam.world_size)
        self.fused_agents: set[int] = set()
        self.fused_frame_ids: set = set()
        self.aligned_poses_c2w: Optional[np.ndarray] = None
        # the accepted closure with the lowest render loss so far: its
        # transform is re-applied to the growing raw trajectory on every
        # publish
        self.closure_relative: Optional[np.ndarray] = None
        self.closure_loss: float = float("inf")
        self.closure_init_loss: float = float("inf")
        self.closure_loop_ts: float = -1.0
        # counters read by the chip smoke test
        self.closures_accepted = 0
        self.closures_rejected = 0
        self.alignments = 0
        self.distillations = 0
        self._foreign_scenes: Dict[int, SceneRep] = {}

    # ------------------------------------------------------------------
    # publication
    # ------------------------------------------------------------------

    def publish(self, kf_poses_c2w: np.ndarray, kf_timestamps: np.ndarray):
        """Publish the keyframe trajectory (closure-deformed once a closure
        is accepted) and the map checkpoint with its bound."""
        slam = self.slam
        self._apply_closure(kf_poses_c2w, kf_timestamps)
        if self.aligned_poses_c2w is not None:
            kf_poses_c2w = np.asarray(self.aligned_poses_c2w)
        self.comms.publish_keyframes(slam.rank, kf_poses_c2w, kf_timestamps)
        self.comms.publish_checkpoint(
            slam.rank, slam.map_state.params,
            {"bound": slam.scene.bounding_box.cpu().numpy()})

    # ------------------------------------------------------------------

    def _foreign_scene(self, rank: int, bound: np.ndarray) -> SceneRep:
        if rank not in self._foreign_scenes:
            cfg = copy.deepcopy(self.slam.config)
            cfg["mapping"]["bound"] = np.asarray(bound).tolist()
            self._foreign_scenes[rank] = SceneRep(cfg, self.device)
        return self._foreign_scenes[rank]

    def _load_foreign(self, rank: int):
        """(scene, params) of another agent from its latest checkpoint, or
        (None, None)."""
        ck = self.comms.get_checkpoint(rank)
        if ck is None:
            return None, None
        params_or_flat, meta = ck
        bound = np.asarray(meta.get("bound", self.all_agent_bounds[rank]))
        scene = self._foreign_scene(rank, bound)
        if isinstance(params_or_flat, dict) and any(
                "/" in k for k in params_or_flat):
            template = scene.init_params(
                torch.Generator(device=self.device).manual_seed(0))
            params = unpack_params(template, params_or_flat)
        else:
            params = params_or_flat
        return scene, params

    def _rays_d_cam(self) -> np.ndarray:
        return np.asarray(self.slam.dataset[0]["direction"],
                          np.float32).reshape(-1, 3)

    # ------------------------------------------------------------------
    # loop closure
    # ------------------------------------------------------------------

    def on_keyframe_mapped(self, kf_id: int, frame_rgb, cur_c2w,
                           kf_poses_c2w: np.ndarray,
                           kf_timestamps: np.ndarray):
        """After each mapped keyframe: publish, detect, maybe close a
        loop."""
        self.publish(kf_poses_c2w, kf_timestamps)
        if not self.enable_loop_detect:
            return None
        info = self.loop_detector.detect_and_add(kf_id, self.slam.rank,
                                                 frame_rgb)
        # a match of the same agent also goes through render alignment (the
        # detector's min_time_diff already filters recent frames)
        if info is not None:
            self.handle_loop_closure(info, kf_id, cur_c2w, kf_poses_c2w,
                                     kf_timestamps)
        return info

    def peer_needed(self, info: Dict, current_map_id: int) -> Optional[int]:
        """The agent whose map `handle_loop_closure(info, current_map_id)`
        would load (`_load_foreign`), or None when it returns before: the
        same checks, with no side effect. The mesh fleet's leaders fetch
        that map before the hook runs (`parallel/fleet.ComposedFleet`)."""
        other = int(info["match_agent_id"])
        if (other, current_map_id) in self.fused_frame_ids:
            return None
        other_kfs = self.comms.get_keyframes(other)
        if other_kfs is None or not np.any(other_kfs[1]
                                           == info["match_kf_id"]):
            return None
        return other

    def handle_loop_closure(self, info: Dict, current_map_id: int, cur_c2w,
                            kf_poses_c2w: np.ndarray,
                            kf_timestamps: np.ndarray):
        """Align the matched pair by rendering and, when this agent is the
        target (the higher rank), gate the closure and deform the raw
        trajectory -> the relative transform base <- target (numpy), or
        None when the match could not be aligned."""
        slam = self.slam
        other = int(info["match_agent_id"])
        if other != slam.rank:
            self.fused_agents.add(other)
        loop_id = (other, current_map_id)
        if loop_id in self.fused_frame_ids:
            return None
        self.fused_frame_ids.add(loop_id)

        other_kfs = self.comms.get_keyframes(other)
        if other_kfs is None:
            return None
        o_poses, o_ts = other_kfs
        hits = np.nonzero(o_ts == info["match_kf_id"])[0]
        if len(hits) == 0:
            return None
        other_c2w = np.asarray(o_poses[int(hits[0])], np.float32)
        cur = np.asarray(cur_c2w, np.float32)

        # base / target by rank order
        target_is_self = slam.rank >= other
        base_np, target_np = ((other_c2w, cur) if target_is_self
                              else (cur, other_c2w))

        f_scene, f_params = self._load_foreign(other)
        if f_params is None:
            return None
        own = (slam.scene, slam.map_state.params)
        (scene_b, params_b), (scene_t, params_t) = (
            ((f_scene, f_params), own) if target_is_self
            else (own, (f_scene, f_params)))

        # sampled camera rays
        cfg = slam.config
        sample = int(cfg["mapping"]["sample"])
        rays_d_cam = self._rays_d_cam()
        idx = np.random.default_rng(current_map_id).integers(
            0, len(rays_d_cam), sample)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        best_c2w, best_loss, init_loss = fusion.align_pose_by_render(
            scene_b, params_b, scene_t, params_t, dev(base_np),
            dev(target_np), dev(rays_d_cam[idx]),
            iters=int(cfg["mapping"]["loop_iters"]),
            lr_rot=float(cfg["mapping"]["lr_rot"]),
            lr_trans=float(cfg["mapping"]["lr_trans"]),
            rgb_weight=float(cfg["training"]["rgb_weight"]),
            depth_weight=float(cfg["training"]["depth_weight"]),
            rot_rep=cfg["training"]["rot_rep"])
        self.alignments += 1
        relative = base_np @ np.linalg.inv(best_c2w.detach().cpu().numpy())

        if target_is_self:
            # Each closure re-estimates the whole inter-agent transform
            # against this agent's own-world (tracker) pose, so it deforms
            # the raw trajectory, never the previous aligned one. Gate
            # (loop_closure.mode "gated"): a closure counts only if the
            # render alignment converged, its best loss under accept_loss
            # or under accept_ratio x the init-pose loss; among accepted
            # closures the lowest loss wins. "reference" applies every
            # closure unconditionally.
            lc = cfg.get("loop_closure", {})
            mode = str(lc.get("mode", "gated"))
            best, init = float(best_loss), float(init_loss)
            if mode == "reference":
                accepted, take = True, True
            else:
                accepted = (best <= float(lc.get("accept_loss", 0.05))
                            or best <= float(lc.get("accept_ratio", 0.25))
                            * init)
                take = accepted and best < self.closure_loss
            if accepted:
                self.closures_accepted += 1
            else:
                self.closures_rejected += 1
            if take:
                self.closure_relative = np.asarray(relative)
                self.closure_loss = best
                self.closure_init_loss = init
                self.closure_loop_ts = float(current_map_id)
                print(f"[agent {slam.rank}] loop with agent {other}: "
                      f"accepted closure (loss {best:.5f}, init {init:.5f})")
            elif not accepted:
                print(f"[agent {slam.rank}] loop with agent {other}: "
                      f"rejected closure (loss {best:.5f}, init {init:.5f})")
            self._apply_closure(kf_poses_c2w, kf_timestamps)
        return relative

    def _apply_closure(self, kf_poses_c2w: np.ndarray,
                       kf_timestamps: np.ndarray):
        """Deform the current raw keyframe trajectory with the stored best
        closure transform (SLERP decay about the closure keyframe)."""
        if self.closure_relative is None:
            return
        poses = np.asarray(kf_poses_c2w, np.float32)
        hits = np.nonzero(np.asarray(kf_timestamps)[: len(poses)]
                          == self.closure_loop_ts)[0]
        loop_idx = int(hits[0]) if len(hits) else len(poses) - 1
        lc = self.slam.config.get("loop_closure", {})
        self.aligned_poses_c2w = fusion.deform_trajectory(
            torch.as_tensor(poses), loop_idx,
            torch.as_tensor(self.closure_relative, dtype=torch.float32),
            decay_sigma=float(lc.get("pose_decay_sigma", 10.0)),
            min_weight=float(lc.get("pose_decay_min_weight", 0.1))).numpy()
        if bool(lc.get("map_aligned", False)):
            # the agent's own map consumes the aligned trajectory too
            self.slam.set_aligned_kf_poses(
                np.asarray(kf_timestamps)[: len(poses)],
                self.aligned_poses_c2w)

    # ------------------------------------------------------------------
    # bound-overlap fusion
    # ------------------------------------------------------------------

    def bound_based_fusion(self):
        """Distil every overlapping agent's map into this one along its
        keyframes that mutually match this agent's (`fusion_plan`), then
        write the fused mesh."""
        slam = self.slam
        cfg = slam.config
        for other, expand in self.fusion_plan():
            f_scene, f_params = self._load_foreign(other)
            if f_params is None:
                continue
            foreign_poses = torch.as_tensor(
                np.stack([k["pose"] for k in expand]).astype(np.float32),
                device=self.device)
            rays_d_cam = torch.as_tensor(self._rays_d_cam(),
                                         device=self.device)
            rays_per_kf = max(int(cfg["mapping"]["sample"]) // len(expand),
                              int(cfg["mapping"]["min_pixels_cur"]))
            _, loss = fusion.distill(
                f_scene, f_params, slam.mapper, slam.map_state,
                foreign_poses, rays_d_cam,
                generator=torch.Generator(device=self.device).manual_seed(
                    17 + other),
                iters=int(cfg["mapping"]["distill_iters"]),
                rays_per_kf=rays_per_kf)
            self.distillations += 1
            print(f"[agent {slam.rank}] distilled from agent {other}: "
                  f"{len(expand)} kfs, final loss {float(loss):.4f}")
            self._save_fused_mesh()

    def fusion_plan(self) -> List:
        """The distillations `bound_based_fusion` runs, in order: (other
        agent, its keyframes {kf_id, pose} to distil along) for every agent
        whose bound overlaps this one's and whose keyframes in the overlap
        mutually match this agent's more than `min_matches_for_fusion`
        times. Reads the exchanged keyframes and descriptors only, so a
        distillation never changes the plan."""
        slam = self.slam
        cfg = slam.config
        if not cfg.get("distillation", {}).get("use_bound_overlap", True):
            return []
        if slam.world_size <= 1:
            return []
        plan = []
        min_matches = cfg.get("loop_detection", {}).get(
            "min_matches_for_fusion", 3)
        candidates = self.fused_agents or (set(range(slam.world_size))
                                           - {slam.rank})
        for other in sorted(candidates):
            if other == slam.rank:
                continue
            overlap = fusion.compute_overlap_bound(
                self.all_agent_bounds[slam.rank],
                self.all_agent_bounds.get(other,
                                          self.all_agent_bounds[slam.rank]))
            if overlap is None:
                continue
            local_kf = self.comms.get_keyframes(slam.rank)
            foreign_kf = self.comms.get_keyframes(other)
            if local_kf is None or foreign_kf is None:
                continue
            local_in = fusion.keyframes_in_bound(*local_kf, overlap)
            foreign_in = fusion.keyframes_in_bound(*foreign_kf, overlap)
            if not local_in or not foreign_in:
                continue

            db = self.comms.descriptors()
            l_ids = {k["kf_id"] for k in local_in}
            f_ids = {k["kf_id"] for k in foreign_in}
            l_desc = [e for e in db
                      if e["agent_id"] == slam.rank and e["kf_id"] in l_ids]
            f_desc = [e for e in db
                      if e["agent_id"] == other and e["kf_id"] in f_ids]
            matches = find_mutual_matches(l_desc, f_desc,
                                          self.loop_detector.sim_threshold)
            if len(matches) <= min_matches:
                continue
            fids = [m["foreign_kf_id"] for m in matches]
            expand = [k for k in foreign_in
                      if min(fids) <= k["kf_id"] <= max(fids)]
            if expand:
                plan.append((other, expand))
        return plan

    def _save_fused_mesh(self):
        """The fused map's mesh, `mesh/fused_mesh.ply`; a meshing failure
        is printed and does not end the run."""
        from ..mapping.mesher import extract_mesh

        slam = self.slam
        path = os.path.join(slam.out_dir, "mesh", "fused_mesh.ply")
        try:
            extract_mesh(slam.scene, slam.map_state.params, slam.config,
                         save_path=path, timers=slam.timers)
        except Exception as e:  # meshing must not end the run
            print(f"[agent {slam.rank}] fused meshing failed: {e}")


class MultiAgentRunner:
    """In-process multi-agent execution: the agents advance round-robin on
    one device."""

    def __init__(self, agents: List, comms: Optional[Comms] = None,
                 descriptor_fn=None):
        self.agents = agents
        self.comms = comms or InMemoryComms()
        self.collabs = [AgentCollaboration(a, self.comms,
                                           descriptor_fn=descriptor_fn)
                        for a in agents]
        for a, c in zip(agents, self.collabs):
            a.collab = c

    def run_mapping_only(self):
        """Round-robin mapping-only run, one dataset frame per agent per
        round (a resumed agent skips the frames it has mapped), then the
        bound-overlap fusion -> each agent's metrics log."""
        max_len = max(len(a.dataset) for a in self.agents)
        done = [set(a.mapped_timestamps) for a in self.agents]
        for idx in range(max_len):
            for a, mapped in zip(self.agents, done):
                every = int(a.config["mapping"]["keyframe_every"])
                if (idx >= len(a.dataset) or idx % every != 0
                        or float(idx) in mapped):
                    continue
                frame, pose = a._frame_for_mapping(idx)
                # _map_keyframe fires a.collab.on_keyframe_mapped
                a._map_keyframe(idx, frame, pose,
                                first=not a.first_frame_mapped)
        for a in self.agents:
            a._flush_metrics()
            a.collab.bound_based_fusion()
        return [a.metrics_log for a in self.agents]

    def run_slam(self):
        """Interleaved multi-agent SLAM: every live agent advances one
        motion-filter batch (`MNESLAM.slam_step`) per round, so cross-agent
        loop closures fire mid-run in either direction; then the one-time
        bound-overlap fusion and each agent's `terminate` -> their
        results."""
        alive = [True] * len(self.agents)
        while any(alive):
            for i, a in enumerate(self.agents):
                if alive[i]:
                    alive[i] = a.slam_step()
        for a in self.agents:
            a._flush_metrics()
            a.collab.bound_based_fusion()
        return [a.terminate() for a in self.agents]
