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

Every `mapping.global_ba_every` keyframes past `tracking.frontend.window`
the tracker runs a global BA over its history (the reference's
BundleAdjustment thread).

Outputs under `<data.output>/<data.exp_name>/agent_<rank>/`:
`metrics.jsonl` (one line per mapped keyframe); every `mapping.vis`
mapped keyframes a render panel `eval_vis/kf_<frame>.jpg`; every
`mapping.mapping_save_stride` mapped keyframes a mesh snapshot
`mesh/mesh_track_<frame>.ply` at `mesh.voxel_eval`. At `terminate`:
`mesh/final_mesh.ply` (SDF grid on the device at `meshing.resolution`,
marching tetrahedra on the host, bounded to the space the mapped
keyframes observed) and `mesh/final_mesh_culled.ply` (frustum- and
occlusion-culled against the keyframes' depths), both modes; a meshing
failure is printed and does not end the run. Then `final_checkpoint.npz`
with the JAX package's key names, plus in SLAM mode `key_est_poses.npy`,
`key_timestamps.npy`, `est_poses.npy` (every frame, from the trajectory
filler) and `metrics_traj.txt` (APE after a Sim(3) alignment to the
dataset's poses).

`save_full_state` / `load_full_state` write and restore the whole agent
in one `.npz` (map parameters, Adam state, keyframe DB, keyframe poses,
the tracker's keyframe buffer and counters, the generator's state), so a
run resumed from it continues as the uninterrupted run would
(`cli --resume`). As in the JAX package, the factor graph's edges and the
motion filter's last features are not in it.

In a world of several ranks (`torch.distributed`, started by `cli.main`
under `torchrun`) an agent runs on its slice of the ranks: a `ray` group
of the fleet's mesh (`mesh`, `parallel/mesh.make_mesh(n_agents)`), or,
for one agent with `mapping.shard_plane_rows` and no mesh given, the
whole world. With `mapping.shard_plane_rows` and more than one rank in
the slice the mapper is the row-sharded one over the slice
(`parallel/mesh.py`). The slice's ray index 0 is the leader: it runs the
agent (dataset, tracking, backend, bookkeeping, terminate, every output
file). Every other rank of the slice is a follower (`follow`): it runs
only the collective `Mapper.optimize`, in lockstep, receiving from the
leader before each map call the keyframe's frame and pose, the
keyframe-DB slots written since the last call and the count, the
keyframe poses, the iteration count and the mapper generator's state;
without row sharding it waits for the leader's release. Every process
seeds the agent's generators by the agent's id (`rank`), never by its
process rank.

Multi-agent hooks (`agents/runner.py`): `world_size`, and `collab`, set
by `MultiAgentRunner`, whose `on_keyframe_mapped` runs after every mapped
keyframe with the agent's raw (tracker-world) keyframe poses. Under
`loop_closure.map_aligned` the collaboration layer overrides the map's
keyframe slots with the closure-deformed trajectory
(`set_aligned_kf_poses`); the raw poses stay retrievable
(`kf_poses_raw`), and only they feed the closure math.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .data import rays as rays_lib
from .device import make_generator, resolve_device
from .eval import ate as ate_lib
from .mapping import cull
from .mapping.mapper import Mapper
from .mapping.mesher import extract_mesh
from .models import droid_net
from .parallel import mesh as mesh_lib
from .models.scene_rep import SceneRep, checkpoint_key, param_items
from .ops import lie, mc
from .tracking import video as video_lib
from .tracking.tracker import Tracker
from .tracking.trajectory_filler import PoseTrajectoryFiller
from .utils.metrics import StageTimers


def _refresh_kf_poses_batched(kf_poses: torch.Tensor,
                              mapped_ts: torch.Tensor,
                              video_state: video_lib.VideoState,
                              counter: int,
                              first_gt: torch.Tensor):
    """Mapper slot poses refreshed from the tracker by timestamp, all slots
    in one batched device op (slam.py:54-76) -> (poses, hit mask). Slots
    whose timestamp has no live tracker row (culled keyframes, empty slots
    with timestamp -1) keep their pose and miss."""
    T = video_state.poses.shape[0]
    all_poses = video_lib.get_poses_c2w(video_state, T, first_gt=first_gt)
    live = torch.arange(T, device=kf_poses.device) < counter
    m = ((mapped_ts[:, None] == video_state.timestamps[None, :])
         & live[None, :] & (mapped_ts >= 0.0)[:, None])
    hit = m.any(dim=1)
    row = m.to(torch.uint8).argmax(dim=1)
    return torch.where(hit[:, None, None], all_poses[row], kf_poses), hit


class MNESLAM:
    def __init__(self, config: Dict, dataset, rank: int = 0,
                 device="cuda", droid_params: Optional[Dict] = None,
                 update_fn=None, agg_fn=None, world_size: int = 1,
                 mesh: Optional[mesh_lib.Mesh] = None):
        self.device = resolve_device(device)
        self.config = config
        self.dataset = dataset
        self.rank = rank
        self.world_size = world_size
        self.mode = config.get("mode", "slam")
        if self.mode not in ("mapping", "slam"):
            raise ValueError(f"mode {self.mode!r}: mneslam_tpu_torch runs "
                             "mode 'mapping' or 'slam'")

        # the agent's slice of the world's ranks: the fleet's `ray` group,
        # or every rank for one row-sharded agent; its index 0 leads
        rows = bool(config["mapping"].get("shard_plane_rows", False))
        if (mesh is None and rows and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            mesh = mesh_lib.make_mesh(1)
        self.slice = (mesh.group(("ray",)) if mesh is not None
                      else mesh_lib.LOCAL)
        self.map_mesh = mesh if rows and self.slice.size > 1 else None
        self.follower = self.slice.index > 0
        self._synced_kf = 0        # keyframe-DB slots the followers hold
        self._released = False

        out_root = config["data"].get("output", "output")
        exp = config["data"].get("exp_name", "exp")
        self.out_dir = os.path.join(out_root, exp, f"agent_{rank}")
        if not self.follower:
            os.makedirs(os.path.join(self.out_dir, "mesh"), exist_ok=True)

        self.scene = SceneRep(config, self.device)
        if self.mode == "mapping":
            # mapping-only mode maps every keyframe_every-th frame
            num_kf = int(len(dataset) // config["mapping"]["keyframe_every"]
                         + 1)
        else:
            # SLAM mode maps every admitted keyframe
            num_kf = min(len(dataset), int(config["tracking"]["buffer"])) + 1
        self.mapper = Mapper(config, self.scene, num_kf=num_kf,
                             rays_per_kf=dataset.num_rays_to_save,
                             mesh=self.map_mesh,
                             shard_plane_rows=self.map_mesh is not None,
                             shard_axes=("ray",))
        self.map_state = self.mapper.init_state(
            make_generator(self.device, 42 + rank))
        self.generator = make_generator(self.device, 1000 + rank)
        self.timers = StageTimers(
            None if self.follower
            else os.path.join(self.out_dir, "metrics.jsonl"))

        self.mapped_timestamps: list[float] = []
        self.first_frame_mapped = False
        self.metrics_log: list[Dict] = []
        self._metrics_flushed = 0  # log entries converted to host floats

        self.tracker = None
        self.traj_filler = None
        if self.mode == "slam" and not self.follower:
            params = self._droid_params(droid_params)
            self.tracker = Tracker(config, params,
                                   self._tracking_intrinsics(), self.device,
                                   update_fn=update_fn, agg_fn=agg_fn)
            # the filler keeps the given weights' fp32 (the tracker casts
            # its own copy), as the JAX package's filler does
            self.traj_filler = PoseTrajectoryFiller(
                params, self.tracker.intrinsics, update_fn=update_fn,
                agg_fn=agg_fn)
        self.map_counter = 0
        self.global_ba_every = int(config["mapping"].get("global_ba_every",
                                                         10))
        self._frame_cursor = 0
        self._last_global_ba = 0
        self.collab = None  # set by agents.runner.MultiAgentRunner
        # loop_closure.map_aligned: (timestamps, c2w) of the closure-
        # deformed trajectory, which overrides the matching map slots
        self._aligned_kf_override = None
        # raw (tracker-world) keyframe poses, kept while an override is
        # active: the closure math must see raw poses, since its stored
        # transform was measured against them (feeding it aligned poses
        # re-applies the correction every keyframe)
        self._raw_kf_poses = None

    def _droid_params(self, droid_params: Optional[Dict]) -> Dict:
        """The given params, else `tracking.pretrained` when that file
        exists, else random weights from a fixed seed."""
        if droid_params is None:
            path = self.config["tracking"].get("pretrained")
            if path and os.path.exists(str(path)):
                if str(path).endswith(".npz"):
                    from .utils.params_io import load_pytree_npz
                    droid_params = load_pytree_npz(str(path))
                else:
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
        """Add the keyframe and optimize: `mapping.first_iters` steps on
        the first (`Mapper.first_frame_mapping`), `mapping.iters` after."""
        with self.timers.stage("map_keyframe"):
            frame = dict(frame, frame_id=frame_idx)
            iters = int(self.config["mapping"][
                "first_iters" if first else "iters"])
            self.map_state = self.mapper.add_keyframe(
                self.map_state, frame_idx, frame, pose_c2w, self.generator)
            self._lead(frame, pose_c2w, iters)
            self.map_state, metrics = self.mapper.optimize(
                self.map_state, frame, pose_c2w, self.generator, iters=iters)
            if first:
                self.first_frame_mapped = True
            self._post_map_bookkeeping(frame_idx, frame, pose_c2w, metrics)
        return metrics

    # ------------------------------------------------------------------
    # the agent's slice of the ranks: leader and followers
    # ------------------------------------------------------------------

    _HEADER = 7  # op, iters, use_cur, first new DB slot, count, H, W

    def _lead(self, frame: Dict, pose_c2w: torch.Tensor, iters: int,
              use_cur: bool = True):
        """Leader: broadcast what the next collective `optimize` needs
        (a no-op without a sharded mapper)."""
        if self.map_mesh is None:
            return
        group = self.slice
        db = self.map_state.db
        H, W = frame["depth"].shape
        lo = self._synced_kf
        mesh_lib.broadcast(torch.tensor(
            [1, iters, int(use_cur), lo, db.count, H, W], dtype=torch.int64,
            device=self.device), group)
        for t in (frame["direction"], frame["rgb"], frame["depth"], pose_c2w,
                  db.rays[lo:db.count], db.frame_ids[lo:db.count],
                  self.map_state.kf_poses,
                  self.generator.get_state().to(self.device)):
            mesh_lib.broadcast(t.contiguous(), group)
        self._synced_kf = db.count

    def release_followers(self):
        """Leader: tell the followers the run has ended (once)."""
        if self.slice.size == 1 or self.follower or self._released:
            return
        mesh_lib.broadcast(torch.zeros(self._HEADER, dtype=torch.int64,
                                       device=self.device), self.slice)
        self._released = True

    def follow(self):
        """Follower: run the leader's map calls in lockstep until it
        releases the followers. Each call receives the frame, the pose,
        the new keyframe-DB slots and the count, the keyframe poses and
        the mapper generator's state, then runs the collective optimize;
        the maps of every rank stay equal."""
        if not self.follower:
            raise RuntimeError("follow() runs on a follower rank (ray index "
                               "> 0 of an agent's slice)")
        group, dev = self.slice, self.device

        def recv(shape, dtype):
            return mesh_lib.broadcast(
                torch.empty(shape, dtype=dtype, device=dev), group)

        db, f32 = self.map_state.db, torch.float32
        gen_state = self.generator.get_state()
        while True:
            op, iters, use_cur, lo, hi, H, W = recv(
                (self._HEADER,), torch.int64).tolist()
            if op == 0:
                return
            if lo != db.count:
                raise RuntimeError(f"follower holds {db.count} keyframes, "
                                   f"the leader sends slots from {lo}")
            frame = {"direction": recv((H, W, 3), f32),
                     "rgb": recv((H, W, 3), f32), "depth": recv((H, W), f32)}
            pose = recv((4, 4), f32)
            db.rays[lo:hi] = recv((hi - lo,) + tuple(db.rays.shape[1:]),
                                  db.rays.dtype)
            db.frame_ids[lo:hi] = recv((hi - lo,), db.frame_ids.dtype)
            db.count = hi
            self.map_state.kf_poses.copy_(recv(
                tuple(self.map_state.kf_poses.shape), f32))
            self.generator.set_state(
                recv(tuple(gen_state.shape), gen_state.dtype).cpu())
            self.map_state, _ = self.mapper.optimize(
                self.map_state, frame, pose, self.generator, iters=iters,
                use_cur=bool(use_cur))

    def _post_map_bookkeeping(self, frame_idx: int, frame: Dict,
                              pose_c2w: torch.Tensor, metrics):
        """Log the keyframe. The new entry keeps its device scalars; the
        entries before it are read back and written to metrics.jsonl now,
        while this keyframe's steps may still run on the device. Then the
        render panel every `mapping.vis` keyframes, the mesh snapshot
        every `mapping.mapping_save_stride` keyframes (0 or absent: off),
        and the collaboration hook (publish, loop detection, closure)."""
        self.mapped_timestamps.append(float(frame_idx))
        if self._aligned_kf_override is not None and \
                self._raw_kf_poses is not None:
            # pose_c2w is raw: it comes from the tracker or the dataset,
            # never from the overridden map slots
            self._raw_kf_poses = np.concatenate(
                [self._raw_kf_poses,
                 pose_c2w.detach().cpu().numpy()[None]])
        self.metrics_log.append(dict(metrics))
        self._flush_metrics(upto=len(self.metrics_log) - 1)

        vis_every = int(self.config["mapping"].get("vis", 0))
        if vis_every > 0 and (len(self.mapped_timestamps) - 1) % vis_every == 0:
            self._save_vis(frame_idx, frame, pose_c2w)
        stride = int(self.config["mapping"].get("mapping_save_stride", 0))
        if stride > 0 and len(self.mapped_timestamps) % stride == 0:
            try:
                extract_mesh(
                    self.scene, self.map_state.params, self.config,
                    voxel_size=float(self.config["mesh"]["voxel_eval"]),
                    save_path=os.path.join(self.out_dir, "mesh",
                                           f"mesh_track_{frame_idx}.ply"))
            except Exception as e:  # a snapshot must not end the run
                print(f"[agent {self.rank}] mesh snapshot failed: {e}")
        if self.collab is not None:
            n = min(len(self.mapped_timestamps),
                    self.map_state.kf_poses.shape[0])
            self.collab.on_keyframe_mapped(
                frame_idx, frame["rgb"], pose_c2w.detach().cpu().numpy(),
                self.kf_poses_raw(n),
                np.asarray(self.mapped_timestamps[:n], float))

    def render_frame(self, frame: Dict, pose_c2w: torch.Tensor):
        """Render a whole frame at its pose with depth-guided samples ->
        (depth [H, W], rgb [H, W, 3]) on the device."""
        H, W = frame["depth"].shape
        rays_o, rays_d = rays_lib.rays_from_pose(
            frame["direction"].reshape(-1, 3), pose_c2w)
        depth, rgb = self.scene.render_image_rays(
            self.map_state.params, rays_o, rays_d,
            frame["depth"].reshape(-1), chunk=4096)
        return depth.reshape(H, W), rgb.reshape(H, W, 3)

    def _save_vis(self, frame_idx: int, frame: Dict, pose_c2w: torch.Tensor):
        """The keyframe's render / residual panel (`utils/vis.py`)."""
        from .utils import vis

        depth, rgb = self.render_frame(frame, pose_c2w)
        vis.save_render_panel(
            os.path.join(self.out_dir, "eval_vis", f"kf_{frame_idx:05d}.jpg"),
            frame["rgb"].cpu().numpy(), frame["depth"].cpu().numpy(),
            rgb.cpu().numpy(), depth.cpu().numpy(),
            title=f"agent {self.rank} keyframe {frame_idx}")

    def _flush_metrics(self, upto: Optional[int] = None):
        """Convert queued metrics_log entries to host floats and write them
        to metrics.jsonl; `upto` = flush entries with index < upto (default
        all). A resumed agent's log starts at its first new keyframe."""
        end = len(self.metrics_log) if upto is None else upto
        first = len(self.mapped_timestamps) - len(self.metrics_log)
        while self._metrics_flushed < end:
            i = self._metrics_flushed
            entry = {k: float(v) for k, v in self.metrics_log[i].items()}
            self.metrics_log[i] = entry
            self.timers.log_scalars(int(self.mapped_timestamps[first + i]),
                                    entry)
            self._metrics_flushed = i + 1

    # ------------------------------------------------------------------

    def run_mapping_only(self, log_every: int = 10):
        """Map every keyframe_every-th frame at its ground-truth pose (a
        resumed agent skips the frames it has mapped)."""
        every = int(self.config["mapping"]["keyframe_every"])
        done = set(self.mapped_timestamps)
        t0 = time.time()
        for idx in range(0, len(self.dataset), every):
            if float(idx) in done:
                continue
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
        mp_slam/mapper.py:193-198); then the `loop_closure.map_aligned`
        override. While an override is active the raw poses are read back
        once per refresh and kept: a slot the refresh hit holds a fresh
        tracker pose, a slot it missed keeps its previous raw pose, so an
        override never leaks into the raw history."""
        if not self.mapped_timestamps:
            return
        if self.tracker is None:
            self._apply_aligned_override()
            return
        with self.timers.stage("pose_refresh"):
            num_kf = self.map_state.kf_poses.shape[0]
            mts = np.full((num_kf,), -1.0, np.float32)
            k = min(len(self.mapped_timestamps), num_kf)
            mts[:k] = self.mapped_timestamps[:k]
            st = self.tracker.state
            self.map_state.kf_poses, hit = _refresh_kf_poses_batched(
                self.map_state.kf_poses,
                torch.as_tensor(mts, device=self.device), st,
                self.tracker.counter, st.poses_gt[0])
            if self._aligned_kf_override is not None:
                raw = self.map_state.kf_poses[:k].cpu().numpy().copy()
                hit_np = hit[:k].cpu().numpy()
                if self._raw_kf_poses is not None:
                    m = min(k, len(self._raw_kf_poses))
                    miss = ~hit_np[:m]
                    raw[:m][miss] = self._raw_kf_poses[:m][miss]
                self._raw_kf_poses = raw
        self._apply_aligned_override()

    def set_aligned_kf_poses(self, timestamps, poses_c2w):
        """`loop_closure.map_aligned`: map against the collaboration
        layer's closure-deformed trajectory from now on. Stored and applied
        at once, and again after every tracker pose refresh, so aligned
        poses win for the matching keyframe slots; the raw poses stay
        retrievable through `kf_poses_raw`."""
        if self._aligned_kf_override is None and self._raw_kf_poses is None:
            # seed the raw history even before a refresh (mapping-only
            # mode has none); _post_map_bookkeeping grows it from here
            n = min(len(self.mapped_timestamps),
                    self.map_state.kf_poses.shape[0])
            self._raw_kf_poses = \
                self.map_state.kf_poses[:n].cpu().numpy().copy()
        self._aligned_kf_override = (
            np.asarray(timestamps, np.float64).ravel(),
            np.asarray(poses_c2w, np.float32))
        self._apply_aligned_override()

    def kf_poses_raw(self, n: int) -> np.ndarray:
        """Tracker-world poses of the mapped keyframe slots [0, n): the map
        slots themselves unless `loop_closure.map_aligned` overrode them,
        else the kept raw history."""
        out = self.map_state.kf_poses[:n].cpu().numpy().copy()
        if self._aligned_kf_override is not None and \
                self._raw_kf_poses is not None:
            m = min(len(out), len(self._raw_kf_poses))
            out[:m] = self._raw_kf_poses[:m]
        return out

    def _apply_aligned_override(self):
        if self._aligned_kf_override is None or not self.mapped_timestamps:
            return
        ats, aposes = self._aligned_kf_override
        pos = {float(t): i for i, t in enumerate(ats)}
        num_kf = self.map_state.kf_poses.shape[0]
        slots, rows = [], []
        for slot, t in enumerate(self.mapped_timestamps[:num_kf]):
            j = pos.get(float(t))
            if j is not None:
                slots.append(slot)
                rows.append(j)
        if slots:
            self.map_state.kf_poses[slots] = torch.as_tensor(
                aposes[rows], device=self.device)

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
        thread)."""
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
        """Flush the metric log; write the final mesh bounded to the
        observed space and its culled variant (`results["mesh_verts"]`,
        `["mesh_verts_culled"]`); in SLAM mode key_est_poses.npy
        (GT-aligned c2w), key_timestamps.npy, and from the trajectory
        filler over every frame est_poses.npy with its APE (Sim(3),
        `results["ate"]`) in metrics_traj.txt; then final_checkpoint.npz
        (slam.py:649-707 of the JAX package). Releases the followers of a
        row-sharded world first."""
        self.release_followers()
        self._flush_metrics()
        results = {"keyframes": len(self.mapped_timestamps)}
        with self.timers.stage("mesh"):
            try:
                results.update(self._final_meshes())
            except Exception as e:  # meshing must not end the evaluation
                print(f"[agent {self.rank}] meshing failed: {e}")
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

            # a pose for every frame, at the tracking resolution
            def stream():
                for idx in range(len(self.dataset)):
                    yield float(idx), self._to_tracking_res(
                        self.dataset[idx]["rgb"])

            with self.timers.stage("fill_trajectory"):
                filled_w2c = self.traj_filler(st, n, stream())
                # GT-aligned c2w: the first GT pose with the axis flips,
                # composed in fp32
                M = lie.matrix(lie.inv(filled_w2c))
                trans = st.poses_gt[0].clone()
                trans[:3, 1:3] = -trans[:3, 1:3]
                M = torch.einsum("ij,njk->nik", trans, M)
                M[:, :3, 1:3] = -M[:, :3, 1:3]
                est_poses = M.cpu().numpy()
            np.save(os.path.join(self.out_dir, "est_poses.npy"), est_poses)
            gt = np.stack([self.dataset[i]["c2w"]
                           for i in range(len(self.dataset))])
            metrics = ate_lib.evaluate_ate(gt, est_poses, alignment="sim3")
            ate_lib.save_trajectory_metrics(
                os.path.join(self.out_dir, "metrics_traj.txt"), metrics)
            results["ate"] = metrics
            print(f"[agent {self.rank}] APE(sim3) rmse="
                  f"{metrics['rmse']:.4f} m")
        path = os.path.join(self.out_dir, "final_checkpoint.npz")
        self.save_checkpoint(path)
        self.timers.close()
        results["checkpoint"] = path
        return results

    def _final_meshes(self) -> Dict:
        """final_mesh.ply, bounded to the observed space, and
        final_mesh_culled.ply -> their vertex counts."""
        with self.timers.stage("mesh/observed_depths"):
            observed = self._observed_space()
        verts, faces, colors = extract_mesh(
            self.scene, self.map_state.params, self.config,
            save_path=os.path.join(self.out_dir, "mesh", "final_mesh.ply"),
            observed=observed, timers=self.timers)
        out = {"mesh_verts": len(verts)}
        if len(verts) and observed is not None:
            out["mesh_verts_culled"] = self._save_culled_mesh(
                verts, faces, colors, observed)
        return out

    def _observed_space(self):
        """(kf_poses, intrinsics, H, W, depths, eps) of the mapped
        keyframes, for the observed-space bound of the mesh, or None before
        any keyframe is mapped. eps is the meshing band, 3 x trunc."""
        if not self.mapped_timestamps:
            return None
        n = min(len(self.mapped_timestamps), self.map_state.kf_poses.shape[0])
        kf_poses = self.map_state.kf_poses[:n].cpu().numpy()
        depths = np.stack([np.asarray(self.dataset[int(t)]["depth"])
                           for t in self.mapped_timestamps[:n]])
        H, W = depths.shape[1:]
        cam = self.config["cam"]
        intr = np.asarray([cam["fx"], cam["fy"], cam["cx"], cam["cy"]],
                          np.float32)
        eps = 3.0 * float(self.config["training"]["trunc"]) * \
            float(self.config["data"]["sc_factor"])
        return kf_poses, intr, H, W, depths, eps

    def _save_culled_mesh(self, verts, faces, colors, observed) -> int:
        """Frustum- and occlusion-cull the mesh against the mapped
        keyframes' poses and depths (eps 0.08) and save it beside the raw
        one -> its vertex count."""
        kf_poses, intr, H, W, depths, _ = observed
        with self.timers.stage("mesh/cull"):
            cverts, cfaces, ccolors = cull.cull_mesh(
                verts, faces, kf_poses, intr, H, W, depths=depths,
                colors=colors, device=self.device)
        if len(cverts):
            mc.save_ply(os.path.join(self.out_dir, "mesh",
                                     "final_mesh_culled.ply"),
                        cverts, cfaces, ccolors)
        return len(cverts)

    # ------------------------------------------------------------------
    # full-state checkpoint and resume
    # ------------------------------------------------------------------

    def full_state(self) -> Dict[str, np.ndarray]:
        """The whole agent as {key: numpy array}: map parameters, Adam's
        step and moments per parameter, the keyframe DB, keyframe poses,
        the mapper's generator state, the host counters and, in SLAM mode,
        the tracker's keyframe buffer (feature maps as float32) and
        counters."""
        ms = self.map_state
        out = {}
        for p, t in param_items(ms.params):
            key = checkpoint_key(p)
            out[f"params/{key}"] = t.detach().cpu().numpy()
            st = ms.optimizer.state.get(t, {})
            for name in ("step", "exp_avg", "exp_avg_sq"):
                if name in st:
                    out[f"adam/{key}/{name}"] = st[name].cpu().numpy()
        out["db/rays"] = ms.db.rays.cpu().numpy()
        out["db/frame_ids"] = ms.db.frame_ids.cpu().numpy()
        out["db/count"] = np.asarray(ms.db.count, np.int64)
        out["kf_poses"] = ms.kf_poses.cpu().numpy()
        out["rng/generator"] = self.generator.get_state().numpy()
        out["host/map_counter"] = np.asarray(self.map_counter, np.int64)
        out["host/mapped_timestamps"] = np.asarray(self.mapped_timestamps,
                                                   np.float64)
        out["host/first_frame_mapped"] = np.asarray(self.first_frame_mapped)
        out["host/frame_cursor"] = np.asarray(self._frame_cursor, np.int64)
        out["host/last_global_ba"] = np.asarray(self._last_global_ba,
                                                np.int64)
        if self.tracker is not None:
            for name, t in self.tracker.state._asdict().items():
                out[f"video/{name}"] = t.float().cpu().numpy()
            out["host/tracker_counter"] = np.asarray(self.tracker.counter,
                                                     np.int64)
            out["host/frontend_t1"] = np.asarray(self.tracker.frontend.t1,
                                                 np.int64)
            out["host/frontend_initialized"] = np.asarray(
                self.tracker.frontend.is_initialized)
        return out

    def save_full_state(self, path: str):
        """`full_state()` as one .npz at `path`, written to a temporary
        name and then renamed, so a reader never sees half a file."""
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **self.full_state())
        os.replace(tmp, path)

    def load_full_state(self, path: str):
        """Restore `save_full_state`'s file into this agent, in place (the
        optimizer keeps its references to the parameter tensors)."""
        ms = self.map_state
        with np.load(path, allow_pickle=False) as data, torch.no_grad():
            for p, t in param_items(ms.params):
                key = checkpoint_key(p)
                t.copy_(torch.as_tensor(data[f"params/{key}"]))
                if f"adam/{key}/step" in data:
                    ms.optimizer.state[t] = {
                        "step": torch.as_tensor(data[f"adam/{key}/step"]),
                        **{name: torch.as_tensor(data[f"adam/{key}/{name}"],
                                                 device=t.device)
                           for name in ("exp_avg", "exp_avg_sq")}}
                else:
                    ms.optimizer.state.pop(t, None)
            ms.db.rays.copy_(torch.as_tensor(data["db/rays"]))
            ms.db.frame_ids.copy_(torch.as_tensor(data["db/frame_ids"]))
            ms.db.count = int(data["db/count"])
            self._synced_kf = ms.db.count   # every rank loads the file
            ms.kf_poses.copy_(torch.as_tensor(data["kf_poses"]))
            self.generator.set_state(torch.as_tensor(data["rng/generator"]))
            self.map_counter = int(data["host/map_counter"])
            self.mapped_timestamps = [
                float(t) for t in data["host/mapped_timestamps"]]
            self.first_frame_mapped = bool(data["host/first_frame_mapped"])
            self._frame_cursor = int(data["host/frame_cursor"])
            self._last_global_ba = int(data["host/last_global_ba"])
            if self.tracker is not None and "video/poses" in data:
                for name, t in self.tracker.state._asdict().items():
                    t.copy_(torch.as_tensor(data[f"video/{name}"]))
                self.tracker.counter = int(data["host/tracker_counter"])
                self.tracker.frontend.t1 = int(data["host/frontend_t1"])
                self.tracker.frontend.is_initialized = bool(
                    data["host/frontend_initialized"])
        self.metrics_log = []
        self._metrics_flushed = 0

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
