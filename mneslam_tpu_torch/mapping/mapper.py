"""Online mapper: per-keyframe gradient-descent steps over the neural map.

Port of `mneslam_tpu/mapping/mapper.py`. Each iteration samples a ray
batch (global keyframe rays + current-frame rays), renders it, and takes
one Adam step. The JAX package compiles the whole loop into one program;
here it is a Python loop of eager steps that never reads a value back to
the host: the metrics stay on the device until the caller flushes them
once per keyframe.

Optimizer: Adam(betas=(0.9, 0.99)) in two groups, the decoder at
lr_decoder with weight decay 1e-6 (PyTorch's coupled L2, the same as
`optax.add_decayed_weights` before `optax.adam`) and the planes (the
colour planes too) at lr_embed with eps 1e-15.

With `training.smooth_weight` > 0 the loss adds the TV smoothness term
(`SceneRep.smoothness`, its uniforms drawn after the render's, or given
through `u`); on the sharded paths every rank adds the same term, so the
gradient of loss / ranks summed over the ranks holds it once.

With a `parallel.mesh.Mesh` of several ranks the loop runs on every rank
of its shard group (`shard_axes`) in lockstep (one process per shard, the
per-device body of the JAX `shard_map` programs). Every rank draws the
whole ray batch from the same generator and renders its contiguous block
of it, with the losses summed over the ranks (`SceneRep.forward(group=
...)`), and differentiates the global loss / ranks (the backward of a sum
over ranks is again a sum):

- ray-sharded (`mesh` alone): the parameters stay replicated; the plane
  and decoder gradients are all-reduced;
- row-sharded (`shard_plane_rows`, ZeRO-style): each plane and its Adam
  moments live as this rank's block of whole y-rows of the flat row-major
  [Hp*W, C] layout (H zero-padded to a multiple of the ranks). Per
  iteration the collective seam (`parallel.mesh.make_row_sharded_pack`)
  packs the local rows and all-gathers the packed tables; its backward
  reduce-scatters the table cotangents and folds them row-locally, so the
  fold and Adam run on 1/N of each plane (the colour planes as the
  geometry planes). Decoder gradients are
  all-reduced. `mapping.shard_gather_every` k: one gather per k
  iterations (Adam every iteration); `mapping.shard_prefetch` 1: tables
  one iteration stale, 2: gradients applied one iteration late too.
  Entering `optimize` the replicated planes and their moments (Adam's step
  count with them) move into the blocks; leaving it everything is
  all-gathered back to [C, H, W], so the renderer, mesher, checkpoints and
  fusion see the ordinary layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..data import rays as rays_lib
from ..models.scene_rep import PLANE_GROUPS, SceneRep, param_leaves
from ..ops import interp
from ..parallel import mesh as mesh_lib
from . import keyframe as kf_lib

METRICS = ("loss", "psnr", "rgb_loss", "depth_loss")


@dataclass
class MapperState:
    params: Dict
    optimizer: torch.optim.Adam
    db: kf_lib.KeyframeDB
    kf_poses: torch.Tensor  # [num_kf, 4, 4] c2w per slot


def make_optimizer(config, params: Dict) -> torch.optim.Adam:
    """Adam with a decoder group and a planes group (every top-level key
    other than "decoder" is a plane group, as in the JAX labelling)."""
    mp = config["mapping"]
    planes = [leaf for k, v in sorted(params.items()) if k != "decoder"
              for leaf in param_leaves(v)]
    return torch.optim.Adam([
        {"params": param_leaves(params["decoder"]),
         "lr": float(mp["lr_decoder"]), "weight_decay": 1e-6, "eps": 1e-8},
        {"params": planes,
         "lr": float(mp["lr_embed"]), "weight_decay": 0.0, "eps": 1e-15},
    ], betas=(0.9, 0.99))


class Mapper:
    def __init__(self, config, scene: SceneRep, num_kf: int,
                 rays_per_kf: int, mesh: Optional[mesh_lib.Mesh] = None,
                 shard_plane_rows: bool = False,
                 shard_axes: Optional[Sequence[str]] = None):
        """`mesh`: shard each iteration's ray batch over the ranks of the
        mesh's `shard_axes` (default: every axis; the ranks call
        `optimize` in lockstep with equal inputs). `shard_plane_rows`
        (with a mesh): also shard the planes, their Adam moments and the
        gradient fold over table rows, over the same ranks. The mesh
        fleet passes shard_axes=("ray",): each agent slice shards over
        its own `ray` group, and the `agent` axis carries the agents
        (`mneslam_tpu/mapping/mapper.py:58-110`). The ray counts round up
        to a multiple of the shard count, so the batch splits evenly."""
        self.config = config
        self.scene = scene
        self.device = scene.device
        self.num_kf = num_kf
        self.rays_per_kf = rays_per_kf
        self.n_global = int(config["mapping"]["sample"])
        self.n_cur = int(config["mapping"]["min_pixels_cur"])
        self.mesh = mesh
        self.shard_rows = bool(shard_plane_rows) and mesh is not None
        self.shard_axes = (tuple(shard_axes) if shard_axes is not None
                           else mesh.axis_names if mesh is not None else ())
        self.group = None
        if mesh is not None:
            self.group = mesh.group(self.shard_axes)
            n = self.group.size
            self.n_global = -(-self.n_global // n) * n
            self.n_cur = -(-self.n_cur // n) * n
        self._seams: Dict[tuple, mesh_lib.RowSeam] = {}

    def init_state(self, generator: torch.Generator) -> MapperState:
        params = self.scene.init_params(generator)
        return MapperState(
            params=params,
            optimizer=make_optimizer(self.config, params),
            db=kf_lib.init_db(self.num_kf, self.rays_per_kf, self.device),
            kf_poses=torch.eye(4, device=self.device).repeat(
                self.num_kf, 1, 1))

    # ------------------------------------------------------------------

    def _smoothness(self, params, generator, u) -> Optional[torch.Tensor]:
        """The TV smoothness term when training.smooth_weight > 0, else
        None."""
        tr = self.config["training"]
        if float(tr.get("smooth_weight", 0.0)) <= 0.0:
            return None
        return self.scene.smoothness(
            params, u=u, generator=generator,
            sample_points=int(tr.get("smooth_pts", 32)),
            voxel_size=float(tr.get("smooth_vox", 0.1)),
            margin=float(tr.get("smooth_margin", 0.05)))

    def _loss_fn(self, params, rays_o, rays_d, target_rgb, target_d,
                 generator=None, u=None):
        ret = self.scene.forward(params, rays_o, rays_d, target_rgb,
                                 target_d, generator=generator, u=u)
        smooth = self._smoothness(params, generator, u)
        return self.scene.get_loss_from_ret(ret, smooth_loss=smooth), ret

    def _build_rays(self, db, kf_poses, dir_flat, rgb_flat, d_flat, cur_pose,
                    HW: int, generator, use_cur: bool,
                    g_idx: Optional[torch.Tensor] = None,
                    c_idx: Optional[torch.Tensor] = None):
        """One iteration's ray batch: n_global rays drawn over every stored
        keyframe ray, then (with `use_cur`) n_cur current-frame pixels.
        `g_idx` / `c_idx` replace the draws (tests)."""
        g_rays, slot_ids = kf_lib.sample_global_rays(db, generator,
                                                     self.n_global, g_idx)
        g_o, g_d = rays_lib.rays_from_pose(g_rays[:, :3], kf_poses[slot_ids])
        g_rgb, g_depth = g_rays[:, 3:6], g_rays[:, 6]
        if not use_cur:
            return g_o, g_d, g_rgb, g_depth[:, None]
        if c_idx is None:
            c_idx = torch.randint(0, HW, (self.n_cur,), generator=generator,
                                  device=dir_flat.device)
        c_idx = c_idx.long()
        c_o, c_d = rays_lib.rays_from_pose(dir_flat[c_idx], cur_pose)
        return (torch.cat([g_o, c_o]), torch.cat([g_d, c_d]),
                torch.cat([g_rgb, rgb_flat[c_idx]]),
                torch.cat([g_depth, d_flat[c_idx]])[:, None])

    def step(self, state: MapperState, rays_o, rays_d, target_rgb, target_d,
             generator=None, u=None) -> Dict[str, torch.Tensor]:
        """One Adam step on one ray batch; -> metrics as device scalars."""
        state.optimizer.zero_grad(set_to_none=True)
        loss, ret = self._loss_fn(state.params, rays_o, rays_d, target_rgb,
                                  target_d, generator=generator, u=u)
        loss.backward()
        state.optimizer.step()
        return {"loss": loss.detach(), "psnr": ret["psnr"].detach(),
                "rgb_loss": ret["rgb_loss"].detach(),
                "depth_loss": ret["depth_loss"].detach()}

    def optimize(self, state: MapperState, cur_frame: Dict[str, torch.Tensor],
                 cur_pose: torch.Tensor, generator: torch.Generator,
                 iters: int, use_cur: bool = True,
                 draws: Optional[Sequence] = None
                 ) -> Tuple[MapperState, Dict[str, torch.Tensor]]:
        """`iters` steps over (global keyframe rays + current-frame rays);
        returns the last step's metrics, still on the device.
        cur_frame: direction [H,W,3], rgb [H,W,3], depth [H,W]. `draws`
        (tests): per iteration (g_idx, c_idx, u) replacing the generator's
        draws, u the whole batch's uniforms (the perturbation's [n_rays,
        S], or a dict of parts: `models.scene_rep.uniforms`)."""
        if self.shard_rows:
            return self._optimize_row_sharded(state, cur_frame, cur_pose,
                                              generator, iters, use_cur,
                                              draws)
        H, W = cur_frame["depth"].shape
        dir_flat = cur_frame["direction"].reshape(-1, 3)
        rgb_flat = cur_frame["rgb"].reshape(-1, 3)
        d_flat = cur_frame["depth"].reshape(-1)
        metrics = {k: torch.zeros((), device=self.device) for k in METRICS}
        leaves = param_leaves(state.params)
        for i in range(iters):
            g_idx, c_idx, u = draws[i] if draws is not None else (None,) * 3
            batch = self._build_rays(state.db, state.kf_poses, dir_flat,
                                     rgb_flat, d_flat, cur_pose, H * W,
                                     generator, use_cur, g_idx, c_idx)
            if self.mesh is None:
                metrics = self.step(state, *batch, generator=generator, u=u)
                continue
            # ray-sharded: replicated parameters, all-reduced gradients
            state.optimizer.zero_grad(set_to_none=True)
            metrics = self._shard_loss_backward(state.params, batch,
                                                generator, u)
            self._all_reduce_grads(leaves)
            state.optimizer.step()
        return state, metrics

    def gradients(self, state: MapperState,
                  cur_frame: Dict[str, torch.Tensor], cur_pose: torch.Tensor,
                  generator: Optional[torch.Generator], use_cur: bool = True,
                  draws: Optional[Tuple] = None) -> List[torch.Tensor]:
        """The loss gradient of one ray batch (drawn as `optimize`'s first
        iteration draws it, or `draws` = (g_idx, c_idx, u)), without a
        step: one tensor per leaf of `param_leaves(state.params)`, in its
        layout. The sharded paths' exact claim: these equal the unsharded
        mapper's gradients up to the order of the sums."""
        H, W = cur_frame["depth"].shape
        g_idx, c_idx, u = draws if draws is not None else (None,) * 3
        batch = self._build_rays(
            state.db, state.kf_poses, cur_frame["direction"].reshape(-1, 3),
            cur_frame["rgb"].reshape(-1, 3), cur_frame["depth"].reshape(-1),
            cur_pose, H * W, generator, use_cur, g_idx, c_idx)
        leaves = param_leaves(state.params)
        state.optimizer.zero_grad(set_to_none=True)
        if self.mesh is None:
            self._loss_fn(state.params, *batch, generator=generator,
                          u=u)[0].backward()
        elif not self.shard_rows:
            self._shard_loss_backward(state.params, batch, generator, u)
            self._all_reduce_grads(leaves)
        else:
            blocks, _, pairs = self._shard_plane_state(state)
            params = {k: v for k, v in state.params.items()
                      if k not in PLANE_GROUPS}
            self._shard_loss_backward(self._packed_params(params, blocks),
                                      batch, generator, u)
            self._all_reduce_grads(param_leaves(params))
            full = {id(leaf): self._from_blocks(blk.grad, shape)
                    for leaf, blk, shape in pairs}
            grads = [full.get(id(t), t.grad) for t in leaves]
            state.optimizer.zero_grad(set_to_none=True)
            return [g.detach().clone() for g in grads]
        grads = [t.grad.detach().clone() for t in leaves]
        state.optimizer.zero_grad(set_to_none=True)
        return grads

    # ------------------------------------------------------------------
    # the sharded paths
    # ------------------------------------------------------------------

    def _shard_loss_backward(self, params, batch, generator, u
                             ) -> Dict[str, torch.Tensor]:
        """This rank's contiguous block of the full batch, rendered with
        the group's losses; backward of loss / ranks -> the metrics (the
        global loss)."""
        group = self.group
        n_total = batch[0].shape[0]
        shard = n_total // group.size
        lo = group.index * shard
        ro, rd, rgb, td = (a[lo:lo + shard] for a in batch)
        ret = self.scene.forward(params, ro, rd, rgb, td, generator=generator,
                                 u=u, group=group,
                                 rng_block=(n_total, lo))
        # the smoothness term is the same on every rank (replicated)
        smooth = self._smoothness(params, generator, u)
        loss = self.scene.get_loss_from_ret(ret, smooth_loss=smooth) \
            / group.size
        loss.backward()
        return {"loss": loss.detach() * group.size,
                "psnr": ret["psnr"].detach(),
                "rgb_loss": ret["rgb_loss"].detach(),
                "depth_loss": ret["depth_loss"].detach()}

    def _all_reduce_grads(self, leaves: List[torch.Tensor]):
        """Sum the leaves' gradients over the group, in one collective."""
        grads = [t.grad for t in leaves]
        flat = mesh_lib.all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                                   self.group)
        off = 0
        for t, g in zip(leaves, grads):
            t.grad = flat[off:off + g.numel()].view_as(g)
            off += g.numel()

    def _pad_h(self, H: int) -> int:
        n = self.group.size
        return -(-H // n) * n

    def _shape(self, group: str, name: str, lvl: int) -> tuple:
        """(C, H, W) of plane `name` at level `lvl` of `group` ("planes"
        or "c_planes")."""
        return tuple(int(s) for s in self.scene.shapes_of(group)[lvl][name])

    def _seam_fn(self, true_shape) -> mesh_lib.RowSeam:
        """The collective seam of one plane shape (cached). The cast to
        `training.render_dtype` happens on the sharded side, so under
        bfloat16 the gathers and the gradient reduction move bf16."""
        seam = self._seams.get(true_shape)
        if seam is None:
            seam = mesh_lib.make_row_sharded_pack(
                self.group, true_shape, self._pad_h(true_shape[1]),
                compute_dtype=self.scene.compute_dtype,
                fold=str(self.config["mapping"].get("shard_fold", "after")))
            self._seams[true_shape] = seam
        return seam

    def _to_block(self, t: torch.Tensor, shape) -> torch.Tensor:
        """[C, H, W] -> this rank's rows of the flat row-major layout
        [Hp*W, C] (pad rows zero): a block of whole y-rows [B, C]."""
        C, H, W = shape
        B = self._pad_h(H) * W // self.group.size
        flat = t.detach().permute(1, 2, 0).reshape(H * W, C)
        lo = self.group.index * B
        blk = flat[lo:lo + B]
        if blk.shape[0] < B:
            blk = torch.cat([blk, blk.new_zeros((B - blk.shape[0], C))])
        return blk.clone()

    def _from_blocks(self, blk: torch.Tensor, shape) -> torch.Tensor:
        """Every rank's block gathered back to [C, H, W], pad cut."""
        C, H, W = shape
        full = mesh_lib.all_gather_rows(blk.detach(), self.group)[:H * W]
        return full.reshape(H, W, C).permute(2, 0, 1).contiguous()

    def _shard_plane_state(self, state: MapperState):
        """Entering the row-sharded loop: a leaf block [B, C] per plane
        leaf (colour planes too), and an Adam over the decoder leaves
        (their state shared with the state's optimizer) and the blocks
        (their rows of the moments, the step count carried) -> (blocks
        {group: {name: [block per level]}}, Adam, [(leaf, block,
        shape)])."""
        orig = state.optimizer
        pairs = []
        blocks = {}
        for group in PLANE_GROUPS:
            for name, lst in state.params.get(group, {}).items():
                for lvl, leaf in enumerate(lst):
                    shape = self._shape(group, name, lvl)
                    blk = self._to_block(leaf, shape).requires_grad_(True)
                    blocks.setdefault(group, {}).setdefault(
                        name, []).append(blk)
                    pairs.append((leaf, blk, shape))
        block_of = {id(leaf): blk for leaf, blk, _ in pairs}
        groups = [dict({k: v for k, v in g.items() if k != "params"},
                       params=[block_of.get(id(t), t) for t in g["params"]])
                  for g in orig.param_groups]
        opt = torch.optim.Adam(groups)
        for g_orig in orig.param_groups:
            for t in g_orig["params"]:
                if id(t) not in block_of:
                    opt.state[t] = orig.state[t]   # shared: updated in place
        for leaf, blk, shape in pairs:
            st = orig.state.get(leaf)
            if st:
                opt.state[blk] = {
                    "step": st["step"],
                    "exp_avg": self._to_block(st["exp_avg"], shape),
                    "exp_avg_sq": self._to_block(st["exp_avg_sq"], shape)}
        return blocks, opt, pairs

    def _unshard_plane_state(self, state: MapperState, opt, pairs):
        """Leaving the loop: planes and their moments all-gathered back to
        [C, H, W] into the state's leaves (in place: its optimizer keeps
        its references) and optimizer."""
        with torch.no_grad():
            for leaf, blk, shape in pairs:
                leaf.copy_(self._from_blocks(blk, shape))
                st = opt.state.get(blk)
                if st:
                    state.optimizer.state[leaf] = {
                        "step": st["step"],
                        "exp_avg": self._from_blocks(st["exp_avg"], shape),
                        "exp_avg_sq": self._from_blocks(st["exp_avg_sq"],
                                                        shape)}

    def _gather_tables(self, blocks):
        """Forward-only pack + all-gather of every plane block: the tables
        of the stale-table modes, {group: {name: [per level]}}."""
        return {group: {name: [self._seam_fn(self._shape(
                            group, name, lvl)).gather(blk)
                        for lvl, blk in enumerate(lst)]
                        for name, lst in planes.items()}
                for group, planes in blocks.items()}

    def _packed_params(self, params, blocks, tables=None):
        """The params tree with every plane (geometry and colour) as an
        `interp.PackedPlane` from the seam (or, with `tables`, the seam's
        `consume` half)."""
        out = dict(params)
        for group, planes in blocks.items():
            packed = {}
            for name, lst in planes.items():
                packed[name] = []
                for lvl, blk in enumerate(lst):
                    shape = self._shape(group, name, lvl)
                    seam = self._seam_fn(shape)
                    tbl = (seam(blk) if tables is None
                           else seam.consume(blk, tables[group][name][lvl]))
                    packed[name].append(interp.PackedPlane(tbl, shape))
            out[group] = packed
        return out

    def _optimize_row_sharded(self, state, cur_frame, cur_pose, generator,
                              iters, use_cur, draws):
        """The ZeRO-style loop (`_make_row_body` and `_optimize_row_sharded`
        of the JAX package): per iteration the full batch from the shared
        generator, this rank's ray block rendered against the gathered
        tables, the seam's backward to the local rows, the decoder
        gradients all-reduced, Adam on the blocks and the decoder."""
        mp = self.config["mapping"]
        prefetch = int(mp.get("shard_prefetch", 0))
        gather_every = max(1, int(mp.get("shard_gather_every", 1)))
        if prefetch != 0 and gather_every > 1:
            raise ValueError("mapping.shard_gather_every composes with the "
                             "sync seam only (shard_prefetch must be 0)")
        H, W = cur_frame["depth"].shape
        dir_flat = cur_frame["direction"].reshape(-1, 3)
        rgb_flat = cur_frame["rgb"].reshape(-1, 3)
        d_flat = cur_frame["depth"].reshape(-1)
        blocks, opt, pairs = self._shard_plane_state(state)
        params = {k: v for k, v in state.params.items()
                  if k not in PLANE_GROUPS}
        decoder = param_leaves(params)
        leaves = decoder + [blk for _, blk, _ in pairs]

        def grads_and_metrics(i, tables):
            g_idx, c_idx, u = draws[i] if draws is not None else (None,) * 3
            batch = self._build_rays(state.db, state.kf_poses, dir_flat,
                                     rgb_flat, d_flat, cur_pose, H * W,
                                     generator, use_cur, g_idx, c_idx)
            opt.zero_grad(set_to_none=True)
            metrics = self._shard_loss_backward(
                self._packed_params(params, blocks, tables), batch,
                generator, u)
            # plane gradients come out of the seam row-local
            self._all_reduce_grads(decoder)
            return metrics

        metrics = {k: torch.zeros((), device=self.device) for k in METRICS}
        if prefetch == 0:
            i = 0
            while i < iters:
                count = min(gather_every, iters - i)
                # k > 1: one table per k iterations, a loop invariant
                tables = None if gather_every == 1 else \
                    self._gather_tables(blocks)
                for j in range(i, i + count):
                    metrics = grads_and_metrics(j, tables)
                    opt.step()
                i += count
        else:
            tables = self._gather_tables(blocks)
            pending = None
            for i in range(iters):
                tables_next = self._gather_tables(blocks)
                metrics = grads_and_metrics(i, tables)
                if prefetch >= 2:
                    # apply the previous iteration's gradients; iteration
                    # 0 has none and takes no step
                    grads = [t.grad for t in leaves]
                    if pending is not None:
                        for t, g in zip(leaves, pending):
                            t.grad = g
                        opt.step()
                    pending = grads
                else:
                    opt.step()
                tables = tables_next
            if pending is not None:
                # the trailing apply of the last iteration's gradients
                for t, g in zip(leaves, pending):
                    t.grad = g
                opt.step()
        self._unshard_plane_state(state, opt, pairs)
        return state, metrics

    def add_keyframe(self, state: MapperState, frame_id: int,
                     cur_frame: Dict[str, torch.Tensor],
                     cur_pose: torch.Tensor,
                     generator: torch.Generator) -> MapperState:
        slot = state.db.count
        kf_lib.add_keyframe(
            state.db, generator, frame_id, cur_frame["direction"],
            cur_frame["rgb"], cur_frame["depth"],
            filter_depth=bool(self.config["mapping"].get("filter_depth",
                                                         False)),
            depth_trunc=float(self.config["cam"]["depth_trunc"]))
        state.kf_poses[slot] = cur_pose
        return state

    def first_frame_mapping(self, state: MapperState, frame: Dict,
                            pose: torch.Tensor, generator: torch.Generator,
                            iters: Optional[int] = None):
        """Add the first keyframe, then optimize hard on it
        (mapping.first_iters steps)."""
        iters = iters if iters is not None else \
            int(self.config["mapping"]["first_iters"])
        state = self.add_keyframe(state, int(frame["frame_id"]), frame, pose,
                                  generator)
        return self.optimize(state, frame, pose, generator, iters=iters,
                             use_cur=True)
