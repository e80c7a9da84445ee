"""Online mapper: per-keyframe gradient-descent steps over the neural map.

Port of the single-device path of `mneslam_tpu/mapping/mapper.py`. Each
iteration samples a ray batch (global keyframe rays + current-frame rays),
renders it, and takes one Adam step. The JAX package compiles the whole
loop into one program; here it is a Python loop of eager steps that never
reads a value back to the host: the metrics stay on the device until the
caller flushes them once per keyframe.

Optimizer: Adam(betas=(0.9, 0.99)) in two groups, the decoder at
lr_decoder with weight decay 1e-6 (PyTorch's coupled L2, the same as
`optax.add_decayed_weights` before `optax.adam`) and the planes at lr_embed
with eps 1e-15.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..data import rays as rays_lib
from ..models.scene_rep import SceneRep, param_leaves
from . import keyframe as kf_lib


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
                 rays_per_kf: int):
        if float(config["training"].get("smooth_weight", 0.0)) > 0.0:
            raise ValueError("training.smooth_weight > 0 (the smoothness "
                             "loss) is not ported")
        self.config = config
        self.scene = scene
        self.device = scene.device
        self.num_kf = num_kf
        self.rays_per_kf = rays_per_kf
        self.n_global = int(config["mapping"]["sample"])
        self.n_cur = int(config["mapping"]["min_pixels_cur"])

    def init_state(self, generator: torch.Generator) -> MapperState:
        params = self.scene.init_params(generator)
        return MapperState(
            params=params,
            optimizer=make_optimizer(self.config, params),
            db=kf_lib.init_db(self.num_kf, self.rays_per_kf, self.device),
            kf_poses=torch.eye(4, device=self.device).repeat(
                self.num_kf, 1, 1))

    # ------------------------------------------------------------------

    def _loss_fn(self, params, rays_o, rays_d, target_rgb, target_d,
                 generator=None, u=None):
        ret = self.scene.forward(params, rays_o, rays_d, target_rgb,
                                 target_d, generator=generator, u=u)
        return self.scene.get_loss_from_ret(ret), ret

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
                 iters: int, use_cur: bool = True
                 ) -> Tuple[MapperState, Dict[str, torch.Tensor]]:
        """`iters` steps over (global keyframe rays + current-frame rays);
        returns the last step's metrics, still on the device.
        cur_frame: direction [H,W,3], rgb [H,W,3], depth [H,W]."""
        H, W = cur_frame["depth"].shape
        dir_flat = cur_frame["direction"].reshape(-1, 3)
        rgb_flat = cur_frame["rgb"].reshape(-1, 3)
        d_flat = cur_frame["depth"].reshape(-1)
        metrics = {k: torch.zeros((), device=self.device)
                   for k in ("loss", "psnr", "rgb_loss", "depth_loss")}
        for _ in range(iters):
            batch = self._build_rays(state.db, state.kf_poses, dir_flat,
                                     rgb_flat, d_flat, cur_pose, H * W,
                                     generator, use_cur)
            metrics = self.step(state, *batch, generator=generator)
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
