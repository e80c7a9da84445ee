"""Inter-agent loop closure and map fusion.

Port of `mneslam_tpu/agents/fusion.py`:

  * `align_pose_by_render`: the base map renders teacher rgb / depth at
    the base pose; the target pose (rotation parameters + translation) is
    optimised by Adam so that the target map's renders match. The JAX
    package runs the loop as one `lax.scan`; here it is an eager loop
    whose best-pose tracking stays on the device. Both maps are frozen:
    no gradient reaches their parameters, so the sampler's backward runs
    its coordinate part only and kernel 1 (the row scatter) never
    launches.
  * `deform_trajectory`: distance-decayed SLERP blend of the corrective
    transform over the keyframe trajectory.
  * `compute_overlap_bound` / `keyframes_in_bound`: AABB overlap of two
    agents' bounds and the keyframes inside it (host numpy).
  * `distill`: teacher renders along foreign keyframe rays supervise the
    student map for `iters` steps of the student's own mapping step (its
    Adam state continues); the student's backward goes through kernel 1.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.droid_net import map_params
from ..ops import lie, rotations


def frozen(params):
    """A parameter tree's leaves detached: renders take no gradient."""
    return map_params(params, torch.Tensor.detach)


def align_pose_by_render(scene_base, params_base: Dict, scene_target,
                         params_target: Dict, base_c2w: torch.Tensor,
                         target_c2w_init: torch.Tensor,
                         rays_d_cam: torch.Tensor, iters: int = 100,
                         lr_rot: float = 0.001, lr_trans: float = 0.001,
                         rgb_weight: float = 5.0, depth_weight: float = 0.1,
                         rot_rep: str = "axis_angle"):
    """-> (best target c2w [4, 4], best loss, init loss), tensors on the
    device. `rays_d_cam` [S, 3]: sampled camera-frame directions. Each
    iteration's loss is that of the pose before its update, and the best
    pose is taken before the update, as in the JAX scan; `init_loss` is
    the first iteration's loss (the render-consistency loss at
    `target_c2w_init`), on which the closure gate compares."""
    S = rays_d_cam.shape[0]
    with torch.no_grad():
        teacher = scene_base.render_rays(
            frozen(params_base), base_c2w[:3, 3].expand(S, 3),
            rays_d_cam @ base_c2w[:3, :3].T, target_d=None)
        t_rgb, t_depth = teacher["rgb"], teacher["depth"]
        rot0, trans0 = rotations.transform_to_rot_trans(target_c2w_init,
                                                        rot_rep)
    target = frozen(params_target)
    rot = rot0.clone().requires_grad_(True)
    trans = trans0.clone().requires_grad_(True)
    # optax.chain of two masked Adams (default betas and eps): one Adam
    # with a group per parameter
    opt = torch.optim.Adam([{"params": [rot], "lr": float(lr_rot)},
                            {"params": [trans], "lr": float(lr_trans)}])
    best_loss = torch.full((), float("inf"), device=rays_d_cam.device)
    best_c2w = target_c2w_init.detach().clone()
    init_loss = None
    for _ in range(iters):
        c2w = rotations.rot_trans_to_transform(rot, trans, rot_rep)
        ret = scene_target.render_rays(target, c2w[:3, 3].expand(S, 3),
                                       rays_d_cam @ c2w[:3, :3].T,
                                       target_d=None)
        loss = rgb_weight * (ret["rgb"] - t_rgb).square().mean() \
            + depth_weight * (ret["depth"] - t_depth).square().mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        with torch.no_grad():
            better = loss < best_loss
            best_loss = torch.where(better, loss, best_loss)
            best_c2w = torch.where(better, c2w, best_c2w)
            if init_loss is None:
                init_loss = loss.detach().clone()
        opt.step()
    return best_c2w, best_loss, init_loss


def deform_trajectory(poses_c2w: torch.Tensor, loop_kf_idx: int,
                      relative_transform: torch.Tensor,
                      decay_sigma: float = 10.0,
                      min_weight: float = 0.1) -> torch.Tensor:
    """poses [N, 4, 4] -> each pose left-multiplied by the corrective
    transform scaled by w = min_weight + (1 - min_weight) exp(-d^2 / (2
    sigma^2)), d the camera's distance to the loop keyframe's: rotation by
    SLERP from the identity, translation by w."""
    N = poses_c2w.shape[0]
    dev, dt = poses_c2w.device, poses_c2w.dtype
    loop_pos = poses_c2w[loop_kf_idx, :3, 3]
    dist = (poses_c2w[:, :3, 3] - loop_pos).norm(dim=1)
    decay = torch.exp(-dist.square() / (2.0 * decay_sigma ** 2))
    w = min_weight + (1.0 - min_weight) * decay                     # [N]
    q_rel = lie.matrix_to_quat(relative_transform[:3, :3])
    q_id = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dt, device=dev)
    q = lie.slerp(q_id.expand(N, 4), q_rel.expand(N, 4), w[:, None])
    inc = torch.eye(4, dtype=dt, device=dev).repeat(N, 1, 1)
    inc[:, :3, :3] = lie.quat_to_matrix(q)
    inc[:, :3, 3] = w[:, None] * relative_transform[:3, 3]
    return inc @ poses_c2w


def compute_overlap_bound(bound1: np.ndarray, bound2: np.ndarray
                          ) -> Optional[np.ndarray]:
    """AABB intersection [3, 2], or None when the boxes do not meet."""
    b1, b2 = np.asarray(bound1, float), np.asarray(bound2, float)
    overlap = np.empty_like(b1)
    overlap[:, 0] = np.maximum(b1[:, 0], b2[:, 0])
    overlap[:, 1] = np.minimum(b1[:, 1], b2[:, 1])
    if np.any(overlap[:, 0] > overlap[:, 1]):
        return None
    return overlap


def keyframes_in_bound(poses: np.ndarray, timestamps: np.ndarray,
                       bound: np.ndarray) -> List[Dict]:
    """Keyframes whose camera centres lie inside `bound` ->
    [{"kf_id", "pose"}]."""
    out = []
    for i, pose in enumerate(np.asarray(poses)):
        p = pose[:3, 3]
        if np.all(p >= bound[:, 0]) and np.all(p <= bound[:, 1]):
            out.append({"kf_id": int(timestamps[i]), "pose": pose})
    return out


def distill(scene_teacher, params_teacher: Dict, mapper, state,
            foreign_poses: torch.Tensor, rays_d_cam: torch.Tensor,
            generator: Optional[torch.Generator] = None, iters: int = 100,
            rays_per_kf: int = 128, idx: Optional[torch.Tensor] = None,
            u: Optional[torch.Tensor] = None):
    """Teacher -> student distillation along foreign keyframe rays: each
    iteration draws `rays_per_kf` rays of every foreign keyframe (poses
    [K, 4, 4], directions from `rays_d_cam` [P, 3]), renders the teacher
    with no gradient, and takes one step of the student's mapping loss on
    the rendered rgb / depth (`mapper.step` on `state`, the student's
    `MapperState`, in place). `idx` [iters, K, rays_per_kf] replaces the
    ray draws and `u` [iters, K rays_per_kf, S] the depth perturbations
    (tests replay JAX's draws). -> (state, the last step's loss)."""
    K, P = foreign_poses.shape[0], rays_d_cam.shape[0]
    teacher_params = frozen(params_teacher)
    loss = None
    for it in range(iters):
        ii = (torch.randint(0, P, (K, rays_per_kf), generator=generator,
                            device=rays_d_cam.device)
              if idx is None else idx[it].long())
        rays_d = torch.einsum("krc,knc->krn", rays_d_cam[ii],
                              foreign_poses[:, :3, :3])
        rays_o = foreign_poses[:, None, :3, 3].expand(rays_d.shape)
        rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
        with torch.no_grad():
            teacher = scene_teacher.render_rays(teacher_params, rays_o,
                                                rays_d, target_d=None)
        metrics = mapper.step(state, rays_o, rays_d, teacher["rgb"],
                              teacher["depth"][:, None],
                              generator=generator if u is None else None,
                              u=None if u is None else u[it])
        loss = metrics["loss"]
    return state, loss
