"""Rotation-representation converters on plain tensors.

Port of `mneslam_tpu/ops/rotations.py`: matrix <-> quaternion (xyzw) <->
axis-angle <-> 6D, and the pose assembly used by the loop-closure pose
optimisation (`agents/fusion.align_pose_by_render`). Every function
broadcasts over leading dims and is differentiable (the singular cases are
handled with `torch.where` on both branches, as in `ops/lie.py`).
"""

from __future__ import annotations

import torch

from . import lie


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] -> [..., 3, 3]."""
    return lie.quat_to_matrix(lie.so3_exp(aa))


def matrix_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    return lie.so3_log(lie.matrix_to_quat(R))


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    return lie.quat_to_matrix(q)


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    return lie.matrix_to_quat(R)


def axis_angle_to_quaternion(aa: torch.Tensor) -> torch.Tensor:
    return lie.so3_exp(aa)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    return lie.so3_log(q)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Zhou et al.'s continuous 6D -> rotation matrix by Gram-Schmidt; the
    two given columns become the first two columns."""
    a1, a2 = d6[..., :3], d6[..., 3:6]
    b1 = a1 / a1.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    a2p = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2p / a2p.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2).transpose(-1, -2)


def matrix_to_rotation_6d(R: torch.Tensor) -> torch.Tensor:
    return torch.cat([R[..., :, 0], R[..., :, 1]], dim=-1)


def rot_trans_to_transform(rot: torch.Tensor, trans: torch.Tensor,
                           rep: str = "axis_angle") -> torch.Tensor:
    """(rotation parameters, translation) -> [..., 4, 4] c2w; `rep` is the
    config's `training.rot_rep` ("axis_angle", "quat" or "6d")."""
    if rep == "axis_angle":
        R = axis_angle_to_matrix(rot)
    elif rep == "quat":
        R = quaternion_to_matrix(lie.quat_normalize(rot))
    elif rep == "6d":
        R = rotation_6d_to_matrix(rot)
    else:
        raise ValueError(f"unknown rotation representation: {rep}")
    top = torch.cat([R, trans[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def transform_to_rot_trans(T: torch.Tensor, rep: str = "axis_angle"):
    """[..., 4, 4] -> (rotation parameters in `rep`, translation)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    if rep == "axis_angle":
        return matrix_to_axis_angle(R), t
    if rep == "quat":
        return matrix_to_quaternion(R), t
    if rep == "6d":
        return matrix_to_rotation_6d(R), t
    raise ValueError(f"unknown rotation representation: {rep}")


def slerp_matrices(R0: torch.Tensor, R1: torch.Tensor,
                   t: torch.Tensor) -> torch.Tensor:
    """SLERP between rotation matrices."""
    q0 = lie.matrix_to_quat(R0)
    q1 = lie.matrix_to_quat(R1)
    return lie.quat_to_matrix(lie.slerp(q0, q1, t))
