"""SE(3) operations on plain tensors.

Port of the SE(3) part of `mneslam_tpu/ops/lie.py`. Poses are `[..., 7]`
tensors `[tx, ty, tz, qx, qy, qz, qw]` (translation + unit quaternion,
scalar last, the reference keyframe buffer's layout); tangent vectors are
`[..., 6] = [tau, phi]`, translation first; retraction is left
multiplication, `retr(X, xi) = exp(xi) * X`. Every function broadcasts
over leading dims. The exp/log Taylor branches near theta = 0 use the same
thresholds as the JAX package; both branches are computed and selected
with `torch.where`, so nothing reads back to the host.
"""

from __future__ import annotations

import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 (x) q2, xyzw layout."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / q.norm(dim=-1, keepdim=True).clamp(min=eps)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v' = v + 2 w (u x v) + 2 u x (u x v), u = the vector part."""
    u = q[..., :3]
    w = q[..., 3:4]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (xyzw) -> rotation matrix [..., 3, 3]."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], dim=-2)


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (xyzw), w >= 0.

    All four Shepperd candidates are computed and the best-conditioned one
    selected per matrix."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    cands = torch.stack([
        torch.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], -1),
        torch.stack([1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12],
                    -1),
        torch.stack([m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20],
                    -1),
        torch.stack([m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01],
                    -1),
    ], dim=-2)                                                # [..., 4, 4]
    lead = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    best = lead.argmax(dim=-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 4)).squeeze(-2)
    q = quat_normalize(q)
    return torch.where(q[..., 3:4] < 0, -q, q)


def _skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], dim=-2)


# ---------------------------------------------------------------------------
# SE(3): [..., 7] = [t(3), q(4)]
# ---------------------------------------------------------------------------

def identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity poses; built on the device (no host copy, so no sync)."""
    e = torch.zeros(tuple(shape) + (7,), dtype=dtype, device=device)
    e[..., 6] = 1.0
    return e


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3]


def quaternion(T: torch.Tensor) -> torch.Tensor:
    return T[..., 3:7]


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose: (a*b) acts as a(b(x))."""
    t = translation(a) + quat_rotate(quaternion(a), translation(b))
    q = quat_mul(quaternion(a), quaternion(b))
    return torch.cat([t, q], dim=-1)


def inv(a: torch.Tensor) -> torch.Tensor:
    qc = quat_conj(quaternion(a))
    return torch.cat([-quat_rotate(qc, translation(a)), qc], dim=-1)


def act(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply poses to 3-D points [..., 3]."""
    return quat_rotate(quaternion(a), p) + translation(a)


def act4(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Homogeneous-depth action on [..., 4] = [X, Y, Z, d]:
    (R p + d t, d)."""
    xyz = quat_rotate(quaternion(a), p[..., :3]) + p[..., 3:4] * translation(a)
    return torch.cat([xyz, p[..., 3:4].expand(xyz.shape[:-1] + (1,))], -1)


def matrix(a: torch.Tensor) -> torch.Tensor:
    """[..., 7] -> [..., 4, 4] homogeneous matrix."""
    R = quat_to_matrix(quaternion(a))
    top = torch.cat([R, translation(a)[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def from_matrix(M: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] homogeneous matrix -> [..., 7]."""
    return torch.cat([M[..., :3, 3], matrix_to_quat(M[..., :3, :3])], -1)


def _so3_exp_coeffs(theta_sq: torch.Tensor):
    """(A, B, C): exp(skew(phi)) = I + A skew + B skew^2 and
    V = I + B skew + C skew^2, Taylor-guarded near 0."""
    small = theta_sq < 1e-8
    ts = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = ts.sqrt()
    A = torch.where(small, 1.0 - theta_sq / 6.0, theta.sin() / theta)
    B = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - theta.cos()) / ts)
    C = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, (1.0 - A) / ts)
    return A, B, C


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """so(3) vector -> unit quaternion (xyzw)."""
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    small = theta_sq < 1e-8
    ts = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = ts.sqrt()
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta_sq / 48.0, half.sin() / theta)
    w = torch.where(small, 1.0 - theta_sq / 8.0, half.cos())
    return torch.cat([k * phi, w], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (xyzw) -> so(3) vector (short geodesic)."""
    q = torch.where(q[..., 3:4] < 0, -q, q)
    u = q[..., :3]
    w = q[..., 3:4]
    un_sq = (u * u).sum(-1, keepdim=True)
    small = un_sq < 1e-12
    un = torch.where(small, torch.ones_like(un_sq), un_sq).sqrt()
    theta = 2.0 * torch.atan2(un, w)
    scale = torch.where(small, 2.0 / w.clamp(min=1e-12), theta / un)
    return scale * u


def exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) [..., 6] = [tau, phi] -> SE(3) [..., 7]."""
    tau, phi = xi[..., :3], xi[..., 3:6]
    q = so3_exp(phi)
    theta_sq = (phi * phi).sum(-1)[..., None, None]
    _, B, C = _so3_exp_coeffs(theta_sq)
    Phi = _skew(phi)
    V = torch.eye(3, dtype=xi.dtype, device=xi.device) + B * Phi \
        + C * (Phi @ Phi)
    t = (V @ tau[..., None])[..., 0]
    return torch.cat([t, q], dim=-1)


def log(a: torch.Tensor) -> torch.Tensor:
    """SE(3) [..., 7] -> se(3) [..., 6] = [tau, phi]."""
    phi = so3_log(quaternion(a))
    theta_sq = (phi * phi).sum(-1)[..., None, None]
    A, B, _ = _so3_exp_coeffs(theta_sq)
    Phi = _skew(phi)
    small = theta_sq < 1e-8
    ts = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    coef = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                       (1.0 - A / (2.0 * B.clamp(min=1e-12))) / ts)
    Vinv = torch.eye(3, dtype=a.dtype, device=a.device) - 0.5 * Phi \
        + coef * (Phi @ Phi)
    tau = (Vinv @ translation(a)[..., None])[..., 0]
    return torch.cat([tau, phi], dim=-1)


def adjoint(a: torch.Tensor) -> torch.Tensor:
    """Ad(a) [..., 6, 6] = [[R, skew(t) R], [0, R]] (tangent [tau, phi])."""
    R = quat_to_matrix(quaternion(a))
    tR = _skew(translation(a)) @ R
    top = torch.cat([R, tR], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def adjT_apply(a: torch.Tensor, J: torch.Tensor) -> torch.Tensor:
    """Row-Jacobians J [..., k, 6] -> J @ Ad(a) (lietorch's adjT)."""
    return J @ adjoint(a)


def retr(a: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left retraction exp(xi) * a (the BA update convention)."""
    return mul(exp(xi), a)
