"""Port of the SE(3) and projective geometry (`mneslam_tpu_torch.ops.lie`,
`.projective`) against the JAX package on the CPU.

Tolerance: fp32, rtol 1e-4 / atol 1e-5; the Jacobian entries scale with
f / Z (up to ~100 here), so those compare at rtol 1e-4 / atol 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mneslam_tpu.ops import lie as jlie
from mneslam_tpu.ops import projective as jproj
from mneslam_tpu_torch.ops import lie as plie
from mneslam_tpu_torch.ops import projective as pproj

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
HT, WD = 12, 16
INTR = np.array([12.0, 12.0, WD / 2 - 0.5, HT / 2 - 0.5], np.float32)


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _poses(rng, n, scale=0.4):
    xi = (scale * rng.normal(size=(n, 6))).astype(np.float32)
    return np.array(jlie.exp(jnp.asarray(xi)))


@pytest.mark.parametrize("scale", [1e-5, 0.3, 2.0])
def test_exp_log_retr_match_jax(scale):
    """Both sides of the Taylor branches (theta^2 below 1e-8 at 1e-5)."""
    rng = np.random.default_rng(0)
    xi = (scale * rng.normal(size=(7, 6))).astype(np.float32)
    T = jlie.exp(jnp.asarray(xi))
    _close(plie.exp(torch.tensor(xi)), T)
    _close(plie.log(torch.tensor(np.asarray(T))), jlie.log(T))
    a = _poses(rng, 7)
    _close(plie.retr(torch.tensor(a), torch.tensor(xi)),
           jlie.retr(jnp.asarray(a), jnp.asarray(xi)))
    _close(plie.so3_exp(torch.tensor(xi[:, 3:])), jlie.so3_exp(
        jnp.asarray(xi[:, 3:])))


def test_group_ops_match_jax():
    rng = np.random.default_rng(1)
    a, b = _poses(rng, 5), _poses(rng, 5)
    p = rng.normal(size=(5, 3)).astype(np.float32)
    p4 = rng.normal(size=(5, 4)).astype(np.float32)
    ta, tb = torch.tensor(a), torch.tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    _close(plie.mul(ta, tb), jlie.mul(ja, jb))
    _close(plie.inv(ta), jlie.inv(ja))
    _close(plie.act(ta, torch.tensor(p)), jlie.act(ja, jnp.asarray(p)))
    _close(plie.act4(ta, torch.tensor(p4)), jlie.act4(ja, jnp.asarray(p4)))
    M = jlie.matrix(ja)
    _close(plie.matrix(ta), M)
    _close(plie.from_matrix(torch.tensor(np.asarray(M))), jlie.from_matrix(M))
    _close(plie.adjoint(ta), jlie.adjoint(ja))
    J = rng.normal(size=(5, 2, 6)).astype(np.float32)
    _close(plie.adjT_apply(ta, torch.tensor(J)),
           jlie.adjT_apply(ja, jnp.asarray(J)))
    _close(plie.identity((3,)), jlie.identity((3,)))
    q = rng.normal(size=(6, 4)).astype(np.float32)
    _close(plie.quat_normalize(torch.tensor(q)),
           jlie.quat_normalize(jnp.asarray(q)))
    _close(plie.quat_to_matrix(plie.quat_normalize(torch.tensor(q))),
           jlie.quat_to_matrix(jlie.quat_normalize(jnp.asarray(q))))


def test_matrix_to_quat_every_branch():
    """Rotations near the identity and by ~pi about each axis pick each of
    the four Shepperd candidates."""
    R = np.stack([np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
                  np.diag([-1.0, -1, 1])]).astype(np.float32)
    R = R @ np.asarray(jlie.quat_to_matrix(jlie.so3_exp(
        jnp.asarray(0.05 * np.ones((4, 3), np.float32)))))
    _close(plie.matrix_to_quat(torch.tensor(R)),
           jlie.matrix_to_quat(jnp.asarray(R)))


def _problem(seed):
    rng = np.random.default_rng(seed)
    poses = _poses(rng, 4, 0.1)
    poses[0] = [0, 0, 0, 0, 0, 0, 1]
    disps = (0.4 + 0.2 * rng.random((4, HT, WD))).astype(np.float32)
    poses[3, 2] = -2.0                           # points behind: invalid
    ii = np.array([0, 1, 2, 3, 1])
    jj = np.array([1, 0, 3, 2, 1])               # (1, 1): a self-edge
    return poses, disps, ii, jj


def test_projective_transform_matches_jax():
    poses, disps, ii, jj = _problem(2)
    jargs = (jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(INTR),
             jnp.asarray(ii), jnp.asarray(jj))
    targs = (torch.tensor(poses), torch.tensor(disps), torch.tensor(INTR),
             torch.tensor(ii), torch.tensor(jj))
    x_j, v_j, (Ji_j, Jj_j, Jz_j) = jproj.projective_transform(
        *jargs, jacobian=True)
    x_t, v_t, (Ji_t, Jj_t, Jz_t) = pproj.projective_transform(
        *targs, jacobian=True)
    _close(x_t, x_j)
    _close(v_t, v_j)
    assert 0 < float(v_t.mean()) < 1
    for a, b in ((Ji_t, Ji_j), (Jj_t, Jj_j), (Jz_t, Jz_j)):
        _close(a, b, atol=1e-4)
    xd_j, _ = jproj.projective_transform(*jargs, return_depth=True)
    xd_t, _ = pproj.projective_transform(*targs, return_depth=True)
    _close(xd_t, xd_j)
    _close(pproj.coords_grid(HT, WD), jproj.coords_grid(HT, WD))
    _close(pproj.iproj(targs[1], targs[2]), jproj.iproj(jargs[1], jargs[2]))


def test_projective_transform_planes_matches_jax():
    poses, disps, ii, jj = _problem(3)
    ref = jproj.projective_transform_planes(
        jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(INTR),
        jnp.asarray(ii), jnp.asarray(jj))
    got = pproj.projective_transform_planes(
        torch.tensor(poses), torch.tensor(disps), torch.tensor(INTR),
        torch.tensor(ii), torch.tensor(jj))
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    for a, b in zip(got[2], ref[2]):
        _close(a, b, atol=1e-4)
    # the planes layout is the [E, H, W, 2, 6] Jacobian with axes moved
    _, _, (Ji, Jj, Jz) = pproj.projective_transform(
        torch.tensor(poses), torch.tensor(disps), torch.tensor(INTR),
        torch.tensor(ii), torch.tensor(jj), jacobian=True)
    E = len(ii)
    _close(got[2][1], Jj.reshape(E, HT * WD, 2, 6).permute(0, 3, 2, 1),
           atol=1e-4)
