"""Port parity of the multi-agent modules (`mneslam_tpu_torch.agents`,
`ops.rotations`, the `lie` slerp / Sim(3) additions, `utils.params_io`)
against the JAX package, on the CPU at a tiny size.

Inputs are made from a seed with numpy (or drawn by `jax.random` exactly
as the JAX code draws them) and handed to both packages. Tolerances: atol
1e-5 for the pose algebra, 1e-6 for the stub descriptor, rtol 1e-4 / atol
1e-5 for the fp32 networks and map steps (as tests/test_torch_mapper.py),
best pose atol 1e-4 and losses rtol 1e-4 for the render alignment.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mneslam_tpu.agents import comms as jcomms
from mneslam_tpu.agents import fusion as jfusion
from mneslam_tpu.agents import loop_detector as jld
from mneslam_tpu.agents import netvlad as jnv
from mneslam_tpu.agents import runner as jrunner
from mneslam_tpu.config import make_config as jmake_config
from mneslam_tpu.ops import lie as jlie
from mneslam_tpu.ops import rotations as jrot
from mneslam_tpu.utils import params_io as jpio
from mneslam_tpu_torch.agents import comms, fusion, netvlad, runner
from mneslam_tpu_torch.agents.loop_detector import (LoopDetector,
                                                    find_mutual_matches)
from mneslam_tpu_torch.config import make_config
from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
from mneslam_tpu_torch.models.scene_rep import param_items
from mneslam_tpu_torch.ops import lie, rotations
from mneslam_tpu_torch.utils import params_io

torch.set_num_threads(1)

POSE_ATOL = 1e-5
DESC_ATOL = 1e-6
RTOL, ATOL = 1e-4, 1e-5
ALIGN_POSE_ATOL = 1e-4


def tiny_overrides(tmp_path=None):
    """tests/test_multiagent.py:17's tiny_cfg."""
    return {
        "mode": "mapping",
        "data": {"output": str(tmp_path) if tmp_path else "/tmp/ma",
                 "exp_name": "t"},
        "mapping": {
            "bound": [[-2.2, 2.2]] * 3,
            "marching_cubes_bound": [[-2.1, 2.1]] * 3,
            "sample": 256, "min_pixels_cur": 48, "first_iters": 60,
            "iters": 12, "keyframe_every": 2, "loop_iters": 40,
            "distill_iters": 20, "lr_rot": 0.01, "lr_trans": 0.01,
        },
        "planes_res": {"coarse": 0.44, "fine": 0.22,
                       "bound_dividable": 0.22},
        "cam": {"H": 40, "W": 56, "fx": 35.0, "fy": 35.0, "cx": 27.5,
                "cy": 19.5, "near": 0.0, "far": 8.0},
        "training": {"n_range_d": 9, "n_samples_d": 8, "range_d": 0.25,
                     "trunc": 0.15},
        "model": {"c_dim": 16, "input_ch": 32, "input_ch_pos": 48,
                  "truncation": 0.15},
        "loop_detection": {"enabled": True, "sim_threshold": 0.85,
                           "min_time_diff": 6, "loop_launch_th": 2,
                           "min_matches_for_fusion": 1},
        "loop_bound": {"bound_0": [[-2.2, 2.2]] * 3,
                       "bound_1": [[-2.2, 2.2]] * 3},
    }


def t32(a):
    return torch.tensor(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# rotations, slerp, Sim(3)
# ---------------------------------------------------------------------------

def _rot_params(rep, rng, n):
    phi = rng.normal(size=(n, 3)).astype(np.float32)
    if rep == "axis_angle":
        return phi
    if rep == "quat":
        return (1.3 * np.asarray(jlie.so3_exp(phi))).astype(np.float32)
    return rng.normal(size=(n, 6)).astype(np.float32)


@pytest.mark.parametrize("rep", ["axis_angle", "quat", "6d"])
def test_rotation_representations_match_jax(rep):
    """rot_trans_to_transform, its round trip through
    transform_to_rot_trans, and its gradient (a random linear functional
    of the transform) against JAX."""
    rng = np.random.default_rng(0)
    rot = _rot_params(rep, rng, 16)
    trans = rng.normal(size=(16, 3)).astype(np.float32)
    W = rng.normal(size=(16, 4, 4)).astype(np.float32)

    T_j = np.asarray(jrot.rot_trans_to_transform(rot, trans, rep))
    T_p = rotations.rot_trans_to_transform(t32(rot), t32(trans), rep)
    np.testing.assert_allclose(T_p.numpy(), T_j, atol=POSE_ATOL)
    r_j, tr_j = jrot.transform_to_rot_trans(jnp.asarray(T_j), rep)
    r_p, tr_p = rotations.transform_to_rot_trans(T_p, rep)
    np.testing.assert_allclose(r_p.numpy(), np.asarray(r_j), atol=POSE_ATOL)
    np.testing.assert_allclose(tr_p.numpy(), np.asarray(tr_j), atol=0)
    back = rotations.rot_trans_to_transform(r_p, tr_p, rep)
    np.testing.assert_allclose(back.numpy(), T_p.numpy(), atol=1e-4)

    gj = jax.grad(lambda r, t: jnp.sum(
        W * jrot.rot_trans_to_transform(r, t, rep)), argnums=(0, 1))(
            jnp.asarray(rot), jnp.asarray(trans))
    r = t32(rot).requires_grad_(True)
    t = t32(trans).requires_grad_(True)
    (t32(W) * rotations.rot_trans_to_transform(r, t, rep)).sum().backward()
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(gj[0]),
                               atol=POSE_ATOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(gj[1]),
                               atol=POSE_ATOL)


def test_rotation_helpers_and_branches_match_jax():
    """The single conversions, the four Shepperd branches (180-degree
    rotations included), slerp_matrices; an unknown rep raises."""
    rng = np.random.default_rng(1)
    phi = rng.normal(size=(8, 3)).astype(np.float32)
    big = np.zeros((3, 3), np.float32)
    big[np.arange(3), np.arange(3)] = np.pi - 1e-4
    phi = np.concatenate([phi, big, np.zeros((1, 3), np.float32)])
    R_j = np.asarray(jrot.axis_angle_to_matrix(phi))
    R_p = rotations.axis_angle_to_matrix(t32(phi))
    np.testing.assert_allclose(R_p.numpy(), R_j, atol=POSE_ATOL)
    for name in ("matrix_to_quaternion", "matrix_to_rotation_6d"):
        np.testing.assert_allclose(
            getattr(rotations, name)(R_p).numpy(),
            np.asarray(getattr(jrot, name)(jnp.asarray(R_j))), atol=POSE_ATOL)
    q = np.asarray(jlie.so3_exp(phi[:8]))
    np.testing.assert_allclose(
        rotations.quaternion_to_axis_angle(t32(q)).numpy(),
        np.asarray(jrot.quaternion_to_axis_angle(q)), atol=POSE_ATOL)
    np.testing.assert_allclose(
        rotations.axis_angle_to_quaternion(t32(phi)).numpy(),
        np.asarray(jrot.axis_angle_to_quaternion(phi)), atol=POSE_ATOL)
    np.testing.assert_allclose(
        rotations.quaternion_to_matrix(t32(q)).numpy(),
        np.asarray(jrot.quaternion_to_matrix(q)), atol=POSE_ATOL)
    np.testing.assert_allclose(
        rotations.matrix_to_axis_angle(R_p[:8]).numpy(),
        np.asarray(jrot.matrix_to_axis_angle(jnp.asarray(R_j[:8]))),
        atol=1e-4)
    w = rng.uniform(size=(4, 1)).astype(np.float32)
    np.testing.assert_allclose(
        rotations.slerp_matrices(R_p[:4], R_p[4:8], t32(w)).numpy(),
        np.asarray(jrot.slerp_matrices(R_j[:4], R_j[4:8], w)),
        atol=POSE_ATOL)
    with pytest.raises(ValueError):
        rotations.rot_trans_to_transform(t32(phi), t32(phi), "euler")


def test_slerp_matches_jax():
    """Random pairs, pairs on opposite hemispheres (negative dot) and
    nearly equal pairs (the lerp branch); t as [N, 1], [N] and a float;
    the gradient in t."""
    rng = np.random.default_rng(2)
    q0 = np.array(jlie.so3_exp(rng.normal(size=(12, 3))), np.float32)
    q1 = np.array(jlie.so3_exp(rng.normal(size=(12, 3))), np.float32)
    q1[4:8] = -q1[4:8]
    q1[8:] = q0[8:] + 1e-8
    t = rng.uniform(size=(12, 1)).astype(np.float32)
    for tt in (t, t[:, 0], 0.3):
        np.testing.assert_allclose(
            lie.slerp(t32(q0), t32(q1), tt if isinstance(tt, float)
                      else t32(tt)).numpy(),
            np.asarray(jlie.slerp(q0, q1, tt)), atol=POSE_ATOL)
    gj = jax.grad(lambda tt: jnp.sum(jlie.slerp(q0[:8], q1[:8], tt)
                                     * q1[:8]))(jnp.asarray(t[:8]))
    tp = t32(t[:8]).requires_grad_(True)
    (lie.slerp(t32(q0[:8]), t32(q1[:8]), tp) * t32(q1[:8])).sum().backward()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gj),
                               atol=POSE_ATOL)


def _sim3(rng, n):
    t = rng.normal(size=(n, 3))
    q = np.asarray(jlie.so3_exp(0.5 * rng.normal(size=(n, 3))))
    s = np.exp(0.3 * rng.normal(size=(n, 1)))
    return np.concatenate([t, q, s], -1).astype(np.float32)


def test_sim3_matches_jax():
    """sim3_identity / mul / inv / act / act4 / exp / log against JAX
    (tests/test_lie.py:165), the exp Taylor branches included (sigma = 0,
    theta = 0); the group axioms hold in the port."""
    rng = np.random.default_rng(3)
    a, b = _sim3(rng, 6), _sim3(rng, 6)
    p = rng.normal(size=(6, 3)).astype(np.float32)
    p4 = rng.normal(size=(6, 4)).astype(np.float32)
    p4[:, 3] = np.abs(p4[:, 3]) + 0.5
    np.testing.assert_array_equal(lie.sim3_identity((6,)).numpy(),
                                  np.asarray(jlie.sim3_identity((6,))))
    for name, args in (("sim3_mul", (a, b)), ("sim3_inv", (a,)),
                       ("sim3_act", (a, p)), ("sim3_act4", (a, p4)),
                       ("sim3_log", (a,))):
        np.testing.assert_allclose(
            getattr(lie, name)(*map(t32, args)).numpy(),
            np.asarray(getattr(jlie, name)(*args)), atol=POSE_ATOL,
            err_msg=name)
    xi = (0.4 * rng.normal(size=(16, 7))).astype(np.float32)
    xi[4:8, 6] = 0.0          # sigma = 0
    xi[8:12, 3:6] = 0.0       # theta = 0
    xi[12:, 3:7] = 0.0        # both
    np.testing.assert_allclose(lie.sim3_exp(t32(xi)).numpy(),
                               np.asarray(jlie.sim3_exp(xi)), atol=POSE_ATOL)
    np.testing.assert_allclose(
        lie.sim3_log(lie.sim3_exp(t32(xi))).numpy(), xi, atol=1e-3)
    eye = lie.sim3_identity((6,))
    np.testing.assert_allclose(
        lie.sim3_mul(t32(a), lie.sim3_inv(t32(a))).numpy(), eye.numpy(),
        atol=1e-4)


# ---------------------------------------------------------------------------
# descriptors, params_io, loop detection
# ---------------------------------------------------------------------------

def test_stub_descriptor_matches_jax(tmp_path):
    ov = tiny_overrides(tmp_path)
    ds = SyntheticBoxDataset(make_config(ov), num_frames=24)
    fn = netvlad.make_descriptor_fn(make_config(ov), "cpu")
    descs = []
    for i in (0, 1, 12):
        img = ds[i]["rgb"]
        d = fn(img)
        np.testing.assert_allclose(d.numpy(),
                                   np.asarray(jnv.stub_descriptor(img)),
                                   atol=DESC_ATOL)
        descs.append(d)
    # an odd-sized image
    img = np.random.default_rng(0).uniform(size=(37, 53, 3)).astype(
        np.float32)
    np.testing.assert_allclose(netvlad.stub_descriptor(t32(img)).numpy(),
                               np.asarray(jnv.stub_descriptor(img)),
                               atol=DESC_ATOL)
    assert float(descs[0] @ descs[0]) > 0.999
    assert float(descs[0] @ descs[1]) > float(descs[0] @ descs[2])


def test_stub_descriptor_dim_is_a_plain_argument():
    """The port takes any `dim` (the first `dim` features, renormalised);
    the JAX package's jitted stub_descriptor traces `dim` and raises for
    any value passed (a known divergence, ROADMAP Queue 3)."""
    img = np.random.default_rng(1).uniform(size=(40, 56, 3)).astype(
        np.float32)
    full = netvlad.stub_descriptor(t32(img))
    short = netvlad.stub_descriptor(t32(img), dim=32)
    assert short.shape == (32,)
    np.testing.assert_allclose(short.numpy(),
                               (full[:32] / full[:32].norm()).numpy(),
                               atol=DESC_ATOL)
    with pytest.raises(jax.errors.TracerBoolConversionError):
        jnv.stub_descriptor(img, dim=32)


def _random_netvlad(whiten_rows=0):
    """JAX init_netvlad_random(whiten=False) as numpy, with an optional
    small whitening of `whiten_rows` outputs."""
    p = jax.tree.map(np.asarray, jnv.init_netvlad_random(
        jax.random.PRNGKey(0), whiten=False))
    if whiten_rows:
        rng = np.random.default_rng(5)
        p["whiten_w"] = (0.02 * rng.normal(size=(whiten_rows, 512 * 64))
                         ).astype(np.float32)
        p["whiten_b"] = (0.01 * rng.normal(size=whiten_rows)).astype(
            np.float32)
    return p


@pytest.mark.parametrize("whiten_rows", [0, 64])
def test_netvlad_apply_matches_jax(whiten_rows):
    """VGG16 + NetVLAD (+ a small whitening) with JAX's random weights on a
    64 x 80 image batch: rtol 1e-4 / atol 1e-5."""
    p = _random_netvlad(whiten_rows)
    img = np.random.default_rng(1).uniform(size=(2, 3, 64, 80)).astype(
        np.float32)
    want = np.asarray(jnv.netvlad_apply(jax.tree.map(jnp.asarray, p), img))
    tp = jax.tree.map(t32, p)
    with torch.no_grad():
        got = netvlad.netvlad_apply(tp, t32(img)).numpy()
    assert got.shape == want.shape == (2, whiten_rows or 512 * 64)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    # the backbone alone, and the layer on its own input
    x = np.random.default_rng(2).normal(size=(1, 512, 12)).astype(np.float32)
    np.testing.assert_allclose(
        netvlad.netvlad_layer_apply(tp, t32(x)).numpy(),
        np.asarray(jnv.netvlad_layer_apply(jax.tree.map(jnp.asarray, p), x)),
        rtol=RTOL, atol=ATOL)


def test_init_netvlad_random_shapes():
    p = netvlad.init_netvlad_random(torch.Generator().manual_seed(0),
                                    whiten=False)
    j = jnv.init_netvlad_random(jax.random.PRNGKey(0), whiten=False)
    shapes = jax.tree.map(lambda a: tuple(a.shape), j)
    assert jax.tree.map(lambda t: tuple(t.shape), p) == shapes


def test_load_netvlad_mat_matches_jax(tmp_path):
    """The MatConvNet importer on tests/netvlad_fixture.py's fake .mat:
    every array equal to the JAX importer's."""
    from tests.netvlad_fixture import make_fake_netvlad_mat

    path = str(tmp_path / "fake_netvlad.mat")
    make_fake_netvlad_mat(path)
    want = jnv.load_netvlad_mat(path)
    got = netvlad.load_netvlad_mat(path)
    assert len(got["convs"]) == 13
    jflat = jax.tree_util.tree_flatten_with_path(want)[0]
    pflat = dict(param_items(got))
    assert len(jflat) == len(pflat)
    for path_, v in jflat:
        key = tuple(getattr(k, "key", getattr(k, "idx", None))
                    for k in path_)
        np.testing.assert_array_equal(pflat[key].numpy(), np.asarray(v),
                                      err_msg=str(key))
    del want, got, jflat, pflat


def test_params_io_interop_and_npz_descriptor(tmp_path):
    """A tree written by JAX's save_pytree_npz loads in the port bit for
    bit and the reverse; make_descriptor_fn takes a .npz NetVLAD and gives
    netvlad_apply's descriptor."""
    p = _random_netvlad()
    jpath, ppath = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jpio.save_pytree_npz(jpath, p)
    got = params_io.load_pytree_npz(jpath)
    assert jax.tree.map(lambda t: t.numpy(), got).keys() == p.keys()
    for (ka, a), (kb, b) in zip(param_items(got), param_items(p)):
        assert ka == kb
        np.testing.assert_array_equal(a.numpy(), b)
    params_io.save_pytree_npz(ppath, got)
    back = jpio.load_pytree_npz(ppath)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        np.testing.assert_array_equal(np.asarray(a), b)

    cfg = {"model_name": "net", "checkpoints": {"net": ppath}}
    fn = netvlad.make_descriptor_fn(cfg, "cpu")
    img = np.random.default_rng(3).uniform(size=(48, 64, 3)).astype(
        np.float32)
    with torch.no_grad():
        ref = netvlad.netvlad_apply(got, t32(img).permute(2, 0, 1)[None])[0]
    np.testing.assert_array_equal(fn(img).numpy(), ref.numpy())
    # no file: the stub
    fn = netvlad.make_descriptor_fn({"checkpoints": {}}, "cpu")
    np.testing.assert_array_equal(fn(img).numpy(),
                                  netvlad.stub_descriptor(t32(img)).numpy())


def test_npz_tracking_pretrained_loads(tmp_path):
    """A .npz `tracking.pretrained` (utils/params_io) gives the tracker
    those weights."""
    from mneslam_tpu_torch.models import droid_net
    from mneslam_tpu_torch.slam import MNESLAM

    path = str(tmp_path / "droid.npz")
    # the JAX tree layout (tests/test_torch_droid_net.py), written by JAX
    jp = droid_net.map_params(droid_net.init_droid_net(
        torch.Generator().manual_seed(3)), lambda t: t.numpy())
    jpio.save_pytree_npz(path, jp)
    ov = tiny_overrides(tmp_path)
    ov.update(mode="slam", tracking={"pretrained": path, "buffer": 8})
    ov["cam"].update(H_out=40, W_out=56)
    cfg = make_config(ov)
    slam = MNESLAM(cfg, SyntheticBoxDataset(cfg, num_frames=4),
                   device="cpu")
    got = dict(param_items(slam.tracker.params))
    for path_, v in jax.tree_util.tree_flatten_with_path(jp)[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", None))
                    for k in path_)
        np.testing.assert_array_equal(got[key].float().numpy(), v)


def test_loop_detector_matches_jax(tmp_path):
    """Two agents' keyframes in turns through both detectors: the same
    matches (kf id, agent id, similarity within 1e-6) and the same DB."""
    ov = tiny_overrides(tmp_path)
    ds = SyntheticBoxDataset(make_config(ov), num_frames=24)
    jdet = jld.LoopDetector(jmake_config(ov), jcomms.InMemoryComms(),
                            lambda img: jnv.stub_descriptor(img))
    pc = comms.InMemoryComms()
    det = LoopDetector(make_config(ov), pc,
                       netvlad.make_descriptor_fn(make_config(ov), "cpu"))
    found = 0
    for kf in range(12):
        for agent, frame in ((0, kf), (1, kf + 6)):
            img = ds[frame]["rgb"]
            want = jdet.detect_and_add(kf, agent, jnp.asarray(img))
            got = det.detect_and_add(kf, agent, torch.tensor(img))
            assert (want is None) == (got is None), (kf, agent, want, got)
            if want is not None:
                found += 1
                assert got["match_kf_id"] == want["match_kf_id"]
                assert got["match_agent_id"] == want["match_agent_id"]
                assert abs(got["similarity"] - want["similarity"]) < 1e-6
    assert found > 0
    jdb, pdb = jdet.comms.descriptors(), pc.descriptors()
    assert [(e["agent_id"], e["kf_id"]) for e in pdb] == \
        [(e["agent_id"], e["kf_id"]) for e in jdb]


def test_find_mutual_matches_matches_jax():
    rng = np.random.default_rng(0)
    base = rng.standard_normal((6, 16))
    local = [{"descriptor": base[i], "kf_id": i} for i in range(6)]
    foreign = [{"descriptor": base[i] + 0.3 * rng.standard_normal(16),
                "kf_id": 10 + i} for i in range(6)]
    foreign.append({"descriptor": base[2] + 0.01, "kf_id": 30})
    for thr in (0.5, 0.9, 0.99):
        assert find_mutual_matches(local, foreign, thr) == \
            jld.find_mutual_matches(local, foreign, thr)
    assert find_mutual_matches([], foreign, 0.5) == []


# ---------------------------------------------------------------------------
# fusion
# ---------------------------------------------------------------------------

def test_deform_trajectory_matches_jax():
    rng = np.random.default_rng(4)
    n = 9
    poses = np.stack([np.asarray(jrot.rot_trans_to_transform(
        0.5 * rng.normal(size=3), rng.normal(size=3)))
        for _ in range(n)]).astype(np.float32)
    rel = np.asarray(jrot.rot_trans_to_transform(
        np.asarray([0.3, -0.2, 0.4]), np.asarray([0.5, -1.0, 0.2])),
        np.float32)
    for loop_idx, sigma, mw in ((3, 1.0, 0.1), (0, 10.0, 0.0),
                                (8, 0.5, 1.0)):
        want = np.asarray(jfusion.deform_trajectory(
            poses, jnp.asarray(loop_idx), rel, decay_sigma=sigma,
            min_weight=mw))
        got = fusion.deform_trajectory(t32(poses), loop_idx, t32(rel),
                                       decay_sigma=sigma, min_weight=mw)
        np.testing.assert_allclose(got.numpy(), want, atol=POSE_ATOL)
    # the identity leaves the trajectory as it was
    same = fusion.deform_trajectory(t32(poses), 2, torch.eye(4))
    np.testing.assert_allclose(same.numpy(), poses, atol=1e-6)


def test_overlap_bound_and_keyframes_in_bound_match_jax():
    rng = np.random.default_rng(5)
    b1 = np.asarray([[-1.0, 2.0], [-1.0, 1.0], [0.0, 3.0]])
    b2 = np.asarray([[0.5, 4.0], [-2.0, 0.5], [1.0, 2.0]])
    far = b2 + 10.0
    np.testing.assert_array_equal(fusion.compute_overlap_bound(b1, b2),
                                  jfusion.compute_overlap_bound(b1, b2))
    assert fusion.compute_overlap_bound(b1, far) is None
    assert jfusion.compute_overlap_bound(b1, far) is None
    poses = np.tile(np.eye(4), (40, 1, 1))
    poses[:, :3, 3] = rng.uniform(-1.0, 2.5, size=(40, 3))
    ts = np.arange(40.0) * 3
    ov = fusion.compute_overlap_bound(b1, b2)
    got = fusion.keyframes_in_bound(poses, ts, ov)
    want = jfusion.keyframes_in_bound(poses, ts, ov)
    assert [k["kf_id"] for k in got] == [k["kf_id"] for k in want]
    assert len(got) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["pose"], b["pose"])


# ---------------------------------------------------------------------------
# the closure gate (tests/test_multiagent.py:98, :239-241, :264, :289)
# ---------------------------------------------------------------------------

BASE_POSE = np.eye(4, dtype=np.float32)
BASE_POSE[:3, 3] = [1.0, 0.5, 0.0]
CUR = np.eye(4, dtype=np.float32)
CUR[:3, 3] = [2.0, 0.0, 0.0]
GARBAGE = np.eye(4, dtype=np.float32)
GARBAGE[:3, 3] = [55.0, -30.0, 10.0]


def poses_of(n):
    p = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    p[:, 0, 3] = np.arange(n, dtype=np.float32)
    return p


class GatePair:
    """The stubbed two-agent closure scenario in both packages (agent 1's
    world biased by CUR; agent 0 published one keyframe at BASE_POSE), the
    render alignment replaced by a fake returning the given result."""

    def __init__(self, monkeypatch, lc_overrides):
        ov = tiny_overrides()
        ov["loop_closure"] = {"pose_decay_sigma": 1e6,
                              "pose_decay_min_weight": 1.0, **lc_overrides}
        H, W = ov["cam"]["H"], ov["cam"]["W"]
        dirs = np.random.default_rng(0).standard_normal((H, W, 3)).astype(
            np.float32)
        self.returns = {}
        self.collabs = []
        for cfg, mod, fus, desc in (
                (jmake_config(ov), jrunner, jfusion, jnv.stub_descriptor),
                (make_config(ov), runner, fusion, netvlad.stub_descriptor)):
            bound = np.asarray(cfg["mapping"]["bound"])
            slam = SimpleNamespace(
                config=cfg, rank=1, world_size=2, device=torch.device("cpu"),
                scene=SimpleNamespace(bounding_box=(
                    bound if mod is jrunner else torch.tensor(bound))),
                map_state=SimpleNamespace(params={}),
                dataset={0: {"direction": dirs}})
            cm = (jcomms if mod is jrunner else comms).InMemoryComms()
            collab = mod.AgentCollaboration(slam, cm, descriptor_fn=desc)
            monkeypatch.setattr(collab, "_load_foreign",
                                lambda rank: (object(), {}))
            cm.publish_keyframes(0, BASE_POSE[None], np.asarray([7.0]))
            monkeypatch.setattr(fus, "align_pose_by_render",
                                self._fake(fus is jfusion))
            self.collabs.append(collab)

    def _fake(self, is_jax):
        def fake(*a, **k):
            r = self.returns
            if is_jax:
                return (jnp.asarray(r["best_c2w"]), jnp.asarray(r["best"]),
                        jnp.asarray(r["init"]))
            return (torch.tensor(r["best_c2w"]), torch.tensor(r["best"]),
                    torch.tensor(r["init"]))
        return fake

    def drive(self, best_c2w, best, init, map_id, n):
        """One handle_loop_closure call on both; the port's state must equal
        JAX's -> the port's collaboration."""
        self.returns.update(best_c2w=best_c2w, best=best, init=init)
        info = {"match_agent_id": 0, "match_kf_id": 7}
        for c in self.collabs:
            c.handle_loop_closure(info, map_id, CUR, poses_of(n),
                                  np.arange(float(n)))
        jc, pc = self.collabs
        assert pc.closure_loss == pytest.approx(jc.closure_loss)
        assert (pc.aligned_poses_c2w is None) == (jc.aligned_poses_c2w
                                                  is None)
        if jc.aligned_poses_c2w is not None:
            np.testing.assert_allclose(pc.aligned_poses_c2w,
                                       np.asarray(jc.aligned_poses_c2w),
                                       atol=POSE_ATOL)
        return pc


def test_closure_acceptance_gate(monkeypatch):
    """Only converged alignments count and the lowest-loss one is kept; a
    badly converged late closure does not displace it; publish re-applies
    the stored transform to the growing trajectory. Same decisions and
    trajectories as the JAX collaboration."""
    pair = GatePair(monkeypatch, {"accept_loss": 0.05, "accept_ratio": 0.25})
    rel1 = BASE_POSE @ np.linalg.inv(CUR)
    pc = pair.drive(CUR, 0.01, 0.2, 3, 4)
    np.testing.assert_allclose(pc.aligned_poses_c2w, rel1 @ poses_of(4),
                               atol=1e-5)
    assert pc.closure_loss == pytest.approx(0.01)
    pc = pair.drive(GARBAGE, 0.4, 0.45, 5, 6)
    assert pc.closure_loss == pytest.approx(0.01)
    assert (pc.closures_accepted, pc.closures_rejected) == (1, 1)
    np.testing.assert_allclose(pc.aligned_poses_c2w, rel1 @ poses_of(6),
                               atol=1e-5)
    cur2 = np.eye(4, dtype=np.float32)
    cur2[:3, 3] = [2.0, 0.1, 0.0]
    pc = pair.drive(cur2, 0.001, 0.2, 6, 7)
    rel3 = BASE_POSE @ np.linalg.inv(cur2)
    np.testing.assert_allclose(pc.aligned_poses_c2w, rel3 @ poses_of(7),
                               atol=1e-5)
    # publish: the stored transform on the longer trajectory, both packages
    for c in pair.collabs:
        c.publish(poses_of(9), np.arange(9.0))
    got = [c.comms.get_keyframes(1)[0] for c in pair.collabs]
    assert len(got[1]) == 9
    np.testing.assert_allclose(got[1], rel3 @ poses_of(9), atol=1e-5)
    np.testing.assert_allclose(got[1], got[0], atol=POSE_ATOL)


@pytest.mark.parametrize("accept_loss", [0.025, 0.05, 0.1])
@pytest.mark.parametrize("accept_ratio", [0.125, 0.25, 0.5])
def test_closure_acceptance_gate_sweep(monkeypatch, accept_loss,
                                       accept_ratio):
    """At every threshold of a 2x band around the defaults the true
    converged closure is accepted and the spurious one rejected, in both
    packages alike."""
    pair = GatePair(monkeypatch, {"accept_loss": accept_loss,
                                  "accept_ratio": accept_ratio})
    pc = pair.drive(CUR, 0.01, 0.2, 3, 4)
    assert pc.closure_loss == pytest.approx(0.01)
    pc = pair.drive(GARBAGE, 0.4, 0.45, 5, 6)
    assert pc.closure_loss == pytest.approx(0.01)
    rel = BASE_POSE @ np.linalg.inv(CUR)
    assert np.abs(pc.aligned_poses_c2w - rel @ poses_of(6)).max() < 1e-5


def test_closure_reference_mode_applies_every(monkeypatch):
    """loop_closure.mode "reference": each closure replaces the stored
    transform unconditionally, the spurious one included."""
    pair = GatePair(monkeypatch, {"mode": "reference"})
    pc = pair.drive(CUR, 0.01, 0.2, 3, 4)
    np.testing.assert_allclose(
        pc.aligned_poses_c2w, BASE_POSE @ np.linalg.inv(CUR) @ poses_of(4),
        atol=1e-5)
    pc = pair.drive(GARBAGE, 0.4, 0.45, 5, 6)
    assert pc.closure_loss == pytest.approx(0.4)
    np.testing.assert_allclose(
        pc.aligned_poses_c2w,
        BASE_POSE @ np.linalg.inv(GARBAGE) @ poses_of(6), atol=1e-4)


def test_closure_map_aligned_pushes_trajectory(monkeypatch):
    """loop_closure.map_aligned pushes the deformed trajectory into the
    agent's own map through set_aligned_kf_poses, in both packages; the
    default never does."""
    pair = GatePair(monkeypatch, {"map_aligned": True})
    pushed = [[], []]
    for c, out in zip(pair.collabs, pushed):
        c.slam.set_aligned_kf_poses = (
            lambda ts, poses, out=out: out.append((np.asarray(ts),
                                                   np.asarray(poses))))
    pair.drive(CUR, 0.01, 0.2, 3, 4)
    assert len(pushed[0]) == len(pushed[1]) == 1
    ts, poses = pushed[1][0]
    np.testing.assert_allclose(ts, np.arange(4.0))
    np.testing.assert_allclose(
        poses, BASE_POSE @ np.linalg.inv(CUR) @ poses_of(4), atol=1e-5)
    np.testing.assert_allclose(poses, pushed[0][0][1], atol=POSE_ATOL)

    pair2 = GatePair(monkeypatch, {})
    for c in pair2.collabs:
        c.slam.set_aligned_kf_poses = (
            lambda *a: pytest.fail("map_aligned=False must not feed the "
                                   "map"))
    pair2.drive(CUR, 0.01, 0.2, 3, 4)


def test_load_agent_bounds_matches_jax():
    ov = tiny_overrides()
    ov["loop_bound"] = {"bound_1": [[0.0, 1.0]] * 3}
    for ws in (1, 2, 3):
        want = jrunner.load_agent_bounds(jmake_config(ov), ws)
        got = runner.load_agent_bounds(make_config(ov), ws)
        assert sorted(got) == sorted(want)
        for r in want:
            np.testing.assert_array_equal(got[r], want[r])
