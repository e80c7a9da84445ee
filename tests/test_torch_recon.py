"""Port of the evaluation side of the run's end (`mneslam_tpu_torch.eval.
recon`, `.utils.vis`, `.tools.eval_recon`, `SceneRep.render_image_rays`)
against the JAX package, on the CPU at a tiny size."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mneslam_tpu.config import make_config as jmake_config
from mneslam_tpu.eval import recon as jrecon
from mneslam_tpu.models.scene_rep import SceneRep as JSceneRep
from mneslam_tpu.ops import mc as jmc
from mneslam_tpu_torch.config import make_config
from mneslam_tpu_torch.data.rays import get_camera_rays, rays_from_pose
from mneslam_tpu_torch.eval import recon
from mneslam_tpu_torch.mapping.cull import cull_mesh
from mneslam_tpu_torch.models.scene_rep import SceneRep
from mneslam_tpu_torch.ops import mc
from mneslam_tpu_torch.tools import eval_recon
from mneslam_tpu_torch.utils import vis
from mneslam_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
# metrics: the same numpy arithmetic on the same inputs in both packages
METRIC_TOL = 1e-6


def sphere_mesh(r, n=40):
    ax = np.linspace(-1.2, 1.2, n, dtype=np.float32)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    vol = np.sqrt(gx**2 + gy**2 + gz**2) - r
    sp = np.full(3, ax[1] - ax[0], np.float32)
    org = np.full(3, ax[0], np.float32)
    return mc.marching_cubes(vol, 0.0, origin=org, spacing=sp)


def two_spheres():
    v1, f1 = sphere_mesh(0.6)
    v2, f2 = sphere_mesh(0.35)
    v2 = v2 + np.asarray([0.9, 0.0, 0.0], np.float32)
    return np.concatenate([v1, v2]), np.concatenate([f1, f2 + len(v1)])


def _close(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert abs(a[k] - b[k]) <= METRIC_TOL * max(1.0, abs(b[k])), (k, a, b)


def test_recon_metrics_identical_and_offset_match_jax():
    """Mirrors tests/test_eval.py:66, and each number against JAX's."""
    v, f = sphere_mesh(0.6)
    m_same = recon.eval_mesh(v, f, v, f, n_samples=20000)
    _close(m_same, jrecon.eval_mesh(v, f, v, f, n_samples=20000))
    assert m_same["accuracy_cm"] < 1.0
    assert m_same["completion_ratio_pct"] > 99.0
    v2, f2 = sphere_mesh(0.7)
    m_off = recon.eval_mesh(v2, f2, v, f, n_samples=20000)
    _close(m_off, jrecon.eval_mesh(v2, f2, v, f, n_samples=20000))
    assert 8.0 < m_off["accuracy_cm"] < 12.0
    assert m_off["completion_ratio_pct"] < 50.0


def test_icp_alignment_recovers_rigid_offset_and_matches_jax():
    """Mirrors tests/test_eval.py:79: the estimated transform equals JAX's
    and inverts the misalignment."""
    v, f = two_spheres()
    ang = 0.06
    R = np.asarray([[np.cos(ang), -np.sin(ang), 0],
                    [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    t = np.asarray([0.05, -0.04, 0.03], np.float32)
    v_mis = v @ R.T + t
    m_mis = recon.eval_mesh(v_mis, f, v, f, n_samples=20000)
    m_ali = recon.eval_mesh(v_mis, f, v, f, n_samples=20000, align=True)
    _close(m_ali, jrecon.eval_mesh(v_mis, f, v, f, n_samples=20000,
                                   align=True))
    assert m_mis["accuracy_cm"] > 3.0
    assert m_ali["accuracy_cm"] < 0.5 * m_mis["accuracy_cm"]
    assert m_ali["completion_ratio_pct"] > 95.0
    T = recon.icp_align(v_mis, v)
    np.testing.assert_allclose(T, jrecon.icp_align(v_mis, v), rtol=0,
                               atol=METRIC_TOL)
    got = v_mis @ T[:3, :3].T + T[:3, 3]
    assert np.abs(got - v).max() < 0.02


def test_depth_l1_and_surface_sampling_match_jax():
    """Mirrors tests/test_eval.py:108."""
    gt = np.ones((10, 10))
    rend = np.ones((10, 10)) * 1.03
    assert abs(recon.depth_l1(rend, gt) - 3.0) < 1e-6
    gt2 = gt.copy()
    gt2[0] = 0
    assert abs(recon.depth_l1(rend, gt2) - 3.0) < 1e-6
    assert np.isnan(recon.depth_l1(rend, np.zeros((10, 10))))
    v, f = sphere_mesh(0.6, n=24)
    np.testing.assert_array_equal(
        recon.sample_surface(v, f, 500, np.random.default_rng(3)),
        jrecon.sample_surface(v, f, 500, np.random.default_rng(3)))


def test_eval_recon_tool(tmp_path, capsys):
    """The entry point reads two PLYs, optionally culls, prints the
    metrics; the same numbers as `eval_mesh`."""
    v, f = two_spheres()
    rec, gt = str(tmp_path / "rec.ply"), str(tmp_path / "gt.ply")
    mc.save_ply(rec, v + 0.01, f)
    mc.save_ply(gt, v, f)
    m = eval_recon.main(["--rec", rec, "--gt", gt, "--n", "5000"])
    _close(m, recon.eval_mesh(v + 0.01, f, v, f, n_samples=5000))
    out = capsys.readouterr().out
    assert "accuracy_cm:" in out and "completion_ratio_pct:" in out
    poses = str(tmp_path / "poses.npy")
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [2.0, 0.0, 3.0]       # sees x in [0, 4] at the spheres
    np.save(poses, c2w[None])
    m2 = eval_recon.main(["--rec", rec, "--gt", gt, "--n", "5000",
                          "--cull", poses, "--intr", "30,30,19.5,15.5",
                          "--hw", "32,40", "--device", "cpu"])
    assert "culled mesh:" in capsys.readouterr().out
    assert m2["completion_cm"] > m["completion_cm"]


def test_eval_recon_culls_on_cuda_by_default(tmp_path):
    """`--cull` counts on the GPU unless `--device cpu` is given: without a
    GPU the default raises instead of moving the work to the host."""
    v, f = two_spheres()
    rec = str(tmp_path / "rec.ply")
    mc.save_ply(rec, v, f)
    poses = str(tmp_path / "poses.npy")
    np.save(poses, np.eye(4, dtype=np.float32)[None])
    argv = ["--rec", rec, "--gt", rec, "--n", "2000", "--cull", poses,
            "--intr", "30,30,19.5,15.5", "--hw", "32,40"]
    if torch.cuda.is_available():
        assert eval_recon.main(argv)["accuracy_cm"] >= 0.0
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            eval_recon.main(argv)
    with pytest.raises(TypeError, match="device"):
        cull_mesh(v, f, np.eye(4, dtype=np.float32)[None],
                  np.asarray([30.0, 30.0, 19.5, 15.5]), 32, 40)


def test_render_panel_and_trajectory_plot(tmp_path):
    rng = np.random.default_rng(0)
    H, W = 24, 32
    depth = rng.uniform(0.5, 2.0, (H, W)).astype(np.float32)
    rgb = rng.uniform(size=(H, W, 3)).astype(np.float32)
    path = str(tmp_path / "eval_vis" / "kf_00000.jpg")
    vis.save_render_panel(path, rgb, depth, rgb * 0.9, depth + 0.1,
                          title="keyframe 0")
    assert os.path.getsize(path) > 1000
    xyz = np.cumsum(rng.normal(size=(20, 3)), 0)
    path = str(tmp_path / "plots" / "traj.jpg")
    vis.save_trajectory_plot(path, xyz, xyz + 0.1)
    assert os.path.getsize(path) > 1000


# ---------------------------------------------------------------------------
# render_image_rays (scene_rep.py:660-692 of the JAX package)
# ---------------------------------------------------------------------------

OVERRIDES = {
    "mapping": {"bound": [[-2.0, 2.0]] * 3},
    "planes_res": {"coarse": 0.8, "fine": 0.4, "bound_dividable": 0.4},
    "cam": {"H": 20, "W": 28, "fx": 20.0, "fy": 20.0, "cx": 13.5,
            "cy": 9.5, "near": 0.0, "far": 4.0},
    "training": {"trunc": 0.3, "n_samples": 24, "n_samples_d": 8,
                 "n_range_d": 9, "range_d": 0.25},
    "model": {"c_dim": 8, "input_ch": 16, "input_ch_pos": 48,
              "truncation": 0.3},
}


@pytest.mark.parametrize("with_depth", [True, False])
def test_render_image_rays_matches_jax(with_depth):
    """A 20 x 28 frame (560 rays, chunks of 256: the last one padded),
    with depth-guided samples or n_samples uniform ones."""
    jcfg = jmake_config(OVERRIDES)
    jscene = JSceneRep(jcfg)
    jparams = jscene.init_params(jax.random.PRNGKey(3))
    scene = SceneRep(make_config(OVERRIDES), "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(0)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.1, -0.2, 0.3]
    dirs = get_camera_rays(20, 28, 20.0, 20.0, 13.5, 9.5).reshape(-1, 3)
    rays_o, rays_d = rays_from_pose(dirs, torch.tensor(c2w))
    depth = rng.uniform(0.5, 3.0, 560).astype(np.float32)
    depth[:40] = 0.0                     # rays without depth
    td = torch.tensor(depth) if with_depth else None
    got_d, got_rgb = scene.render_image_rays(params, rays_o, rays_d, td,
                                             chunk=256)
    ref_d, ref_rgb = jscene.render_image_rays(
        jparams, jnp.asarray(rays_o.numpy()), jnp.asarray(rays_d.numpy()),
        jnp.asarray(depth) if with_depth else None, chunk=256)
    assert got_d.shape == (560,) and got_rgb.shape == (560, 3)
    assert not got_d.requires_grad
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_rgb.numpy(), np.asarray(ref_rgb),
                               rtol=RTOL, atol=ATOL)


def test_render_frame_and_panels_in_a_run(tmp_path):
    """`mapping.vis`: the run writes a panel for keyframes 0, 2, ... of
    the mapped ones; `render_frame` renders the whole frame."""
    from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
    from mneslam_tpu_torch.slam import MNESLAM

    cfg = make_config({
        "mode": "mapping",
        "data": {"output": str(tmp_path), "exp_name": "vis"},
        "mapping": {"bound": [[-2.2, 2.2]] * 3, "sample": 128,
                    "min_pixels_cur": 32, "first_iters": 5, "iters": 2,
                    "keyframe_every": 2, "vis": 2},
        "planes_res": {"coarse": 0.44, "fine": 0.22,
                       "bound_dividable": 0.22},
        "cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
                "cy": 11.5, "near": 0.0, "far": 8.0},
        "model": {"c_dim": 8, "input_ch": 16, "input_ch_pos": 48},
    })
    slam = MNESLAM(cfg, SyntheticBoxDataset(cfg, num_frames=5),
                   device="cpu")
    slam.run_mapping_only()
    assert sorted(os.listdir(os.path.join(slam.out_dir, "eval_vis"))) == [
        "kf_00000.jpg", "kf_00004.jpg"]
    frame, pose = slam._frame_for_mapping(4)
    depth, rgb = slam.render_frame(frame, pose)
    assert depth.shape == (24, 32) and rgb.shape == (24, 32, 3)
    assert torch.isfinite(depth).all() and torch.isfinite(rgb).all()
    assert np.isfinite(recon.depth_l1(depth.numpy(), frame["depth"].numpy()))


def test_jax_reads_the_port_meshes(tmp_path):
    v, f = sphere_mesh(0.5, n=20)
    path = str(tmp_path / "m.ply")
    mc.save_ply(path, v, f)
    jv, jf, _ = jmc.load_ply(path)
    np.testing.assert_array_equal(jv, v)
    np.testing.assert_array_equal(jf, f)
