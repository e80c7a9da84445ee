"""Port of meshing (`mneslam_tpu_torch.ops.mc`, `.mapping.mesher`,
`.mapping.cull`) against the JAX package, on the CPU at a tiny size: the
SDF grid, marching tetrahedra (native and numpy), the observed-space bound,
culling, vertex colours, and the meshes `terminate` writes."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mneslam_tpu.config import make_config as jmake_config
from mneslam_tpu.mapping import cull as jcull
from mneslam_tpu.mapping import mesher as jmesher
from mneslam_tpu.models.scene_rep import SceneRep as JSceneRep
from mneslam_tpu.ops import mc as jmc
from mneslam_tpu_torch.config import make_config
from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
from mneslam_tpu_torch.mapping import cull, mesher
from mneslam_tpu_torch.models.scene_rep import SceneRep
from mneslam_tpu_torch.ops import mc
from mneslam_tpu_torch.slam import MNESLAM
from mneslam_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
NATIVE = [pytest.param(True, id="native"), pytest.param(False, id="numpy")]

# the JAX package's meshing test config (tests/test_mesher.py:117)
OVERRIDES = {
    "mapping": {"bound": [[-2.0, 2.0]] * 3,
                "marching_cubes_bound": [[-2.0, 2.0]] * 3},
    "planes_res": {"coarse": 0.8, "fine": 0.4, "bound_dividable": 0.4},
    "cam": {"H": 32, "W": 40, "fx": 30.0, "fy": 30.0, "cx": 19.5,
            "cy": 15.5, "near": 0.0, "far": 8.0},
    "training": {"trunc": 0.3},
    "model": {"c_dim": 8, "input_ch": 16, "input_ch_pos": 48,
              "truncation": 0.3},
    "meshing": {"resolution": 0.25},
}


def sphere_sdf(n=48, r=0.6):
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.sqrt(gx**2 + gy**2 + gz**2) - r, ax


def _lexsort_rows(a):
    return a[np.lexsort(a.T[::-1])]


@pytest.fixture(scope="module")
def scenes():
    """The same random map in both packages: (JAX scene, params, config),
    (port scene, params, config)."""
    jcfg = jmake_config(OVERRIDES)
    jscene = JSceneRep(jcfg)
    jparams = jscene.init_params(jax.random.PRNGKey(0))
    cfg = make_config(OVERRIDES)
    scene = SceneRep(cfg, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    return (jscene, jparams, jcfg), (scene, params, cfg)


@pytest.fixture
def jax_numpy_mc(monkeypatch):
    """The JAX package's numpy polygoniser (its C++ one is built by make)."""
    monkeypatch.setenv("MNESLAM_NO_NATIVE", "1")


def _observed(H=32, W=40):
    kf_poses = np.eye(4, dtype=np.float32)[None]
    depths = np.full((1, H, W), 1.5, np.float32)
    intr = np.asarray([30.0, 30.0, 19.5, 15.5], np.float32)
    return kf_poses, intr, H, W, depths, 3.0 * 0.3


# ---------------------------------------------------------------------------
# marching tetrahedra (mirrors tests/test_mesher.py:15-93)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("native", NATIVE)
def test_sphere_surface_accuracy(native):
    vol, ax = sphere_sdf()
    spacing = np.full(3, ax[1] - ax[0], np.float32)
    origin = np.full(3, ax[0], np.float32)
    verts, faces = mc.marching_cubes(vol, 0.0, origin=origin,
                                     spacing=spacing, native=native)
    assert len(verts) > 500 and len(faces) > 500
    radii = np.linalg.norm(verts, axis=1)
    assert np.max(np.abs(radii - 0.6)) < 0.5 * spacing[0]
    assert faces.min() >= 0 and faces.max() < len(verts)
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1).sum()
    expected = 4 * np.pi * 0.6**2
    assert abs(area - expected) / expected < 0.05, (area, expected)


@pytest.mark.parametrize("native", NATIVE)
def test_truncation_and_nan_skip_cubes(native):
    vol, ax = sphere_sdf()
    verts, _ = mc.marching_cubes(vol, 0.0, truncation=0.2, native=native)
    assert len(verts) > 0
    radii = np.linalg.norm(verts * (ax[1] - ax[0]) + ax[0], axis=1)
    assert np.max(np.abs(radii - 0.6)) < 0.05
    vol2 = vol.copy()
    vol2[:10] = np.nan
    verts2, _ = mc.marching_cubes(vol2, 0.0, native=native)
    assert len(verts2) > 0 and verts2[:, 0].min() >= 9.0


@pytest.mark.parametrize("native", NATIVE)
def test_isovalue_offset_and_empty_volume(native):
    vol, ax = sphere_sdf()
    spacing = np.full(3, ax[1] - ax[0], np.float32)
    origin = np.full(3, ax[0], np.float32)
    verts, _ = mc.marching_cubes(vol, 0.1, origin=origin, spacing=spacing,
                                 native=native)
    assert abs(np.mean(np.linalg.norm(verts, axis=1)) - 0.7) < 0.02
    verts, faces = mc.marching_cubes(np.ones((8, 8, 8), np.float32), 0.0,
                                     native=native)
    assert verts.shape == (0, 3) and faces.shape == (0, 3)


def test_ply_roundtrip_and_jax_reads_it(tmp_path):
    vol, _ = sphere_sdf(n=24)
    verts, faces = mc.marching_cubes(vol, 0.0)
    colors = np.random.default_rng(0).uniform(
        size=(len(verts), 3)).astype(np.float32)
    p = str(tmp_path / "m.ply")
    mc.save_ply(p, verts, faces, colors)
    for load in (mc.load_ply, jmc.load_ply):
        v2, f2, c2 = load(p)
        np.testing.assert_array_equal(v2, verts)
        np.testing.assert_array_equal(f2, faces)
        assert np.max(np.abs(c2 - colors)) < 1 / 255 + 1e-3
    mc.save_ply(p, verts, faces)
    v3, f3, c3 = mc.load_ply(p)
    np.testing.assert_array_equal(v3, verts)
    np.testing.assert_array_equal(f3, faces)
    assert c3 is None


def _volumes():
    rng = np.random.default_rng(0)
    vol, _ = sphere_sdf(n=32)
    noisy = (vol + 0.05 * rng.normal(size=vol.shape)).astype(np.float32)
    poisoned = noisy.copy()
    poisoned[3:6, :, 10:12] = np.nan
    return {"sphere": (vol, 0.0, None), "noisy": (noisy, 0.0, 3.0),
            "offset": (noisy, 0.1, 0.2), "nan": (poisoned, 0.0, None)}


@pytest.mark.parametrize("name", ["sphere", "noisy", "offset", "nan"])
def test_marching_cubes_matches_jax_and_native_matches_numpy(name,
                                                             jax_numpy_mc):
    """The numpy path gives the JAX package's vertices and faces exactly.
    The native polygoniser emits the same raw triangle vertices bit for
    bit, in cube order; after the weld its faces are the same (in its own
    triangle order) and each vertex is the same up to the weld's rounding
    quantum of 1e-5 (a welded vertex is the first raw vertex of its key,
    and the same cube edge interpolated from either end can differ by an
    ulp)."""
    vol, iso, trunc = _volumes()[name]
    v_py, f_py = mc.marching_cubes(vol, iso, truncation=trunc, native=False)
    v_j, f_j = jmc.marching_cubes(vol, iso, truncation=trunc)
    np.testing.assert_array_equal(v_py, v_j)
    np.testing.assert_array_equal(f_py, f_j)
    raw_nat = mc.polygonize(vol, iso, trunc)
    raw_py = mc.polygonize(vol, iso, trunc, native=False)
    np.testing.assert_array_equal(_lexsort_rows(raw_nat),
                                  _lexsort_rows(raw_py))
    v_nat, f_nat = mc.marching_cubes(vol, iso, truncation=trunc)
    assert len(v_py) > 100
    np.testing.assert_allclose(v_nat, v_py, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(_lexsort_rows(f_nat), _lexsort_rows(f_py))


@pytest.mark.parametrize("name", ["sphere", "noisy", "offset", "nan"])
def test_native_weld_equals_numpy_weld(name):
    """On the same raw vertices (either polygoniser's) the C++ weld gives
    the numpy weld's vertices and faces bit for bit."""
    vol, iso, trunc = _volumes()[name]
    for raw in (mc.polygonize(vol, iso, trunc),
                mc.polygonize(vol, iso, trunc, native=False)):
        got, ref = mc.weld(raw), mc._weld(raw)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
    empty = mc.weld(np.zeros((0, 3), np.float32))
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)


def test_native_build_failure_raises(monkeypatch):
    """native=True never falls back to the numpy path."""
    from mneslam_tpu_torch.kernels import build

    def fail(name):
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(build, "load_host", fail)
    vol, _ = sphere_sdf(n=8)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        mc.marching_cubes(vol, 0.0)
    assert len(mc.marching_cubes(vol, 0.0, native=False)[0]) > 0


# ---------------------------------------------------------------------------
# culling (mirrors tests/test_mesher.py:95)
# ---------------------------------------------------------------------------

def test_frustum_and_occlusion_culling():
    verts = np.asarray([
        [0, 0, -2], [0.2, 0, -2], [0, 0.2, -2],    # visible triangle
        [0, 0, 3], [0.2, 0, 3], [0, 0.2, 3],       # behind the camera
    ], np.float32)
    faces = np.asarray([[0, 1, 2], [3, 4, 5]])
    c2w = np.eye(4, dtype=np.float32)[None]
    intr = np.asarray([50.0, 50.0, 31.5, 23.5], np.float32)
    v, f, _ = cull.cull_mesh(verts, faces, c2w, intr, H=48, W=64,
                             device="cpu")
    assert len(v) == 3 and len(f) == 1
    depths = np.ones((1, 48, 64), np.float32)
    _, f2, _ = cull.cull_mesh(verts, faces, c2w, intr, H=48, W=64,
                              depths=depths, device="cpu")
    assert len(f2) == 0


@pytest.mark.parametrize("with_depth", [True, False])
def test_visible_counts_match_jax(with_depth):
    """Counts over 3 keyframes for points spread around them, chunked
    (3000 points in chunks of 1024) against the JAX counts."""
    rng = np.random.default_rng(1)
    H, W = 24, 32
    verts = rng.uniform(-2.5, 2.5, (3000, 3)).astype(np.float32)
    c2w = np.stack([np.eye(4, dtype=np.float32)] * 3)
    for k, yaw in enumerate((0.0, 1.2, 2.5)):
        c, s = np.cos(yaw), np.sin(yaw)
        c2w[k, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        c2w[k, :3, 3] = rng.normal(0, 0.2, 3)
    intr = np.asarray([20.0, 21.0, 15.5, 11.5], np.float32)
    depths = rng.uniform(0.5, 3.0, (3, H, W)).astype(np.float32)
    depths[:, :4] = 0.0                          # pixels without depth
    d = depths if with_depth else None
    got = cull.visible_counts(
        torch.tensor(verts), torch.tensor(c2w), torch.tensor(intr),
        None if d is None else torch.tensor(d), H, W, eps=0.1, chunk=1024)
    ref = jcull._visible_counts(
        jnp.asarray(verts), jnp.asarray(c2w), jnp.asarray(intr),
        None if d is None else jnp.asarray(d), H, W, eps=0.1, chunk=1024)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < (got.numpy() > 0).sum() < len(verts)
    faces = rng.integers(0, len(verts), (2000, 3))
    out = cull.cull_mesh(verts, faces, c2w, intr, H, W, depths=d,
                         device="cpu")
    ref = jcull.cull_mesh(verts, faces, c2w, intr, H, W, depths=d)
    for a, b in zip(out[:2], ref[:2]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the SDF grid and extract_mesh (mirrors tests/test_mesher.py:117, :169)
# ---------------------------------------------------------------------------

def test_sdf_grid_matches_jax(scenes):
    """The 17^3 grid in chunks of 1000 (the last padded) against the JAX
    grid in its chunks of 65536."""
    (jscene, jparams, jcfg), (scene, params, cfg) = scenes
    bound = np.asarray(cfg["mapping"]["marching_cubes_bound"], np.float32)
    vol, origin, spacing = mesher.sdf_grid(scene, params, bound, 0.25,
                                           chunk=1000)
    jvol, jorigin, jspacing = jmesher.sdf_grid(jscene, jparams, bound, 0.25)
    assert vol.shape == (17, 17, 17) and vol.dtype == np.float32
    np.testing.assert_allclose(vol, jvol, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(origin, jorigin)
    np.testing.assert_array_equal(spacing, jspacing)


@pytest.fixture
def jax_volume(scenes, monkeypatch):
    """extract_mesh's grid is the port's own, held to the JAX grid at the
    fp32 bounds and then replaced by it: an SDF value a few ulp off can
    move a vertex across the weld's rounding quantum and reorder the
    vertex list, so the steps after the grid are compared on one volume."""
    (jscene, jparams, _), _ = scenes
    real = mesher.sdf_volume

    def grid(scene, params, bound, voxel_size, chunk=65536):
        vol, origin, spacing = real(scene, params, bound, voxel_size, chunk)
        jvol, jorigin, jspacing = jmesher.sdf_grid(jscene, jparams, bound,
                                                   voxel_size)
        np.testing.assert_allclose(vol.numpy(), jvol, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(origin, jorigin)
        np.testing.assert_array_equal(spacing, jspacing)
        return torch.as_tensor(np.asarray(jvol)), origin, spacing

    monkeypatch.setattr(mesher, "sdf_volume", grid)


def test_extract_mesh_observed_bound_matches_jax(scenes, jax_numpy_mc,
                                                 jax_volume):
    """With `observed`, the mesh keeps only what the keyframe saw; the
    port's vertices and faces equal the JAX package's, its colours within
    the fp32 bounds."""
    (jscene, jparams, jcfg), (scene, params, cfg) = scenes
    observed = _observed()
    raw = mesher.extract_mesh(scene, params, cfg, color=False)
    got = mesher.extract_mesh(scene, params, cfg, observed=observed,
                              native=False)
    ref = jmesher.extract_mesh(jscene, jparams, jcfg, observed=observed)
    assert len(raw[0]) > len(got[0]) > 0
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=RTOL, atol=ATOL)
    # every kept vertex is seen, within one voxel diagonal of the band
    kf_poses, intr, H, W, depths, eps = observed
    counts = cull.visible_counts(
        torch.tensor(got[0]), torch.tensor(kf_poses), torch.tensor(intr),
        torch.tensor(depths), H, W, eps=eps + 0.25 * np.sqrt(3.0))
    assert (counts > 0).all()
    # the native polygoniser's mesh is the same mesh
    nat = mesher.extract_mesh(scene, params, cfg, observed=observed)
    np.testing.assert_allclose(nat[0], got[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(_lexsort_rows(nat[1]),
                                  _lexsort_rows(got[1]))


def test_render_color_path_matches_jax(scenes, jax_numpy_mc, jax_volume):
    """`mesh.render_color`: the colours composited along the vertex
    normals against the JAX package's; geometry as with point queries."""
    (jscene, jparams, jcfg), (scene, params, cfg) = scenes
    verts_q, faces_q, col_q = mesher.extract_mesh(scene, params, cfg,
                                                  native=False)
    cfg_r = dict(cfg, mesh=dict(cfg["mesh"], render_color=True))
    jcfg_r = dict(jcfg, mesh=dict(jcfg["mesh"], render_color=True))
    verts_r, faces_r, col_r = mesher.extract_mesh(scene, params, cfg_r,
                                                  native=False)
    jverts, _, jcol = jmesher.extract_mesh(jscene, jparams, jcfg_r)
    np.testing.assert_array_equal(verts_r, verts_q)
    np.testing.assert_array_equal(verts_r, jverts)
    np.testing.assert_allclose(col_r, jcol, rtol=RTOL, atol=ATOL)
    assert ((col_r >= 0) & (col_r <= 1)).all()
    assert not np.allclose(col_r, col_q)
    assert np.abs(col_r - col_q).mean() < 0.2
    n = mesher.vertex_normals(verts_q, faces_q)
    np.testing.assert_allclose(n, jmesher.vertex_normals(verts_q, faces_q),
                               rtol=1e-6, atol=1e-7)


def test_query_tables_give_the_packed_sampler_bit_for_bit(scenes):
    """Chunked queries sample tables packed once; the result equals the
    training path's per-call packing bit for bit."""
    _, (scene, params, _) = scenes
    pts = torch.tensor(np.random.default_rng(2).uniform(
        -2.2, 2.2, (500, 3)).astype(np.float32))
    with torch.no_grad():
        ref = scene.query_color_sdf(params, pts)
    got = torch.cat([scene.query_sdf(params, pts, scene.query_tables(params))
                     [:, None]], 1)
    np.testing.assert_array_equal(got[:, 0].numpy(), ref[:, 3].numpy())
    rgb = scene.query_color(params, pts.reshape(20, 25, 3))
    assert rgb.shape == (20, 25, 3)
    np.testing.assert_array_equal(rgb.reshape(-1, 3).numpy(),
                                  torch.sigmoid(ref[:, :3]).numpy())


# ---------------------------------------------------------------------------
# terminate writes both meshes, in both modes
# ---------------------------------------------------------------------------

def _mapping_overrides(tmp_path):
    return {
        "mode": "mapping",
        "data": {"output": str(tmp_path), "exp_name": "mesh"},
        "mapping": {"bound": [[-2.2, 2.2]] * 3,
                    "marching_cubes_bound": [[-2.2, 2.2]] * 3,
                    "sample": 256, "min_pixels_cur": 64, "first_iters": 40,
                    "iters": 5, "keyframe_every": 3,
                    "mapping_save_stride": 2},
        "planes_res": {"coarse": 0.44, "fine": 0.22,
                       "bound_dividable": 0.22},
        "cam": {"H": 40, "W": 56, "fx": 35.0, "fy": 35.0, "cx": 27.5,
                "cy": 19.5, "near": 0.0, "far": 8.0},
        "training": {"n_range_d": 9, "n_samples_d": 8, "range_d": 0.25,
                     "trunc": 0.15},
        "model": {"c_dim": 16, "input_ch": 32, "input_ch_pos": 48,
                  "truncation": 0.15},
        "meshing": {"resolution": 0.2},
        "mesh": {"voxel_eval": 0.4},
    }


def _check_meshes(slam, res):
    mesh_dir = os.path.join(slam.out_dir, "mesh")
    v, f, c = mc.load_ply(os.path.join(mesh_dir, "final_mesh.ply"))
    vc, fc, _ = mc.load_ply(os.path.join(mesh_dir, "final_mesh_culled.ply"))
    assert res["mesh_verts"] == len(v) > 0 and len(f) > 0
    assert 0 < res["mesh_verts_culled"] == len(vc) <= len(v)
    assert c.shape == (len(v), 3) and np.isfinite(v).all()
    assert fc.max() < len(vc)
    stages = slam.timers.summary()
    assert {"mesh", "mesh/observed_depths", "mesh/sdf_grid", "mesh/to_host",
            "mesh/polygonize", "mesh/weld", "mesh/observed_filter",
            "mesh/vertex_color", "mesh/cull"} <= set(stages)


def test_terminate_writes_meshes_in_mapping_mode(tmp_path):
    cfg = make_config(_mapping_overrides(tmp_path))
    slam = MNESLAM(cfg, SyntheticBoxDataset(cfg, num_frames=7), device="cpu")
    slam.run_mapping_only()
    res = slam.terminate()
    _check_meshes(slam, res)
    # the snapshot after the second mapped keyframe (frame 3)
    assert os.listdir(os.path.join(slam.out_dir, "mesh")).count(
        "mesh_track_3.ply") == 1


def test_terminate_writes_meshes_in_slam_mode(tmp_path):
    from test_torch_slam import _oracle, _slam_overrides

    ov = _slam_overrides(tmp_path)
    ov["mapping"]["marching_cubes_bound"] = [[-2.2, 2.2]] * 3
    ov["meshing"] = {"resolution": 0.2}
    cfg = make_config(ov)
    ds = SyntheticBoxDataset(cfg, num_frames=7)
    update_fn, agg_fn = _oracle(ds, torch.tensor([7.5, 7.5, 47.5 / 8,
                                                  31.5 / 8]))
    slam = MNESLAM(cfg, ds, device="cpu", update_fn=update_fn,
                   agg_fn=agg_fn)
    res = slam.run_slam()
    _check_meshes(slam, res)
    assert res["tracked_keyframes"] == 7


def test_meshing_failure_does_not_end_terminate(tmp_path, monkeypatch,
                                                capsys):
    from mneslam_tpu_torch import slam as slam_mod

    cfg = make_config(_mapping_overrides(tmp_path))
    cfg["mapping"].update(first_iters=2, iters=1, mapping_save_stride=0)
    slam = MNESLAM(cfg, SyntheticBoxDataset(cfg, num_frames=4), device="cpu")
    slam.run_mapping_only()

    def fail(*a, **k):
        raise RuntimeError("no polygoniser")

    monkeypatch.setattr(slam_mod, "extract_mesh", fail)
    res = slam.terminate()
    assert "mesh_verts" not in res and os.path.exists(res["checkpoint"])
    assert "meshing failed: no polygoniser" in capsys.readouterr().out
