"""Port parity: the scene representation's options that the Replica
configs leave off, against the JAX package on numpy inputs from a seed.

- colour planes (`grid.oneGrid: false`): shapes, the raw query, and the
  gradient of one mapper loss for each plane sampler (`packed`, `merged`,
  `rows`, set through monkeypatch of both packages' `_PLANE_SAMPLER`);
- the samplers: `interp.upsample_exact`, merged against per-level;
- hierarchical importance resampling (`training.n_importance`):
  `sample_pdf`, `render_rays` and `forward` with the first pass's maps and
  losses;
- the mapper with these options (the smoothness term, the row-sharded
  mapper, carrying the colour planes across) is in
  tests/test_torch_scene_options_mapper.py.

The JAX draws are replayed into the port through the `u` seam (a dict of
parts, `models.scene_rep.uniforms`). Tolerances: rtol 1e-4 / atol 1e-5
(fp32) unless stated; gradients per leaf within 1e-4 of the leaf's largest
element (test_torch_parallel_grads' measure).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mneslam_tpu.config import make_config as jmake_config
from mneslam_tpu.mapping.mapper import Mapper as JMapper
from mneslam_tpu.models import scene_rep as jsr
from mneslam_tpu.models.scene_rep import SceneRep as JSceneRep
from mneslam_tpu.ops import interp as jinterp
from mneslam_tpu_torch.config import make_config
from mneslam_tpu_torch.mapping.mapper import Mapper
from mneslam_tpu_torch.models import scene_rep as psr
from mneslam_tpu_torch.models.scene_rep import SceneRep, param_items
from mneslam_tpu_torch.ops import interp
from mneslam_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
GRAD_TOL = 1e-4
SAMPLERS = ("packed", "merged", "rows")

OVERRIDES = {
    "grid": {"oneGrid": False},
    "c_planes_res": {"coarse": 0.44, "fine": 0.22},
    "mapping": {"bound": [[-2.2, 2.2]] * 3, "sample": 96,
                "min_pixels_cur": 32, "keyframe_every": 2},
    "planes_res": {"coarse": 0.44, "fine": 0.22, "bound_dividable": 0.22},
    "cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
            "cy": 11.5, "near": 0.0, "far": 8.0},
    "training": {"n_range_d": 9, "n_samples_d": 8, "range_d": 0.25,
                 "trunc": 0.15, "n_importance": 8, "smooth_weight": 0.01,
                 "smooth_pts": 8, "smooth_vox": 0.3},
    "model": {"c_dim": 16, "input_ch": 32, "input_ch_pos": 48,
              "truncation": 0.15},
}
S = 9 + 8       # n_range_d + n_samples_d


def _t(a):
    return torch.tensor(np.asarray(a))


def _with(overrides, **training):
    return dict(overrides, training=dict(overrides["training"], **training))


@pytest.fixture
def sampler(monkeypatch, request):
    """Both packages' plane sampler set to `request.param`."""
    monkeypatch.setattr(jsr, "_PLANE_SAMPLER", request.param)
    monkeypatch.setattr(psr, "_PLANE_SAMPLER", request.param)
    return request.param


def _pair(overrides=OVERRIDES, seed=0):
    jscene = JSceneRep(jmake_config(overrides))
    scene = SceneRep(make_config(overrides), "cpu")
    jparams = jscene.init_params(jax.random.PRNGKey(seed))
    return jscene, scene, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams))


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 0.2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rgb = rng.uniform(size=(n, 3)).astype(np.float32)
    td = (0.4 + 1.2 * rng.uniform(size=(n, 1))).astype(np.float32)
    td[::7] = 0.0                        # rays without depth
    return o, d, rgb, td


def jax_uniforms(k_render, n, n_importance=0, smooth=False, S=S) -> dict:
    """The uniforms JAX draws from a render key for a batch of n rays of S
    samples: the perturbation, the importance samples (fold_in 777) and
    the smoothness grid's offset and jitter (fold_in 101, split), as numpy
    arrays."""
    u = {"perturb": np.asarray(jax.random.uniform(k_render, (n, S)))}
    if n_importance:
        u["importance"] = np.asarray(jax.random.uniform(
            jax.random.fold_in(k_render, 777), (n, n_importance)))
    if smooth:
        k1, k2 = jax.random.split(jax.random.fold_in(k_render, 101))
        u["smooth_offset"] = np.asarray(jax.random.uniform(k1, (3,)))
        u["smooth_jitter"] = np.asarray(jax.random.uniform(
            k2, (1, 1, 1, 3))).reshape(3)
    return u


def _tu(u):
    return {k: torch.tensor(v) for k, v in u.items()}


def scene_leaves(planes):
    return [t for _, t in param_items(planes)]


def assert_grads_close(items, jgrads, tol=GRAD_TOL):
    """Every leaf's gradient within tol of its largest element."""
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(items)
    for path, g in flat:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        got, ref = items[key].grad.numpy(), np.asarray(g)
        scale = max(float(np.abs(ref).max()), 1e-30)
        assert float(np.abs(got - ref).max()) <= tol * scale, (
            key, float(np.abs(got - ref).max()), scale)


# ---------------------------------------------------------------------------
# colour planes and the samplers
# ---------------------------------------------------------------------------

def test_colour_plane_shapes_and_parameter_tree_match_jax():
    jscene, scene, jparams, tparams = _pair()
    assert scene.c_plane_shapes == [
        {k: tuple(v) for k, v in lvl.items()} for lvl in
        jscene.c_plane_shapes]
    # the room0 widths: replica.yaml's c_planes_res 0.08 / 0.02
    room = {"grid": {"oneGrid": False},
            "c_planes_res": {"coarse": 0.08, "fine": 0.02},
            "mapping": {"bound": [[-1.0, 7.0], [-1.3, 3.7], [-1.7, 1.4]]},
            "planes_res": {"coarse": 0.02, "fine": 0.01,
                           "bound_dividable": 0.02}}
    assert SceneRep(make_config(room), "cpu").c_plane_shapes == [
        {k: tuple(v) for k, v in lvl.items()} for lvl in
        JSceneRep(jmake_config(room)).c_plane_shapes]
    own = scene.init_params(torch.Generator().manual_seed(0))
    ref = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p):
           tuple(v.shape) for p, v in
           jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert {p: tuple(t.shape) for p, t in param_items(own)} == ref
    assert all(t.is_leaf and t.requires_grad for _, t in param_items(own))
    # the colour net reads pos enc + colour planes + geo feature
    assert own["decoder"]["color"][0].shape[0] == 48 + 2 * 16 + 15


@pytest.mark.parametrize("sampler", SAMPLERS, indirect=True)
def test_query_color_sdf_with_colour_planes_matches_jax(sampler):
    """Training-time queries and the chunked queries' tables (meshing),
    per sampler."""
    jscene, scene, jparams, tparams = _pair()
    pts = np.random.default_rng(1).uniform(-2.4, 2.4, (500, 3)).astype(
        np.float32)
    ref = np.asarray(jscene.query_color_sdf(jparams, jnp.asarray(pts)))
    got = scene.query_color_sdf(tparams, torch.tensor(pts))
    np.testing.assert_allclose(got.detach().numpy(), ref, RTOL, ATOL)
    tables = scene.query_tables(tparams)
    assert set(tables) == {"xy", "xz", "yz", "c_planes"}
    np.testing.assert_allclose(
        scene.query_color_sdf(tparams, torch.tensor(pts),
                              tables).detach().numpy(),
        ref, RTOL, ATOL)
    rgb = scene.query_color(tparams, torch.tensor(pts), tables)
    np.testing.assert_allclose(rgb.numpy(), 1 / (1 + np.exp(-ref[:, :3])),
                               RTOL, ATOL)


def _count_scatters(monkeypatch):
    """Record the dtype of every kernel-1 call of the plane samplers."""
    calls = []
    real = interp.scatter_add_rows

    def counted(idx, vals, n_rows):
        calls.append(vals.dtype)
        return real(idx, vals, n_rows)

    monkeypatch.setattr(interp, "scatter_add_rows", counted)
    return calls


@pytest.mark.parametrize("sampler", SAMPLERS, indirect=True)
def test_mapper_loss_gradient_matches_jax(sampler, monkeypatch):
    """One mapper loss with colour planes, importance resampling and the
    smoothness term: the loss and every leaf's gradient equal jax.grad of
    the JAX mapper's `_loss_fn` with the same uniforms; kernel 1 is called
    6 x 2 (geometry + colour) x 2 (passes) + 6 (smoothness) = 30 times by
    the packed sampler, 15 by the merged one and never by rows."""
    jscene, scene, jparams, tparams = _pair()
    jm = JMapper(jscene.config, jscene, num_kf=2, rays_per_kf=8)
    m = Mapper(scene.config, scene, num_kf=2, rays_per_kf=8)
    o, d, rgb, td = _rays(96)
    key = jax.random.PRNGKey(4)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jm._loss_fn, has_aux=True))(jparams, o, d, rgb, td, key)
    calls = _count_scatters(monkeypatch)
    loss, ret = m._loss_fn(tparams, *(_t(a) for a in (o, d, rgb, td)),
                           u=_tu(jax_uniforms(key, 96, 8, smooth=True)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), RTOL)
    assert_grads_close(dict(param_items(tparams)), jgrads)
    assert len(calls) == {"packed": 30, "merged": 15, "rows": 0}[sampler]


def test_upsample_exact_matches_jax():
    plane = np.random.default_rng(2).normal(size=(8, 9, 13)).astype(
        np.float32)
    for k in (1, 2, 3, 4):
        ref = np.asarray(jinterp.upsample_exact(jnp.asarray(plane), k))
        got = interp.upsample_exact(torch.tensor(plane), k)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got[:, ::k, ::k].numpy(), plane)


def test_merged_sampler_matches_per_level(monkeypatch):
    """The port's merged sampler against its per-level packed sampler on
    the nested grid: the features (atol 1e-5) and the planes' gradients
    (atol 1e-4), as tests/test_scene_rep.py:222 holds the JAX one."""
    _, scene, _, tparams = _pair()
    planes = tparams["planes"]
    assert scene._mergeable(planes)
    assert not scene._mergeable(
        {n: [interp.PackedPlane(interp.pack_corners(p), p.shape)
             for p in lst] for n, lst in planes.items()})
    pts = np.random.default_rng(3).uniform(-2.4, 2.4, (300, 3)).astype(
        np.float32)
    p_nor = scene._normalize(torch.tensor(pts))
    out = {}
    for name in ("packed", "merged"):
        monkeypatch.setattr(psr, "_PLANE_SAMPLER", name)
        for t in scene_leaves(planes):
            t.grad = None
        f = scene.plane_features(planes, p_nor)
        torch.sin(f).sum().backward()
        out[name] = (f.detach(), [t.grad.clone() for t in
                                  scene_leaves(planes)])
    np.testing.assert_allclose(out["merged"][0].numpy(),
                               out["packed"][0].numpy(), atol=1e-5)
    for a, b in zip(out["merged"][1], out["packed"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)


def test_unknown_plane_sampler_raises(monkeypatch):
    monkeypatch.setattr(psr, "_PLANE_SAMPLER", "tiles")
    with pytest.raises(ValueError, match="MNESLAM_PLANE_SAMPLER"):
        SceneRep(make_config(OVERRIDES), "cpu")


# ---------------------------------------------------------------------------
# importance resampling
# ---------------------------------------------------------------------------

def test_sample_pdf_matches_jax():
    """Stratified (no uniforms) and at given uniforms, on weights with a
    peak, zero rows (the 1e-5 guard) and flat rows."""
    rng = np.random.default_rng(4)
    bins = np.sort(rng.uniform(0, 4, (6, 16)), -1).astype(np.float32)
    w = rng.uniform(size=(6, 16)).astype(np.float32)
    w[0] = 0.0
    w[1] = 0.0
    w[1, 8] = 1.0
    w[2] = 1.0
    jscene = JSceneRep(jmake_config(OVERRIDES))
    ref = np.asarray(jscene.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 12))
    got = SceneRep.sample_pdf(torch.tensor(bins), torch.tensor(w), 12)
    np.testing.assert_allclose(got.numpy(), ref, RTOL, ATOL)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jscene.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 12,
                                       key=key))
    u = jax.random.uniform(key, (6, 12))
    got = SceneRep.sample_pdf(torch.tensor(bins), torch.tensor(w), 12,
                              u=_t(u))
    np.testing.assert_allclose(got.numpy(), ref, RTOL, ATOL)
    # the samples gather at the peak
    assert float((got[1] - bins[1, 8]).abs().mean()) < 0.3


@pytest.mark.parametrize("perturb", [True, False])
def test_render_rays_and_forward_with_importance_match_jax(perturb):
    """`render_rays` (both passes' maps, the final z_vals of 9 + 8 + 8
    samples) and `forward`'s losses, the first pass's rgb and depth losses
    summed in; without perturbation the importance samples are
    stratified."""
    ov = {**OVERRIDES, "grid": {"oneGrid": True},
          "training": dict(OVERRIDES["training"], perturb=int(perturb))}
    jscene, scene, jparams, tparams = _pair(ov)
    o, d, rgb, td = _rays(64, seed=5)
    key = jax.random.PRNGKey(6)
    u = _tu(jax_uniforms(key, 64, 8))
    ref = jax.jit(lambda p: jscene.render_rays(
        p, jnp.asarray(o), jnp.asarray(d), target_d=jnp.asarray(td),
        key=key))(jparams)
    got = scene.render_rays(tparams, _t(o), _t(d), _t(td), u=u)
    assert got["z_vals"].shape == (64, 9 + 8 + 8)
    for k in ("rgb0", "depth0", "acc0", "disp0", "depth_var0", "z_vals",
              "rgb", "depth", "weights"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(ref[k]), RTOL, ATOL,
                                   err_msg=k)
    jret = jax.jit(lambda p: jscene.forward(p, o, d, rgb, td,
                                            key=key))(jparams)
    ret = scene.forward(tparams, *(_t(a) for a in (o, d, rgb, td)), u=u)
    for k in ("rgb_loss", "depth_loss", "co_sdf_loss", "co_fs_loss",
              "e_fs_loss", "e_center_loss", "e_tail_loss", "psnr"):
        np.testing.assert_allclose(float(ret[k].detach()), float(jret[k]),
                                   RTOL, ATOL, err_msg=k)
    # the coarse pass's losses are in
    first = float(((got["rgb0"] - _t(rgb)) ** 2).mean().detach())
    assert float(ret["rgb_loss"].detach()) > first > 0.0
