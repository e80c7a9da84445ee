"""Port parity: the scene representation (encoding, decoder, sampling,
compositing, losses) and the flagship forward of `__graft_entry__.entry()`.

Weights go from JAX to the port through `utils.convert.params_from_jax`;
the depth-sample perturbation that JAX draws from its key is handed to the
port as `u`. Tolerances: rtol 1e-4 / atol 1e-5 (fp32) unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from mneslam_tpu.config import make_config as jmake_config
from mneslam_tpu.models import decoder as jdecoder
from mneslam_tpu.models.scene_rep import SceneRep as JSceneRep
from mneslam_tpu.ops import encodings as jencodings
from mneslam_tpu_torch.config import make_config
from mneslam_tpu_torch.configs import ROOM0
from mneslam_tpu_torch.models import decoder
from mneslam_tpu_torch.models.scene_rep import SceneRep, param_items
from mneslam_tpu_torch.ops import encodings
from mneslam_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def test_entry_loss_and_every_gradient_match_jax():
    """The flagship forward of `__graft_entry__.entry()` (render + losses
    at its tiny config):
    same weights, same rays, same perturbation uniforms -> same loss and
    the same gradient for every parameter leaf."""
    fn, args = __graft_entry__.entry()
    params, rays_o, rays_d, target_rgb, target_d = args
    loss_j, grads_j = jax.value_and_grad(fn)(*args)

    cfg = __graft_entry__._tiny_config()
    jscene = JSceneRep(cfg)
    S = jscene.n_range_d + jscene.n_samples_d
    u = jax.random.uniform(jax.random.PRNGKey(0), (rays_o.shape[0], S))

    scene = SceneRep(cfg, "cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, params))
    ret = scene.forward(tparams, _t(rays_o), _t(rays_d), _t(target_rgb),
                        _t(target_d), u=_t(u))
    loss = scene.get_loss_from_ret(ret)
    loss.backward()

    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=RTOL)
    flat_j = jax.tree_util.tree_flatten_with_path(grads_j)[0]
    items = dict(param_items(tparams))
    assert len(items) == len(flat_j) == 10
    for path, g in flat_j:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        got = items[key].grad.numpy()
        scale = float(np.abs(np.asarray(g)).max())
        # atol relative to the leaf's largest gradient: plane texels hit by
        # one sample carry tiny gradients next to large ones elsewhere
        np.testing.assert_allclose(got, np.asarray(g), rtol=1e-3,
                                   atol=1e-5 * max(scale, 1.0),
                                   err_msg=str(key))


def test_plane_shapes_match_jax_at_room0_widths():
    """Shapes only (nothing allocated): the nested 0.02 / 0.01 m planes
    over room0's bound."""
    jscene = JSceneRep(jmake_config(ROOM0))
    scene = SceneRep(make_config(ROOM0), "cpu")
    assert scene.plane_shapes == jscene.plane_shapes
    assert scene.plane_shapes[1]["xy"] == (32, 501, 799)   # 400,299 rows
    assert scene.plane_shapes[0]["xy"] == (32, 251, 400)   # 100,400 rows
    np.testing.assert_array_equal(scene.bound.numpy(),
                                  np.asarray(jscene.bound))


def test_one_blob_matches_jax():
    x = np.random.default_rng(0).uniform(-0.1, 1.1, (300, 3)).astype(
        np.float32)
    got = encodings.one_blob_encode(torch.tensor(x), 16)
    ref = jencodings.one_blob_encode(jnp.asarray(x), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), RTOL, ATOL)
    fn, dim = encodings.get_encoder("OneBlob", n_bins=16)
    assert dim == 48 and fn(torch.tensor(x)).shape == (300, 48)


def test_decoder_matches_jax():
    cfg = jmake_config({"model": {"c_dim": 8, "input_ch": 16}})
    jparams = jdecoder.init_decoder(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(1)
    embed = [rng.standard_normal((50, 8)).astype(np.float32)
             for _ in range(2)]
    pos = rng.standard_normal((50, 48)).astype(np.float32)
    ref = jdecoder.decoder_apply(jparams, [jnp.asarray(e) for e in embed],
                                 jnp.asarray(pos))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    got = decoder.decoder_apply(tparams, [torch.tensor(e) for e in embed],
                                torch.tensor(pos))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               RTOL, ATOL)
    sdf_dims, color_dims = decoder.decoder_dims(cfg)
    assert [tuple(w.shape) for w in tparams["sdf"]] == list(
        zip(sdf_dims[:-1], sdf_dims[1:]))
    assert [tuple(w.shape) for w in tparams["color"]] == list(
        zip(color_dims[:-1], color_dims[1:]))


def _small_pair():
    cfg = __graft_entry__._tiny_config()
    return JSceneRep(cfg), SceneRep(cfg, "cpu")


def test_sample_z_vals_matches_jax():
    jscene, scene = _small_pair()
    rng = np.random.default_rng(2)
    n = 64
    td = rng.uniform(0.3, 2.0, (n, 1)).astype(np.float32)
    td[:5] = 0.0  # rays without depth fall back to [near, far]
    ref = jscene.sample_z_vals(jnp.asarray(td), n, None)
    got = scene.sample_z_vals(torch.tensor(td), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), RTOL, ATOL)

    key = jax.random.PRNGKey(5)
    ref_p = jscene.sample_z_vals(jnp.asarray(td), n, key)
    u = jax.random.uniform(key, ref_p.shape)
    got_p = scene.sample_z_vals(torch.tensor(td), n, u=_t(u))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), RTOL, ATOL)


def test_raw2outputs_and_loss_terms_match_jax():
    jscene, scene = _small_pair()
    rng = np.random.default_rng(4)
    R, S = 40, 17
    z = np.sort(rng.uniform(0.1, 3.0, (R, S)), axis=-1).astype(np.float32)
    td = rng.uniform(0.5, 2.5, (R, 1)).astype(np.float32)
    td[:3] = 0.0
    raw = rng.standard_normal((R, S, 4)).astype(np.float32)
    # an sdf that crosses zero near the target depth
    raw[..., 3] = ((td - z) / 0.3 + 0.1 * raw[..., 3]).astype(np.float32)

    refs = jscene.raw2outputs(jnp.asarray(raw), jnp.asarray(z))
    gots = scene.raw2outputs(torch.tensor(raw), torch.tensor(z))
    for got, ref in zip(gots, refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), RTOL, ATOL)

    sdf = raw[..., 3]
    for name in ("co_sdf_losses", "eslam_sdf_losses"):
        refs = getattr(jscene, name)(jnp.asarray(z), jnp.asarray(td),
                                     jnp.asarray(sdf))
        gots = getattr(scene, name)(torch.tensor(z), torch.tensor(td),
                                    torch.tensor(sdf))
        for got, ref in zip(gots, refs):
            np.testing.assert_allclose(float(got), float(ref), rtol=RTOL,
                                       err_msg=name)


@pytest.mark.parametrize("is_co", [True, False])
def test_get_loss_from_ret_matches_jax(is_co):
    cfg = __graft_entry__._tiny_config()
    cfg["training"]["is_co_sdf"] = is_co
    jscene, scene = JSceneRep(cfg), SceneRep(cfg, "cpu")
    names = ("rgb_loss", "depth_loss", "co_sdf_loss", "co_fs_loss",
             "e_fs_loss", "e_center_loss", "e_tail_loss")
    vals = np.random.default_rng(5).uniform(0.01, 1.0, len(names))
    ref = jscene.get_loss_from_ret({k: jnp.float32(v)
                                    for k, v in zip(names, vals)})
    got = scene.get_loss_from_ret({k: torch.tensor(v, dtype=torch.float32)
                                   for k, v in zip(names, vals)})
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)


def test_unported_options_raise():
    """Every option of the JAX package is ported now (colour planes and
    importance resampling: tests/test_torch_scene_options.py): those build;
    what the JAX package does not know still raises."""
    scene = SceneRep(make_config({"grid": {"oneGrid": False}}), "cpu")
    assert "c_planes" in scene.init_params(torch.Generator().manual_seed(0))
    assert SceneRep(make_config({"training": {"n_importance": 8}}),
                    "cpu").n_importance == 8
    # bfloat16 is ported (tests/test_torch_render_bf16.py); other dtypes
    # still raise
    with pytest.raises(ValueError):
        SceneRep(make_config({"training": {"render_dtype": "float16"}}),
                 "cpu")
    with pytest.raises(ValueError, match="unknown encoding"):
        SceneRep(make_config({"pos": {"enc": "HashGrid"}}), "cpu")
