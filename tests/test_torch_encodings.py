"""Port parity: the coordinate encodings (`mneslam_tpu_torch/ops/
encodings.py`) and the multi-resolution hash grid (`ops/hashgrid.py`)
against the JAX package, on numpy inputs from a seed.

Tolerances: the encodings rtol 1e-5 / atol 1e-6 (fp32, the same
expressions); the hash grid's indices equal bit for bit, its features
atol 1e-9 (sums of 8 products of values near 1e-4), the table's gradient
rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mneslam_tpu.ops import encodings as jenc
from mneslam_tpu.ops import hashgrid as jhash
from mneslam_tpu_torch.ops import encodings as enc
from mneslam_tpu_torch.ops import hashgrid

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("name,kw,dim_in", [
    ("OneBlob", {"n_bins": 16}, 3),
    ("Frequency", {"n_frequencies": 6}, 3),
    ("Frequency", {"n_frequencies": 12}, 2),
    ("SphericalHarmonics", {"degree": 1}, 3),
    ("SphericalHarmonics", {"degree": 2}, 3),
    ("SphericalHarmonics", {"degree": 3}, 3),
    ("SphericalHarmonics", {"degree": 4}, 3),
    ("Identity", {}, 3),
])
def test_every_encoding_matches_jax(name, kw, dim_in):
    """Values and output widths of `get_encoder` on points in [0, 1]
    (unit directions for the spherical harmonics), in JAX's layout."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(5, 7, dim_in)).astype(np.float32)
    if name == "SphericalHarmonics":
        x = rng.normal(size=(64, 3)).astype(np.float32)
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    jfn, jdim = jenc.get_encoder(name, input_dim=dim_in, **kw)
    fn, dim = enc.get_encoder(name, input_dim=dim_in, **kw)
    assert dim == jdim
    got = fn(torch.tensor(x))
    ref = np.asarray(jfn(jnp.asarray(x)))
    assert got.shape == ref.shape and got.shape[-1] == dim
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_frequency_layout_is_sines_then_cosines_per_coordinate():
    """[..., D, 2F]: all sines of one coordinate, then all its cosines
    (not NeRF's interleave)."""
    x = torch.tensor([[0.25, 0.5]])
    out = enc.frequency_encode(x, n_frequencies=3).reshape(2, 6)
    ang = 0.25 * np.pi * np.array([1.0, 2.0, 4.0])
    np.testing.assert_allclose(out[0, :3].numpy(), np.sin(ang), atol=1e-6)
    np.testing.assert_allclose(out[0, 3:].numpy(), np.cos(ang), atol=1e-6)


def test_unknown_encoding_raises_with_the_jax_message():
    with pytest.raises(ValueError, match="unknown encoding: HashGrid"):
        enc.get_encoder("HashGrid")
    with pytest.raises(ValueError, match="unknown encoding"):
        jenc.get_encoder("HashGrid")


def test_level_resolutions_match_jax():
    for args in ((16, 16, 512), (4, 4, 32), (1, 16, 512), (8, 2, 2048)):
        assert hashgrid.level_resolutions(*args) == \
            jhash.level_resolutions(*args)


def _corners(rng, n, res):
    """Integer corners in [0, res], the top ones included."""
    c = rng.integers(0, res + 1, size=(n, 3))
    c[:4] = res
    return c


@pytest.mark.parametrize("res,T", [(16, 2 ** 16), (40, 2 ** 16),
                                   (512, 2 ** 16), (512, 2 ** 19),
                                   (2048, 2 ** 12)])
def test_corner_index_equals_jax_bit_for_bit(res, T):
    """Dense levels ((res + 1)^3 <= T) and hashed ones, up to res 2048:
    y * 2654435761 wraps around 32 bits, which the int64 products masked
    to their low 32 bits reproduce."""
    c = _corners(np.random.default_rng(res), 4096, res)
    ref = np.asarray(jhash._corner_index(
        *(jnp.asarray(c[:, i], jnp.int32) for i in range(3)), res, T))
    got = hashgrid.corner_index(*(torch.tensor(c[:, i]) for i in range(3)),
                                res, T)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert int(got.min()) >= 0 and int(got.max()) < T


def _grid_pair(seed, **kw):
    jparams, jres = jhash.init_hash_grid(jax.random.PRNGKey(seed), **kw)
    params = {"table": torch.tensor(np.asarray(jparams["table"]),
                                    requires_grad=True)}
    return jparams, jres, params


@pytest.mark.parametrize("kw", [
    # every level dense
    dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=16,
         base_resolution=4, desired_resolution=32),
    # the defaults: 16 levels, 2^16 rows; the fine levels hashed up to
    # res 512
    dict(),
])
def test_hash_grid_encode_and_table_gradient_match_jax(kw):
    """Features of points in [0, 1] (some near 1.0, where the corners
    reach res and the hash wraps) and the table's gradient of a weighted
    sum of them."""
    jparams, jres, params = _grid_pair(0, **kw)
    _, res = hashgrid.init_hash_grid(torch.Generator().manual_seed(0), **kw)
    assert res == jres
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(256, 3)).astype(np.float32)
    x[:32] = 1.0 - rng.uniform(0, 1e-3, size=(32, 3))
    x[32:36] = 1.0
    x = x.reshape(16, 16, 3)
    w = rng.normal(size=(16, 16, len(res) * 2)).astype(np.float32)

    ref, jgrad = jax.value_and_grad(lambda p: jnp.sum(
        jhash.hash_grid_encode(p, jnp.asarray(x), jres) * w))(jparams)
    out = hashgrid.hash_grid_encode(params, torch.tensor(x), res)
    assert out.shape == (16, 16, len(res) * 2)
    ref_out = np.asarray(jhash.hash_grid_encode(jparams, jnp.asarray(x),
                                                jres))
    np.testing.assert_allclose(out.detach().numpy(), ref_out, rtol=0,
                               atol=1e-9)
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(params["table"].grad.numpy(),
                               np.asarray(jgrad["table"]), rtol=1e-5,
                               atol=1e-6)


def test_init_hash_grid_is_a_trainable_leaf_in_range():
    params, res = hashgrid.init_hash_grid(
        torch.Generator().manual_seed(3), n_levels=3,
        n_features_per_level=4, log2_hashmap_size=8)
    t = params["table"]
    assert t.shape == (3, 256, 4) and t.is_leaf and t.requires_grad
    assert float(t.detach().abs().max()) <= 1e-4 and len(res) == 3
