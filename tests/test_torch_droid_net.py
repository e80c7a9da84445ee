"""Port of the DROID tracker networks (`mneslam_tpu_torch.models.droid_net`,
`.nn`) against the JAX package on the CPU, with the JAX-initialised
weights carried over by `utils.convert.droid_params_from_jax`.

Tolerance: fp32; single heads rtol 1e-4 / atol 1e-5, the encoders (nine
convolutions with instance norms, summed in another order by XLA and
oneDNN) rtol 1e-4 / atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mneslam_tpu.models import droid_net as jdn
from mneslam_tpu_torch.models import droid_net as pdn
from mneslam_tpu_torch.models import nn as pnn
from mneslam_tpu_torch.utils.convert import droid_params_from_jax

torch.set_num_threads(1)

H, W = 64, 96
h, w = H // 8, W // 8


@pytest.fixture(scope="module")
def params():
    jp = jdn.init_droid_net(jax.random.PRNGKey(0))
    return jp, droid_params_from_jax(jax.tree.map(np.asarray, jp))


def _close(got, ref, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


def test_encoders_match_jax(params):
    jp, tp = params
    img = np.random.default_rng(0).random((2, 3, H, W)).astype(np.float32)
    jx = jdn.normalize_images(jnp.asarray(img))
    tx = pdn.normalize_images(torch.tensor(img))
    _close(tx, jx)
    _close(pdn.feature_encoder(tp, tx), jdn.feature_encoder(jp, jx),
           atol=1e-4)
    jnet, jinp = jdn.context_encoder(jp, jx)
    tnet, tinp = pdn.context_encoder(tp, tx)
    assert tnet.shape == (2, 128, h, w)
    _close(tnet, jnet, atol=1e-4)
    _close(tinp, jinp, atol=1e-4)


def test_update_apply_matches_jax(params):
    jp, tp = params
    rng = np.random.default_rng(1)
    E = 3
    net = np.tanh(rng.normal(size=(E, 128, h, w))).astype(np.float32)
    inp = np.maximum(rng.normal(size=(E, 128, h, w)), 0).astype(np.float32)
    corr = rng.normal(size=(E, 196, h, w)).astype(np.float32)
    flow = rng.normal(size=(E, 4, h, w)).astype(np.float32)
    for fl in (flow, None):
        ref = jdn.update_apply(jp["update"], jnp.asarray(net),
                               jnp.asarray(inp), jnp.asarray(corr),
                               None if fl is None else jnp.asarray(fl))
        got = pdn.update_apply(tp["update"], torch.tensor(net),
                               torch.tensor(inp), torch.tensor(corr),
                               None if fl is None else torch.tensor(fl))
        for a, b in zip(got, ref):
            _close(a, b)
        assert got[1].shape == (E, h, w, 2) and got[1].dtype == torch.float32


def test_agg_apply_with_padded_edges_matches_jax(params):
    jp, tp = params
    rng = np.random.default_rng(2)
    net = np.tanh(rng.normal(size=(5, 128, h, w))).astype(np.float32)
    ii = np.array([0, 0, 2, 1, 0])
    mask = np.array([1, 1, 1, 0, 0], np.float32)     # two padded slots
    jeta, jup = jdn.agg_apply(jp["update"]["agg"], jnp.asarray(net),
                              jnp.asarray(ii), jnp.asarray(mask), 4)
    teta, tup = pdn.agg_apply(tp["update"]["agg"], torch.tensor(net),
                              torch.tensor(ii), torch.tensor(mask), 4)
    _close(teta, jeta)
    _close(tup, jup)
    assert tup.shape == (4, 576, h, w)
    # a padded edge does not enter its frame's mean
    net2 = net.copy()
    net2[3] = 50.0
    teta2, _ = pdn.agg_apply(tp["update"]["agg"], torch.tensor(net2),
                             torch.tensor(ii), torch.tensor(mask), 4)
    _close(teta2[:3], teta[:3], atol=0)


def test_gru_and_cvx_upsample_match_jax(params):
    jp, tp = params
    rng = np.random.default_rng(3)
    net = (0.1 * rng.normal(size=(2, 128, h, w))).astype(np.float32)
    inp = (0.1 * rng.normal(size=(2, 320, h, w))).astype(np.float32)
    _close(pdn.gru_apply(tp["update"]["gru"], torch.tensor(net),
                         torch.tensor(inp)),
           jdn.gru_apply(jp["update"]["gru"], jnp.asarray(net),
                         jnp.asarray(inp)))
    data = rng.normal(size=(2, h, w, 2)).astype(np.float32)
    mask = rng.normal(size=(2, 576, h, w)).astype(np.float32)
    _close(pdn.cvx_upsample(torch.tensor(data), torch.tensor(mask)),
           jdn.cvx_upsample(jnp.asarray(data), jnp.asarray(mask)))


def test_nn_primitives():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 9, 7)).astype(np.float32)
    from mneslam_tpu.models import nn as jnn
    _close(pnn.instance_norm(torch.tensor(x)),
           jnn.instance_norm(jnp.asarray(x)))
    p = {"weight": rng.normal(size=(4, 3, 3, 3)).astype(np.float32),
         "bias": rng.normal(size=4).astype(np.float32)}
    _close(pnn.conv2d({k: torch.tensor(v) for k, v in p.items()},
                      torch.tensor(x), stride=2, padding=1),
           jnn.conv2d({k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(x), stride=2, padding=1))
    # bf16 weights run the conv in bf16
    pb = {k: torch.tensor(v).bfloat16() for k, v in p.items()}
    assert pnn.conv2d(pb, torch.tensor(x)).dtype == torch.bfloat16
    # GradientClip: identity forward; big or NaN gradients zeroed
    t = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    y = pnn.clip_grad_custom(t)
    assert torch.equal(y, t)
    y.backward(torch.tensor([0.005, 0.5, float("nan")]))
    np.testing.assert_array_equal(t.grad.numpy(),
                                  np.float32([0.005, 0.0, 0.0]))
    g = torch.Generator().manual_seed(0)
    c = pnn.init_conv(g, 8, 16, 3)
    assert c["weight"].shape == (16, 8, 3, 3) and not c["bias"].any()
    np.testing.assert_allclose(float(c["weight"].std()),
                               np.sqrt(2.0 / (16 * 9)), rtol=0.15)


def _state_dict(jp):
    """A droid.pth-shaped state dict from a JAX params tree: the
    reference's module names, the `module.` prefix, 3-channel delta and
    weight heads (the loaders keep the first 2)."""
    sd = {}

    def put(prefix, conv):
        for k, v in conv.items():
            sd[f"module.{prefix}.{k}"] = torch.tensor(np.asarray(v))

    for enc in ("fnet", "cnet"):
        e = jp[enc]
        put(f"{enc}.conv1", e["conv1"])
        put(f"{enc}.conv2", e["conv2"])
        for layer in ("layer1", "layer2", "layer3"):
            for i, blk in enumerate(e[layer]):
                put(f"{enc}.{layer}.{i}.conv1", blk["conv1"])
                put(f"{enc}.{layer}.{i}.conv2", blk["conv2"])
                if "downsample" in blk:
                    put(f"{enc}.{layer}.{i}.downsample.0", blk["downsample"])
    u = jp["update"]
    for name in ("corr_encoder", "flow_encoder", "weight", "delta"):
        put(f"update.{name}.0", u[name][0])
        put(f"update.{name}.2", u[name][1])
    for k, v in u["gru"].items():
        put(f"update.gru.{k}", v)
    put("update.agg.conv1", u["agg"]["conv1"])
    put("update.agg.conv2", u["agg"]["conv2"])
    put("update.agg.eta.0", u["agg"]["eta"][0])
    put("update.agg.upmask.0", u["agg"]["upmask"][0])
    for head in ("weight", "delta"):
        for k in ("weight", "bias"):
            t = sd[f"module.update.{head}.2.{k}"]
            sd[f"module.update.{head}.2.{k}"] = torch.cat([t, t[:1] + 1])
    return sd


def test_load_droid_weights_matches_jax_loader(params, tmp_path):
    jp, tp = params
    path = tmp_path / "droid.pth"
    torch.save(_state_dict(jp), path)
    jl = jax.tree.map(np.asarray, jdn.load_droid_weights(str(path)))
    tl = pdn.load_droid_weights(str(path))
    jleaves = {jax.tree_util.keystr(kp): a for kp, a in
               jax.tree_util.tree_flatten_with_path(jl)[0]}
    tleaves = {jax.tree_util.keystr(kp): a for kp, a in
               jax.tree_util.tree_flatten_with_path(tl)[0]}
    assert jleaves.keys() == tleaves.keys()
    for k, a in jleaves.items():
        np.testing.assert_array_equal(tleaves[k].numpy(), a, err_msg=k)
    assert tl["update"]["delta"][1]["weight"].shape[0] == 2
    # and the loaded weights equal the tree they were written from
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jp)),
                    jax.tree.leaves(jl)):
        np.testing.assert_array_equal(a, b)
