"""Port parity: `training.render_dtype: bfloat16` (configs/Replica/
room0_fast.yaml) against the JAX package's bf16 render on the CPU.

The JAX side runs its plane scatter through the Pallas kernel in interpret
mode (MNESLAM_SCATTER_IMPL=pallas), which sums bf16 values in fp32, as
kernel 1 does. Its CPU default, XLA's scatter, accumulates in bf16: after 3
steps the planes then differ by up to 1e-2.

Tolerances (bf16), each ten or more times what was measured on the CPU:
- raw outputs [N, 4]: one bf16 ulp of the largest output (2^-8 x max|raw|;
  measured 0: the same bf16 products, rounded at the same points);
- the loss: rtol 1e-5 (measured 1.9e-7);
- every parameter after 3 mapper steps (Adam): atol 5e-4 (measured
  5.8e-5, a decoder weight; 5.6e-5 in a fine plane): torch's and the
  jitted XLA's bf16 matmuls round their gradient sums at other points,
  and Adam's first steps turn a small gradient change on a texel with a
  small gradient into a step change of up to the learning rate.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mneslam_tpu.config import make_config as jmake_config
from mneslam_tpu.mapping.mapper import Mapper as JMapper
from mneslam_tpu.models.scene_rep import SceneRep as JSceneRep
from mneslam_tpu_torch.config import make_config
from mneslam_tpu_torch.mapping.mapper import Mapper, make_optimizer
from mneslam_tpu_torch.models.scene_rep import SceneRep, param_items
from mneslam_tpu_torch.utils.convert import params_from_jax

from test_torch_mapper import OVERRIDES, _batches

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-4


@pytest.fixture
def pair(monkeypatch):
    monkeypatch.setenv("MNESLAM_SCATTER_IMPL", "pallas")
    over = copy.deepcopy(OVERRIDES)
    over["training"]["render_dtype"] = "bfloat16"
    jcfg, cfg = jmake_config(over), make_config(over)
    jscene, scene = JSceneRep(jcfg), SceneRep(cfg, "cpu")
    jparams = jscene.init_params(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, cfg, jscene, scene, jparams, tparams


def _raw_tol(ref):
    return 2.0 ** -8 * float(np.abs(ref).max())


def test_bf16_raw_outputs_match_jax(pair):
    _, _, jscene, scene, jparams, tparams = pair
    assert scene.compute_dtype == torch.bfloat16
    pts = np.random.default_rng(3).uniform(-1.8, 1.8, (4096, 3)).astype(
        np.float32)
    ref = np.asarray(jscene.query_color_sdf(jparams, jnp.asarray(pts)))
    got = scene.query_color_sdf(tparams, torch.tensor(pts))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), ref,
                               atol=_raw_tol(ref), rtol=0)
    # the meshing query: tables packed once, in bf16
    tables = scene.query_tables(tparams)
    assert tables["xy"][0].dtype == torch.bfloat16
    sdf = scene.query_sdf(tparams, torch.tensor(pts), tables)
    np.testing.assert_allclose(sdf.numpy(), ref[:, 3], atol=_raw_tol(ref),
                               rtol=0)
    # bf16 differs from the fp32 render (the cast really happens)
    fp32 = SceneRep(make_config(OVERRIDES), "cpu")
    raw32 = fp32.query_color_sdf(tparams, torch.tensor(pts)).detach()
    assert float((raw32 - got.detach()).abs().max()) > 1e-4


def test_bf16_loss_and_gradients_reach_fp32_leaves(pair):
    jcfg, cfg, jscene, scene, jparams, tparams = pair
    o, d, rgb, td = _batches(192, 1, seed=4)[0]
    S = jscene.n_range_d + jscene.n_samples_d
    key = jax.random.PRNGKey(5)
    u = jax.random.uniform(key, (o.shape[0], S))

    def jloss(p):
        ret = jscene.forward(p, *(jnp.asarray(a) for a in (o, d, rgb, td)),
                             key)
        return jscene.get_loss_from_ret(ret)

    ref = float(jax.jit(jloss)(jparams))
    ret = scene.forward(tparams, *(torch.tensor(a) for a in (o, d, rgb, td)),
                        u=torch.tensor(np.asarray(u)))
    loss = scene.get_loss_from_ret(ret)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref, rtol=LOSS_RTOL)
    for path, leaf in param_items(tparams):
        assert leaf.dtype == torch.float32, path
        assert leaf.grad is not None and leaf.grad.dtype == torch.float32
        assert bool(torch.isfinite(leaf.grad).all()), path


def test_three_bf16_mapper_steps_match_jax(pair):
    jcfg, cfg, jscene, scene, jparams, tparams = pair
    jm = JMapper(jcfg, jscene, num_kf=4, rays_per_kf=30)
    m = Mapper(cfg, scene, num_kf=4, rays_per_kf=30)
    S = jscene.n_range_d + jscene.n_samples_d
    state = m.init_state(torch.Generator().manual_seed(0))
    state.params = tparams
    state.optimizer = make_optimizer(cfg, state.params)

    grad_fn = jax.jit(jax.value_and_grad(jm._loss_fn, has_aux=True))
    opt_state = jm.optimizer.init(jparams)
    import optax

    batches = _batches(192, 3)
    keys = [jax.random.PRNGKey(100 + i) for i in range(3)]
    jlosses, losses = [], []
    for (o, d, rgb, td), key in zip(batches, keys):
        (loss, _), grads = grad_fn(jparams, o, d, rgb, td, key)
        updates, opt_state = jm.optimizer.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        jlosses.append(float(loss))
        u = jax.random.uniform(key, (o.shape[0], S))
        met = m.step(state, *(torch.tensor(a) for a in (o, d, rgb, td)),
                     u=torch.tensor(np.asarray(u)))
        losses.append(float(met["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    items = dict(param_items(state.params))
    for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        assert items[key].dtype == torch.float32
        np.testing.assert_allclose(items[key].detach().numpy(),
                                   np.asarray(v), atol=PARAM_ATOL, rtol=0,
                                   err_msg=str(key))
