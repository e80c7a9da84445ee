"""Port parity: plane sampling and the plane-cotangent scatter.

Inputs are made with numpy from a seed and run through the JAX function and
its PyTorch port (`mneslam_tpu_torch.ops.interp`,
`mneslam_tpu_torch.kernels.scatter_add_rows`, plain path on the CPU).
Tolerances: rtol 1e-4 / atol 1e-5 for fp32 results unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mneslam_tpu.ops import interp as jinterp
from mneslam_tpu.ops import pallas_kernels
from mneslam_tpu_torch.kernels.scatter_add_rows import (
    bf16_workspace, scatter_add_rows, scatter_add_rows_bf16_staged,
    scatter_add_rows_plain)
from mneslam_tpu_torch.ops import interp

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _plane_and_coords(seed, C=8, H=13, W=17, n=400):
    rng = np.random.default_rng(seed)
    plane = rng.standard_normal((C, H, W)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (n, 2)).astype(np.float32)
    return plane, coords


def test_grid_sample_and_pack_match_jax():
    plane, coords = _plane_and_coords(0)
    got = interp.grid_sample_2d(torch.tensor(plane), torch.tensor(coords))
    ref = jinterp.grid_sample_2d(jnp.asarray(plane), jnp.asarray(coords))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), RTOL, ATOL)

    packed = interp.pack_corners(torch.tensor(plane))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jinterp.pack_corners(jnp.asarray(plane))))


def test_unpack_adjoint_matches_jax():
    rng = np.random.default_rng(1)
    C, H, W = 4, 7, 9
    d = rng.standard_normal((H * W, 4 * C)).astype(np.float32)
    got = interp._unpack_corners_adjoint(torch.tensor(d), C, H, W)
    ref = jinterp._unpack_corners_adjoint(jnp.asarray(d), C, H, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), RTOL, ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_plane_packed_forward_and_grads_match_jax(seed):
    """Forward, plane gradient and coordinate gradient against JAX's
    custom-VJP sampler under jax.grad, away from |coord| == 1 ties (the
    clip splits a tie's gradient; measure zero)."""
    plane, coords = _plane_and_coords(seed, C=32, H=37, W=53, n=500)
    w = np.cos(np.arange(32)).astype(np.float32)

    def jloss(p, c):
        return jnp.sum(jnp.sin(jinterp.sample_plane_packed(p, c)) * w)

    ref = jinterp.sample_plane_packed(jnp.asarray(plane), jnp.asarray(coords))
    g_p, g_c = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(plane),
                                               jnp.asarray(coords))

    tp = torch.tensor(plane, requires_grad=True)
    tc = torch.tensor(coords, requires_grad=True)
    out = interp.sample_plane_packed(tp, tc)
    (torch.sin(out) * torch.tensor(w)).sum().backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               RTOL, ATOL)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(g_p), RTOL, ATOL)
    no_tie = np.abs(np.abs(coords) - 1.0) > 1e-6
    np.testing.assert_allclose(tc.grad.numpy()[no_tie],
                               np.asarray(g_c)[no_tie], RTOL, 1e-4)
    # and the packed sampler equals the four-gather one
    np.testing.assert_allclose(
        out.detach().numpy(),
        interp.grid_sample_2d(torch.tensor(plane), torch.tensor(coords)).numpy(),
        RTOL, ATOL)


@pytest.mark.parametrize("n_rows,nu,width", [(201, 64, 128), (1001, 500, 64),
                                             (301, 128, 128)])
def test_plain_scatter_matches_pallas_and_xla(n_rows, nu, width):
    """Duplicates (forced), untouched rows, row counts that are not a
    multiple of 8: the plain scatter == the Pallas kernel (interpret mode)
    == `.at[idx].add`."""
    rng = np.random.default_rng(n_rows)
    idx = rng.integers(0, n_rows - 5, nu).astype(np.int32)  # 5 rows untouched
    idx[: nu // 4] = idx[nu // 4: 2 * (nu // 4)]
    vals = rng.standard_normal((nu, width)).astype(np.float32)

    got = scatter_add_rows(torch.tensor(idx), torch.tensor(vals), n_rows)
    xla = jnp.zeros((n_rows, width)).at[jnp.asarray(idx)].add(
        jnp.asarray(vals))
    pallas = pallas_kernels.scatter_add_rows_pallas(
        jnp.asarray(idx), jnp.asarray(vals), n_rows, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), RTOL, ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), RTOL, ATOL)
    assert not got[n_rows - 5:].any()


@pytest.mark.parametrize("out_of_range", [False, True])
@pytest.mark.parametrize("width", [128, 100])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
def test_plain_scatter_bf16_accumulates_in_fp32(idx_dtype, width,
                                                out_of_range):
    """bf16 values: sums in fp32, result cast to bf16 — the JAX
    dispatcher's bf16 rule (exact agreement after the final cast), for
    int32 and int64 indices, a width that is not a multiple of 8, and
    indices on both sides of [0, n_rows), which are dropped (JAX's
    `mode="drop"` without wrapping negative indices)."""
    rng = np.random.default_rng(3)
    n_rows, nu = 301, 128
    idx = rng.integers(0, n_rows, nu).astype(idx_dtype)
    drop = {}
    if out_of_range:
        idx[:6] = [-1, -7, n_rows, n_rows + 5, -n_rows, 2 * n_rows]
        drop = {"mode": "drop", "wrap_negative_indices": False}
    vals = rng.standard_normal((nu, width)).astype(np.float32)
    vals_bf = torch.tensor(vals).to(torch.bfloat16)
    got = scatter_add_rows(torch.tensor(idx), vals_bf, n_rows)
    assert got.dtype == torch.bfloat16
    ref = jnp.zeros((n_rows, width)).at[jnp.asarray(idx)].add(
        jnp.asarray(vals_bf.float().numpy()), **drop).astype(jnp.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    # untouched rows are +0.0, bit for bit
    untouched = np.setdiff1d(np.arange(n_rows), idx)
    assert not got[torch.tensor(untouched)].view(torch.int16).any()


def test_scatter_drops_out_of_range_rows():
    """An index outside [0, n_rows) is dropped (the Pallas kernel would
    clamp it). Past the end this is XLA's `.at[].add` rule; a negative
    index, which JAX would wrap, is dropped too."""
    n_rows, width = 10, 4
    idx = torch.tensor([0, 3, 10, 11, 3])
    vals = torch.arange(20, dtype=torch.float32).reshape(5, 4)
    got = scatter_add_rows_plain(idx, vals, n_rows)
    ref = jnp.zeros((n_rows, width)).at[jnp.asarray(idx.numpy())].add(
        jnp.asarray(vals.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got[3].tolist() == (vals[1] + vals[4]).tolist()

    neg = scatter_add_rows(torch.tensor([-1, 2]), vals[:2], n_rows)
    assert not neg[n_rows - 1].any() and not neg[0].any()
    assert neg[2].tolist() == vals[1].tolist()


def test_scatter_checks_arguments_and_counts_only_kernel_launches():
    vals = torch.zeros(3, 4)
    with pytest.raises(TypeError):
        scatter_add_rows(torch.zeros(3), vals, 5)
    with pytest.raises(TypeError):
        scatter_add_rows(torch.zeros(3, dtype=torch.long),
                         vals.to(torch.float64), 5)
    with pytest.raises(ValueError):
        scatter_add_rows(torch.zeros(2, dtype=torch.long), vals, 5)
    before = scatter_add_rows.launches
    scatter_add_rows(torch.zeros(3, dtype=torch.long), vals, 5)
    assert scatter_add_rows.launches == before  # CPU: plain version


def test_staged_bf16_entry_runs_the_plain_version_on_the_cpu():
    """The first port's bf16 route, kept beside the workspace route: on
    CPU tensors it is the plain version, counts no launch and touches no
    workspace; it takes bf16 values only."""
    rng = np.random.default_rng(5)
    idx = torch.tensor(rng.integers(-2, 42, 64))
    vals = torch.tensor(rng.standard_normal((64, 24)),
                        dtype=torch.float32).to(torch.bfloat16)
    before = scatter_add_rows_bf16_staged.launches
    got = scatter_add_rows_bf16_staged(idx, vals, 40)
    assert scatter_add_rows_bf16_staged.launches == before
    assert torch.equal(got, scatter_add_rows_plain(idx, vals, 40))
    assert torch.equal(got, scatter_add_rows(idx, vals, 40))
    assert bf16_workspace("cpu") is None
    with pytest.raises(TypeError, match="bfloat16"):
        scatter_add_rows_bf16_staged(idx, vals.float(), 40)
