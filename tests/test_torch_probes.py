"""The H100 probes (`mneslam_tpu_torch/tools/prof_corr.py`,
`prof_scatter.py`) and their kernels' plain versions against the TPU probes
under `tools/`, on the CPU.

The TPU probes build their Pallas kernels when called; here every
`pl.pallas_call` runs in interpret mode (monkeypatched for the test), so
nothing under `tools/` changes. The tools are imported by path.

Tolerance: fp32 sums of at most a few dozen values, taken in another order
on each side: rtol 1e-5 / atol 1e-5. bf16 results: both sides round an
fp32 sum to bf16, so they may differ by one bf16 ulp (rtol 2^-7).
"""

import functools
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mneslam_tpu.ops import pallas_kernels as jpk
from mneslam_tpu_torch.kernels import corr_window as kcw
from mneslam_tpu_torch.kernels.scatter_add_rows import (
    scatter_add_rows, scatter_add_rows_per_warp, scatter_add_rows_plain)
from mneslam_tpu_torch.kernels.scatter_cluster import CLUSTERS
from mneslam_tpu_torch.kernels.scatter_rows_blocked import (
    scatter_add_rows_blocked, scatter_add_rows_blocked_plain)
from mneslam_tpu_torch.kernels.scatter_rows_bucketed import (
    bucket_route, cluster_route, scatter_add_rows_bucketed,
    scatter_add_rows_bucketed_plain, scatter_add_rows_bucketed_tiles)
from mneslam_tpu_torch.tools import (prof_corr, prof_scatter,
                                     scatter_ablation,
                                     scatter_bf16_ablation)
from test_torch_correlation import HT, WD, _kernel_inputs, _t

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-5
BF16_RTOL = 2.0 ** -7


def _tool(name):
    """A TPU probe under tools/, imported by path."""
    spec = importlib.util.spec_from_file_location(
        f"tpu_probe_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """Every pallas_call the TPU probes make runs in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _blk(n_rows, n_blocks):
    """The TPU probes' block height: ceil(n_rows / n_blocks) rounded up to
    a multiple of 8; the port's tile height for the same blocks."""
    blk = -(-n_rows // n_blocks)
    return -(-blk // 8) * 8


def _data(n_rows, nu, width, seed, out_of_range=True):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_rows, nu).astype(np.int32)
    idx[: nu // 4] = idx[nu // 4: 2 * (nu // 4)]        # duplicates
    if out_of_range:
        idx[:3] = [-1, -7, n_rows]                       # dropped
        idx[3] = n_rows + 40
    vals = rng.standard_normal((nu, width)).astype(np.float32)
    return idx, vals


def _close(got, ref, bf16=False):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32),
                               rtol=BF16_RTOL if bf16 else RTOL, atol=ATOL)


@pytest.mark.parametrize("n_blocks", [1, 3])
@pytest.mark.parametrize("unroll", [1, 8])
@pytest.mark.parametrize("n_rows,nu,width", [(100, 40, 16), (257, 97, 128)])
def test_blocked_matches_tpu_probe(interpret, n_blocks, unroll, n_rows, nu,
                                   width):
    """`make_pallas_scatter` (fp32, and bf16 through its fp32 kernel as the
    probe's `pallasF32acc`) against the blocked scatter over the same
    blocks; out-of-range indices dropped on both sides."""
    mod = _tool("prof_pallas_scatter")
    idx, vals = _data(n_rows, nu, width, seed=n_blocks + unroll)
    fn = mod.make_pallas_scatter(n_rows, nu, width, jnp.float32,
                                 n_blocks=n_blocks, unroll=unroll)
    t = _blk(n_rows, n_blocks)
    ref = np.asarray(fn(jnp.asarray(idx), jnp.asarray(vals)))
    got = scatter_add_rows_blocked(torch.tensor(idx), torch.tensor(vals),
                                   n_rows, t)
    assert got.shape == (n_rows, width) and got.dtype == torch.float32
    _close(got, ref)
    _close(scatter_add_rows_blocked_plain(torch.tensor(idx).long(),
                                          torch.tensor(vals), n_rows, t), ref)
    # bf16 values: the probe casts to fp32, scatters, casts back
    vb = jnp.asarray(vals).astype(jnp.bfloat16)
    ref16 = fn(jnp.asarray(idx), vb.astype(jnp.float32)).astype(jnp.bfloat16)
    got16 = scatter_add_rows_blocked(
        torch.tensor(idx), torch.tensor(np.asarray(vb.astype(jnp.float32)))
        .to(torch.bfloat16), n_rows, t)
    assert got16.dtype == torch.bfloat16
    _close(got16.float(), np.asarray(ref16.astype(jnp.float32)), bf16=True)


@pytest.mark.parametrize("n_buckets", [2, 4])
@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("n_rows,nu,width", [(120, 50, 16), (301, 88, 128)])
def test_bucketed_matches_tpu_probe(interpret, n_buckets, presorted, n_rows,
                                    nu, width):
    """`make_bucketed` (routed, and `presorted` on sorted inputs) against
    the bucketed scatter over the same buckets; indices below 0 fall
    before the first bucket, those past the last bucket after it, those in
    the last bucket's pad rows are sliced off: dropped on both sides."""
    mod = _tool("prof_scatter_bucketed")
    idx, vals = _data(n_rows, nu, width, seed=n_buckets)
    if presorted:
        order = np.argsort(idx, kind="stable")
        idx, vals = idx[order], vals[order]
    fn = mod.make_bucketed(n_rows, nu, width, jnp.float32, n_buckets,
                           presorted=presorted)
    ref = np.asarray(fn(jnp.asarray(idx), jnp.asarray(vals)))
    t = _blk(n_rows, n_buckets)
    got = scatter_add_rows_bucketed(torch.tensor(idx), torch.tensor(vals),
                                    n_rows, t, presorted=presorted)
    assert got.shape == (n_rows, width) and got.dtype == torch.float32
    _close(got, ref)
    _close(scatter_add_rows_bucketed_plain(torch.tensor(idx).long(),
                                           torch.tensor(vals), n_rows, t,
                                           presorted=presorted), ref)


def _clusters(bucket_rows):
    """The cluster sizes that split a bucket into whole tiles."""
    return [cl for cl in CLUSTERS if bucket_rows % cl == 0]


def _bf16_pair(fn, idx, vals):
    """The TPU probe's fp32 kernel on bf16-rounded values, its result
    rounded to bf16 (the probe's `pallasF32acc` rule); and those values as
    a bf16 tensor."""
    vb = jnp.asarray(vals).astype(jnp.bfloat16).astype(jnp.float32)
    ref = fn(jnp.asarray(idx), vb).astype(jnp.bfloat16).astype(jnp.float32)
    return np.asarray(ref), torch.tensor(np.asarray(vb)).to(torch.bfloat16)


@pytest.mark.parametrize("n_blocks", [1, 3])
@pytest.mark.parametrize("n_rows,nu,width", [(100, 40, 16), (257, 97, 128)])
def test_blocked_cluster_design_matches_tpu_probe(interpret, n_blocks, n_rows,
                                                  nu, width):
    """`make_pallas_scatter` against the cluster design's plain version and
    CPU path over buckets of cluster * tile_rows rows = the probe's block
    of n_rows / n_blocks rows, at every cluster size that divides it: fp32,
    and bf16 as the probe's `pallasF32acc`; duplicates, negative and
    out-of-range indices (dropped on both sides)."""
    mod = _tool("prof_pallas_scatter")
    idx, vals = _data(n_rows, nu, width, seed=10 + n_blocks)
    fn = mod.make_pallas_scatter(n_rows, nu, width, jnp.float32,
                                 n_blocks=n_blocks, unroll=8)
    ref = np.asarray(fn(jnp.asarray(idx), jnp.asarray(vals)))
    ref16, vals16 = _bf16_pair(fn, idx, vals)
    bucket = _blk(n_rows, n_blocks)
    ti, tv = torch.tensor(idx), torch.tensor(vals)
    for cl in _clusters(bucket):
        t = bucket // cl
        for got in (scatter_add_rows_blocked(ti, tv, n_rows, t, cl),
                    scatter_add_rows_blocked_plain(ti.long(), tv, n_rows, t,
                                                   cl)):
            assert got.shape == (n_rows, width) and got.dtype == torch.float32
            _close(got, ref)
        got16 = scatter_add_rows_blocked(ti, vals16, n_rows, t, cl)
        assert got16.dtype == torch.bfloat16
        _close(got16.float(), ref16, bf16=True)


@pytest.mark.parametrize("n_buckets", [2, 4])
@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("n_rows,nu,width", [(120, 50, 16), (301, 88, 128)])
def test_bucketed_cluster_design_matches_tpu_probe(interpret, n_buckets,
                                                   presorted, n_rows, nu,
                                                   width):
    """`make_bucketed` (routed, and `presorted` on sorted inputs) against
    the cluster design's plain version and CPU path over buckets of
    cluster * tile_rows rows = the probe's buckets, at every cluster size
    that divides them: fp32 and bf16 (values rounded to bf16, fp32 sums,
    one rounding at the end), negative and out-of-range indices dropped."""
    mod = _tool("prof_scatter_bucketed")
    idx, vals = _data(n_rows, nu, width, seed=20 + n_buckets)
    if presorted:
        order = np.argsort(idx, kind="stable")
        idx, vals = idx[order], vals[order]
    fn = mod.make_bucketed(n_rows, nu, width, jnp.float32, n_buckets,
                           presorted=presorted)
    ref = np.asarray(fn(jnp.asarray(idx), jnp.asarray(vals)))
    ref16, vals16 = _bf16_pair(fn, idx, vals)
    bucket = _blk(n_rows, n_buckets)
    ti, tv = torch.tensor(idx), torch.tensor(vals)
    for cl in _clusters(bucket):
        t = bucket // cl
        for got in (scatter_add_rows_bucketed(ti, tv, n_rows, t, presorted,
                                              cl),
                    scatter_add_rows_bucketed_plain(ti.long(), tv, n_rows, t,
                                                    presorted, cl)):
            assert got.shape == (n_rows, width) and got.dtype == torch.float32
            _close(got, ref)
        got16 = scatter_add_rows_bucketed(ti, vals16, n_rows, t, presorted,
                                          cl)
        assert got16.dtype == torch.bfloat16
        _close(got16.float(), ref16, bf16=True)


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_cluster_route_gathers_as_the_permuted_route(idx_dtype):
    """The cluster route permutes only the indices: gathering vals by its
    permutation gives the tile route's permuted vals up to the order of
    equal keys (the sort is stable: equal keys keep their input order),
    the same keys and offsets, and the same scatter. presorted=True skips
    the sort."""
    n_rows, nu, width = 300, 200, 16
    idx, vals = _data(n_rows, nu, width, seed=5)
    ti, tv = torch.tensor(idx).to(idx_dtype), torch.tensor(vals)
    idx_s, perm, off = cluster_route(ti, n_rows, 64)
    t_s, vals_s, t_off = bucket_route(ti, tv, n_rows, 64)
    assert torch.equal(idx_s, t_s) and torch.equal(off, t_off)
    assert perm.dtype == torch.int64 and torch.equal(ti[perm], idx_s)
    same = idx_s[1:] == idx_s[:-1]
    assert bool((perm[1:][same] > perm[:-1][same]).all())      # stable
    # each key's rows are the same multiset in both routes
    gathered = tv[perm]
    for key in idx_s.unique():
        a = gathered[idx_s == key]
        b = vals_s[idx_s == key]
        torch.testing.assert_close(a.sum(0), b.sum(0))
        assert a.shape == b.shape
    _close(scatter_add_rows_bucketed_plain(ti, tv, n_rows, 32, cluster=2),
           scatter_add_rows_bucketed_tiles(ti, tv, n_rows, 64))

    def no_sort(*args, **kwargs):
        raise AssertionError("presorted input was sorted again")

    s_idx, s_vals = ti[perm], tv[perm]
    ref = scatter_add_rows_plain(ti, tv, n_rows)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "sort", no_sort)
        p_idx, p_perm, p_off = cluster_route(s_idx, n_rows, 64,
                                             presorted=True)
        assert p_perm is None and torch.equal(p_idx, s_idx)
        assert torch.equal(p_off, off)
        _close(scatter_add_rows_bucketed(s_idx, s_vals, n_rows, 16,
                                         presorted=True, cluster=4), ref)


@pytest.mark.parametrize("fn", [scatter_add_rows_blocked,
                                scatter_add_rows_bucketed,
                                scatter_add_rows_blocked_plain,
                                scatter_add_rows_bucketed_plain])
def test_cluster_sizes_the_kernels_do_not_build_raise(fn):
    """A cluster size outside CLUSTERS, or a tile that does not fit shared
    memory, raises on the CPU path too (the CUDA path raises the same
    before any launch)."""
    idx = torch.tensor([0, 3, 3], dtype=torch.int64)
    vals = torch.ones(3, 128)
    for cl in (0, 1, 3, 32):
        with pytest.raises(ValueError, match="cluster"):
            fn(idx, vals, 10, 4, cluster=cl)
    for t in (0, 455):
        with pytest.raises(ValueError, match="shared memory"):
            fn(idx, vals, 10, t, cluster=2)
    assert fn(idx, vals, 10, 454, cluster=16)[3].sum() == 2 * 128


def test_probe_tile_load_and_route_bound():
    """`tile_load` reports the busiest 64-row tile and the busiest of the
    bucketed kernel's default buckets; `route_bound` counts the
    permutation and, only for the tile design's route, the permuted copy
    of vals."""
    bucket = prof_scatter.BUCKET_ROWS
    n_rows = 3 * bucket
    idx = torch.tensor([0, 1, 63, 64, bucket, bucket + 1, bucket + 2,
                        2 * bucket, -1, n_rows])
    load = prof_scatter.tile_load(idx, n_rows)
    assert load["tiles"] == n_rows // 64 and load["busiest"] == 3
    assert load["buckets"] == 3 and load["bucket_rows"] == bucket
    assert load["busiest_bucket"] == 4
    vals = torch.zeros(10, 128)
    plain, _ = prof_scatter.route_bound(idx, vals, n_rows, bucket)
    permuted, _ = prof_scatter.route_bound(idx, vals, n_rows, bucket, True)
    nbytes = 2 * 10 * 8 + 8 * 10 + 8 * 4
    assert plain == pytest.approx(1e3 * nbytes / 3.35e12)
    assert permuted - plain == pytest.approx(1e3 * 2 * 10 * 128 * 4 / 3.35e12)


@pytest.mark.parametrize("unroll", [8, 16, 32])
def test_serial_per_warp_matches_tpu_probe(interpret, unroll):
    """`make_serial` (kernel 1's Pallas body at unroll 8 / 16 / 32) against
    kernel 1's plain version and its per-warp variants. In-range indices
    only: that Pallas body clamps an index instead of dropping it."""
    mod = _tool("prof_scatter_bucketed")
    n_rows, nu, width = 203, 75, 128
    idx, vals = _data(n_rows, nu, width, seed=unroll, out_of_range=False)
    ref = np.asarray(mod.make_serial(n_rows, nu, width, jnp.float32, unroll)(
        jnp.asarray(idx), jnp.asarray(vals)))
    ti, tv = torch.tensor(idx), torch.tensor(vals)
    _close(scatter_add_rows_plain(ti, tv, n_rows), ref)
    _close(scatter_add_rows_per_warp(ti, tv, n_rows, unroll), ref)
    _close(scatter_add_rows(ti, tv, n_rows), ref)


def test_bucket_route_offsets():
    """The route: sorted keys, vals in the same order, offsets in idx's own
    dtype placed at every tile edge; int32 and int64 agree."""
    idx = torch.tensor([5, -2, 130, 64, 65, 300, 0, 127, 128],
                       dtype=torch.int32)
    vals = torch.arange(9, dtype=torch.float32)[:, None].expand(9, 4)
    for dt in (torch.int32, torch.int64):
        idx_s, vals_s, off = bucket_route(idx.to(dt), vals, 200, 64)
        assert idx_s.tolist() == [-2, 0, 5, 64, 65, 127, 128, 130, 300]
        assert vals_s[:, 0].tolist() == [1, 6, 0, 3, 4, 7, 8, 2, 5]
        assert off.tolist() == [1, 3, 6, 8, 8]       # 4 tiles of 64 rows
        assert off.dtype == torch.int64


@pytest.mark.parametrize("fn", [scatter_add_rows_blocked,
                                scatter_add_rows_bucketed])
def test_blocked_and_bucketed_edge_cases(fn):
    """nu = 0, all updates on one row, n_rows not a multiple of the tile,
    bad inputs rejected: on the CPU path, which the CUDA tests hold the
    kernels against."""
    empty = fn(torch.zeros(0, dtype=torch.int64), torch.zeros(0, 8), 10, 4)
    assert empty.shape == (10, 8) and not empty.any()
    idx = torch.full((50,), 9, dtype=torch.int64)
    vals = torch.randn(50, 8, generator=torch.Generator().manual_seed(0))
    got = fn(idx, vals, 10, 4)
    torch.testing.assert_close(got[9], vals.sum(0))
    assert not got[:9].any()
    with pytest.raises(ValueError, match="shared memory"):
        fn(idx, vals, 10, 10_000)
    with pytest.raises(TypeError):
        fn(idx.float(), vals, 10)
    with pytest.raises(ValueError):
        fn(idx[:3], vals, 10)


@pytest.mark.parametrize("unroll", kcw.UNROLLS)
def test_unrolled_corr_matches_pallas_interpret(unroll):
    """The unrolled wrapper's CPU path against the JAX multi-level kernel
    (the base of the TPU probes' variants) in interpret mode, masked edge
    included."""
    f1, levels, w2ps, xs = _kernel_inputs(0)
    ii = np.array([0, 1, 0, 2], np.int32)
    jj = np.array([1, 2, 2, 0], np.int32)
    mask = np.array([1, 0, 1, 1], np.int32)
    xs4 = jnp.concatenate([xs, xs[:1]])
    ref = jpk.corr_window_int_multilevel(
        f1, levels, jnp.asarray(ii), jnp.asarray(jj), xs4, 8, tuple(w2ps),
        mask=jnp.asarray(mask), interpret=True)
    got = kcw.corr_window_multilevel_unrolled(
        _t(f1), [_t(lv) for lv in levels], _t(ii), _t(jj),
        _t(xs4).contiguous(), w2ps, mask=_t(mask), unroll=unroll)
    assert got.shape == (4, HT * WD, 4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    assert not got[1].any()


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("bf16", [False, True])
def test_scatter_probe_runs_on_cpu(capsys, bf16):
    """The probe end to end with --device cpu at a small size: every
    variant of the TPU probes' lists has its counterparts, each correct."""
    rc = prof_scatter.main(["--device", "cpu", "--small"]
                           + (["--bf16"] if bf16 else []))
    res = _last_json(capsys.readouterr().out)
    assert rc == 0 and res["failed"] == [] and res["device"] == "cpu"
    # the lists of tools/prof_pallas_scatter.py and prof_scatter_bucketed.py
    tpu = (["xla", "pallasU8", "pallasF32acc"]
           + [f"serialU{u}" for u in (8, 16, 32)]
           + [f"bucket{b}{s}" for b in (2, 4, 8, 16)
              for s in ("", "_presorted")])
    for tag, _, _ in prof_scatter.SHAPES:
        for name in tpu:
            for h100 in prof_scatter.TPU_COUNTERPARTS[name]:
                v = res[f"{tag}/{h100}"]
                assert v["err_ratio"] <= 1.0 and v["ms"] > 0, (tag, h100)
        for extra in ("kernel1", "route", "blocked_plain", "bucket_plain"):
            assert isinstance(res[f"{tag}/{extra}"], dict)


def test_corr_probe_runs_on_cpu(capsys):
    rc = prof_corr.main(["--device", "cpu", "--small"])
    res = _last_json(capsys.readouterr().out)
    assert rc == 0 and res["failed"] == []
    for name, h100s in prof_corr.TPU_COUNTERPARTS.items():
        for h100 in h100s:
            assert res[h100]["err_ratio"] <= 1.0, name
    # the unrolled variants equal the row design they unroll, bit for bit
    assert all(res[f"kernel2+skip u{u}"]["equal_to_rows"]
               for u in kcw.UNROLLS)
    assert len(res["box_share"]) == 4


def test_probe_failure_exits_nonzero(capsys, monkeypatch):
    """A wrong variant is printed and makes the probe exit non-zero (both
    blocked designs made wrong: the cluster design and the tile design)."""
    def wrong(idx, vals, n, *sizes):
        return 2 * scatter_add_rows_plain(idx, vals, n)

    monkeypatch.setattr(prof_scatter, "scatter_add_rows_blocked", wrong)
    monkeypatch.setattr(prof_scatter, "scatter_add_rows_blocked_tiles", wrong)
    rc = prof_scatter.main(["--device", "cpu", "--small"])
    out = capsys.readouterr().out
    res = _last_json(out)
    assert rc == 1 and "WRONG" in out
    assert "fine@11.5k/blockedT64" in res["failed"]
    t, cl = prof_scatter.CONFIGS[0]
    assert f"fine@11.5k/blockedT{t}C{cl}" in res["failed"]


def test_bf16_ablation_variants_are_in_the_source():
    """Each variant of the bf16 route's ablation changes text found once
    in kernel 1's source (so an edit of the kernel cannot leave a variant
    silently equal to the base)."""
    from mneslam_tpu_torch.kernels import build

    with open(os.path.join(build.CSRC, "scatter_add_rows.cu")) as f:
        src = f.read()
    for name, subs in scatter_bf16_ablation.VARIANTS.items():
        for text, repl in subs:
            assert src.count(text) == 1 and text != repl, name


@pytest.mark.parametrize("probe", [prof_corr, prof_scatter,
                                   scatter_ablation, scatter_bf16_ablation])
def test_probes_raise_without_a_gpu(probe):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the probe would run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        probe.main([])
