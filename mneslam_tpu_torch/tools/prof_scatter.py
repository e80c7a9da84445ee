"""H100 probe of the row scatter's designs, at the mapping backward's shapes.

    python -m mneslam_tpu_torch.tools.prof_scatter [--bf16] [--device cpu] [--small]

The counterpart of the two TPU probes `tools/prof_pallas_scatter.py` and
`tools/prof_scatter_bucketed.py`, with their shapes (width 128; the five
(rows, updates) shapes of the first, which include the three of the
second) and their variant lists. Each TPU variant and its H100 counterparts:

  TPU probe variant            H100 variant (this probe)
  xla                          xla: one `index_add_` into a zeroed table in
                               vals' dtype (with --bf16 a bf16 table, as
                               the TPU's bf16 `.at[].add`)
  pallasU8 (one VMEM block,    blockedT{T}C{CL}: the blocked kernel in the
  8-wide unroll), and the      cluster design (`scatter_add_rows_blocked`),
  docstring's pallas1 /        one cluster of CL blocks per bucket of
  pallasB<k> / pallasU         CL x T rows, T rows per block in shared
                               memory; the bucket stands in for the TPU's
                               n_blocks. blockedT64: the tile design of
                               the first port
                               (`scatter_add_rows_blocked_tiles`), one
                               block per tile of 64 rows
  pallasF32acc (--bf16)        the same with --bf16: bf16 values summed in
                               fp32 in shared memory
  serialU8 / U16 / U32         serialU8 / U16 / U32: kernel 1 with 8, 16, 32
                               updates per warp (`scatter_add_rows_per_warp`)
  bucket{2,4,8,16}             bucketT{T}C{CL}: the bucketed kernel in the
                               cluster design (`scatter_add_rows_bucketed`)
                               with its route; bucketT64: the tile
                               design (`scatter_add_rows_bucketed_tiles`)
                               with its route. A TPU bucket of 10k-80k rows
                               does not fit a block or a cluster
  bucket{b}_presorted          bucketT{...}_presorted: inputs sorted first,
                               the route's sort skipped
The cluster configurations are CONFIGS (T x CL); on a GPU only those for
which cudaOccupancyMaxActiveClusters reports at least 1 run, and the count
is printed for each; the default (T, CL) must be among them, or the probe
fails. The tile design runs at TILES.
Added here: kernel1 (the production entry `scatter_add_rows`, the yardstick
of every variant), route (the cluster design's route alone: stable sort,
offsets; no permuted copy of vals) and route_tiles (the tile design's:
sort, permute vals, offsets), so that route and walk can be told apart,
blocked_plain and bucket_plain (the plain versions at the default
(T, CL)), the spread of the updates (`tile_load`: over tiles of 64 rows
and over the default buckets), and every case the caller passes
to `run(cases=...)` (`chip_smoke.py` passes the mapping path's real index
stream).

Protocol: each variant is first checked against the plain float32 sums
(`scatter_add_rows_plain`), per output within SCATTER_RTOL x the sum of the
magnitudes added into it + SCATTER_ATOL (atomics add a row's updates in a
run-dependent order), plus one bf16 ulp (2^-7 x |result|) for a bf16 result
and, for the bf16 `index_add_`, 2^-8 x (updates into the row) x that sum (it
rounds to bf16 at every addition). Then it is timed: CUDA events around K
calls after a warm-up, the median of 5 (ms: what a caller pays, the
wrapper's host work included); on a GPU, every variant but the plain ones
also once more as K calls captured in one CUDA graph and replayed (device:
the device time per call without the host). Each line gives both, the
bound (bytes at 3.35 TB/s: the table written once, vals and idx read once)
and the error ratio. The last line is a JSON dict of the results. A wrong
or failing variant is printed, and the probe then exits non-zero. Without
`--device cpu` it runs on the GPU and raises without one; on the CPU every
variant runs its plain version and the times are host-clock times.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.scatter_add_rows import (scatter_add_rows,
                                        scatter_add_rows_per_warp,
                                        scatter_add_rows_plain)
from ..kernels import scatter_rows_blocked, scatter_rows_bucketed
from ..kernels.scatter_cluster import (DEFAULT_CLUSTER, DEFAULT_TILE_ROWS,
                                       n_tiles)
from ..kernels.scatter_rows_blocked import (
    scatter_add_rows_blocked, scatter_add_rows_blocked_plain,
    scatter_add_rows_blocked_tiles)
from ..kernels.scatter_rows_bucketed import (
    bucket_route, cluster_route, scatter_add_rows_bucketed,
    scatter_add_rows_bucketed_plain, scatter_add_rows_bucketed_tiles)
from .measure import bound_ms, graph_ms, median_ms

WIDTH = 128
SHAPES = (("fine@11.5k", 160801, 11567), ("coarse@11.5k", 40401, 11567),
          ("fine@5.8k", 160801, 5784), ("fine@23k", 160801, 23134),
          ("fine@92k", 160801, 92536))
SMALL = 400                 # --small: rows and updates divided by this
TILES = (64,)   # the tile design, at its fastest tile of 64-384 (PERF.md)
CONFIGS = tuple((t, cl) for t in (224, 448) for cl in (4, 8, 16))  # T, CL
TILE_LOAD_ROWS = 64             # the tile of `tile_load`'s busiest tile
BUCKET_ROWS = DEFAULT_CLUSTER * DEFAULT_TILE_ROWS   # the default bucket
PER_WARP = (8, 16, 32)
K = 20                      # calls per timed run
WALLS = 5                   # timed runs; the median is reported
SCATTER_RTOL = 5e-5
SCATTER_ATOL = 1e-6

# each TPU probe variant -> the names of its H100 counterparts
BLOCKED = [f"blockedT{t}C{cl}" for t, cl in CONFIGS] + [
    f"blockedT{t}" for t in TILES]
BUCKETED = [f"bucketT{t}C{cl}" for t, cl in CONFIGS] + [
    f"bucketT{t}" for t in TILES]
TPU_COUNTERPARTS = {
    "xla": ["xla"],
    "pallasU8": BLOCKED,
    "pallasF32acc": BLOCKED,
    **{f"serialU{u}": [f"serialU{u}"] for u in PER_WARP},
    **{f"bucket{b}": BUCKETED for b in (2, 4, 8, 16)},
    **{f"bucket{b}_presorted": [f"{v}_presorted" for v in BUCKETED]
       for b in (2, 4, 8, 16)},
}

Case = Tuple[str, torch.Tensor, torch.Tensor, int]


def synthetic_cases(device: torch.device, dtype: torch.dtype,
                    small: bool = False, seed: int = 0) -> List[Case]:
    """The TPU probes' shapes: uniform random rows (int32), normal values,
    made from a numpy seed."""
    rng = np.random.default_rng(seed)
    div = SMALL if small else 1
    cases = []
    for tag, n_rows, nu in SHAPES:
        n_rows, nu = max(n_rows // div, 1), max(nu // div, 1)
        idx = rng.integers(0, n_rows, nu).astype(np.int32)
        vals = rng.standard_normal((nu, WIDTH)).astype(np.float32)
        cases.append((tag, torch.as_tensor(idx, device=device),
                      torch.as_tensor(vals, device=device).to(dtype),
                      n_rows))
    return cases


def scatter_bound(idx: torch.Tensor, vals: torch.Tensor, n_rows: int):
    """The function's bytes: the table written once in vals' dtype, vals
    and idx read once; one add per value -> (ms, bound_by)."""
    nu, width = vals.shape
    nbytes = (n_rows * width * vals.element_size()
              + nu * width * vals.element_size() + nu * idx.element_size())
    return bound_ms(nbytes, nu * width)


def route_bound(idx: torch.Tensor, vals: torch.Tensor, n_rows: int,
                bucket_rows: int, permute_vals: bool = False):
    """The route's bytes: idx read once, the sorted idx, the permutation
    (int64) and the offsets written once; with `permute_vals` (the tile
    design's route) also vals read and its permuted copy written."""
    nu, width = vals.shape
    nb = n_tiles(n_rows, bucket_rows)
    nbytes = 2 * nu * idx.element_size() + 8 * nu + 8 * (nb + 1)
    if permute_vals:
        nbytes += 2 * nu * width * vals.element_size()
    return bound_ms(nbytes)


def tile_load(idx: torch.Tensor, n_rows: int) -> Dict:
    """How the updates spread: over tiles of TILE_LOAD_ROWS rows (the tile
    design works a tile on one SM): the tiles, those that hold updates,
    the most one tile holds; over the default buckets (BUCKET_ROWS rows,
    one cluster each): the buckets, their rows, the most one bucket
    holds."""
    keep = (idx >= 0) & (idx < n_rows)
    rows = idx[keep].long()

    def counts(size):
        return torch.bincount(rows // size, minlength=n_tiles(n_rows, size))

    tiles = counts(TILE_LOAD_ROWS)
    buckets = counts(BUCKET_ROWS)
    return {"tiles": tiles.numel(), "hit": int((tiles > 0).sum()),
            "busiest": int(tiles.max()) if tiles.numel() else 0,
            "buckets": buckets.numel(), "bucket_rows": BUCKET_ROWS,
            "busiest_bucket": int(buckets.max()) if buckets.numel() else 0}


def cluster_occupancy(vals: torch.Tensor, idx: torch.Tensor) -> Dict:
    """cudaOccupancyMaxActiveClusters of both cluster kernels at every
    configuration of CONFIGS, for these inputs' dtypes -> {"blockedT{T}C
    {CL}" / "bucketT{T}C{CL}": clusters}."""
    width = vals.shape[1]
    return {f"{name}T{t}C{cl}": module.max_active_clusters(
                width, t, cl, vals.dtype, idx.dtype)
            for name, module in (("blocked", scatter_rows_blocked),
                                 ("bucket", scatter_rows_bucketed))
            for t, cl in CONFIGS}


def _variants(idx, vals, n_rows, idx_s, vals_s, runs=lambda name: True
              ) -> List[Tuple[str, Callable[[], torch.Tensor]]]:
    """Every variant on these inputs; `runs(name)` False leaves a cluster
    configuration out (one the card cannot hold)."""
    dev, dtype = vals.device, vals.dtype
    out = [("xla", lambda: torch.zeros((n_rows, vals.shape[1]), dtype=dtype,
                                       device=dev).index_add_(0, idx, vals)),
           ("kernel1", lambda: scatter_add_rows(idx, vals, n_rows))]
    out += [(f"serialU{u}", lambda u=u: scatter_add_rows_per_warp(
        idx, vals, n_rows, u)) for u in PER_WARP]
    for t, cl in CONFIGS:
        if runs(f"blockedT{t}C{cl}"):
            out.append((f"blockedT{t}C{cl}",
                        lambda t=t, cl=cl: scatter_add_rows_blocked(
                            idx, vals, n_rows, t, cl)))
        if runs(f"bucketT{t}C{cl}"):
            out += [(f"bucketT{t}C{cl}",
                     lambda t=t, cl=cl: scatter_add_rows_bucketed(
                         idx, vals, n_rows, t, cluster=cl)),
                    (f"bucketT{t}C{cl}_presorted",
                     lambda t=t, cl=cl: scatter_add_rows_bucketed(
                         idx_s, vals_s, n_rows, t, presorted=True,
                         cluster=cl))]
    out += [(f"blockedT{t}", lambda t=t: scatter_add_rows_blocked_tiles(
        idx, vals, n_rows, t)) for t in TILES]
    out += [(f"bucketT{t}", lambda t=t: scatter_add_rows_bucketed_tiles(
        idx, vals, n_rows, t)) for t in TILES]
    out += [(f"bucketT{t}_presorted",
             lambda t=t: scatter_add_rows_bucketed_tiles(
                 idx_s, vals_s, n_rows, t, presorted=True)) for t in TILES]
    out += [("blocked_plain", lambda: scatter_add_rows_blocked_plain(
                idx, vals, n_rows)),
            ("bucket_plain", lambda: scatter_add_rows_bucketed_plain(
                idx, vals, n_rows))]
    return out


def _tolerance(name, idx, vals, n_rows, ref, mag):
    tol = SCATTER_RTOL * mag + SCATTER_ATOL
    if vals.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * ref.float().abs()
        if name == "xla":
            keep = (idx >= 0) & (idx < n_rows)
            count = torch.bincount(idx[keep].long(), minlength=n_rows)
            tol = tol + 2.0 ** -8 * count[:, None].float() * mag
    return tol


def _routes(idx, vals, n_rows):
    """Both routes at their default sizes, checked -> (idx sorted, vals in
    that order, ok, {name: the route as a function})."""
    bucket = BUCKET_ROWS
    idx_s, perm, off = cluster_route(idx, n_rows, bucket)
    t_s, vals_s, t_off = bucket_route(idx, vals, n_rows, TILES[0])
    ok = (bool((idx_s[1:] >= idx_s[:-1]).all())
          and bool((idx[perm] == idx_s).all())
          and bool((perm.sort().values == torch.arange(
              perm.numel(), device=perm.device)).all())
          and bool((t_s == idx_s).all())
          and bool((off[1:] >= off[:-1]).all())
          and off.shape[0] == n_tiles(n_rows, bucket) + 1
          and t_off.shape[0] == n_tiles(n_rows, TILES[0]) + 1)
    return t_s, vals_s, ok, {
        "route": (lambda: cluster_route(idx, n_rows, bucket), bucket, False),
        "route_tiles": (lambda: bucket_route(idx, vals, n_rows, TILES[0]),
                        TILES[0], True)}


def _fmt(g_ms):
    return "not measured" if g_ms is None else f"{g_ms:.4f} ms"


def run(device="cuda", bf16: bool = False, small: bool = False,
        cases: Iterable[Case] = (), reps: int = None, walls: int = None,
        log: Callable[[str], None] = print) -> Dict:
    """Check, then time, every variant on the TPU probes' shapes and on
    each extra case (tag, idx, vals, n_rows) ->
    {"device", "bf16", "failed": [names], "max_active_clusters" (on a
    GPU), "<tag>/tiles": `tile_load`, "<tag>/<variant>": {"ms",
    "graph_ms", "bound_ms", "bound_by", "max_abs_err", "err_ratio"} or
    "wrong: ..." / "failed: ..."}."""
    dev = resolve_device(device)
    dtype = torch.bfloat16 if bf16 else torch.float32
    on_gpu = dev.type == "cuda"
    reps = (K if on_gpu else 1) if reps is None else reps
    walls = (WALLS if on_gpu else 1) if walls is None else walls
    kind = torch.cuda.get_device_name(dev) if on_gpu else "cpu"
    log(f"device={kind} ({'CUDA events' if on_gpu else 'host clock'})  "
        f"K={reps}  median of {walls}  width={WIDTH}  "
        f"dtype={str(dtype).replace('torch.', '')}")
    results: Dict = {"device": kind, "bf16": bf16, "failed": []}
    all_cases = synthetic_cases(dev, dtype, small) + [
        (tag, i.to(dev), v.to(dev), n) for tag, i, v, n in cases]
    for tag, idx, vals, n_rows in all_cases:
        results[f"{tag}/tiles"] = load = tile_load(idx, n_rows)
        log(f"{tag}: {idx.shape[0]} updates into {n_rows} rows; tiles of "
            f"{TILE_LOAD_ROWS} rows: {load['hit']} of {load['tiles']} "
            f"hold updates, the busiest {load['busiest']}; buckets of "
            f"{load['bucket_rows']} rows: {load['buckets']}, the busiest "
            f"{load['busiest_bucket']}")
        occ = cluster_occupancy(vals, idx) if on_gpu else None
        if occ is not None and occ != results.get("max_active_clusters"):
            results["max_active_clusters"] = occ
            log("cudaOccupancyMaxActiveClusters (idx "
                f"{str(idx.dtype).replace('torch.', '')}): "
                + ", ".join(f"{k} {v}" for k, v in occ.items()))
        ref = scatter_add_rows_plain(idx, vals, n_rows)
        mag = scatter_add_rows_plain(idx, vals.float().abs(), n_rows)
        idx_s, vals_s, route_ok, routes = _routes(idx, vals, n_rows)
        runs = (lambda name: True) if occ is None else (
            lambda name: occ[name] >= 1)
        for name in ("blocked", "bucket"):
            default = f"{name}T{DEFAULT_TILE_ROWS}C{DEFAULT_CLUSTER}"
            if not runs(default):
                log(f"{tag + '/' + default:40s} FAILED: the card holds no "
                    f"cluster of the default configuration")
                results[f"{tag}/{default}"] = "failed: the card holds no " \
                                              "cluster of it"
                results["failed"].append(f"{tag}/{default}")
        for name, fn in _variants(idx, vals, n_rows, idx_s, vals_s, runs):
            full = f"{tag}/{name}"
            try:
                got = fn()
                err = (got.float() - ref.float()).abs()
                tol = _tolerance(name, idx, vals, n_rows, ref, mag)
                ratio = float((err / tol).max()) if err.numel() else 0.0
                if got.shape != ref.shape or got.dtype != ref.dtype \
                        or not ratio <= 1.0:
                    log(f"{full:40s} WRONG (err / tolerance {ratio:.3g})")
                    results[full] = f"wrong: err / tolerance {ratio:.3g}"
                    results["failed"].append(full)
                    continue
                ms = median_ms(fn, dev, reps, walls)
                g_ms = (graph_ms(fn, reps, walls)
                        if on_gpu and not name.endswith("_plain") else None)
                b_ms, by = scatter_bound(idx, vals, n_rows)
            except Exception as e:  # noqa: BLE001 — reported, then exit 1
                msg = str(e).split("\n")[0][:160]
                log(f"{full:40s} FAILED: {msg}")
                results[full] = f"failed: {msg}"
                results["failed"].append(full)
                continue
            results[full] = {"ms": ms, "graph_ms": g_ms, "bound_ms": b_ms,
                             "bound_by": by, "max_abs_err": float(err.max())
                             if err.numel() else 0.0,
                             "err_ratio": ratio}
            log(f"{full:40s} {ms:9.4f} ms/call  device {_fmt(g_ms)}  bound "
                f"{b_ms:.4f} ms ({by})  err/tol {ratio:.3g}")
        if not route_ok:
            for name in routes:
                log(f"{tag + '/' + name:40s} WRONG (unsorted keys, offsets "
                    f"or permutation)")
                results[f"{tag}/{name}"] = "wrong: unsorted keys, offsets " \
                                           "or permutation"
                results["failed"].append(f"{tag}/{name}")
            continue
        for name, (route, rows, permute) in routes.items():
            ms = median_ms(route, dev, reps, walls)
            g_ms = graph_ms(route, reps, walls) if on_gpu else None
            b_ms, by = route_bound(idx, vals, n_rows, rows, permute)
            results[f"{tag}/{name}"] = {"ms": ms, "graph_ms": g_ms,
                                        "bound_ms": b_ms, "bound_by": by}
            log(f"{tag + '/' + name:40s} {ms:9.4f} ms/call  device "
                f"{_fmt(g_ms)}  bound {b_ms:.4f} ms ({by})  (sort"
                f"{' + index_select' if permute else ''} + searchsorted, "
                f"buckets of {rows} rows)")
    return results


def main(argv: Sequence[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 values (sums in float32)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--small", action="store_true",
                    help=f"rows and updates divided by {SMALL}, for a quick "
                         f"run on the CPU")
    args = ap.parse_args(argv)
    results = run(args.device, bf16=args.bf16, small=args.small)
    print(json.dumps(results), flush=True)
    return 1 if results["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
