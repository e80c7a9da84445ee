"""H100 probe of the row scatter's designs, at the mapping backward's shapes.

    python -m mneslam_tpu_torch.tools.prof_scatter [--bf16] [--device cpu] [--small]

The counterpart of the two TPU probes `tools/prof_pallas_scatter.py` and
`tools/prof_scatter_bucketed.py`, with their shapes (width 128; the five
(rows, updates) shapes of the first, which include the three of the
second) and their variant lists. Each TPU variant and its H100 counterpart:

  TPU probe variant            H100 variant (this probe)
  xla                          xla: one `index_add_` into a zeroed table in
                               vals' dtype (with --bf16 a bf16 table, as
                               the TPU's bf16 `.at[].add`)
  pallasU8 (one VMEM block,    blockedT{64,128,256,384}: the blocked kernel
  8-wide unroll), and the      (`kernels/scatter_rows_blocked.py`), one
  docstring's pallas1 /        block per tile of T rows in shared memory;
  pallasB<k> / pallasU         T stands in for the TPU's n_blocks
  pallasF32acc (--bf16)        blockedT{...} with --bf16: bf16 values
                               summed in fp32 in shared memory
  serialU8 / U16 / U32         serialU8 / U16 / U32: kernel 1 with 8, 16, 32
                               updates per warp (`scatter_add_rows_per_warp`)
  bucket{2,4,8,16}             bucketT{64,128,256,384}: the bucketed kernel
                               (`kernels/scatter_rows_bucketed.py`) with its
                               route; a TPU bucket of 10k-80k rows does not
                               fit a block, a tile of T rows does
  bucket{b}_presorted          bucketT{...}_presorted: inputs sorted first,
                               the route's sort skipped
Added here: kernel1 (the production entry `scatter_add_rows`, the yardstick
of every variant), route (the bucketed route alone: sort, permute,
offsets, so that route and walk can be told apart), blocked_plain and
bucket_plain (the plain versions at T = 64), the spread of the updates
over tiles (`tile_load`), and every case the caller
passes to `run(cases=...)` (`chip_smoke.py` passes the mapping path's real
index stream).

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
from ..kernels.scatter_rows_blocked import (DEFAULT_TILE_ROWS, n_tiles,
                                            scatter_add_rows_blocked,
                                            scatter_add_rows_blocked_plain)
from ..kernels.scatter_rows_bucketed import (bucket_route,
                                             scatter_add_rows_bucketed,
                                             scatter_add_rows_bucketed_plain)
from .measure import bound_ms, graph_ms, median_ms

WIDTH = 128
SHAPES = (("fine@11.5k", 160801, 11567), ("coarse@11.5k", 40401, 11567),
          ("fine@5.8k", 160801, 5784), ("fine@23k", 160801, 23134),
          ("fine@92k", 160801, 92536))
SMALL = 400                 # --small: rows and updates divided by this
TILES = (64, 128, 256, 384)
PER_WARP = (8, 16, 32)
K = 20                      # calls per timed run
WALLS = 5                   # timed runs; the median is reported
SCATTER_RTOL = 5e-5
SCATTER_ATOL = 1e-6

# each TPU probe variant -> the names of its H100 counterparts
TPU_COUNTERPARTS = {
    "xla": ["xla"],
    "pallasU8": [f"blockedT{t}" for t in TILES],
    "pallasF32acc": [f"blockedT{t}" for t in TILES],
    **{f"serialU{u}": [f"serialU{u}"] for u in PER_WARP},
    **{f"bucket{b}": [f"bucketT{t}" for t in TILES] for b in (2, 4, 8, 16)},
    **{f"bucket{b}_presorted": [f"bucketT{t}_presorted" for t in TILES]
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


def route_bound(idx: torch.Tensor, vals: torch.Tensor, n_rows: int):
    """The route's bytes: idx and vals read once, sorted idx, the
    permutation (int64), permuted vals and the offsets written once."""
    nu, width = vals.shape
    nt = n_tiles(n_rows, DEFAULT_TILE_ROWS)
    nbytes = (2 * nu * idx.element_size() + 8 * nu
              + 2 * nu * width * vals.element_size() + 8 * (nt + 1))
    return bound_ms(nbytes)


def tile_load(idx: torch.Tensor, n_rows: int) -> Dict:
    """How the updates spread over tiles of DEFAULT_TILE_ROWS rows: the
    tiles, those that hold updates, and the most updates one tile holds
    (the blocked and bucketed kernels work a tile on one SM)."""
    nt = n_tiles(n_rows, DEFAULT_TILE_ROWS)
    keep = (idx >= 0) & (idx < n_rows)
    count = torch.bincount(idx[keep].long() // DEFAULT_TILE_ROWS,
                           minlength=nt)
    return {"tiles": nt, "hit": int((count > 0).sum()),
            "busiest": int(count.max()) if nt else 0}


def _variants(idx, vals, n_rows, idx_s, vals_s
              ) -> List[Tuple[str, Callable[[], torch.Tensor]]]:
    dev, dtype = vals.device, vals.dtype
    out = [("xla", lambda: torch.zeros((n_rows, vals.shape[1]), dtype=dtype,
                                       device=dev).index_add_(0, idx, vals)),
           ("kernel1", lambda: scatter_add_rows(idx, vals, n_rows))]
    out += [(f"serialU{u}", lambda u=u: scatter_add_rows_per_warp(
        idx, vals, n_rows, u)) for u in PER_WARP]
    out += [(f"blockedT{t}", lambda t=t: scatter_add_rows_blocked(
        idx, vals, n_rows, t)) for t in TILES]
    out += [(f"bucketT{t}", lambda t=t: scatter_add_rows_bucketed(
        idx, vals, n_rows, t)) for t in TILES]
    out += [(f"bucketT{t}_presorted", lambda t=t: scatter_add_rows_bucketed(
        idx_s, vals_s, n_rows, t, presorted=True)) for t in TILES]
    out += [("blocked_plain", lambda: scatter_add_rows_blocked_plain(
                idx, vals, n_rows, DEFAULT_TILE_ROWS)),
            ("bucket_plain", lambda: scatter_add_rows_bucketed_plain(
                idx, vals, n_rows, DEFAULT_TILE_ROWS))]
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


def _check_route(idx, vals, n_rows):
    idx_s, vals_s, off = bucket_route(idx, vals, n_rows, DEFAULT_TILE_ROWS)
    ok = (bool((idx_s[1:] >= idx_s[:-1]).all())
          and bool((off[1:] >= off[:-1]).all())
          and off.shape[0] == n_tiles(n_rows, DEFAULT_TILE_ROWS) + 1)
    return idx_s, vals_s, off, ok


def _fmt(g_ms):
    return "not measured" if g_ms is None else f"{g_ms:.4f} ms"


def run(device="cuda", bf16: bool = False, small: bool = False,
        cases: Iterable[Case] = (), reps: int = None, walls: int = None,
        log: Callable[[str], None] = print) -> Dict:
    """Check, then time, every variant on the TPU probes' shapes and on
    each extra case (tag, idx, vals, n_rows) -> {"device", "bf16", "failed":
    [names], "<tag>/<variant>": {"ms", "bound_ms", "bound_by",
    "max_abs_err", "err_ratio"} or "wrong: ..." / "failed: ..."}."""
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
        results[f"{tag}/tiles"] = tiles = tile_load(idx, n_rows)
        log(f"{tag}: {idx.shape[0]} updates into {n_rows} rows; tiles of "
            f"{DEFAULT_TILE_ROWS} rows: {tiles['hit']} of {tiles['tiles']} "
            f"hold updates, the busiest {tiles['busiest']}")
        ref = scatter_add_rows_plain(idx, vals, n_rows)
        mag = scatter_add_rows_plain(idx, vals.float().abs(), n_rows)
        idx_s, vals_s, _, route_ok = _check_route(idx, vals, n_rows)
        for name, fn in _variants(idx, vals, n_rows, idx_s, vals_s):
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
        full = f"{tag}/route"
        if not route_ok:
            log(f"{full:40s} WRONG (unsorted keys or offsets)")
            results[full] = "wrong: unsorted keys or offsets"
            results["failed"].append(full)
            continue
        route = lambda: bucket_route(idx, vals, n_rows, DEFAULT_TILE_ROWS)
        ms = median_ms(route, dev, reps, walls)
        g_ms = graph_ms(route, reps, walls) if on_gpu else None
        b_ms, by = route_bound(idx, vals, n_rows)
        results[full] = {"ms": ms, "graph_ms": g_ms, "bound_ms": b_ms,
                         "bound_by": by}
        log(f"{full:40s} {ms:9.4f} ms/call  device {_fmt(g_ms)}  bound "
            f"{b_ms:.4f} ms ({by})  (sort + index_select + searchsorted)")
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
