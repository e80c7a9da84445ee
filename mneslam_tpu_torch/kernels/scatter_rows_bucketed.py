"""`zeros((n_rows, width)).index_add_(0, idx, vals)` over updates sorted
into row buckets.

Port of the Pallas kernel of the TPU probe tools/prof_scatter_bucketed.py
(`make_bucketed`: argsort + permute + `searchsorted` offsets outside the
kernel, then a grid over row-range buckets, each walking only its sorted
update range; `presorted=True` is the probe's `bucket{b}_presorted`). On a
CUDA tensor the wrapper `scatter_add_rows_bucketed` runs the route
(`cluster_route`: a stable sort of idx and `searchsorted` at the bucket
edges; vals is not permuted) and launches the hand-written kernel in
`csrc/scatter_rows_bucketed.cu` (or raises) in the cluster design: a
thread-block cluster of `cluster` blocks owns a bucket of
`cluster * tile_rows` rows, each block `tile_rows` of them in shared
memory, the bucket's sorted range split evenly over the cluster's warps,
each reading vals[perm[i]] where it lies (`csrc/scatter_cluster.cuh`). The
first port's tile design (one block per tile over vals permuted by the
route `bucket_route`) stays reachable as `scatter_add_rows_bucketed_tiles`,
so that one run can time both. On a CPU tensor both run the same route and
the plain PyTorch version below. There is no size gate and no fallback.

Contract, the same on both paths and the same as `scatter_add_rows`: idx
[nu] int32 or int64, vals [nu, width] float32 or bfloat16, result
[n_rows, width] in vals' dtype, with sums taken in float32. An idx outside
[0, n_rows) falls outside every bucket's range (a negative one sorts to the
front, before the first bucket), or into the last bucket's pad rows, and
is dropped. With `presorted=True` the caller passes idx sorted ascending
and vals in the same order; the route's sort is skipped.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .scatter_add_rows import _check
from .scatter_cluster import (TILES_TILE_ROWS, check_cluster, check_tile,
                              n_tiles, occupancy)

INT32_MAX = 2 ** 31 - 1


def _offsets(idx_s: torch.Tensor, n_rows: int,
             bucket_rows: int) -> torch.Tensor:
    """int64 [n_buckets + 1]: bucket b holds the sorted updates
    off[b] .. off[b + 1]."""
    nb = n_tiles(n_rows, bucket_rows)
    if idx_s.dtype == torch.int32 and nb * bucket_rows > INT32_MAX:
        raise ValueError(f"int32 indices cannot address {nb} buckets of "
                         f"{bucket_rows} rows")
    # edges in idx's own dtype: searchsorted takes one dtype for both
    edges = torch.arange(nb + 1, dtype=idx_s.dtype, device=idx_s.device)
    return torch.searchsorted(idx_s, edges * bucket_rows)


def cluster_route(idx: torch.Tensor, n_rows: int, bucket_rows: int,
                  presorted: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                             torch.Tensor]:
    """The cluster design's route -> (idx sorted, perm int64 or None for
    presorted input, offsets int64 [n_buckets + 1]): sorted update i is
    vals[perm[i]]. A stable sort (the permutation comes with the keys in
    one call) and `searchsorted` at the bucket edges; vals stays where it
    is."""
    if presorted:
        idx_s, perm = idx.contiguous(), None
    else:
        idx_s, perm = torch.sort(idx, stable=True)
    return idx_s, perm, _offsets(idx_s, n_rows, bucket_rows)


def bucket_route(idx: torch.Tensor, vals: torch.Tensor, n_rows: int,
                 tile_rows: int, presorted: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tile design's route -> (idx sorted, vals in that order, offsets
    int64 [n_tiles + 1]): tile b walks the sorted updates off[b] ..
    off[b + 1]. The sort returns the permutation with the keys,
    `index_select` permutes vals, `searchsorted` places the tile edges."""
    if presorted:
        idx_s, vals_s = idx.contiguous(), vals.contiguous()
    else:
        idx_s, perm = torch.sort(idx)
        vals_s = vals.index_select(0, perm)
    return idx_s, vals_s, _offsets(idx_s, n_rows, tile_rows)


def _routed_plain(idx_s: torch.Tensor, vals_s: torch.Tensor,
                  off: torch.Tensor, n_rows: int,
                  bucket_rows: int) -> torch.Tensor:
    """`index_add_` of the routed updates off[0] .. off[-1] (those that
    land in a bucket) into a float32 table of whole buckets, the pad rows
    sliced off."""
    lo, hi = int(off[0]), int(off[-1])
    table = torch.zeros((n_tiles(n_rows, bucket_rows) * bucket_rows,
                         vals_s.shape[1]), dtype=torch.float32,
                        device=vals_s.device)
    table.index_add_(0, idx_s[lo:hi].long(), vals_s[lo:hi].float())
    return table[:n_rows].to(vals_s.dtype)


def _cluster_plain(idx, vals, n_rows, t, cl, presorted):
    idx_s, perm, off = cluster_route(idx, n_rows, t * cl, presorted)
    vals_s = vals if perm is None else vals.index_select(0, perm)
    return _routed_plain(idx_s, vals_s, off, n_rows, t * cl)


def scatter_add_rows_bucketed_plain(idx: torch.Tensor, vals: torch.Tensor,
                                    n_rows: int,
                                    tile_rows: Optional[int] = None,
                                    presorted: bool = False,
                                    cluster: Optional[int] = None
                                    ) -> torch.Tensor:
    """The plain PyTorch version over the cluster design's buckets of
    cluster * tile_rows rows: the route, then `index_add_` of the updates
    that land in a bucket (vals gathered by the permutation)."""
    t = check_tile(vals, tile_rows)
    return _cluster_plain(idx, vals, n_rows, t, check_cluster(cluster),
                          presorted)


def _lib():
    from . import build

    return build.load("scatter_rows_bucketed")


def max_active_clusters(width: int, tile_rows: int, cluster: int,
                        dtype: torch.dtype = torch.float32,
                        idx_dtype: torch.dtype = torch.int64) -> int:
    """cudaOccupancyMaxActiveClusters of the cluster kernel at (width,
    tile_rows, cluster) on the current GPU: the clusters it holds at once.
    Raises on a query the runtime refuses."""
    return occupancy("scatter_rows_bucketed", width, tile_rows, cluster,
                     dtype, idx_dtype)


def _launch_cluster(idx_s: torch.Tensor, perm: Optional[torch.Tensor],
                    off: torch.Tensor, vals: torch.Tensor, n_rows: int,
                    tile_rows: int, cluster: int) -> torch.Tensor:
    fn = _lib().scatter_rows_bucketed_cluster
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    vals = vals.contiguous()
    width = vals.shape[1]
    with torch.cuda.device(vals.device):
        out = torch.empty((n_rows, width), dtype=vals.dtype,
                          device=vals.device)
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = fn(off.data_ptr(), idx_s.data_ptr(),
                 None if perm is None else perm.data_ptr(), vals.data_ptr(),
                 out.data_ptr(), width, n_rows, tile_rows, cluster,
                 int(vals.dtype == torch.bfloat16),
                 int(idx_s.dtype == torch.int64), stream)
    if err != 0:
        raise RuntimeError(f"scatter_rows_bucketed_cluster kernel launch "
                           f"failed: cudaError {err}")
    return out


def _launch_tiles(idx_s: torch.Tensor, vals_s: torch.Tensor,
                  off: torch.Tensor, n_rows: int,
                  tile_rows: int) -> torch.Tensor:
    fn = _lib().scatter_rows_bucketed
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    width = vals_s.shape[1]
    with torch.cuda.device(vals_s.device):
        out = torch.empty((n_rows, width), dtype=vals_s.dtype,
                          device=vals_s.device)
        stream = torch.cuda.current_stream(vals_s.device).cuda_stream
        err = fn(off.data_ptr(), idx_s.data_ptr(), vals_s.data_ptr(),
                 out.data_ptr(), width, n_rows, tile_rows,
                 int(vals_s.dtype == torch.bfloat16),
                 int(idx_s.dtype == torch.int64), stream)
    if err != 0:
        raise RuntimeError(f"scatter_rows_bucketed kernel launch failed: "
                           f"cudaError {err}")
    return out


def scatter_add_rows_bucketed(idx: torch.Tensor, vals: torch.Tensor,
                              n_rows: int, tile_rows: Optional[int] = None,
                              presorted: bool = False,
                              cluster: Optional[int] = None) -> torch.Tensor:
    """`zeros((n_rows, width)).at[idx].add(vals)` through the route and
    one thread-block cluster per bucket of cluster * tile_rows rows: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    `scatter_add_rows_bucketed.launches` counts kernel launches."""
    _check(idx, vals, n_rows)
    t = check_tile(vals, tile_rows)
    cl = check_cluster(cluster)
    if vals.device.type == "cuda":
        idx_s, perm, off = cluster_route(idx, n_rows, t * cl, presorted)
        out = _launch_cluster(idx_s, perm, off, vals, n_rows, t, cl)
        scatter_add_rows_bucketed.launches += 1
        return out
    if vals.device.type == "cpu":
        return _cluster_plain(idx, vals, n_rows, t, cl, presorted)
    raise ValueError(f"unsupported device {vals.device}")


def scatter_add_rows_bucketed_tiles(idx: torch.Tensor, vals: torch.Tensor,
                                    n_rows: int,
                                    tile_rows: Optional[int] = None,
                                    presorted: bool = False
                                    ) -> torch.Tensor:
    """The tile design of the first port: the route with the permuted copy
    of vals (`bucket_route`), then one block per tile of `tile_rows` rows
    (TILES_TILE_ROWS for None). CUDA kernel for CUDA tensors, the plain
    version over the same tiles for CPU tensors.
    `scatter_add_rows_bucketed_tiles.launches` counts kernel launches."""
    _check(idx, vals, n_rows)
    t = check_tile(vals, tile_rows, TILES_TILE_ROWS)
    idx_s, vals_s, off = bucket_route(idx, vals, n_rows, t, presorted)
    if vals.device.type == "cuda":
        out = _launch_tiles(idx_s, vals_s, off.contiguous(), n_rows, t)
        scatter_add_rows_bucketed_tiles.launches += 1
        return out
    if vals.device.type == "cpu":
        return _routed_plain(idx_s, vals_s, off, n_rows, t)
    raise ValueError(f"unsupported device {vals.device}")


scatter_add_rows_bucketed.launches = 0
scatter_add_rows_bucketed_tiles.launches = 0
