"""`zeros((n_rows, width)).index_add_(0, idx, vals)`, built bucket by bucket.

Port of the Pallas kernel of the TPU probe tools/prof_pallas_scatter.py
(`make_pallas_scatter`: the output table in `n_blocks` row blocks, every
block re-walking all updates with predicated writes). On a CUDA tensor the
wrapper `scatter_add_rows_blocked` launches the hand-written kernel in
`csrc/scatter_rows_blocked.cu` (or raises) in the cluster design: a
thread-block cluster of `cluster` blocks owns a bucket of
`cluster * tile_rows` rows, the stand-in for the TPU probe's `n_blocks`;
each block holds `tile_rows` of them in shared memory, every block of the
cluster adds into the owner's through distributed shared memory, and the
cluster walks idx once (`csrc/scatter_cluster.cuh`). The first port's tile
design (one block per tile, each re-walking idx) stays reachable as
`scatter_add_rows_blocked_tiles`, so that one run can time both. On a CPU
tensor both run the plain PyTorch version below. There is no size gate and
no fallback.

Contract, the same on both paths and the same as `scatter_add_rows`: idx
[nu] int32 or int64, vals [nu, width] float32 or bfloat16, result
[n_rows, width] in vals' dtype, with sums taken in float32. An idx outside
[0, n_rows) is dropped. `tile_rows * width` fp32 must fit a block's shared
memory (227 KB); `cluster` is one of CLUSTERS (`scatter_cluster.py`, the
sizes and defaults both row scatters share).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .scatter_add_rows import _check
from .scatter_cluster import (TILES_TILE_ROWS, check_cluster, check_tile,
                              n_tiles, occupancy)

def _padded_plain(idx: torch.Tensor, vals: torch.Tensor, n_rows: int,
                 bucket_rows: int) -> torch.Tensor:
    """`index_add_` into a float32 table padded to whole buckets of
    `bucket_rows` rows (row r in bucket r // bucket_rows), the pad rows
    sliced off, in vals' dtype."""
    padded = n_tiles(n_rows, bucket_rows) * bucket_rows
    idx = idx.long()
    keep = (idx >= 0) & (idx < padded)
    table = torch.zeros((padded, vals.shape[1]), dtype=torch.float32,
                        device=vals.device)
    table.index_add_(0, idx[keep], vals[keep].float())
    return table[:n_rows].to(vals.dtype)


def scatter_add_rows_blocked_plain(idx: torch.Tensor, vals: torch.Tensor,
                                   n_rows: int,
                                   tile_rows: Optional[int] = None,
                                   cluster: Optional[int] = None
                                   ) -> torch.Tensor:
    """The plain PyTorch version over the cluster design's buckets of
    cluster * tile_rows rows."""
    t = check_tile(vals, tile_rows)
    return _padded_plain(idx, vals, n_rows, t * check_cluster(cluster))


def _launch(entry: str, idx: torch.Tensor, vals: torch.Tensor, n_rows: int,
            *sizes: int) -> torch.Tensor:
    """Launch C entry `entry` of scatter_rows_blocked.cu with the size
    arguments `sizes` (tile_rows, and the cluster size for the cluster
    design)."""
    from . import build

    fn = getattr(build.load("scatter_rows_blocked"), entry)
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * (5 + len(sizes))
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    idx = idx.contiguous()
    vals = vals.contiguous()
    nu, width = vals.shape
    with torch.cuda.device(vals.device):
        out = torch.empty((n_rows, width), dtype=vals.dtype,
                          device=vals.device)
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = fn(idx.data_ptr(), vals.data_ptr(), out.data_ptr(), nu, width,
                 n_rows, *sizes, int(vals.dtype == torch.bfloat16),
                 int(idx.dtype == torch.int64), stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")
    return out


def max_active_clusters(width: int, tile_rows: int, cluster: int,
                        dtype: torch.dtype = torch.float32,
                        idx_dtype: torch.dtype = torch.int64) -> int:
    """cudaOccupancyMaxActiveClusters of the cluster kernel at (width,
    tile_rows, cluster) on the current GPU: the clusters it holds at once.
    Raises on a query the runtime refuses."""
    return occupancy("scatter_rows_blocked", width, tile_rows, cluster,
                     dtype, idx_dtype)


def scatter_add_rows_blocked(idx: torch.Tensor, vals: torch.Tensor,
                             n_rows: int, tile_rows: Optional[int] = None,
                             cluster: Optional[int] = None) -> torch.Tensor:
    """`zeros((n_rows, width)).at[idx].add(vals)` in buckets of
    cluster * tile_rows rows, one thread-block cluster each: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.
    `scatter_add_rows_blocked.launches` counts kernel launches."""
    _check(idx, vals, n_rows)
    t = check_tile(vals, tile_rows)
    cl = check_cluster(cluster)
    if vals.device.type == "cuda":
        out = _launch("scatter_rows_blocked_cluster", idx, vals, n_rows, t,
                      cl)
        scatter_add_rows_blocked.launches += 1
        return out
    if vals.device.type == "cpu":
        return _padded_plain(idx, vals, n_rows, t * cl)
    raise ValueError(f"unsupported device {vals.device}")


def scatter_add_rows_blocked_tiles(idx: torch.Tensor, vals: torch.Tensor,
                                   n_rows: int,
                                   tile_rows: Optional[int] = None
                                   ) -> torch.Tensor:
    """The tile design of the first port: one block per tile of
    `tile_rows` rows (TILES_TILE_ROWS for None), each walking all of idx.
    CUDA kernel for CUDA tensors, the plain version over the same tiles for
    CPU tensors. `scatter_add_rows_blocked_tiles.launches` counts kernel
    launches."""
    _check(idx, vals, n_rows)
    t = check_tile(vals, tile_rows, TILES_TILE_ROWS)
    if vals.device.type == "cuda":
        out = _launch("scatter_rows_blocked", idx, vals, n_rows, t)
        scatter_add_rows_blocked_tiles.launches += 1
        return out
    if vals.device.type == "cpu":
        return _padded_plain(idx, vals, n_rows, t)
    raise ValueError(f"unsupported device {vals.device}")


scatter_add_rows_blocked.launches = 0
scatter_add_rows_blocked_tiles.launches = 0
