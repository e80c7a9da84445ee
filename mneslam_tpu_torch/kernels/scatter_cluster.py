"""The row scatters' cluster policy, shared by `scatter_rows_blocked` and
`scatter_rows_bucketed` (the Python side of `csrc/scatter_cluster.cuh`).

A thread-block cluster of `cluster` blocks owns a bucket of
`cluster * tile_rows` rows, each block `tile_rows` of them in shared
memory. This module holds the sizes the kernels take, their defaults, the
checks both wrappers apply, and the occupancy query of both libraries.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

SMEM_BYTES = 232448         # shared memory a Hopper block can use (227 KB)
CLUSTERS = (2, 4, 8, 16)    # cluster sizes the kernels take (16: non-portable)
# the cluster design's defaults, for both kernels: the fastest (T, CL) on
# the mapping path's real index stream on the H100 (PERF.md)
DEFAULT_TILE_ROWS = 224
DEFAULT_CLUSTER = 16
TILES_TILE_ROWS = 64        # the tile design's fastest of 64-384 (PERF.md)


def default_tile_rows(width: int, rows: int = DEFAULT_TILE_ROWS) -> int:
    """`rows`, or fewer where a wide row would not fit shared memory."""
    return max(1, min(rows, SMEM_BYTES // (4 * max(width, 1))))


def check_tile(vals: torch.Tensor, tile_rows: Optional[int],
               default: int = DEFAULT_TILE_ROWS) -> int:
    """The tile height to use (`default_tile_rows(width, default)` for
    None); raises on a tile that does not fit a block's shared memory."""
    width = vals.shape[1]
    t = default_tile_rows(width, default) if tile_rows is None \
        else int(tile_rows)
    if t < 1 or t * width * 4 > SMEM_BYTES:
        raise ValueError(f"tile_rows {t} x width {width} x 4 B does not fit "
                         f"{SMEM_BYTES} B of shared memory")
    return t


def check_cluster(cluster: Optional[int]) -> int:
    """The cluster size to use (DEFAULT_CLUSTER for None); raises on one
    the kernels do not take."""
    cl = DEFAULT_CLUSTER if cluster is None else cluster
    if cl not in CLUSTERS:
        raise ValueError(f"cluster must be one of {CLUSTERS}, got {cl}")
    return int(cl)


def n_tiles(n_rows: int, tile_rows: int) -> int:
    """Buckets (or tiles) of `tile_rows` rows that cover n_rows."""
    return -(-n_rows // tile_rows)


def occupancy(source: str, width: int, tile_rows: int, cluster: int,
              dtype: torch.dtype, idx_dtype: torch.dtype) -> int:
    """cudaOccupancyMaxActiveClusters of the cluster kernel of library
    `source` at (width, tile_rows, cluster) on the current GPU: the
    clusters it holds at once. Raises on a query the runtime refuses."""
    from . import build

    fn = getattr(build.load(source), f"{source}_cluster_occupancy")
    fn.argtypes = [ctypes.c_int64] * 5
    fn.restype = ctypes.c_int
    n = fn(width, tile_rows, cluster, int(dtype == torch.bfloat16),
           int(idx_dtype == torch.int64))
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed for "
                           f"{source}: cudaError {-n}")
    return n
