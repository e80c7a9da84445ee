"""`zeros((n_rows, width)).index_add_(0, idx, vals)` over updates sorted
into row tiles.

Port of the Pallas kernel of the TPU probe tools/prof_scatter_bucketed.py
(`make_bucketed`: argsort + permute + `searchsorted` offsets outside the
kernel, then a grid over row-range buckets, each walking only its sorted
update range; `presorted=True` is the probe's `bucket{b}_presorted`). On a
CUDA tensor the wrapper runs the route (`bucket_route`) and launches the
hand-written kernel in `csrc/scatter_rows_bucketed.cu` (or raises): one
block per tile of `tile_rows` rows in shared memory. On a CPU tensor it runs
the same route and the plain PyTorch version below. There is no size gate
and no fallback.

Contract, the same on both paths and the same as `scatter_add_rows`: idx
[nu] int32 or int64, vals [nu, width] float32 or bfloat16, result
[n_rows, width] in vals' dtype, with sums taken in float32. An idx outside
[0, n_rows) falls outside every tile's range, or into the last tile's pad
rows, and is dropped. With `presorted=True` the caller passes idx sorted
ascending and vals in the same order; the route's sort is skipped.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .scatter_add_rows import _check
from .scatter_rows_blocked import check_tile, n_tiles

INT32_MAX = 2 ** 31 - 1


def bucket_route(idx: torch.Tensor, vals: torch.Tensor, n_rows: int,
                 tile_rows: int, presorted: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The route outside the kernel -> (idx sorted, vals in that order,
    offsets int64 [n_tiles + 1]): tile b walks the sorted updates
    off[b] .. off[b + 1]. The sort returns the permutation with the keys
    (an argsort and the gather of idx in one call), `index_select` permutes
    vals, `searchsorted` places the tile edges."""
    if presorted:
        idx_s, vals_s = idx.contiguous(), vals.contiguous()
    else:
        idx_s, perm = torch.sort(idx)
        vals_s = vals.index_select(0, perm)
    nt = n_tiles(n_rows, tile_rows)
    if idx.dtype == torch.int32 and nt * tile_rows > INT32_MAX:
        raise ValueError(f"int32 indices cannot address {nt} tiles of "
                         f"{tile_rows} rows")
    # edges in idx's own dtype: searchsorted takes one dtype for both
    edges = torch.arange(nt + 1, dtype=idx.dtype, device=idx.device)
    off = torch.searchsorted(idx_s, edges * tile_rows)
    return idx_s, vals_s, off


def scatter_add_rows_bucketed_plain(idx: torch.Tensor, vals: torch.Tensor,
                                    n_rows: int,
                                    tile_rows: Optional[int] = None,
                                    presorted: bool = False) -> torch.Tensor:
    """The plain PyTorch version over the same buckets: the route, then
    `index_add_` of the updates off[0] .. off[n_tiles] (those that land in
    a tile) into a float32 table of n_tiles * tile_rows rows, the pad rows
    sliced off."""
    t = check_tile(vals, tile_rows)
    idx_s, vals_s, off = bucket_route(idx, vals, n_rows, t, presorted)
    lo, hi = int(off[0]), int(off[-1])
    table = torch.zeros((n_tiles(n_rows, t) * t, vals.shape[1]),
                        dtype=torch.float32, device=vals.device)
    table.index_add_(0, idx_s[lo:hi].long(), vals_s[lo:hi].float())
    return table[:n_rows].to(vals.dtype)


def _launch_cuda(idx_s: torch.Tensor, vals_s: torch.Tensor,
                 off: torch.Tensor, n_rows: int,
                 tile_rows: int) -> torch.Tensor:
    from . import build

    fn = build.load("scatter_rows_bucketed").scatter_rows_bucketed
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
                              presorted: bool = False) -> torch.Tensor:
    """`zeros((n_rows, width)).at[idx].add(vals)` through the route and one
    block per row tile: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. `scatter_add_rows_bucketed.launches` counts kernel
    launches."""
    _check(idx, vals, n_rows)
    t = check_tile(vals, tile_rows)
    if vals.device.type == "cuda":
        idx_s, vals_s, off = bucket_route(idx, vals, n_rows, t, presorted)
        out = _launch_cuda(idx_s, vals_s, off.contiguous(), n_rows, t)
        scatter_add_rows_bucketed.launches += 1
        return out
    if vals.device.type == "cpu":
        return scatter_add_rows_bucketed_plain(idx, vals, n_rows, t,
                                               presorted)
    raise ValueError(f"unsupported device {vals.device}")


scatter_add_rows_bucketed.launches = 0
