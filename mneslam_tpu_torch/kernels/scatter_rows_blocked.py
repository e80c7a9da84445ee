"""`zeros((n_rows, width)).index_add_(0, idx, vals)`, built tile by tile.

Port of the Pallas kernel of the TPU probe tools/prof_pallas_scatter.py
(`make_pallas_scatter`: the output table in `n_blocks` row blocks, every
block re-walking all updates with predicated writes). On a CUDA tensor the
wrapper launches the hand-written kernel in `csrc/scatter_rows_blocked.cu`
(or raises): one block per tile of `tile_rows` rows in shared memory, the
stand-in for the TPU probe's `n_blocks`. On a CPU tensor it runs the plain
PyTorch version below. There is no size gate and no fallback.

Contract, the same on both paths and the same as `scatter_add_rows`: idx
[nu] int32 or int64, vals [nu, width] float32 or bfloat16, result
[n_rows, width] in vals' dtype, with sums taken in float32. An idx outside
[0, n_rows) is dropped. `tile_rows * width` fp32 must fit a block's shared
memory (227 KB).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .scatter_add_rows import _check

SMEM_BYTES = 232448         # shared memory a Hopper block can use (227 KB)
DEFAULT_TILE_ROWS = 64      # the fastest of 64-384 on the H100 (PERF.md)


def default_tile_rows(width: int) -> int:
    """DEFAULT_TILE_ROWS, or fewer where a wide row would not fit shared
    memory."""
    return max(1, min(DEFAULT_TILE_ROWS, SMEM_BYTES // (4 * max(width, 1))))


def check_tile(vals: torch.Tensor, tile_rows: Optional[int]) -> int:
    """The tile height to use (`default_tile_rows` for None); raises on a
    tile that does not fit a block's shared memory."""
    width = vals.shape[1]
    t = default_tile_rows(width) if tile_rows is None else int(tile_rows)
    if t < 1 or t * width * 4 > SMEM_BYTES:
        raise ValueError(f"tile_rows {t} x width {width} x 4 B does not fit "
                         f"{SMEM_BYTES} B of shared memory")
    return t


def n_tiles(n_rows: int, tile_rows: int) -> int:
    return -(-n_rows // tile_rows)


def scatter_add_rows_blocked_plain(idx: torch.Tensor, vals: torch.Tensor,
                                   n_rows: int,
                                   tile_rows: Optional[int] = None
                                   ) -> torch.Tensor:
    """The plain PyTorch version over the same blocks: a float32 table of
    n_tiles * tile_rows rows (row r in tile r // tile_rows), `index_add_`
    of the updates that land in it, the pad rows sliced off."""
    t = check_tile(vals, tile_rows)
    padded = n_tiles(n_rows, t) * t
    idx = idx.long()
    keep = (idx >= 0) & (idx < padded)
    table = torch.zeros((padded, vals.shape[1]), dtype=torch.float32,
                        device=vals.device)
    table.index_add_(0, idx[keep], vals[keep].float())
    return table[:n_rows].to(vals.dtype)


def _launch_cuda(idx: torch.Tensor, vals: torch.Tensor, n_rows: int,
                 tile_rows: int) -> torch.Tensor:
    from . import build

    fn = build.load("scatter_rows_blocked").scatter_rows_blocked
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    idx = idx.contiguous()
    vals = vals.contiguous()
    nu, width = vals.shape
    with torch.cuda.device(vals.device):
        out = torch.empty((n_rows, width), dtype=vals.dtype,
                          device=vals.device)
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = fn(idx.data_ptr(), vals.data_ptr(), out.data_ptr(), nu, width,
                 n_rows, tile_rows, int(vals.dtype == torch.bfloat16),
                 int(idx.dtype == torch.int64), stream)
    if err != 0:
        raise RuntimeError(f"scatter_rows_blocked kernel launch failed: "
                           f"cudaError {err}")
    return out


def scatter_add_rows_blocked(idx: torch.Tensor, vals: torch.Tensor,
                             n_rows: int,
                             tile_rows: Optional[int] = None) -> torch.Tensor:
    """`zeros((n_rows, width)).at[idx].add(vals)` in tiles of `tile_rows`
    rows: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. `scatter_add_rows_blocked.launches` counts kernel launches."""
    _check(idx, vals, n_rows)
    t = check_tile(vals, tile_rows)
    if vals.device.type == "cuda":
        out = _launch_cuda(idx, vals, n_rows, t)
        scatter_add_rows_blocked.launches += 1
        return out
    if vals.device.type == "cpu":
        return scatter_add_rows_blocked_plain(idx, vals, n_rows, t)
    raise ValueError(f"unsupported device {vals.device}")


scatter_add_rows_blocked.launches = 0
