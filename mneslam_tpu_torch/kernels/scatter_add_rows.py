"""`zeros((n_rows, width)).index_add_(0, idx, vals)` for the plane backward.

Port of the Pallas row scatter `scatter_add_rows` /
`scatter_add_rows_pallas` (mneslam_tpu/ops/pallas_kernels.py). On a CUDA
tensor the wrapper launches the hand-written kernel in
`csrc/scatter_add_rows.cu` (or raises); on a CPU tensor it runs the plain
PyTorch version below. There is no size gate and no fallback.

Contract, the same on both paths: idx [nu] integer, vals [nu, width]
float32 or bfloat16, result [n_rows, width] in vals' dtype, with sums taken
in float32. An idx outside [0, n_rows) is dropped, as XLA's `.at[].add`
drops it.
"""

from __future__ import annotations

import ctypes

import torch


def scatter_add_rows_plain(idx: torch.Tensor, vals: torch.Tensor,
                           n_rows: int) -> torch.Tensor:
    """The plain PyTorch version: mask out-of-range rows, then
    `index_add_` into a float32 table."""
    idx = idx.long()
    keep = (idx >= 0) & (idx < n_rows)
    out = torch.zeros((n_rows, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    out.index_add_(0, idx[keep], vals[keep].float())
    return out.to(vals.dtype)


def _check(idx: torch.Tensor, vals: torch.Tensor, n_rows: int):
    if vals.dim() != 2 or idx.dim() != 1 or idx.shape[0] != vals.shape[0]:
        raise ValueError(f"expected idx [nu] and vals [nu, width], got "
                         f"{tuple(idx.shape)} and {tuple(vals.shape)}")
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"vals must be float32 or bfloat16, got {vals.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")
    if idx.device != vals.device:
        raise ValueError(f"idx on {idx.device}, vals on {vals.device}")
    if n_rows < 0:
        raise ValueError(f"n_rows must be >= 0, got {n_rows}")


def _launch_cuda(idx: torch.Tensor, vals: torch.Tensor,
                 n_rows: int) -> torch.Tensor:
    from . import build

    lib = build.load("scatter_add_rows")
    fn = (lib.scatter_add_rows_f32 if vals.dtype == torch.float32
          else lib.scatter_add_rows_bf16)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    idx = idx.to(torch.int64).contiguous()
    vals = vals.contiguous()
    nu, width = vals.shape
    with torch.cuda.device(vals.device):
        out = torch.zeros((n_rows, width), dtype=torch.float32,
                          device=vals.device)
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = fn(idx.data_ptr(), vals.data_ptr(), out.data_ptr(), nu, width,
                 n_rows, stream)
    if err != 0:
        raise RuntimeError(f"scatter_add_rows kernel launch failed: "
                           f"cudaError {err}")
    scatter_add_rows.launches += 1
    return out.to(vals.dtype)


def scatter_add_rows(idx: torch.Tensor, vals: torch.Tensor,
                     n_rows: int) -> torch.Tensor:
    """`zeros((n_rows, width)).at[idx].add(vals)`: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. `scatter_add_rows.launches`
    counts kernel launches."""
    _check(idx, vals, n_rows)
    if vals.device.type == "cuda":
        return _launch_cuda(idx, vals, n_rows)
    if vals.device.type == "cpu":
        return scatter_add_rows_plain(idx, vals, n_rows)
    raise ValueError(f"unsupported device {vals.device}")


scatter_add_rows.launches = 0
