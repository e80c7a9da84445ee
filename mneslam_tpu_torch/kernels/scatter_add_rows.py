"""`zeros((n_rows, width)).index_add_(0, idx, vals)` for the plane backward.

Port of the Pallas row scatter `scatter_add_rows` /
`scatter_add_rows_pallas` (mneslam_tpu/ops/pallas_kernels.py). On a CUDA
tensor the wrapper launches the hand-written kernel in
`csrc/scatter_add_rows.cu` (or raises); on a CPU tensor it runs the plain
PyTorch version below. There is no size gate and no fallback.
`scatter_add_rows_per_warp` launches the same kernel with 16 or 32
updates per warp (the counterparts of the TPU probe
tools/prof_scatter_bucketed.py `make_serial` at unroll 16 / 32); no caller
on the main path uses it.

On float32 values the wrapper zero-fills an fp32 table and the kernel adds
into it. On bfloat16 values (the bf16 render's backward) it makes two
launches (`scatter_add_rows_bf16_once`): the first adds into an fp32
workspace that this module keeps zero between calls, flagging each row it
touches, and writes the bf16 result as zeros; the second writes each
touched row's sums as bf16 and clears its workspace row and flag. The
workspace (fp32 rows and a 32-bit flag per row) is one per device, grown
when a call needs more (never inside a CUDA-graph capture: warm up before
capturing) and re-zeroed after a failed launch. A call from another stream
than the last one first waits for that stream's work (a CUDA-graph replay
is ordered by its caller). `scatter_add_rows_bf16_staged` keeps the first
port's bf16 route (zero fill, the kernel, a cast) for comparison; no
caller on the main path uses it.

Contract, the same on every path: idx [nu] integer, vals [nu, width]
float32 or bfloat16, result [n_rows, width] in vals' dtype, with sums taken
in float32 (and rounded once, to nearest even, to bfloat16). An idx outside
[0, n_rows) is dropped, as XLA's `.at[].add` drops it. Untouched rows are
+0.0.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

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


PER_WARP = (8, 16, 32)      # updates per warp the kernel is built for
BF16_LAUNCHES_PER_CALL = 2  # the bf16 route: accumulate, emit


def accumulate_into(table: torch.Tensor, idx: torch.Tensor,
                    vals: torch.Tensor, per_warp=None) -> None:
    """Launch the kernel alone: add vals' rows into the fp32 CUDA `table`
    [n_rows, width] in place (`scatter_add_rows_f32` / `_bf16`, or
    `scatter_add_rows_per_warp` with `per_warp` updates per warp). The
    staged routes' middle step; raises on a failed launch."""
    from . import build

    lib = build.load("scatter_add_rows")
    args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    if per_warp is None:
        fn = (lib.scatter_add_rows_f32 if vals.dtype == torch.float32
              else lib.scatter_add_rows_bf16)
        extra = ()
    else:
        fn = lib.scatter_add_rows_per_warp
        args += [ctypes.c_int64, ctypes.c_int64]
        extra = (per_warp, int(vals.dtype == torch.bfloat16))
    fn.argtypes = args + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    idx = idx.to(torch.int64).contiguous()
    vals = vals.contiguous()
    nu, width = vals.shape
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = fn(idx.data_ptr(), vals.data_ptr(), table.data_ptr(), nu, width,
                 table.shape[0], *extra, stream)
    if err != 0:
        raise RuntimeError(f"scatter_add_rows kernel launch failed: "
                           f"cudaError {err}")


def _launch_cuda(idx: torch.Tensor, vals: torch.Tensor, n_rows: int,
                 per_warp=None) -> torch.Tensor:
    """Zero-fill an fp32 table, launch the kernel into it, cast to vals'
    dtype (the fp32 route; for bf16 values the staged route)."""
    out = torch.zeros((n_rows, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    accumulate_into(out, idx, vals, per_warp)
    return out.to(vals.dtype)


@dataclass
class _Workspace:
    """The bf16 route's fp32 rows (flat, row stride = the call's width) and
    32-bit row flags on one device: all zero between calls."""
    rows: torch.Tensor
    flags: torch.Tensor
    stream: torch.cuda.Stream
    dirty: bool = False       # a launch failed: re-zero before the next use
    captured: bool = False    # a CUDA graph holds these buffers' pointers
    # earlier buffers a captured graph may still use
    retired: List[Tuple[torch.Tensor, torch.Tensor]] = field(
        default_factory=list)


_workspaces: Dict[int, _Workspace] = {}


def _workspace(device: torch.device, n_rows: int, width: int) -> _Workspace:
    """The device's workspace, at least n_rows x width, zero, and ordered
    after its last user's stream. Allocates only outside a capture."""
    stream = torch.cuda.current_stream(device)
    capturing = torch.cuda.is_current_stream_capturing()
    ws = _workspaces.get(device.index)
    if ws is not None and ws.stream != stream and not capturing:
        stream.wait_stream(ws.stream)
        ws.rows.record_stream(stream)
        ws.flags.record_stream(stream)
    if (ws is None or ws.rows.numel() < n_rows * width
            or ws.flags.numel() < n_rows):
        if capturing:
            raise RuntimeError(
                f"scatter_add_rows: the bf16 workspace must hold {n_rows} x "
                f"{width} before a CUDA-graph capture: make one call of this "
                f"size on the device first")
        retired = []
        if ws is not None:
            retired = ws.retired + ([(ws.rows, ws.flags)] if ws.captured
                                    else [])
        old_rows = 0 if ws is None else ws.rows.numel()
        old_flags = 0 if ws is None else ws.flags.numel()
        ws = _Workspace(
            torch.zeros(max(old_rows, n_rows * width), dtype=torch.float32,
                        device=device),
            torch.zeros(max(old_flags, n_rows), dtype=torch.int32,
                        device=device), stream, retired=retired)
        _workspaces[device.index] = ws
    elif ws.dirty:
        if capturing:
            raise RuntimeError("scatter_add_rows: the bf16 workspace is "
                               "dirty after a failed launch: make one call "
                               "before the capture")
        ws.rows.zero_()
        ws.flags.zero_()
        ws.dirty = False
    ws.stream = stream
    ws.captured = ws.captured or capturing
    return ws


def bf16_workspace(device) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The bf16 route's (fp32 rows, int32 flags) on a CUDA device, or None
    before its first bf16 call there. Both are all zero between calls."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    ws = _workspaces.get(index)
    return None if ws is None else (ws.rows, ws.flags)


def _launch_bf16(idx: torch.Tensor, vals: torch.Tensor,
                 n_rows: int) -> torch.Tensor:
    """The bf16 route: launch A adds into the workspace, flags the rows it
    touches and writes the bf16 result as zeros; launch B writes the
    touched rows and clears them in the workspace."""
    from . import build

    fn = build.load("scatter_add_rows").scatter_add_rows_bf16_once
    if fn.argtypes is None:             # once per loaded library
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    idx = idx.contiguous()
    vals = vals.contiguous()
    nu, width = vals.shape
    with torch.cuda.device(vals.device):
        ws = _workspace(vals.device, n_rows, width)
        out = torch.empty((n_rows, width), dtype=torch.bfloat16,
                          device=vals.device)
        err = fn(idx.data_ptr(), int(idx.dtype == torch.int64),
                 vals.data_ptr(), ws.rows.data_ptr(), ws.flags.data_ptr(),
                 out.data_ptr(), nu, width, n_rows, ws.stream.cuda_stream)
    if err != 0:
        ws.dirty = True
        raise RuntimeError(f"scatter_add_rows bf16 launch failed: "
                           f"cudaError {err}")
    return out


def scatter_add_rows(idx: torch.Tensor, vals: torch.Tensor,
                     n_rows: int) -> torch.Tensor:
    """`zeros((n_rows, width)).at[idx].add(vals)`: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. `scatter_add_rows.launches`
    counts the calls that launched the kernel (one launch for float32
    values, BF16_LAUNCHES_PER_CALL for bfloat16),
    `scatter_add_rows.launches_bf16` those on bfloat16 values (the bf16
    render's backward) among them."""
    _check(idx, vals, n_rows)
    if vals.device.type == "cuda":
        bf16 = vals.dtype == torch.bfloat16
        out = (_launch_bf16 if bf16 else _launch_cuda)(idx, vals, n_rows)
        scatter_add_rows.launches += 1
        scatter_add_rows.launches_bf16 += int(bf16)
        return out
    if vals.device.type == "cpu":
        return scatter_add_rows_plain(idx, vals, n_rows)
    raise ValueError(f"unsupported device {vals.device}")


def scatter_add_rows_per_warp(idx: torch.Tensor, vals: torch.Tensor,
                              n_rows: int, per_warp: int) -> torch.Tensor:
    """`scatter_add_rows` with `per_warp` (8, 16 or 32) consecutive updates
    walked by each warp: the counterparts of the TPU probe's unroll depths
    (tools/prof_scatter_bucketed.py `make_serial`). The production entry
    stays at 8. `scatter_add_rows_per_warp.launches` counts kernel
    launches."""
    _check(idx, vals, n_rows)
    if per_warp not in PER_WARP:
        raise ValueError(f"per_warp must be one of {PER_WARP}, got "
                         f"{per_warp}")
    if vals.device.type == "cuda":
        out = _launch_cuda(idx, vals, n_rows, per_warp)
        scatter_add_rows_per_warp.launches += 1
        return out
    if vals.device.type == "cpu":
        return scatter_add_rows_plain(idx, vals, n_rows)
    raise ValueError(f"unsupported device {vals.device}")


def scatter_add_rows_bf16_staged(idx: torch.Tensor, vals: torch.Tensor,
                                 n_rows: int) -> torch.Tensor:
    """`scatter_add_rows` on bfloat16 values by the first port's route: an
    fp32 zero fill, the kernel (`scatter_add_rows_bf16`), a cast to bf16.
    Kept to time against the workspace route; no caller on the main path
    uses it. `scatter_add_rows_bf16_staged.launches` counts its calls on
    CUDA tensors."""
    _check(idx, vals, n_rows)
    if vals.dtype != torch.bfloat16:
        raise TypeError(f"vals must be bfloat16, got {vals.dtype}")
    if vals.device.type == "cuda":
        out = _launch_cuda(idx, vals, n_rows)
        scatter_add_rows_bf16_staged.launches += 1
        return out
    if vals.device.type == "cpu":
        return scatter_add_rows_plain(idx, vals, n_rows)
    raise ValueError(f"unsupported device {vals.device}")


scatter_add_rows.launches = 0
scatter_add_rows.launches_bf16 = 0
scatter_add_rows_per_warp.launches = 0
scatter_add_rows_bf16_staged.launches = 0
