"""Integer-offset correlation windows over a padded feature pyramid.

Port of the Pallas kernels `corr_window_int_multilevel` (all pyramid
levels in one launch; its `mxu=True` variant) and `corr_window_int` (one
level) of mneslam_tpu/ops/pallas_kernels.py. On CUDA tensors the wrappers
launch the hand-written kernels in `csrc/corr_window.cu` (kernels 2 and 3)
and `csrc/corr_window_mma.cu` (kernel 2b, tensor cores) or raise; on CPU
tensors they run the plain PyTorch versions below. There is no size gate
and no fallback.

Contract, the same on both paths. f1_rows [N, HW, C] float32 (level 0,
already scaled by 1/4); each f2 level [N, R_l, C] float32, the zero-padded
level in row layout with padded width w2p_l; ii, jj [E] int32; xs int32
slab starts ([E, HW, L] for the multi-level entry, [E, HW] for the
per-level one); mask [E] int32 or None (all edges real). The output is
float32, j-major: out[e, p, l, j * 8 + i] = f1_rows[ii[e], p] .
f2_l[jj[e], xs[e, p, l] + j * w2p_l + i], and all zeros for an edge with
mask[e] == 0. The window is 8 x 8 (radius 3); kernel 2 takes C a
multiple of 32, kernel 2b C of 32, 64 or 128.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

NX = 8                      # window side: 2 * radius + 2 at radius 3
_VOLUME_BYTES = 1 << 28     # plain version: dot volume per edge chunk


def _offsets(w2p: int, device) -> torch.Tensor:
    """[64] row offsets of the 8 x 8 window, j-major."""
    j = torch.arange(NX, device=device) * int(w2p)
    i = torch.arange(NX, device=device)
    return (j[:, None] + i[None, :]).reshape(-1)


def corr_window_multilevel_plain(f1_rows: torch.Tensor,
                                 f2_levels: Sequence[torch.Tensor],
                                 ii: torch.Tensor, jj: torch.Tensor,
                                 xs: torch.Tensor, w2ps: Sequence[int],
                                 mask: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """The plain PyTorch version: per edge, the dots of every f1 row with
    every row of the padded level (one batched matrix product), then the
    window's 64 entries gathered; a chunk of edges at a time."""
    E, HW = xs.shape[:2]
    L = len(f2_levels)
    out = torch.zeros((E, HW, L, NX * NX), dtype=torch.float32,
                      device=f1_rows.device)
    ii, jj = ii.long(), jj.long()
    for lvl, (f2, w2p) in enumerate(zip(f2_levels, w2ps)):
        offs = _offsets(w2p, f1_rows.device)
        chunk = max(1, _VOLUME_BYTES // max(HW * f2.shape[1] * 4, 1))
        for e0 in range(0, E, chunk):
            sl = slice(e0, min(e0 + chunk, E))
            vol = torch.bmm(f1_rows[ii[sl]],
                            f2[jj[sl]].transpose(1, 2))        # [c, HW, R]
            rows = xs[sl, :, lvl].long()[..., None] + offs    # [c, HW, 64]
            out[sl, :, lvl] = vol.gather(2, rows)
    if mask is not None:
        out = torch.where((mask != 0)[:, None, None, None], out,
                          torch.zeros_like(out))
    return out


def corr_window_multilevel_mma_plain(f1_rows: torch.Tensor,
                                     f2_levels: Sequence[torch.Tensor],
                                     ii: torch.Tensor, jj: torch.Tensor,
                                     xs: torch.Tensor, w2ps: Sequence[int],
                                     mask: Optional[torch.Tensor] = None
                                     ) -> torch.Tensor:
    """The plain version of kernel 2b, in the TPU kernel's block form: per
    block of U pixels (the largest of 16, 8, 4, 2, 1 dividing HW) and
    level, the pixels' window rows S [U * 64, C] times the block's f1
    [C, U] in one batched fp32 product, then each pixel's own column (the
    diagonal); a chunk of edges at a time."""
    E, HW = xs.shape[:2]
    L = len(f2_levels)
    U = next(u for u in (16, 8, 4, 2, 1) if HW % u == 0)
    C = f1_rows.shape[2]
    out = torch.zeros((E, HW, L, NX * NX), dtype=torch.float32,
                      device=f1_rows.device)
    ii, jj = ii.long(), jj.long()
    chunk = max(1, _VOLUME_BYTES // max(HW * NX * NX * C * 4, 1))
    for lvl, (f2, w2p) in enumerate(zip(f2_levels, w2ps)):
        offs = _offsets(w2p, f1_rows.device)
        for e0 in range(0, E, chunk):
            sl = slice(e0, min(e0 + chunk, E))
            c = sl.stop - e0
            rows = xs[sl, :, lvl].long()[..., None] + offs      # [c, HW, 64]
            S = f2[jj[sl][:, None], rows.reshape(c, -1)]        # [c, HW*64, C]
            S = S.reshape(c, HW // U, U * NX * NX, C)
            f1b = f1_rows[ii[sl]].reshape(c, HW // U, U, C)
            dots = S @ f1b.transpose(-1, -2)                    # [.., U*64, U]
            d = dots.reshape(c, HW // U, U, NX * NX, U)
            diag = torch.diagonal(d, dim1=2, dim2=4)            # [.., 64, U]
            out[sl, :, lvl] = diag.permute(0, 1, 3, 2).reshape(c, HW,
                                                               NX * NX)
    if mask is not None:
        out = torch.where((mask != 0)[:, None, None, None], out,
                          torch.zeros_like(out))
    return out


def corr_window_plain(f1_rows: torch.Tensor, f2_rows_pad: torch.Tensor,
                      ii: torch.Tensor, jj: torch.Tensor, xs: torch.Tensor,
                      w2p: int) -> torch.Tensor:
    """The plain per-level version -> [E, HW, 64]."""
    return corr_window_multilevel_plain(f1_rows, [f2_rows_pad], ii, jj,
                                        xs[..., None], [w2p])[:, :, 0]


def _check(f1_rows, f2_levels, ii, jj, xs, w2ps, mask, mma=False):
    dev = f1_rows.device
    if f1_rows.dim() != 3:
        raise ValueError(f"f1_rows must be [N, HW, C], got "
                         f"{tuple(f1_rows.shape)}")
    N, HW, C = f1_rows.shape
    L = len(f2_levels)
    if not 1 <= L <= 4 or len(w2ps) != L:
        raise ValueError(f"expected 1-4 levels with one width each, got "
                         f"{L} levels and {len(w2ps)} widths")
    if dev.type == "cuda" and mma and C not in (32, 64, 128):
        raise ValueError(f"C must be 32, 64 or 128, got {C}")
    if dev.type == "cuda" and C % 32 != 0:
        raise ValueError(f"C must be a multiple of 32, got {C}")
    E = ii.shape[0]
    if ii.shape != (E,) or jj.shape != (E,) or xs.shape != (E, HW, L):
        raise ValueError(f"expected ii, jj [E] and xs [E, HW, L] = "
                         f"[{E}, {HW}, {L}], got {tuple(ii.shape)}, "
                         f"{tuple(jj.shape)}, {tuple(xs.shape)}")
    tensors = [("f1_rows", f1_rows, torch.float32), ("ii", ii, torch.int32),
               ("jj", jj, torch.int32), ("xs", xs, torch.int32)]
    tensors += [(f"f2_levels[{k}]", f, torch.float32)
                for k, f in enumerate(f2_levels)]
    if mask is not None:
        if mask.shape != (E,):
            raise ValueError(f"mask must be [E], got {tuple(mask.shape)}")
        tensors.append(("mask", mask, torch.int32))
    for name, t, dtype in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, f1_rows on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for k, (f, w2p) in enumerate(zip(f2_levels, w2ps)):
        if f.dim() != 3 or f.shape[0] != N or f.shape[2] != C:
            raise ValueError(f"f2_levels[{k}] must be [{N}, R, {C}], got "
                             f"{tuple(f.shape)}")
        if f.shape[1] % int(w2p) != 0 or f.shape[1] < NX * int(w2p):
            raise ValueError(f"f2_levels[{k}] rows {f.shape[1]} are not a "
                             f"padded image of width {w2p}")


def _launch_cuda(f1_rows, f2_levels, ii, jj, xs, w2ps, mask,
                 source="corr_window"):
    """Launch the C entry `source` of `csrc/<source>.cu` (both kernels take
    the same arguments)."""
    from . import build

    fn = getattr(build.load(source), source)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    E, HW, L = xs.shape
    C = f1_rows.shape[2]
    dev = f1_rows.device
    if mask is None:
        mask = torch.ones((E,), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * L)(*[f.data_ptr() for f in f2_levels])
    rows = (ctypes.c_int64 * L)(*[f.shape[1] for f in f2_levels])
    widths = (ctypes.c_int64 * L)(*[int(w) for w in w2ps])
    with torch.cuda.device(dev):
        out = torch.empty((E, HW, L, NX * NX), dtype=torch.float32,
                          device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(f1_rows.data_ptr(), ptrs, rows, widths, ii.data_ptr(),
                 jj.data_ptr(), mask.data_ptr(), xs.data_ptr(),
                 out.data_ptr(), E, HW, C, L, stream)
    if err != 0:
        raise RuntimeError(f"{source} kernel launch failed: "
                           f"cudaError {err}")
    return out


def corr_window_multilevel(f1_rows: torch.Tensor,
                           f2_levels: Sequence[torch.Tensor],
                           ii: torch.Tensor, jj: torch.Tensor,
                           xs: torch.Tensor, w2ps: Sequence[int],
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """All levels in one launch -> [E, HW, L, 64] (TPU kernel 2): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.
    `corr_window_multilevel.launches` counts kernel launches."""
    _check(f1_rows, f2_levels, ii, jj, xs, w2ps, mask)
    if f1_rows.device.type == "cuda":
        out = _launch_cuda(f1_rows, f2_levels, ii, jj, xs, w2ps, mask)
        corr_window_multilevel.launches += 1
        return out
    if f1_rows.device.type == "cpu":
        return corr_window_multilevel_plain(f1_rows, f2_levels, ii, jj, xs,
                                            w2ps, mask)
    raise ValueError(f"unsupported device {f1_rows.device}")


def corr_window_multilevel_mma(f1_rows: torch.Tensor,
                               f2_levels: Sequence[torch.Tensor],
                               ii: torch.Tensor, jj: torch.Tensor,
                               xs: torch.Tensor, w2ps: Sequence[int],
                               mask: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """All levels in one launch on the tensor cores -> [E, HW, L, 64] (TPU
    kernel 2b, `mxu=True`): the same contract as `corr_window_multilevel`.
    The CUDA kernel for CUDA tensors, the plain block version for CPU
    tensors. `corr_window_multilevel_mma.launches` counts kernel
    launches."""
    _check(f1_rows, f2_levels, ii, jj, xs, w2ps, mask, mma=True)
    if f1_rows.device.type == "cuda":
        out = _launch_cuda(f1_rows, f2_levels, ii, jj, xs, w2ps, mask,
                           source="corr_window_mma")
        corr_window_multilevel_mma.launches += 1
        return out
    if f1_rows.device.type == "cpu":
        return corr_window_multilevel_mma_plain(f1_rows, f2_levels, ii, jj,
                                                xs, w2ps, mask)
    raise ValueError(f"unsupported device {f1_rows.device}")


def corr_window(f1_rows: torch.Tensor, f2_rows_pad: torch.Tensor,
                ii: torch.Tensor, jj: torch.Tensor, xs: torch.Tensor,
                w2p: int) -> torch.Tensor:
    """One level -> [E, HW, 64] (TPU kernel 3): the same device code as
    `corr_window_multilevel`, launched for one level.
    `corr_window.launches` counts kernel launches."""
    xs1 = xs[..., None]
    _check(f1_rows, [f2_rows_pad], ii, jj, xs1, [w2p], None)
    if f1_rows.device.type == "cuda":
        out = _launch_cuda(f1_rows, [f2_rows_pad], ii, jj, xs1, [w2p], None)
        corr_window.launches += 1
        return out[:, :, 0]
    if f1_rows.device.type == "cpu":
        return corr_window_plain(f1_rows, f2_rows_pad, ii, jj, xs, w2p)
    raise ValueError(f"unsupported device {f1_rows.device}")


corr_window_multilevel.launches = 0
corr_window_multilevel_mma.launches = 0
corr_window.launches = 0
