"""Integer-offset correlation windows over a padded feature pyramid.

Port of the Pallas kernels `corr_window_int_multilevel` (all pyramid
levels in one launch; its `mxu=True` variant) and `corr_window_int` (one
level) of mneslam_tpu/ops/pallas_kernels.py. On CUDA tensors the wrappers
launch the hand-written kernels in `csrc/corr_window.cu` (kernels 2 and 3)
and `csrc/corr_window_mma.cu` (kernel 2b, tensor cores) or raise; on CPU
tensors they run the plain PyTorch versions below. There is no size gate
and no fallback.

Two designs of each kernel. The box design (`corr_window_multilevel`,
`corr_window`, `corr_window_multilevel_mma`; `csrc/corr_box.cuh`) runs one
block per (edge, 4 x 4 tile of the H x W pixel grid), stages the union of
the tile's windows (the box) in shared memory once per level and takes the
tile's dots with every box row as a small dense product (fp32 FMAs, or
3xTF32 `mma.sync` for 2b); a tile whose box does not fit takes the row
design inside the same kernel (`box_path_share` applies the kernel's
rule). It needs the grid width W (`width`), which the callers take from
the pyramid. The row design of the first port stays reachable as
`corr_window_multilevel_rows` and `corr_window_multilevel_mma_rows`, and
`corr_window_multilevel_unrolled` launches the former with its pixel loop
unrolled U-fold (the counterparts of the TPU probe tools/prof_corr6.py).
No caller on the main path uses those three.

Contract, the same on both paths. f1_rows [N, HW, C] float32 (level 0,
already scaled by 1/4, HW = H * W row-major); each f2 level [N, R_l, C]
float32, the zero-padded level in row layout with padded width w2p_l; ii,
jj [E] int32; xs int32 slab starts ([E, HW, L] for the multi-level
entries, [E, HW] for the per-level one); mask [E] int32 or None (all edges
real). The output is float32, j-major: out[e, p, l, j * 8 + i] =
f1_rows[ii[e], p] . f2_l[jj[e], clamp(xs[e, p, l] + j * w2p_l, 0, R_l - 8)
+ i], and all zeros for an edge with mask[e] == 0. The window is 8 x 8
(radius 3); kernel 2 takes C a multiple of 32, kernel 2b C of 32, 64 or
128.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

NX = 8                      # window side: 2 * radius + 2 at radius 3
UNROLLS = (1, 2, 4, 8, 16)  # pixel-loop unrolls of `corr_window_unrolled`
TILE = (4, 4)               # the box design's pixel tile (rows, columns)
BOX_ROWS = 160              # the box design's budget of f2 rows per box
_VOLUME_BYTES = 1 << 28     # plain version: dot volume per edge chunk


def _window_rows(xs: torch.Tensor, w2p: int, n_rows: int) -> torch.Tensor:
    """[..., 64] f2 rows of the 8 x 8 windows at slab starts xs [...],
    j-major, each window row's start clamped to [0, n_rows - 8] as the
    kernels clamp it."""
    j = torch.arange(NX, device=xs.device) * int(w2p)
    i = torch.arange(NX, device=xs.device)
    starts = (xs.long()[..., None] + j).clamp(0, n_rows - NX)
    return (starts[..., None] + i).flatten(-2)


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
        chunk = max(1, _VOLUME_BYTES // max(HW * f2.shape[1] * 4, 1))
        for e0 in range(0, E, chunk):
            sl = slice(e0, min(e0 + chunk, E))
            vol = torch.bmm(f1_rows[ii[sl]],
                            f2[jj[sl]].transpose(1, 2))        # [c, HW, R]
            rows = _window_rows(xs[sl, :, lvl], w2p, f2.shape[1])
            out[sl, :, lvl] = vol.gather(2, rows)           # [c, HW, 64]
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
        for e0 in range(0, E, chunk):
            sl = slice(e0, min(e0 + chunk, E))
            c = sl.stop - e0
            rows = _window_rows(xs[sl, :, lvl], w2p, f2.shape[1])
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


def box_path_share(xs: torch.Tensor, level_rows: Sequence[int],
                   w2ps: Sequence[int], width: int,
                   mask: Optional[torch.Tensor] = None) -> List[float]:
    """Per level, the share of (real edge, pixel tile) pairs that take the
    box design's box path, by the kernel's rule (`csrc/corr_box.cuh`): every
    pixel of the 4 x 4 tile (the ragged edge tiles hold fewer) has a slab
    start that no window row clamps and whose rows do not wrap, and the box
    (y span + 8) x (x span + 8) holds at most BOX_ROWS rows. xs [E, HW, L];
    level_rows: R_l of each level."""
    E, HW, L = xs.shape
    H = HW // width
    th, tw = TILE
    Hp, Wp = -(-H // th) * th, -(-width // tw) * tw
    real = (torch.ones(E, dtype=torch.bool, device=xs.device) if mask is None
            else mask != 0)
    shares = []
    for lvl in range(L):
        s = xs[real, :, lvl].long().reshape(-1, H, width)
        rows, w2p = int(level_rows[lvl]), int(w2ps[lvl])
        y, x = s.div(w2p, rounding_mode="floor"), s.remainder(w2p)
        ok = (s >= 0) & (s + (NX - 1) * w2p <= rows - NX) & (x + NX <= w2p)
        pad = (0, Wp - width, 0, Hp - H)

        def tiles(t, fill):
            t = torch.nn.functional.pad(t, pad, value=fill)
            return t.reshape(-1, Hp // th, th, Wp // tw, tw).transpose(
                2, 3).reshape(-1, Hp // th, Wp // tw, th * tw)

        big = 1 << 40
        t_ok = tiles(ok.long(), 1).min(-1).values
        span = [tiles(v, big).min(-1).values for v in (y, x)]
        top = [tiles(v, -big).max(-1).values for v in (y, x)]
        n_box = (top[0] - span[0] + NX) * (top[1] - span[1] + NX)
        box = (t_ok == 1) & (n_box <= BOX_ROWS)
        shares.append(float(box.float().mean()) if box.numel() else 0.0)
    return shares


def _check(f1_rows, f2_levels, ii, jj, xs, w2ps, mask, mma=False,
           width=None):
    dev = f1_rows.device
    if f1_rows.dim() != 3:
        raise ValueError(f"f1_rows must be [N, HW, C], got "
                         f"{tuple(f1_rows.shape)}")
    N, HW, C = f1_rows.shape
    if width is not None and (int(width) < 1 or HW % int(width) != 0):
        raise ValueError(f"width {width} does not divide HW = {HW}: the "
                         f"pixel grid is H x width")
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
        if dev.type == "cuda" and t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} must be 16-byte aligned (the kernels "
                             f"read float4 and copy 16 bytes at a time)")
    for k, (f, w2p) in enumerate(zip(f2_levels, w2ps)):
        if f.dim() != 3 or f.shape[0] != N or f.shape[2] != C:
            raise ValueError(f"f2_levels[{k}] must be [{N}, R, {C}], got "
                             f"{tuple(f.shape)}")
        if f.shape[1] % int(w2p) != 0 or f.shape[1] < NX * int(w2p):
            raise ValueError(f"f2_levels[{k}] rows {f.shape[1]} are not a "
                             f"padded image of width {w2p}")


def _launch_cuda(f1_rows, f2_levels, ii, jj, xs, w2ps, mask, source, entry,
                 width=None, unroll=None):
    """Launch the C entry `entry` of `csrc/<source>.cu`. Every entry takes
    the same arguments; the box design's entries also take the grid width
    after HW, `corr_window_unrolled` the unroll before the stream."""
    from . import build

    fn = getattr(build.load(source), entry)
    mid = () if width is None else (int(width),)
    extra = () if unroll is None else (int(unroll),)
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int64] * (4 + len(mid)
                                                                + len(extra))
                   + [ctypes.c_void_p])
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
                 out.data_ptr(), E, HW, *mid, C, L, *extra, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err}")
    return out


def _unsupported(dev):
    return ValueError(f"unsupported device {dev}")


def corr_window_multilevel(f1_rows: torch.Tensor,
                           f2_levels: Sequence[torch.Tensor],
                           ii: torch.Tensor, jj: torch.Tensor,
                           xs: torch.Tensor, w2ps: Sequence[int], width: int,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """All levels in one launch -> [E, HW, L, 64] (TPU kernel 2), the box
    design on the H x `width` pixel grid: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.
    `corr_window_multilevel.launches` counts kernel launches."""
    _check(f1_rows, f2_levels, ii, jj, xs, w2ps, mask, width=width)
    if f1_rows.device.type == "cuda":
        out = _launch_cuda(f1_rows, f2_levels, ii, jj, xs, w2ps, mask,
                           "corr_window", "corr_window", width=width)
        corr_window_multilevel.launches += 1
        return out
    if f1_rows.device.type == "cpu":
        return corr_window_multilevel_plain(f1_rows, f2_levels, ii, jj, xs,
                                            w2ps, mask)
    raise _unsupported(f1_rows.device)


def corr_window_multilevel_rows(f1_rows: torch.Tensor,
                                f2_levels: Sequence[torch.Tensor],
                                ii: torch.Tensor, jj: torch.Tensor,
                                xs: torch.Tensor, w2ps: Sequence[int],
                                mask: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """`corr_window_multilevel` in the row design of the first port (one
    block per edge and 16 consecutive pixels, each window row's f2 rows read
    from L1 / L2). The plain version for CPU tensors.
    `corr_window_multilevel_rows.launches` counts kernel launches."""
    _check(f1_rows, f2_levels, ii, jj, xs, w2ps, mask)
    if f1_rows.device.type == "cuda":
        out = _launch_cuda(f1_rows, f2_levels, ii, jj, xs, w2ps, mask,
                           "corr_window", "corr_window_rows")
        corr_window_multilevel_rows.launches += 1
        return out
    if f1_rows.device.type == "cpu":
        return corr_window_multilevel_plain(f1_rows, f2_levels, ii, jj, xs,
                                            w2ps, mask)
    raise _unsupported(f1_rows.device)


def corr_window_multilevel_unrolled(f1_rows: torch.Tensor,
                                    f2_levels: Sequence[torch.Tensor],
                                    ii: torch.Tensor, jj: torch.Tensor,
                                    xs: torch.Tensor, w2ps: Sequence[int],
                                    mask: Optional[torch.Tensor] = None,
                                    unroll: int = 16) -> torch.Tensor:
    """`corr_window_multilevel_rows` with the kernel's pixel loop unrolled
    `unroll`-fold (1, 2, 4, 8 or 16): the counterparts of the TPU probe's
    pixel-loop unroll (tools/prof_corr6.py). Each output's FMA sequence is
    the row design's, so the result is the same bit for bit. The plain
    version for CPU tensors is `corr_window_multilevel_plain`.
    `corr_window_multilevel_unrolled.launches` counts kernel launches."""
    _check(f1_rows, f2_levels, ii, jj, xs, w2ps, mask)
    if unroll not in UNROLLS:
        raise ValueError(f"unroll must be one of {UNROLLS}, got {unroll}")
    if f1_rows.device.type == "cuda":
        out = _launch_cuda(f1_rows, f2_levels, ii, jj, xs, w2ps, mask,
                           "corr_window", "corr_window_unrolled",
                           unroll=unroll)
        corr_window_multilevel_unrolled.launches += 1
        return out
    if f1_rows.device.type == "cpu":
        return corr_window_multilevel_plain(f1_rows, f2_levels, ii, jj, xs,
                                            w2ps, mask)
    raise _unsupported(f1_rows.device)


def corr_window_multilevel_mma(f1_rows: torch.Tensor,
                               f2_levels: Sequence[torch.Tensor],
                               ii: torch.Tensor, jj: torch.Tensor,
                               xs: torch.Tensor, w2ps: Sequence[int],
                               width: int,
                               mask: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """All levels in one launch on the tensor cores -> [E, HW, L, 64] (TPU
    kernel 2b, `mxu=True`), the box design: the same contract as
    `corr_window_multilevel`. The CUDA kernel for CUDA tensors, the plain
    block version for CPU tensors. `corr_window_multilevel_mma.launches`
    counts kernel launches."""
    _check(f1_rows, f2_levels, ii, jj, xs, w2ps, mask, mma=True, width=width)
    if f1_rows.device.type == "cuda":
        out = _launch_cuda(f1_rows, f2_levels, ii, jj, xs, w2ps, mask,
                           "corr_window_mma", "corr_window_mma", width=width)
        corr_window_multilevel_mma.launches += 1
        return out
    if f1_rows.device.type == "cpu":
        return corr_window_multilevel_mma_plain(f1_rows, f2_levels, ii, jj,
                                                xs, w2ps, mask)
    raise _unsupported(f1_rows.device)


def corr_window_multilevel_mma_rows(f1_rows: torch.Tensor,
                                    f2_levels: Sequence[torch.Tensor],
                                    ii: torch.Tensor, jj: torch.Tensor,
                                    xs: torch.Tensor, w2ps: Sequence[int],
                                    mask: Optional[torch.Tensor] = None
                                    ) -> torch.Tensor:
    """`corr_window_multilevel_mma` in the row design of the first port (a
    warp per edge, 8 consecutive pixels and level; 8-wide products of
    which one column is kept). The plain block version for CPU tensors.
    `corr_window_multilevel_mma_rows.launches` counts kernel launches."""
    _check(f1_rows, f2_levels, ii, jj, xs, w2ps, mask, mma=True)
    if f1_rows.device.type == "cuda":
        out = _launch_cuda(f1_rows, f2_levels, ii, jj, xs, w2ps, mask,
                           "corr_window_mma", "corr_window_mma_rows")
        corr_window_multilevel_mma_rows.launches += 1
        return out
    if f1_rows.device.type == "cpu":
        return corr_window_multilevel_mma_plain(f1_rows, f2_levels, ii, jj,
                                                xs, w2ps, mask)
    raise _unsupported(f1_rows.device)


def corr_window(f1_rows: torch.Tensor, f2_rows_pad: torch.Tensor,
                ii: torch.Tensor, jj: torch.Tensor, xs: torch.Tensor,
                w2p: int, width: int) -> torch.Tensor:
    """One level -> [E, HW, 64] (TPU kernel 3): the same device code as
    `corr_window_multilevel`, launched for one level.
    `corr_window.launches` counts kernel launches."""
    xs1 = xs[..., None]
    _check(f1_rows, [f2_rows_pad], ii, jj, xs1, [w2p], None, width=width)
    if f1_rows.device.type == "cuda":
        out = _launch_cuda(f1_rows, [f2_rows_pad], ii, jj, xs1, [w2p], None,
                           "corr_window", "corr_window", width=width)
        corr_window.launches += 1
        return out[:, :, 0]
    if f1_rows.device.type == "cpu":
        return corr_window_plain(f1_rows, f2_rows_pad, ii, jj, xs, w2p)
    raise _unsupported(f1_rows.device)


corr_window_multilevel.launches = 0
corr_window_multilevel_rows.launches = 0
corr_window_multilevel_unrolled.launches = 0
corr_window_multilevel_mma.launches = 0
corr_window_multilevel_mma_rows.launches = 0
corr_window.launches = 0
