"""Bilinear plane sampling for the tri-plane map.

Port of `mneslam_tpu/ops/interp.py`'s samplers:
coordinates in [-1, 1], align_corners=True (grid corners at pixel centers 0
and size-1), border clamping. `sample_plane_packed` gathers one row of a
`pack_corners` table per point (all four bilinear corners at once); its
backward scatters the four corner cotangents with ONE row scatter-add
(`kernels.scatter_add_rows`, the CUDA kernel on the GPU) and folds the
packed cotangent back onto the plane with the dense adjoint of the pack.

The row-sharded mapper's seam (`parallel/mesh.make_row_sharded_pack`)
samples a packed table directly (`PackedPlane`, `sample_packed_table`):
the table is the differentiable input and its cotangent is the raw
scatter, folded later block by block (`fold_corners_rows`).

The other samplers of `MNESLAM_PLANE_SAMPLER` (`models/scene_rep.py`):
`rows` is `grid_sample_2d` (four corner gathers, plain autograd);
`merged` samples one `pack_corners` table of the coarse plane upsampled
onto the fine grid (`upsample_exact`) beside the fine plane through
`sample_packed_table`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.scatter_add_rows import scatter_add_rows


def _cell(coords: torch.Tensor, H: int, W: int):
    """Corner index and fractional weights of each point: (idx int64 [N],
    wx [N], wy [N]) with the continuous coordinate border-clamped."""
    x = torch.clamp((coords[:, 0] + 1.0) * 0.5 * (W - 1), 0.0, W - 1)
    y = torch.clamp((coords[:, 1] + 1.0) * 0.5 * (H - 1), 0.0, H - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x0i = torch.clamp(x0.long(), 0, W - 1)
    y0i = torch.clamp(y0.long(), 0, H - 1)
    return y0i * W + x0i, x - x0, y - y0


def _combine(g: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor, C: int):
    """Bilinear blend of gathered corner rows g [N, 4C] -> [N, C]."""
    return (g[:, 0 * C:1 * C] * ((1 - wx) * (1 - wy))[:, None]
            + g[:, 1 * C:2 * C] * (wx * (1 - wy))[:, None]
            + g[:, 2 * C:3 * C] * ((1 - wx) * wy)[:, None]
            + g[:, 3 * C:4 * C] * (wx * wy)[:, None])


def grid_sample_2d(plane: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of plane [C, H, W] at coords [N, 2] ((x, y) in
    [-1, 1]; x indexes W, y indexes H) -> [N, C]. Four corner gathers from
    an [H*W, C] view; plain autograd."""
    C, H, W = plane.shape
    idx, wx, wy = _cell(coords, H, W)
    x0i, y0i = idx % W, idx // W
    x1i = torch.clamp(x0i + 1, max=W - 1)
    y1i = torch.clamp(y0i + 1, max=H - 1)
    flat = plane.reshape(C, H * W).T
    g = torch.cat([flat[y0i * W + x0i], flat[y0i * W + x1i],
                   flat[y1i * W + x0i], flat[y1i * W + x1i]], dim=-1)
    return _combine(g, wx, wy, C)


def pack_corners_hwc(hwc: torch.Tensor) -> torch.Tensor:
    """[H, W, C] -> packed [H*W, 4C]: row (y*W + x) holds the corners
    (y, x), (y, x+1), (y+1, x), (y+1, x+1), border-clamped."""
    H, W, C = hwc.shape
    sx = torch.cat([hwc[:, 1:], hwc[:, -1:]], dim=1)
    sy = torch.cat([hwc[1:], hwc[-1:]], dim=0)
    sxy = torch.cat([sy[:, 1:], sy[:, -1:]], dim=1)
    return torch.cat([hwc, sx, sy, sxy], dim=-1).reshape(H * W, 4 * C)


def pack_corners(plane: torch.Tensor) -> torch.Tensor:
    """plane [C, H, W] -> packed [H*W, 4C] (see `pack_corners_hwc`)."""
    return pack_corners_hwc(plane.permute(1, 2, 0))


def _shift_back_x(a: torch.Tensor) -> torch.Tensor:
    """Adjoint of concat([p[:, 1:], p[:, -1:]], dim=1) on [H, W, C]."""
    out = torch.cat([torch.zeros_like(a[:, :1]), a[:, :-1]], dim=1)
    out[:, -1] += a[:, -1]
    return out


def _shift_back_y(a: torch.Tensor) -> torch.Tensor:
    """Adjoint of concat([p[1:], p[-1:]], dim=0) on [H, W, C]."""
    out = torch.cat([torch.zeros_like(a[:1]), a[:-1]], dim=0)
    out[-1] += a[-1]
    return out


def _fold_b_rows(d_rows: torch.Tensor) -> torch.Tensor:
    """The y-shift operand of the corner fold on whole y-rows,
    b = d10 + shift_back_x(d11), row-local (the x-shift never crosses
    y-rows): d_rows [Hb, W, 4C] -> [Hb, W, C]."""
    C = d_rows.shape[-1] // 4
    return d_rows[..., 2 * C:3 * C] + _shift_back_x(d_rows[..., 3 * C:])


def fold_corners_rows(d_rows: torch.Tensor, H: int, W: int, y0: int = 0,
                      halo_row: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Adjoint of `pack_corners_hwc` on a block of whole y-rows.

    d_rows [Hb*W, 4C]: packed-table cotangent rows for global y in
    [y0, y0+Hb) (rows with y >= H are the row-sharding pad). halo_row
    [W, C] or None: the y-shift term entering from row y0-1, the previous
    block's last `_fold_b_rows` row (None: zeros, right for y0 == 0).
    -> the plane cotangent rows [Hb*W, C], rows y >= H zero. Folding
    consecutive blocks with their halos equals folding the whole table:
    the x-shift stays inside a y-row and the y-shift moves one y-row."""
    Hb = d_rows.shape[0] // W
    C = d_rows.shape[1] // 4
    d = d_rows.reshape(Hb, W, 4 * C)
    b = _fold_b_rows(d)
    halo = (d.new_zeros((1, W, C)) if halo_row is None
            else halo_row.reshape(1, W, C).to(d.dtype))
    y = y0 + torch.arange(Hb, device=d.device).reshape(Hb, 1, 1)
    out = (d[..., :C] + _shift_back_x(d[..., C:2 * C])
           + torch.cat([halo, b[:-1]], dim=0)
           + torch.where(y == H - 1, b, torch.zeros((), dtype=d.dtype,
                                                    device=d.device)))
    if not (y0 == 0 and Hb == H):
        out = torch.where(y < H, out, torch.zeros((), dtype=d.dtype,
                                                  device=d.device))
    return out.reshape(Hb * W, C)


def _unpack_corners_adjoint(d_packed: torch.Tensor, C: int, H: int,
                            W: int) -> torch.Tensor:
    """Adjoint of `pack_corners`: packed cotangent [H*W, 4C] -> plane
    cotangent [C, H, W]."""
    d = d_packed.reshape(H, W, 4 * C)
    d00 = d[..., 0 * C:1 * C]
    d01 = d[..., 1 * C:2 * C]
    d10 = d[..., 2 * C:3 * C]
    d11 = d[..., 3 * C:4 * C]
    out = d00 + _shift_back_x(d01) + _shift_back_y(d10 + _shift_back_x(d11))
    return out.permute(2, 0, 1).contiguous()


def _corner_vals(dout, wx, wy) -> torch.Tensor:
    """The four corners' cotangents of dout [N, C] side by side, [N, 4C]:
    the rows the sampler's backward scatter-adds into the packed table."""
    return torch.cat([dout * ((1 - wx) * (1 - wy))[:, None],
                      dout * (wx * (1 - wy))[:, None],
                      dout * ((1 - wx) * wy)[:, None],
                      dout * (wx * wy)[:, None]], dim=-1)


def _coords_cotangent(g, wx, wy, coords, dout, C: int, H: int, W: int):
    """The sample coordinates' cotangent [N, 2] from the gathered corner
    rows g [N, 4C] and the output cotangent dout [N, C]."""
    g00, g01, g10, g11 = (g[:, i * C:(i + 1) * C] for i in range(4))
    gx = (g01 - g00) * (1 - wy)[:, None] + (g11 - g10) * wy[:, None]
    gy = (g10 - g00) * (1 - wx)[:, None] + (g11 - g01) * wx[:, None]
    # a clip passes its gradient on [min, max] inclusive
    mx = ((coords[:, 0] >= -1.0) & (coords[:, 0] <= 1.0)).to(dout.dtype)
    my = ((coords[:, 1] >= -1.0) & (coords[:, 1] <= 1.0)).to(dout.dtype)
    dx = (gx * dout).sum(-1) * (0.5 * (W - 1)) * mx
    dy = (gy * dout).sum(-1) * (0.5 * (H - 1)) * my
    return torch.stack([dx, dy], dim=-1).to(coords.dtype)


class _SamplePlanePacked(torch.autograd.Function):
    """Forward: one packed-row gather per point. Backward: the corner
    cotangents [N, 4C] through one row scatter-add, then the dense unpack
    adjoint; the coordinate cotangent from the gathered corners."""

    @staticmethod
    def forward(ctx, plane, coords):
        C, H, W = plane.shape
        idx, wx, wy = _cell(coords, H, W)
        wx = wx.to(plane.dtype)
        wy = wy.to(plane.dtype)
        g = pack_corners(plane)[idx]                       # [N, 4C]
        ctx.save_for_backward(g, wx, wy, idx, coords)
        ctx.plane_shape = (C, H, W)
        return _combine(g, wx, wy, C)

    @staticmethod
    def backward(ctx, dout):
        g, wx, wy, idx, coords = ctx.saved_tensors
        C, H, W = ctx.plane_shape
        dout = dout.to(g.dtype)
        d_plane = d_coords = None
        if ctx.needs_input_grad[0]:
            d_packed = scatter_add_rows(idx, _corner_vals(dout, wx, wy),
                                        H * W)
            d_plane = _unpack_corners_adjoint(d_packed, C, H, W)
        if ctx.needs_input_grad[1]:
            d_coords = _coords_cotangent(g, wx, wy, coords, dout, C, H, W)
        return d_plane, d_coords


class PackedPlane:
    """A `pack_corners` table standing in for a plane in a params tree:
    `packed` [H*W, 4C] and the plane's shape (C, H, W). The row-sharded
    mapper renders from these, so the table (not the plane) is the
    differentiable input and its cotangent is the raw packed scatter."""

    __slots__ = ("packed", "shape")

    def __init__(self, packed: torch.Tensor, shape):
        self.packed = packed
        self.shape = tuple(int(s) for s in shape)

    def to(self, dtype) -> "PackedPlane":
        """The table cast to `dtype` (for `cast_params`)."""
        return PackedPlane(self.packed.to(dtype), self.shape)

    def __repr__(self):
        return f"PackedPlane(shape={self.shape})"


class _SamplePackedTable(torch.autograd.Function):
    """Forward: one row gather per point from a packed table. Backward:
    the table cotangent is the corner cotangents [N, 4C] through one row
    scatter-add, without the unpack fold (the caller owns the pack and its
    adjoint); the coordinate cotangent as in `_SamplePlanePacked`."""

    @staticmethod
    def forward(ctx, table, coords, H, W):
        C = table.shape[1] // 4
        idx, wx, wy = _cell(coords, H, W)
        wx = wx.to(table.dtype)
        wy = wy.to(table.dtype)
        g = table[idx]                                     # [N, 4C]
        ctx.save_for_backward(g, wx, wy, idx, coords)
        ctx.hw = (H, W)
        return _combine(g, wx, wy, C)

    @staticmethod
    def backward(ctx, dout):
        g, wx, wy, idx, coords = ctx.saved_tensors
        H, W = ctx.hw
        C = g.shape[1] // 4
        dout = dout.to(g.dtype)
        d_table = d_coords = None
        if ctx.needs_input_grad[0]:
            d_table = scatter_add_rows(idx, _corner_vals(dout, wx, wy),
                                       H * W)
        if ctx.needs_input_grad[1]:
            d_coords = _coords_cotangent(g, wx, wy, coords, dout, C, H, W)
        return d_table, d_coords, None, None


def sample_packed_table(table: torch.Tensor, coords: torch.Tensor, H: int,
                        W: int) -> torch.Tensor:
    """Bilinear sample from a table packed by `pack_corners`: [H*W, 4C]
    table, coords [N, 2] in [-1, 1] -> [N, C], bit for bit the packed
    sampler's forward. Differentiable in the table (the raw packed
    scatter, one kernel-1 call) and in the coordinates; without grad it is
    the chunked queries' sampler (each plane packed once)."""
    return _SamplePackedTable.apply(table, coords, H, W)


def sample_plane_packed(plane: torch.Tensor,
                        coords: torch.Tensor) -> torch.Tensor:
    """plane [C, H, W], coords [N, 2] in [-1, 1] -> [N, C]; equal to
    `grid_sample_2d(plane, coords)`, with the packed-row backward."""
    return _SamplePlanePacked.apply(plane, coords)


def upsample_exact(plane: torch.Tensor, k: int) -> torch.Tensor:
    """k-times upsampling of plane [C, H, W] onto the nested grid
    [C, k(H-1)+1, k(W-1)+1] (node j of an axis at coarse coordinate j/k),
    bilinear along each axis: bilinear sampling of the result equals
    bilinear sampling of the plane, since a bilinear function on a nested
    sub-cell is fixed by its corners. The merged sampler's coarse level;
    plain autograd."""
    if k == 1:
        return plane
    C, H, W = plane.shape
    w = (torch.arange(k, dtype=plane.dtype, device=plane.device)
         / k)[None, None, :, None]
    rows = plane[:, :-1, None, :] * (1 - w) + plane[:, 1:, None, :] * w
    rows = torch.cat([rows.reshape(C, k * (H - 1), W), plane[:, -1:, :]],
                     dim=1)                           # [C, k(H-1)+1, W]
    wc = w.reshape(1, 1, 1, k)
    cols = rows[:, :, :-1, None] * (1 - wc) + rows[:, :, 1:, None] * wc
    return torch.cat([cols.reshape(C, rows.shape[1], k * (W - 1)),
                      rows[:, :, -1:]], dim=2)
