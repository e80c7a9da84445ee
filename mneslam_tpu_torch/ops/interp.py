"""Bilinear plane sampling for the tri-plane map (the packed sampler).

Port of the default `packed` path of `mneslam_tpu/ops/interp.py`:
coordinates in [-1, 1], align_corners=True (grid corners at pixel centers 0
and size-1), border clamping. `sample_plane_packed` gathers one row of a
`pack_corners` table per point (all four bilinear corners at once); its
backward scatters the four corner cotangents with ONE row scatter-add
(`kernels.scatter_add_rows`, the CUDA kernel on the GPU) and folds the
packed cotangent back onto the plane with the dense adjoint of the pack.
"""

from __future__ import annotations

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
            vals = torch.cat([
                dout * ((1 - wx) * (1 - wy))[:, None],
                dout * (wx * (1 - wy))[:, None],
                dout * ((1 - wx) * wy)[:, None],
                dout * (wx * wy)[:, None],
            ], dim=-1)                                     # [N, 4C]
            d_packed = scatter_add_rows(idx, vals, H * W)
            d_plane = _unpack_corners_adjoint(d_packed, C, H, W)
        if ctx.needs_input_grad[1]:
            g00, g01, g10, g11 = (g[:, i * C:(i + 1) * C] for i in range(4))
            gx = (g01 - g00) * (1 - wy)[:, None] + (g11 - g10) * wy[:, None]
            gy = (g10 - g00) * (1 - wx)[:, None] + (g11 - g01) * wx[:, None]
            # a clip passes its gradient on [min, max] inclusive
            mx = ((coords[:, 0] >= -1.0) & (coords[:, 0] <= 1.0)).to(dout.dtype)
            my = ((coords[:, 1] >= -1.0) & (coords[:, 1] <= 1.0)).to(dout.dtype)
            dx = (gx * dout).sum(-1) * (0.5 * (W - 1)) * mx
            dy = (gy * dout).sum(-1) * (0.5 * (H - 1)) * my
            d_coords = torch.stack([dx, dy], dim=-1).to(coords.dtype)
        return d_plane, d_coords


def sample_packed_table(table: torch.Tensor, coords: torch.Tensor, H: int,
                        W: int) -> torch.Tensor:
    """Forward of `sample_plane_packed` from a table already packed by
    `pack_corners` (no autograd), so that a chunked query packs each plane
    once: [H*W, 4C] table, coords [N, 2] -> [N, C], bit for bit the
    packed sampler's forward."""
    C = table.shape[1] // 4
    idx, wx, wy = _cell(coords, H, W)
    return _combine(table[idx], wx.to(table.dtype), wy.to(table.dtype), C)


def sample_plane_packed(plane: torch.Tensor,
                        coords: torch.Tensor) -> torch.Tensor:
    """plane [C, H, W], coords [N, 2] in [-1, 1] -> [N, C]; equal to
    `grid_sample_2d(plane, coords)`, with the packed-row backward."""
    return _SamplePlanePacked.apply(plane, coords)
