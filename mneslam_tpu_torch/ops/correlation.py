"""Correlation-volume features for the recurrent tracker.

Port of `mneslam_tpu/ops/correlation.py`: all-pairs feature correlation
over a 4-level average-pooled pyramid, sampled in a (2r+1)^2 window around
per-pixel lookup centres with bilinear weights and zero padding, never
storing the O(N * HW^2) volume. The semantics are the reference CUDA
sampler's: window channels laid out [x_offset, y_offset] (x slower),
levels concatenated (4 * 49 = 196 channels), corners outside the volume
contribute zero, features pre-scaled by 1/4 on each side.

`alt_corr` is the path the tracker takes: the integer 8 x 8 window dots
of every level come from one `kernels.corr_window.corr_window_multilevel`
call (the CUDA kernel on a GPU tensor, its plain version on a CPU tensor);
the bilinear combine of the scalar field is plain torch. `alt_corr_per_level`
runs the per-level entry (TPU kernel 3) instead; `alt_corr_plain` is the
slab-gather formulation (the JAX `alt_corr_xla`).

One difference from the JAX `alt_corr_pallas_ml` / `alt_corr_pallas`: a
lookup centre more than r + 1 pixels outside a level has its slab start
clipped there, so those functions return the border rows' dots for a
window that lies wholly outside the volume. Here such a window is zero,
as in the reference sampler, `alt_corr_xla` and `alt_corr_plain`.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from ..kernels.corr_window import corr_window, corr_window_multilevel
from .projective import coords_grid


def build_pyramid(fmaps: torch.Tensor, num_levels: int = 4
                  ) -> List[torch.Tensor]:
    """[N, C, H, W] -> [N, C, H/2^i, W/2^i] per level, scaled by 1/4, fp32
    (the reference casts features to float before its altcorr kernel)."""
    f = fmaps.float() / 4.0
    pyr = [f]
    for _ in range(num_levels - 1):
        f = F.avg_pool2d(f, 2, 2)
        pyr.append(f)
    return pyr


def _padded_levels(pyr, coords, radius: int):
    """Zero-padded levels in row layout, their widths, the clipped slab
    starts xs [E, HW, L] int32, and per level the bilinear fractions and
    the mask of centres whose window reaches into the level."""
    N, C, H, W = pyr[0].shape
    E = coords.shape[0]
    nx = 2 * radius + 2
    padl = 2 * radius + 1
    cflat = coords.reshape(E, H * W, 2).float()
    f2_levels, w2ps, xs_levels, fracs = [], [], [], []
    for lvl, f2 in enumerate(pyr):
        H2, W2 = f2.shape[2], f2.shape[3]
        w2p = W2 + padl + nx
        f2_pad = F.pad(f2.permute(0, 2, 3, 1), (0, 0, padl, nx, padl, nx))
        f2_levels.append(f2_pad.reshape(N, -1, C).contiguous())
        w2ps.append(w2p)
        c = cflat / (2 ** lvl)
        x0 = torch.floor(c[..., 0])
        y0 = torch.floor(c[..., 1])
        inside = ((x0 >= -(radius + 1)) & (x0 <= W2 + radius)
                  & (y0 >= -(radius + 1)) & (y0 <= H2 + radius))
        fracs.append((c[..., 0] - x0, c[..., 1] - y0, inside))
        # clip so every slab read stays inside the padded level (the second,
        # integer clamp also catches NaN lookup centres)
        x0c = x0.clamp(-(radius + 1), W2 + radius).int().clamp(
            -(radius + 1), W2 + radius)
        y0c = y0.clamp(-(radius + 1), H2 + radius).int().clamp(
            -(radius + 1), H2 + radius)
        xs_levels.append((y0c - radius + padl) * w2p
                         + (x0c - radius + padl))
    xs = torch.stack(xs_levels, dim=-1).to(torch.int32).contiguous()
    return f2_levels, w2ps, xs, fracs


def _bilinear(ci: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
              inside: torch.Tensor, rd: int) -> torch.Tensor:
    """j-major integer window ci [E, HW, nx(j), nx(i)] -> [E, HW, rd*rd]
    with channel i * rd + j (x offset slower); zero where not `inside`."""
    w00 = ((1 - fx) * (1 - fy))[..., None, None]
    w10 = (fx * (1 - fy))[..., None, None]
    w01 = ((1 - fx) * fy)[..., None, None]
    w11 = (fx * fy)[..., None, None]
    out = (ci[..., :rd, :rd] * w00 + ci[..., :rd, 1:] * w10
           + ci[..., 1:, :rd] * w01 + ci[..., 1:, 1:] * w11)
    out = torch.where(inside[..., None, None], out, torch.zeros_like(out))
    E, HW = out.shape[:2]
    return out.transpose(-1, -2).reshape(E, HW, rd * rd)


def alt_corr(fmaps: torch.Tensor, ii: torch.Tensor, jj: torch.Tensor,
             coords: torch.Tensor, radius: int = 3,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Correlation features for an edge set -> [E, L*(2r+1)^2, H, W].

    fmaps [N, C, H, W] (unscaled), ii / jj [E], coords [E, H, W, 2] lookup
    centres in level-0 pixels, mask [E] (0 = padded edge: all-zero output).
    The port of `alt_corr_pallas_ml`: the pyramid and its padded copies
    are rebuilt for the whole buffer on every call, as in the JAX package."""
    pyr = build_pyramid(fmaps)
    N, C, H, W = pyr[0].shape
    HW = H * W
    E = ii.shape[0]
    rd = 2 * radius + 1
    nx = rd + 1
    f1_rows = pyr[0].permute(0, 2, 3, 1).reshape(N, HW, C).contiguous()
    f2_levels, w2ps, xs, fracs = _padded_levels(pyr, coords, radius)
    m = None if mask is None else mask.to(torch.int32).contiguous()
    corr_int = corr_window_multilevel(
        f1_rows, f2_levels, ii.to(torch.int32).contiguous(),
        jj.to(torch.int32).contiguous(), xs, w2ps, mask=m,
    ).reshape(E, HW, len(pyr), nx, nx)
    corr = torch.cat([_bilinear(corr_int[:, :, lvl], *frac, rd)
                      for lvl, frac in enumerate(fracs)], dim=-1)
    return corr.permute(0, 2, 1).reshape(E, -1, H, W)


def alt_corr_per_level(fmaps: torch.Tensor, ii: torch.Tensor,
                       jj: torch.Tensor, coords: torch.Tensor,
                       radius: int = 3) -> torch.Tensor:
    """`alt_corr` with one `corr_window` call per level (the JAX
    `alt_corr_pallas`, TPU kernel 3); no mask."""
    pyr = build_pyramid(fmaps)
    N, C, H, W = pyr[0].shape
    HW = H * W
    E = ii.shape[0]
    rd = 2 * radius + 1
    nx = rd + 1
    f1_rows = pyr[0].permute(0, 2, 3, 1).reshape(N, HW, C).contiguous()
    f2_levels, w2ps, xs, fracs = _padded_levels(pyr, coords, radius)
    ii32 = ii.to(torch.int32).contiguous()
    jj32 = jj.to(torch.int32).contiguous()
    out = []
    for lvl, frac in enumerate(fracs):
        ci = corr_window(f1_rows, f2_levels[lvl], ii32, jj32,
                         xs[..., lvl].contiguous(), w2ps[lvl])
        out.append(_bilinear(ci.reshape(E, HW, nx, nx), *frac, rd))
    return torch.cat(out, dim=-1).permute(0, 2, 1).reshape(E, -1, H, W)


def _corr_level_plain(f1_rows: torch.Tensor, f2: torch.Tensor,
                      coords: torch.Tensor, radius: int) -> torch.Tensor:
    """One level for a batch of edges, slab-gather form (the JAX
    `_corr_edge_level`): f1_rows [e, HW, C], f2 [e, C, H2, W2], coords
    [e, HW, 2] in level pixels -> [e, HW, (2r+1)^2]."""
    e, HW, C = f1_rows.shape
    H2, W2 = f2.shape[2], f2.shape[3]
    rd = 2 * radius + 1
    nx = rd + 1
    x0f = torch.floor(coords[..., 0])
    y0f = torch.floor(coords[..., 1])
    fx, fy = coords[..., 0] - x0f, coords[..., 1] - y0f
    x0, y0 = x0f.long(), y0f.long()

    padl = 2 * radius + 1
    f2_pad = F.pad(f2.permute(0, 2, 3, 1), (0, 0, padl, nx))  # pad x only
    x0c = x0.clamp(-(radius + 1), W2 + radius)
    fully_out = (x0 < -(radius + 1)) | (x0 > W2 + radius)
    xs = x0c - radius + padl
    n = torch.arange(nx, device=f2.device)
    x_pos = x0c[..., None] + (n - radius)
    x_inb = (x_pos >= 0) & (x_pos < W2) & ~fully_out[..., None]
    eidx = torch.arange(e, device=f2.device)[:, None, None]

    cols = []
    for j in range(nx):                                  # y offset index
        yi = y0 + (j - radius)
        y_inb = (yi >= 0) & (yi < H2)
        rows = f2_pad[eidx, yi.clamp(0, H2 - 1)[..., None],
                      xs[..., None] + n]                 # [e, HW, nx, C]
        dot = torch.einsum("epnc,epc->epn", rows, f1_rows)
        cols.append(dot * (x_inb & y_inb[..., None]))
    ci = torch.stack(cols, dim=-1)                       # [e, HW, i, j]
    out = (ci[..., :rd, :rd] * ((1 - fx) * (1 - fy))[..., None, None]
           + ci[..., 1:, :rd] * (fx * (1 - fy))[..., None, None]
           + ci[..., :rd, 1:] * ((1 - fx) * fy)[..., None, None]
           + ci[..., 1:, 1:] * (fx * fy)[..., None, None])
    return out.reshape(e, HW, rd * rd)


def alt_corr_plain(fmaps: torch.Tensor, ii: torch.Tensor, jj: torch.Tensor,
                   coords: torch.Tensor, radius: int = 3,
                   chunk: int = 8) -> torch.Tensor:
    """The slab-gather formulation (the JAX `alt_corr_xla`), `chunk` edges
    at a time -> [E, L*(2r+1)^2, H, W]."""
    pyr = build_pyramid(fmaps)
    N, C, H, W = pyr[0].shape
    E = ii.shape[0]
    ii, jj = ii.long(), jj.long()
    cflat = coords.reshape(E, H * W, 2).float()
    out = []
    for e0 in range(0, E, chunk):
        sl = slice(e0, min(e0 + chunk, E))
        f1 = pyr[0][ii[sl]].flatten(2).transpose(1, 2)   # [e, HW, C]
        levels = [_corr_level_plain(f1, lv[jj[sl]], cflat[sl] / (2 ** k),
                                    radius)
                  for k, lv in enumerate(pyr)]
        out.append(torch.cat(levels, dim=-1).transpose(1, 2))
    return torch.cat(out).reshape(E, -1, H, W)


def self_corr(fmap_prev: torch.Tensor, fmap_new: torch.Tensor,
              radius: int = 3) -> torch.Tensor:
    """Single-pair correlation at the identity grid, the motion filter's
    lookup (motion_filter.py:70-74) -> [1, 196, H, W]."""
    _, H, W = fmap_prev.shape
    dev = fmap_prev.device
    coords0 = coords_grid(H, W, device=dev)[None]
    idx0 = torch.zeros((1,), dtype=torch.int32, device=dev)
    return alt_corr(torch.stack([fmap_prev, fmap_new.to(fmap_prev.dtype)]),
                    idx0, idx0 + 1, coords0, radius=radius)
