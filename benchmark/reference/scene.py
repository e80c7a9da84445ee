"""The plain reference of the tri-plane SDF map and its volume rendering.

Plain PyTorch in float32, written from the method's description (ESLAM's
coarse and fine tri-planes summed per level, a OneBlob encoding of the
position, bias-free ReLU decoders for the SDF with a geometric feature and
for the colour, Co-SLAM's truncated-SDF weights and losses) with the
configuration's keys. It imports nothing of the program. Points are sampled
on each plane bilinearly (corners at the grid's nodes, coordinates clamped
to the border), by four plain gathers; autograd takes the gradients.

The configuration's grid is nested: the fine level's node count on each
axis is 2 (n_coarse - 1) + 1 where the fine cell is half the coarse one, so
a fine cell subdivides a coarse cell evenly. `param_shapes` works the
shapes out from the mapping bound grown to a multiple of
`planes_res.bound_dividable`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

ORIENTATIONS = (("xy", (0, 1)), ("xz", (0, 2)), ("yz", (1, 2)))


def grown_bound(cfg) -> np.ndarray:
    """The mapping bound [3, 2] with each upper end moved to lo + (floor(
    len / div) + 1) div, float32."""
    b = np.asarray(cfg["mapping"]["bound"], np.float32) * cfg["scale"]
    div = cfg["planes_res"]["bound_dividable"]
    out = b.copy()
    out[:, 1] = (np.floor((b[:, 1] - b[:, 0]) / div) + 1) * div + b[:, 0]
    return out


def plane_sizes(cfg):
    """[(nx, ny, nz) per level]: the coarse level int(len / res) nodes an
    axis (at least 2), the fine level nested in it."""
    b = grown_bound(cfg)
    length = b[:, 1] - b[:, 0]
    coarse, fine = cfg["planes_res"]["coarse"], cfg["planes_res"]["fine"]
    n0 = [max(int(v / coarse), 2) for v in length]
    k = max(2, int(round(coarse / fine)))
    return [tuple(n0), tuple(k * (n - 1) + 1 for n in n0)]


def param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """{path: shape} of the map: planes [C, rows, cols] (xy: [ny, nx], xz:
    [nz, nx], yz: [nz, ny]) per level, decoder matrices [in, out]."""
    C = int(cfg["model"]["c_dim"])
    shapes = {}
    for lvl, (nx, ny, nz) in enumerate(plane_sizes(cfg)):
        shapes[f"planes/xy/{lvl}"] = (C, ny, nx)
        shapes[f"planes/xz/{lvl}"] = (C, nz, nx)
        shapes[f"planes/yz/{lvl}"] = (C, nz, ny)
    dec = cfg["decoder"]
    n_pos = 3 * int(cfg["pos"]["n_bins"])
    geo = int(dec["geo_feat_dim"])
    sdf = [2 * C + n_pos] + [dec["hidden_dim"]] * (dec["num_layers"] - 1) \
        + [1 + geo]
    col = [n_pos + geo] + [dec["hidden_dim_color"]] * (
        dec["num_layers_color"] - 1) + [3]
    for name, dims in (("sdf", sdf), ("color", col)):
        for i in range(len(dims) - 1):
            shapes[f"decoder/{name}/{i}"] = (int(dims[i]), int(dims[i + 1]))
    return shapes


def bilinear(plane: torch.Tensor, u: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    """plane [C, H, W] at coordinates u (along W), v (along H) in [-1, 1]
    -> [N, C]."""
    C, H, W = plane.shape
    x = torch.clamp((u + 1.0) * 0.5 * (W - 1), 0.0, W - 1)
    y = torch.clamp((v + 1.0) * 0.5 * (H - 1), 0.0, H - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    x1, y1 = torch.clamp(x0 + 1, max=W - 1), torch.clamp(y0 + 1, max=H - 1)
    flat = plane.reshape(C, H * W)
    f00, f01 = flat[:, y0 * W + x0], flat[:, y0 * W + x1]
    f10, f11 = flat[:, y1 * W + x0], flat[:, y1 * W + x1]
    out = (f00 * (1 - fx) * (1 - fy) + f01 * fx * (1 - fy)
           + f10 * (1 - fx) * fy + f11 * fx * fy)
    return out.T


def one_blob(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    """[N, 3] in [0, 1] -> [N, 3 n_bins]: each coordinate against n_bins
    bin centres with the quartic kernel 15/16 (1 - t^2)^2 on |t| < 1,
    t = (x - centre) n_bins; all bins of x, then of y, then of z."""
    centres = (torch.arange(n_bins, device=x.device, dtype=x.dtype) + 0.5) \
        / n_bins
    t = (x[:, :, None] - centres) * n_bins
    k = 15.0 / 16.0 * (1.0 - t * t) ** 2
    return torch.where(t.abs() < 1.0, k, torch.zeros_like(k)).reshape(
        x.shape[0], -1)


def mlp(ws, x: torch.Tensor) -> torch.Tensor:
    for w in ws[:-1]:
        x = torch.relu(x @ w)
    return x @ ws[-1]


class Scene:
    """The map's query and render for one configuration."""

    def __init__(self, cfg, device):
        self.cfg = cfg
        raw = torch.tensor(np.asarray(cfg["mapping"]["bound"], np.float32)
                           * cfg["scale"], device=device)
        self.box = raw                                        # encoding
        self.grid = torch.tensor(grown_bound(cfg), device=device)  # planes
        tr = cfg["training"]
        self.trunc = float(tr["trunc"]) * float(cfg["data"]["sc_factor"])
        self.n_bins = int(cfg["pos"]["n_bins"])

    def raw(self, w: Dict[str, torch.Tensor], pts: torch.Tensor):
        """World points [N, 3] -> (rgb logits [N, 3], sdf [N])."""
        lo, hi = self.grid[:, 0], self.grid[:, 1]
        p = (pts - lo) / (hi - lo) * 2.0 - 1.0
        feats = []
        for lvl in range(2):
            f = 0.0
            for name, (a, b) in ORIENTATIONS:
                f = f + bilinear(w[f"planes/{name}/{lvl}"], p[:, a], p[:, b])
            feats.append(f)
        enc = one_blob((pts - self.box[:, 0]) / (self.box[:, 1]
                                                 - self.box[:, 0]),
                       self.n_bins)
        h = mlp([w["decoder/sdf/0"], w["decoder/sdf/1"]],
                torch.cat(feats + [enc], dim=-1))
        rgb = mlp([w["decoder/color/0"], w["decoder/color/1"]],
                  torch.cat([enc, h[:, 1:]], dim=-1))
        return rgb, h[:, 0]

    def composite(self, rgb_logit: torch.Tensor, sdf: torch.Tensor,
                  z: torch.Tensor):
        """[R, S] samples -> (rgb [R, 3], depth [R]): weights
        sigmoid(s / tr) sigmoid(-s / tr), kept up to tr past the first
        sign change of the SDF along the ray (from the first sample when
        the SDF keeps its sign), normalised."""
        w = torch.sigmoid(sdf / self.trunc) * torch.sigmoid(-sdf / self.trunc)
        change = (sdf[:, 1:] * sdf[:, :-1]) < 0
        S = z.shape[1]
        pos = torch.arange(S - 1, device=z.device).expand_as(change)
        first = torch.where(change, pos, torch.full_like(pos, S)).min(1).values
        first = torch.where(first == S, torch.zeros_like(first), first)
        z_first = z.gather(1, first[:, None])
        w = w * (z < z_first + self.trunc).float()
        w = w / (w.sum(1, keepdim=True) + 1e-8)
        return ((w[..., None] * torch.sigmoid(rgb_logit)).sum(1),
                (w * z).sum(1))

    def render(self, w, rays_o, rays_d, z):
        """Rays [R, 3] at depths z [R, S] -> (rgb [R, 3], depth [R], sdf
        [R, S])."""
        R, S = z.shape
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        rgb_logit, sdf = self.raw(w, pts.reshape(-1, 3))
        sdf = sdf.reshape(R, S)
        rgb, depth = self.composite(rgb_logit.reshape(R, S, 3), sdf, z)
        return rgb, depth, sdf


def depth_guided_z(cfg, target_d: torch.Tensor,
                   u: Optional[torch.Tensor]) -> torch.Tensor:
    """Sample depths [R, n_samples_d + n_range_d]: n_samples_d evenly in
    [near, far] and n_range_d evenly in [d - range_d, d + range_d] (in
    [near, far] where d <= 0), sorted; with uniforms u [R, S] each moved
    within its bin, between the mid-points to its neighbours."""
    tr, cam = cfg["training"], cfg["cam"]
    near, far = float(cam["near"]), float(cam["far"])
    dev = target_d.device
    R = target_d.shape[0]
    d = target_d.reshape(R, 1)
    n_d, n_r, rd = int(tr["n_samples_d"]), int(tr["n_range_d"]), \
        float(tr["range_d"])
    around = d + torch.linspace(-rd, rd, n_r, device=dev)[None]
    around = torch.where(d <= 0, torch.linspace(near, far, n_r,
                                                device=dev)[None], around)
    even = torch.linspace(near, far, n_d, device=dev)[None].expand(R, n_d)
    z = torch.sort(torch.cat([even, around], 1), 1).values
    return z if u is None else jitter(z, u)


def jitter(z: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    mid = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mid, z[:, -1:]], 1)
    lower = torch.cat([z[:, :1], mid], 1)
    return lower + (upper - lower) * u


def mapping_loss(cfg, rgb, depth, sdf, z, target_rgb, target_d):
    """The mapping loss: weighted colour MSE, depth MSE over valid depths,
    and the truncated-SDF and free-space terms balanced by their sample
    counts."""
    tr = cfg["training"]
    t = target_d.reshape(-1)
    trunc = float(tr["trunc"]) * float(cfg["data"]["sc_factor"])
    valid = ((t > 0) & (t < float(cfg["cam"]["depth_trunc"]))).float()
    rgb_loss = ((rgb - target_rgb) ** 2).mean()
    depth_loss = (((depth - t) ** 2) * valid).sum() / valid.sum().clamp(
        min=1.0)
    tc = t[:, None]
    front = (z < tc - trunc).float()
    back = (z > tc + trunc).float()
    band = (1 - front) * (1 - back) * (tc > 0).float()
    n_front, n_band = front.sum(), band.sum()
    n = (n_front + n_band).clamp(min=1.0)
    fs = ((sdf * front - front) ** 2).mean() * (1 - n_front / n)
    sdf_l = (((z + sdf * trunc) * band - tc * band) ** 2).mean() \
        * (1 - n_band / n)
    return (tr["rgb_weight"] * rgb_loss + tr["depth_weight"] * depth_loss
            + tr["sdf_weight"] * sdf_l + tr["fs_weight"] * fs)
