"""Tri-plane neural scene representation with SDF volume rendering.

Port of `mneslam_tpu/models/scene_rep.py`: coarse + fine tri-plane
feature grids (ESLAM), the positional encoding (`pos.enc`), tiny SDF/color
MLPs, truncation-windowed SDF->weight compositing with depth-guided
stratified sampling and optional hierarchical importance resampling, the
rgb / depth / free-space / SDF loss suite and the TV smoothness term, and
the chunked no-grad queries and renders of meshing and evaluation
(`query_sdf`, `query_color`, `render_surface_color`, `render_image_rays`;
`query_tables` packs each plane once for them). The model is a set of
functions over a parameter dict:

    {"planes": {"xy": [coarse, fine], "xz": [...], "yz": [...]},  # [C, H, W]
     "c_planes": {...},          # colour planes, with grid.oneGrid: false
     "decoder": {"sdf": [W0, W1], "color": [W0, W1]}}             # [in, out]

Every option of the JAX package runs: `grid.oneGrid` true or false,
`training.n_importance` >= 0, `training.render_dtype` float32 or bfloat16
(other dtypes raise), and the plane sampler of `MNESLAM_PLANE_SAMPLER`,
read at import as in the JAX package: `packed` (default; one packed-row
gather per point and plane, kernel 1 in the backward), `merged` (one
gather per point and orientation from the coarse level upsampled onto the
nested fine grid beside the fine level, kernel 1 on the [8C]-wide table)
or `rows` (four corner gathers, plain autograd). Under bfloat16 every
query (renders, training and meshing) casts the parameters and the points
to bf16 at its top, so the plane features and the decoders run in bf16
and give fp32 raw outputs; the parameters, Adam and the losses stay fp32,
and autograd brings fp32 gradients back to the fp32 leaves. The plane
sampler's backward then hands kernel 1 bf16 values, which it sums in
fp32. The smoothness term is not cast, as in the JAX package: its kernel-1
calls take fp32 values under either dtype.

Random draws come from a `torch.Generator`, or pre-drawn through `u`
(torch cannot replay `jax.random`): a tensor (the depth perturbation) or a
dict of the parts {"perturb": [n_rays, S], "importance": [n_rays,
n_importance], "smooth_offset": [3], "smooth_jitter": [3]}.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..ops import encodings, interp
from ..parallel.mesh import all_reduce_sum
from . import decoder as decoder_lib
from .droid_net import cast_params


# "packed" (default), "merged" or "rows"; see the module docstring
_PLANE_SAMPLER = os.environ.get("MNESLAM_PLANE_SAMPLER", "packed")
PLANE_SAMPLERS = ("packed", "merged", "rows")
PLANE_GROUPS = ("planes", "c_planes")   # the parameter dict's plane trees


def uniforms(u, part: str) -> Optional[torch.Tensor]:
    """The `part` of pre-drawn uniforms `u` (see the module docstring): a
    tensor is the perturbation's; None where not given."""
    if u is None:
        return None
    if isinstance(u, dict):
        return u.get(part)
    return u if part == "perturb" else None


def _plane_shapes(bound: np.ndarray, resolutions, c_dim: int,
                  nested: bool = True):
    """Per-level {xy, xz, yz} plane shapes [C, rows, cols] (xy: [ny, nx],
    xz: [nz, nx], yz: [nz, ny]) with n_axis = int(len / res). With `nested`,
    level-1 node counts snap to k*(n0-1)+1, k = round(res0/res1) >= 2, so
    fine cells evenly subdivide coarse cells."""
    xyz_len = bound[:, 1] - bound[:, 0]
    shapes = []
    k = max(2, int(round(resolutions[0] / max(resolutions[1], 1e-9)))) \
        if len(resolutions) == 2 else 0
    for lvl, res in enumerate(resolutions):
        nx, ny, nz = (int(l / res) for l in xyz_len)
        nx, ny, nz = max(nx, 2), max(ny, 2), max(nz, 2)
        if nested and lvl == 1:
            c = shapes[0]
            nx = k * (c["xy"][2] - 1) + 1
            ny = k * (c["xy"][1] - 1) + 1
            nz = k * (c["xz"][1] - 1) + 1
        shapes.append({
            "xy": (c_dim, ny, nx),
            "xz": (c_dim, nz, nx),
            "yz": (c_dim, nz, ny),
        })
    return shapes


def _linspace(start: float, stop: float, n: int, device) -> torch.Tensor:
    return torch.linspace(start, stop, n, dtype=torch.float32, device=device)


class SceneRep:
    """Static configuration + functions over a parameter dict."""

    def __init__(self, config, device):
        self.config = config
        self.device = torch.device(device)
        tr = config["training"]
        if _PLANE_SAMPLER not in PLANE_SAMPLERS:
            raise ValueError(f"MNESLAM_PLANE_SAMPLER={_PLANE_SAMPLER!r}: "
                             f"one of {PLANE_SAMPLERS}")
        render_dtype = str(tr.get("render_dtype", "float32"))
        if render_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"training.render_dtype {render_dtype!r}: "
                             "float32 or bfloat16 are ported")
        # mixed precision: plane features and decoders in bf16
        self.compute_dtype = (torch.bfloat16 if render_dtype == "bfloat16"
                              else torch.float32)

        # bounding_box: raw mapping bound, for the [0, 1] positional
        # encoding; bound: copy grown to a multiple of bound_dividable, for
        # the [-1, 1] plane coordinates
        bb = np.array(config["mapping"]["bound"], dtype=np.float32) \
            * config["scale"]
        div = config["planes_res"]["bound_dividable"]
        bound = bb.copy()
        bound[:, 1] = (np.floor((bound[:, 1] - bound[:, 0]) / div) + 1) * div \
            + bound[:, 0]
        self.bounding_box = torch.as_tensor(bb, device=self.device)
        self.bound = torch.as_tensor(bound, device=self.device)

        self.one_grid = bool(config["grid"]["oneGrid"])
        c_dim = config["model"]["c_dim"]
        self.plane_shapes = _plane_shapes(
            bound, [config["planes_res"]["coarse"],
                    config["planes_res"]["fine"]], c_dim)
        if not self.one_grid:
            self.c_plane_shapes = _plane_shapes(
                bound, [config["c_planes_res"]["coarse"],
                        config["c_planes_res"]["fine"]], c_dim)
        self.pos_encode, self.input_ch_pos = encodings.get_encoder(
            config["pos"]["enc"], n_bins=config["pos"]["n_bins"])

        self.trunc = float(tr["trunc"])
        self.sc_factor = float(config["data"]["sc_factor"])
        self.near, self.far = (float(config["cam"]["near"]),
                               float(config["cam"]["far"]))
        self.n_range_d = int(tr["n_range_d"])
        self.range_d = float(tr["range_d"])
        self.n_samples_d = int(tr["n_samples_d"])
        self.n_samples = int(tr["n_samples"])
        self.n_importance = int(tr.get("n_importance", 0))
        self.perturb = float(tr["perturb"]) > 0.0
        self.white_bkgd = bool(tr["white_bkgd"])
        self.truncation_model = float(config["model"]["truncation"])
        self.depth_trunc = float(config["cam"]["depth_trunc"])

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------

    def shapes_of(self, group: str) -> list:
        """Per-level plane shapes of "planes" or "c_planes"."""
        return self.plane_shapes if group == "planes" else \
            self.c_plane_shapes

    def init_params(self, generator: torch.Generator) -> Dict:
        """Planes (and colour planes) ~ 0.01 N(0, 1), decoder ~
        nn.Linear's uniform init; every leaf a float32 leaf tensor with
        requires_grad. Drawn planes, decoder, colour planes."""
        def init_planes(shapes):
            planes = {"xy": [], "xz": [], "yz": []}
            for s in shapes:
                for name in ("xy", "xz", "yz"):
                    planes[name].append(0.01 * torch.randn(
                        s[name], generator=generator, device=self.device))
            return planes

        params = {"planes": init_planes(self.plane_shapes),
                  "decoder": decoder_lib.init_decoder(
                      self.config, generator, self.device)}
        if not self.one_grid:
            params["c_planes"] = init_planes(self.c_plane_shapes)
        for leaf in param_leaves(params):
            leaf.requires_grad_(True)
        return params

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def _normalize(self, pts: torch.Tensor) -> torch.Tensor:
        """World points -> [-1, 1] plane coords."""
        lo, hi = self.bound[:, 0], self.bound[:, 1]
        return (pts - lo) / (hi - lo) * 2.0 - 1.0

    def _normalize01(self, pts: torch.Tensor) -> torch.Tensor:
        """World points -> [0, 1] for the positional encoding."""
        lo, hi = self.bounding_box[:, 0], self.bounding_box[:, 1]
        return (pts - lo) / (hi - lo)

    def plane_feature_blocks(self, planes: Dict, p_nor: torch.Tensor,
                             tables: Optional[Dict] = None) -> list:
        """Per-level feature blocks [N, C]: xy + xz + yz samples of that
        level (ESLAM's summation), by `MNESLAM_PLANE_SAMPLER`. `tables`:
        the planes already prepared for the sampler (`query_tables`;
        forward only). A plane given as an `interp.PackedPlane` (the
        row-sharded mapper's seam) is sampled from its table, and such
        planes never merge."""
        uv = {"xy": p_nor[:, [0, 1]], "xz": p_nor[:, [0, 2]],
              "yz": p_nor[:, [1, 2]]}
        if _PLANE_SAMPLER == "merged" and self._mergeable(planes):
            C = planes["xy"][0].shape[0]
            feats = None
            for name in ("xy", "xz", "yz"):
                fine = planes[name][1]
                table = (tables[name][0] if tables is not None else
                         interp.pack_corners(self._merged_plane(planes,
                                                                name)))
                # one [8C]-row gather per point; kernel 1 in the backward
                g = interp.sample_packed_table(table, uv[name],
                                               *fine.shape[1:])
                feats = g if feats is None else feats + g
            return [feats[:, :C], feats[:, C:]]

        def sample(name, lvl):
            pl = planes[name][lvl]
            if isinstance(pl, interp.PackedPlane):
                # the row-sharded mapper's seam: the table is the leaf
                return interp.sample_packed_table(pl.packed, uv[name],
                                                  *pl.shape[1:])
            if _PLANE_SAMPLER == "rows":
                return interp.grid_sample_2d(
                    pl if tables is None else tables[name][lvl], uv[name])
            if tables is not None:
                return interp.sample_packed_table(tables[name][lvl],
                                                  uv[name], *pl.shape[1:])
            return interp.sample_plane_packed(pl, uv[name])

        feats = []
        for lvl in range(len(planes["xy"])):
            feats.append(sample("xy", lvl) + sample("xz", lvl)
                         + sample("yz", lvl))
        return feats

    def plane_features(self, planes: Dict, p_nor: torch.Tensor
                       ) -> torch.Tensor:
        """The feature blocks side by side, [N, levels * C]."""
        return torch.cat(self.plane_feature_blocks(planes, p_nor), dim=-1)

    @staticmethod
    def _mergeable(planes: Dict) -> bool:
        """Two levels whose grids nest (fine = k (coarse - 1) + 1 nodes,
        one k for both axes of each orientation), none a PackedPlane."""
        if len(planes["xy"]) != 2:
            return False
        if any(isinstance(pl, interp.PackedPlane)
               for lst in planes.values() for pl in lst):
            return False
        for name in ("xy", "xz", "yz"):
            c, f = planes[name][0].shape, planes[name][1].shape
            if (f[1] - 1) % (c[1] - 1) or (f[2] - 1) % (c[2] - 1):
                return False
            if (f[1] - 1) // (c[1] - 1) != (f[2] - 1) // (c[2] - 1):
                return False
        return True

    @staticmethod
    def _merged_plane(planes: Dict, name: str) -> torch.Tensor:
        """The coarse level upsampled onto the fine grid beside the fine
        level, [2C, Hf, Wf] (the merged sampler's plane)."""
        coarse, fine = planes[name][0], planes[name][1]
        k = (fine.shape[1] - 1) // (coarse.shape[1] - 1)
        return torch.cat([interp.upsample_exact(coarse, k), fine], dim=0)

    def query_color_sdf(self, params: Dict, pts: torch.Tensor,
                        tables: Optional[Dict] = None) -> torch.Tensor:
        """World points [N, 3] -> raw [N, 4] (rgb logits, sdf), computed
        in `compute_dtype` and returned in fp32. `tables` come from
        `query_tables`, already in `compute_dtype`."""
        if self.compute_dtype != torch.float32:
            params = cast_params(params, self.compute_dtype)
            pts = pts.to(self.compute_dtype)
        # the bounds are fp32: the plane coordinates and the encoding are
        # computed in fp32 from the rounded points, as in the JAX package
        p_nor = self._normalize(pts)
        embed = self.plane_feature_blocks(params["planes"], p_nor, tables)
        embed_pos = self.pos_encode(self._normalize01(pts)).to(
            embed[0].dtype)
        embed_color = None
        if not self.one_grid:
            embed_color = self.plane_feature_blocks(
                params["c_planes"], p_nor,
                None if tables is None else tables["c_planes"])
        return decoder_lib.decoder_apply(params["decoder"], embed,
                                         embed_pos, embed_color).float()

    def _sampler_tables(self, planes: Dict) -> Dict:
        """One plane tree prepared once for the sampler in
        `compute_dtype`: packed tables per level, the merged table of each
        orientation, or (rows) the cast planes."""
        planes = {name: [p.to(self.compute_dtype) for p in lst]
                  for name, lst in planes.items()}
        if _PLANE_SAMPLER == "merged" and self._mergeable(planes):
            return {name: [interp.pack_corners(self._merged_plane(planes,
                                                                  name))]
                    for name in ("xy", "xz", "yz")}
        if _PLANE_SAMPLER == "rows":
            return planes
        return {name: [interp.pack_corners(p) for p in lst]
                for name, lst in planes.items()}

    @torch.no_grad()
    def query_tables(self, params: Dict) -> Dict:
        """Every plane prepared once for the sampler (`pack_corners` for
        the packed sampler) in `compute_dtype`, for the chunked queries of
        meshing and rendering: {"xy": [per level], ...}, with the colour
        planes' tables under "c_planes"."""
        tables = self._sampler_tables(params["planes"])
        if not self.one_grid:
            tables["c_planes"] = self._sampler_tables(params["c_planes"])
        return tables

    def query_plane_feature_grid(self, params: Dict, pts: torch.Tensor
                                 ) -> torch.Tensor:
        """Raw geometry-plane features (before the decoders) at world
        points [..., 3] -> [..., levels * C], for the smoothness term. Not
        cast to `compute_dtype`, as in the JAX package."""
        flat = pts.reshape(-1, 3)
        emb = self.plane_features(params["planes"], self._normalize(flat))
        return emb.reshape(*pts.shape[:-1], emb.shape[-1])

    @torch.no_grad()
    def query_sdf(self, params: Dict, pts: torch.Tensor,
                  tables: Optional[Dict] = None) -> torch.Tensor:
        """World points [..., 3] -> sdf [...]."""
        raw = self.query_color_sdf(params, pts.reshape(-1, 3), tables)
        return raw[:, 3].reshape(pts.shape[:-1])

    @torch.no_grad()
    def query_color(self, params: Dict, pts: torch.Tensor,
                    tables: Optional[Dict] = None) -> torch.Tensor:
        """World points [..., 3] -> rgb [..., 3] in [0, 1]."""
        raw = self.query_color_sdf(params, pts.reshape(-1, 3), tables)
        return torch.sigmoid(raw[:, :3]).reshape(*pts.shape[:-1], 3)

    # ------------------------------------------------------------------
    # rendering
    # ------------------------------------------------------------------

    def sdf2weights(self, sdf: torch.Tensor,
                    z_vals: torch.Tensor) -> torch.Tensor:
        """sigmoid(s/tr)*sigmoid(-s/tr), zeroed behind the first sign change
        plus the truncation band, renormalized."""
        weights = torch.sigmoid(sdf / self.trunc) * torch.sigmoid(
            -sdf / self.trunc)
        signs = sdf[:, 1:] * sdf[:, :-1]
        mask = (signs < 0.0).to(sdf.dtype)
        inds = torch.argmax(mask, dim=1)      # first sign change (or 0)
        z_min = torch.gather(z_vals, 1, inds[:, None])
        band = (z_vals < z_min + self.sc_factor * self.trunc).to(sdf.dtype)
        weights = weights * band
        return weights / (weights.sum(-1, keepdim=True) + 1e-8)

    def raw2outputs(self, raw: torch.Tensor, z_vals: torch.Tensor):
        """Composite raw [R, S, 4] along rays -> (rgb, disp, acc, weights,
        depth, depth_var)."""
        rgb = torch.sigmoid(raw[..., :3])
        weights = self.sdf2weights(raw[..., 3], z_vals)
        rgb_map = (weights[..., None] * rgb).sum(-2)
        depth_map = (weights * z_vals).sum(-1)
        depth_var = (weights * (z_vals - depth_map[..., None]) ** 2).sum(-1)
        acc_map = weights.sum(-1)
        disp_map = 1.0 / torch.clamp(
            depth_map / torch.clamp(acc_map, min=1e-10), min=1e-10)
        if self.white_bkgd:
            rgb_map = rgb_map + (1.0 - acc_map[..., None])
        return rgb_map, disp_map, acc_map, weights, depth_map, depth_var

    @torch.no_grad()
    def render_surface_color(self, params: Dict, points: torch.Tensor,
                             normal: torch.Tensor,
                             tables: Optional[Dict] = None) -> torch.Tensor:
        """Colour at surface points [N, 3], composited along the normal
        over n_range_d samples in [-trunc, trunc] -> rgb [N, 3]."""
        n_rays = points.shape[0]
        z_vals = _linspace(-self.trunc, self.trunc, self.n_range_d,
                           points.device).expand(n_rays, self.n_range_d)
        pts = points[:, None, :] + normal[:, None, :] * z_vals[..., None]
        raw = self.query_color_sdf(params, pts.reshape(-1, 3),
                                   tables).reshape(n_rays, self.n_range_d, 4)
        return self.raw2outputs(raw, z_vals)[0]

    def sample_z_vals(self, target_d: torch.Tensor, n_rays: int,
                      generator: Optional[torch.Generator] = None,
                      u: Optional[torch.Tensor] = None,
                      rng_block=None) -> torch.Tensor:
        """Depth-guided stratified sampling: n_range_d samples in
        [d - range_d, d + range_d] (rays without depth fall back to
        [near, far]) plus n_samples_d uniform samples, sorted; then a
        per-bin perturbation when `training.perturb` is set and either
        pre-drawn uniforms `u` or a generator is given (see
        `_perturb` for `rng_block`)."""
        dev = target_d.device
        t = target_d.reshape(n_rays, 1)
        z_around = _linspace(-self.range_d, self.range_d, self.n_range_d,
                             dev)[None, :] + t
        z_fallback = _linspace(self.near, self.far, self.n_range_d,
                               dev).expand(n_rays, self.n_range_d)
        z_samples = torch.where(t <= 0, z_fallback, z_around)
        if self.n_samples_d > 0:
            z_uniform = _linspace(self.near, self.far, self.n_samples_d,
                                  dev).expand(n_rays, self.n_samples_d)
            z_vals = torch.sort(torch.cat([z_uniform, z_samples], -1),
                                dim=-1).values
        else:
            z_vals = z_samples
        return self._perturb(z_vals, generator, u, rng_block)

    def _perturb(self, z_vals: torch.Tensor,
                 generator: Optional[torch.Generator],
                 u: Optional[torch.Tensor], rng_block=None) -> torch.Tensor:
        """Each sample moved uniformly within its bin (between the mids
        of its neighbours) when `training.perturb` is set and either
        pre-drawn uniforms `u` or a generator is given.

        `rng_block=(n_total, offset)`: these rays are the block [offset,
        offset + n_rays) of a batch of n_total rays (a ray shard of the
        sharded mapper). The uniforms are then drawn (or given as `u`) for
        the whole batch, [n_total, S], and the block is taken, so a shard
        sees the numbers the unsharded batch would."""
        u = uniforms(u, "perturb")
        if not (self.perturb and (u is not None or generator is not None)):
            return z_vals
        mids = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
        upper = torch.cat([mids, z_vals[:, -1:]], -1)
        lower = torch.cat([z_vals[:, :1], mids], -1)
        n_rays, S = z_vals.shape
        u = self._block_uniform(u, generator, n_rays, S, rng_block,
                                z_vals.device)
        return lower + (upper - lower) * u

    @staticmethod
    def _block_uniform(u: Optional[torch.Tensor],
                       generator: Optional[torch.Generator], n_rays: int,
                       width: int, rng_block, device) -> torch.Tensor:
        """Per-ray uniforms [n_rays, width]: `u`, else drawn from
        `generator`. With `rng_block=(n_total, offset)` they are those of
        the whole batch [n_total, width] (given or drawn), sliced at the
        block, so a ray shard sees the unsharded batch's numbers."""
        n_total, offset = (n_rays, 0) if rng_block is None else rng_block
        if u is None:
            u = torch.rand((int(n_total), width), generator=generator,
                           device=device)
        if rng_block is not None:
            u = u[int(offset):int(offset) + n_rays]
        return u

    @staticmethod
    def sample_pdf(bins: torch.Tensor, weights: torch.Tensor,
                   n_importance: int, u: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """Inverse-CDF importance sampling: bins [R, B], weights [R, B] ->
        samples [R, n_importance], at the uniforms `u` [R, n_importance],
        or stratified (the bin midpoints of [0, 1]) without them."""
        weights = weights + 1e-5
        pdf = weights / weights.sum(-1, keepdim=True)
        cdf = torch.cumsum(pdf, -1)
        cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
        R = cdf.shape[0]
        if u is None:
            u = _linspace(0.5 / n_importance, 1.0 - 0.5 / n_importance,
                          n_importance, cdf.device).expand(R, n_importance)
        u = u.contiguous()
        idx = torch.searchsorted(cdf.contiguous(), u, right=True)
        below = torch.clamp(idx - 1, min=0)
        above = torch.clamp(idx, max=cdf.shape[-1] - 1)
        cdf_b = torch.gather(cdf, 1, below)
        cdf_a = torch.gather(cdf, 1, above)
        last = bins.shape[-1] - 1
        bins_b = torch.gather(bins, 1, torch.clamp(below, max=last))
        bins_a = torch.gather(bins, 1, torch.clamp(above, max=last))
        denom = torch.where(cdf_a - cdf_b < 1e-5, torch.ones_like(cdf_a),
                            cdf_a - cdf_b)
        t = (u - cdf_b) / denom
        return bins_b + t * (bins_a - bins_b)

    def render_rays(self, params: Dict, rays_o: torch.Tensor,
                    rays_d: torch.Tensor, target_d: Optional[torch.Tensor],
                    generator: Optional[torch.Generator] = None,
                    u: Optional[torch.Tensor] = None,
                    tables: Optional[Dict] = None,
                    rng_block=None) -> Dict:
        """Render a batch of rays [R, 3] with depth-guided samples, or
        without a target depth with n_samples uniform in [near, far]
        (perturbed per bin when `training.perturb` is set and `u` or a
        generator is given; `rng_block`: see `_perturb`). With
        `training.n_importance` > 0 a second pass renders the samples and
        n_importance more drawn from the first pass's weights (random
        under the same condition, else stratified), and the first pass's
        maps come back as rgb0, depth0, ..."""
        n_rays = rays_o.shape[0]
        if target_d is None:
            z_vals = self._perturb(_linspace(
                self.near, self.far, self.n_samples,
                rays_o.device).expand(n_rays, self.n_samples), generator, u,
                rng_block)
        else:
            z_vals = self.sample_z_vals(target_d, n_rays, generator, u,
                                        rng_block)
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        raw = self.query_color_sdf(params, pts.reshape(-1, 3),
                                   tables).reshape(n_rays, z_vals.shape[1], 4)
        rgb_map, disp_map, acc_map, weights, depth_map, depth_var = \
            self.raw2outputs(raw, z_vals)
        ret = {}
        if self.n_importance > 0:
            ret.update(rgb0=rgb_map, disp0=disp_map, acc0=acc_map,
                       depth0=depth_map, depth_var0=depth_var)
            z_mid = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
            u_imp = uniforms(u, "importance")
            if self.perturb and (u_imp is not None or generator is not None):
                u_imp = self._block_uniform(u_imp, generator, n_rays,
                                            self.n_importance, rng_block,
                                            rays_o.device)
            else:
                u_imp = None
            z_samples = self.sample_pdf(z_mid.detach(),
                                        weights[:, 1:-1].detach(),
                                        self.n_importance, u_imp)
            z_vals = torch.sort(torch.cat([z_vals, z_samples], -1),
                                dim=-1).values
            pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
            raw = self.query_color_sdf(
                params, pts.reshape(-1, 3),
                tables).reshape(n_rays, z_vals.shape[1], 4)
            rgb_map, disp_map, acc_map, weights, depth_map, depth_var = \
                self.raw2outputs(raw, z_vals)
        ret.update({"rgb": rgb_map, "depth": depth_map, "disp_map": disp_map,
                    "acc_map": acc_map, "depth_var": depth_var,
                    "z_vals": z_vals, "raw": raw, "weights": weights})
        return ret

    @torch.no_grad()
    def render_image_rays(self, params: Dict, rays_o: torch.Tensor,
                          rays_d: torch.Tensor,
                          target_d: Optional[torch.Tensor] = None,
                          chunk: int = 4096):
        """Whole-image render without perturbation -> (depth [N], rgb
        [N, 3]). The rays are padded to a multiple of `chunk` (origins and
        directions with ones, target depths with zeros) and rendered
        `chunk` at a time, as the JAX package's fixed-size batches are."""
        n = rays_o.shape[0]
        n_pad = (chunk - n % chunk) % chunk
        ro = torch.cat([rays_o, rays_o.new_ones((n_pad, 3))])
        rd = torch.cat([rays_d, rays_d.new_ones((n_pad, 3))])
        td = None if target_d is None else torch.cat(
            [target_d.reshape(-1), target_d.new_zeros((n_pad,))])
        tables = self.query_tables(params)
        depth, rgb = [], []
        for s in range(0, n + n_pad, chunk):
            out = self.render_rays(
                params, ro[s:s + chunk], rd[s:s + chunk],
                None if td is None else td[s:s + chunk], tables=tables)
            depth.append(out["depth"])
            rgb.append(out["rgb"])
        return torch.cat(depth)[:n], torch.cat(rgb)[:n]

    # ------------------------------------------------------------------
    # losses
    # ------------------------------------------------------------------

    @staticmethod
    def _psum(x: torch.Tensor, group) -> torch.Tensor:
        """Sum of `x`, over every rank of `group` when the rays are a shard
        (the differentiable all-reduce, whose backward is again a sum);
        with group None the plain sum."""
        s = x.sum()
        return s if group is None else all_reduce_sum(s, group)

    def _pmean(self, x: torch.Tensor, group) -> torch.Tensor:
        """Global mean: the sum over the group over the element count over
        the group (every shard holds the same number of rays)."""
        if group is None:
            return x.mean()
        return self._psum(x, group) / (x.numel() * group.size)

    def co_sdf_losses(self, z_vals, target_d, sdf, group=None):
        """Co-SLAM free-space + sdf losses: full-tensor MSE with
        mask-as-weight times the count-balance weights. `group`: the ranks
        over which the rays are sharded; the weights and means are then
        those of the whole batch."""
        truncation = self.trunc * self.sc_factor
        t = target_d.reshape(-1, 1)
        front_mask = (z_vals < (t - truncation)).to(z_vals.dtype)
        back_mask = (z_vals > (t + truncation)).to(z_vals.dtype)
        depth_mask = (t > 0.0).to(z_vals.dtype)
        sdf_mask = (1.0 - front_mask) * (1.0 - back_mask) * depth_mask

        num_fs = self._psum(front_mask, group)
        num_sdf = self._psum(sdf_mask, group)
        num = torch.clamp(num_fs + num_sdf, min=1.0)
        fs_weight = 1.0 - num_fs / num
        sdf_weight = 1.0 - num_sdf / num

        fs_loss = self._pmean((sdf * front_mask - front_mask) ** 2,
                              group) * fs_weight
        sdf_loss = self._pmean(((z_vals + sdf * truncation) * sdf_mask
                                - t * sdf_mask) ** 2, group) * sdf_weight
        return fs_loss, sdf_loss

    def eslam_sdf_losses(self, z_vals, target_d, sdf, group=None):
        """ESLAM three-band losses as masked means; rays without depth are
        excluded. `group` as in `co_sdf_losses`."""
        tr = self.truncation_model
        t = target_d.reshape(-1, 1)
        ray_valid = (t > 0).to(z_vals.dtype)

        front = (z_vals < (t - tr)).to(z_vals.dtype) * ray_valid
        back = (z_vals > (t + tr)).to(z_vals.dtype) * ray_valid
        center = ((z_vals > (t - 0.4 * tr)) & (z_vals < (t + 0.4 * tr))
                  ).to(z_vals.dtype) * ray_valid
        tail = (1 - front) * (1 - back) * (1 - center) * ray_valid

        def masked_mean(x, m):
            return self._psum(x * m, group) / torch.clamp(
                self._psum(m, group), min=1.0)

        fs_loss = masked_mean((sdf - 1.0) ** 2, front)
        est_d = z_vals + sdf * tr
        center_loss = masked_mean((est_d - t) ** 2, center)
        tail_loss = masked_mean((est_d - t) ** 2, tail)
        return fs_loss, center_loss, tail_loss

    def forward(self, params: Dict, rays_o: torch.Tensor,
                rays_d: torch.Tensor, target_rgb: torch.Tensor,
                target_d: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                u: Optional[torch.Tensor] = None, group=None,
                rng_block=None) -> Dict:
        """Training forward: render + the full loss dict. `u`: pre-drawn
        perturbation uniforms (else drawn from `generator`).

        `group` (a `parallel.mesh.AxisGroup`): the rays are this rank's
        shard of a batch sharded over the group's ranks; every loss is
        then summed over the group, so each rank returns the losses (and
        the PSNR) of the whole batch. `rng_block=(n_total, offset)`: the
        shard's place in the batch, for its perturbation uniforms."""
        rend = self.render_rays(params, rays_o, rays_d, target_d,
                                generator, u, rng_block=rng_block)
        t = target_d.reshape(-1)
        valid_depth = ((t > 0.0) & (t < self.depth_trunc)).to(rays_o.dtype)
        n_valid = torch.clamp(self._psum(valid_depth, group), min=1.0)

        rgb_loss = self._pmean((rend["rgb"] - target_rgb) ** 2, group)
        psnr = -10.0 * torch.log10(torch.clamp(rgb_loss, min=1e-12))
        depth_loss = self._psum(((rend["depth"] - t) ** 2) * valid_depth,
                                group) / n_valid
        if "rgb0" in rend:   # the importance resampling's first pass
            rgb_loss = rgb_loss + self._pmean(
                (rend["rgb0"] - target_rgb) ** 2, group)
            depth_loss = depth_loss + self._psum(
                ((rend["depth0"] - t) ** 2) * valid_depth, group) / n_valid

        sdf = rend["raw"][..., 3]
        z_vals = rend["z_vals"]
        co_fs_loss, co_sdf_loss = self.co_sdf_losses(z_vals, target_d, sdf,
                                                     group)
        e_fs_loss, e_center_loss, e_tail_loss = self.eslam_sdf_losses(
            z_vals, target_d, sdf, group)
        return {
            "rgb": rend["rgb"],
            "depth": rend["depth"],
            "rgb_loss": rgb_loss,
            "depth_loss": depth_loss,
            "co_sdf_loss": co_sdf_loss,
            "co_fs_loss": co_fs_loss,
            "e_fs_loss": e_fs_loss,
            "e_center_loss": e_center_loss,
            "e_tail_loss": e_tail_loss,
            "psnr": psnr,
        }

    def get_loss_from_ret(self, ret: Dict, rgb=True, sdf=True, depth=True,
                          smooth_loss=None) -> torch.Tensor:
        """Weighted total loss (with `smooth_loss`, its term at
        training.smooth_weight)."""
        tr = self.config["training"]
        is_co = bool(self.config.get("is_co_sdf", tr.get("is_co_sdf", True)))
        loss = 0.0
        if rgb:
            loss += tr["rgb_weight"] * ret["rgb_loss"]
        if depth:
            loss += tr["depth_weight"] * ret["depth_loss"]
        if sdf:
            if is_co:
                loss += (tr["sdf_weight"] * ret["co_sdf_loss"]
                         + tr["fs_weight"] * ret["co_fs_loss"])
            else:
                mp = self.config["mapping"]
                loss += (mp["w_sdf_fs"] * ret["e_fs_loss"]
                         + mp["w_sdf_center"] * ret["e_center_loss"]
                         + mp["w_sdf_tail"] * ret["e_tail_loss"])
        if smooth_loss is not None:
            loss += tr["smooth_weight"] * smooth_loss
        return loss

    def smoothness(self, params: Dict, u=None,
                   generator: Optional[torch.Generator] = None,
                   sample_points: int = 32, voxel_size: float = 0.1,
                   margin: float = 0.05) -> torch.Tensor:
        """TV smoothness of the geometry planes' features over a random
        (sample_points - 1)^3 sub-grid of `voxel_size` spacing inside the
        mapping bound. The grid's offset and its jitter are the uniforms
        `u` (parts smooth_offset [3] and smooth_jitter [3]), else drawn
        from `generator` (else from torch's default generator)."""
        dev = self.bounding_box.device
        lo = self.bounding_box[:, 0]
        hi = self.bounding_box[:, 1]
        grid_size = (sample_points - 1) * voxel_size
        offset_max = hi - lo - grid_size - 2 * margin
        u_off, u_jit = uniforms(u, "smooth_offset"), \
            uniforms(u, "smooth_jitter")
        if u_off is None:
            u_off = torch.rand((3,), generator=generator, device=dev)
        if u_jit is None:
            u_jit = torch.rand((3,), generator=generator, device=dev)
        offset = u_off * offset_max + margin
        n = sample_points - 1
        r = torch.arange(n, device=dev)
        idx = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                          dim=-1).float()
        pts = (idx + u_jit.reshape(1, 1, 1, 3)) * voxel_size + lo + offset
        feat = self.query_plane_feature_grid(params, pts)
        tv_x = ((feat[1:] - feat[:-1]) ** 2).sum()
        tv_y = ((feat[:, 1:] - feat[:, :-1]) ** 2).sum()
        tv_z = ((feat[:, :, 1:] - feat[:, :, :-1]) ** 2).sum()
        return (tv_x + tv_y + tv_z) / (sample_points ** 3)


def param_leaves(params: Dict) -> list:
    """Every tensor of a parameter dict, in the JAX tree order (dict keys
    sorted, list items in order)."""
    return [leaf for _, leaf in param_items(params)]


def param_items(params: Dict, prefix=()) -> list:
    """[(path, tensor)] in the JAX tree order; a path is a tuple of dict
    keys (str) and list positions (int)."""
    out = []
    if isinstance(params, dict):
        for k in sorted(params):
            out.extend(param_items(params[k], prefix + (k,)))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            out.extend(param_items(v, prefix + (i,)))
    else:
        out.append((prefix, params))
    return out


def checkpoint_key(path) -> str:
    """The JAX package's npz key of a parameter path, e.g.
    "['planes']/['xy']/[1]" (`"/".join(str(k) for k in path)` over its
    DictKey / SequenceKey entries)."""
    return "/".join(f"[{k!r}]" for k in path)
