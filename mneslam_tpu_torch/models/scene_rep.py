"""Tri-plane neural scene representation with SDF volume rendering.

Port of `mneslam_tpu/models/scene_rep.py` for the mapping slice: coarse +
fine tri-plane feature grids (ESLAM) sampled by the packed sampler, OneBlob
positional encoding, tiny SDF/color MLPs, truncation-windowed SDF->weight
compositing with depth-guided stratified sampling, and the rgb / depth /
free-space / SDF loss suite, and the chunked no-grad queries and renders
of meshing and evaluation (`query_sdf`, `query_color`,
`render_surface_color`, `render_image_rays`; `query_tables` packs each
plane once for them). The model is a set of functions over a parameter
dict:

    {"planes": {"xy": [coarse, fine], "xz": [...], "yz": [...]},  # [C, H, W]
     "decoder": {"sdf": [W0, W1], "color": [W0, W1]}}             # [in, out]

Ported configurations: `grid.oneGrid: true`, `training.n_importance: 0`,
`training.render_dtype: float32` or `bfloat16` (the Replica settings).
Others raise. Under bfloat16 every query (renders, training and meshing)
casts the parameters and the points to bf16 at its top, so the plane
features and the decoders run in bf16 and give fp32 raw outputs; the
parameters, Adam and the losses stay fp32, and autograd brings fp32
gradients back to the fp32 leaves. The plane sampler's backward then hands
kernel 1 bf16 values, which it sums in fp32.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..ops import encodings, interp
from ..parallel.mesh import all_reduce_sum
from . import decoder as decoder_lib
from .droid_net import cast_params


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
        if not bool(config["grid"]["oneGrid"]):
            raise ValueError("grid.oneGrid: false (color planes) is not "
                             "ported")
        if int(tr.get("n_importance", 0)) > 0:
            raise ValueError("training.n_importance > 0 is not ported")
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

        c_dim = config["model"]["c_dim"]
        self.plane_shapes = _plane_shapes(
            bound, [config["planes_res"]["coarse"],
                    config["planes_res"]["fine"]], c_dim)
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
        self.perturb = float(tr["perturb"]) > 0.0
        self.white_bkgd = bool(tr["white_bkgd"])
        self.truncation_model = float(config["model"]["truncation"])
        self.depth_trunc = float(config["cam"]["depth_trunc"])

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------

    def init_params(self, generator: torch.Generator) -> Dict:
        """Planes ~ 0.01 N(0, 1), decoder ~ nn.Linear's uniform init; every
        leaf a float32 leaf tensor with requires_grad."""
        planes = {"xy": [], "xz": [], "yz": []}
        for s in self.plane_shapes:
            for name in ("xy", "xz", "yz"):
                planes[name].append(0.01 * torch.randn(
                    s[name], generator=generator, device=self.device))
        params = {"planes": planes,
                  "decoder": decoder_lib.init_decoder(
                      self.config, generator, self.device)}
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
        level (ESLAM's summation). `tables`: the planes already packed
        (`query_tables`; forward only). A plane given as an
        `interp.PackedPlane` is sampled from its table."""
        uv = {"xy": p_nor[:, [0, 1]], "xz": p_nor[:, [0, 2]],
              "yz": p_nor[:, [1, 2]]}
        def sample(name, lvl):
            pl = planes[name][lvl]
            if isinstance(pl, interp.PackedPlane):
                # the row-sharded mapper's seam: the table is the leaf
                return interp.sample_packed_table(pl.packed, uv[name],
                                                  *pl.shape[1:])
            if tables is not None:
                return interp.sample_packed_table(tables[name][lvl],
                                                  uv[name], *pl.shape[1:])
            return interp.sample_plane_packed(pl, uv[name])

        feats = []
        for lvl in range(len(planes["xy"])):
            feats.append(sample("xy", lvl) + sample("xz", lvl)
                         + sample("yz", lvl))
        return feats

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
        embed = self.plane_feature_blocks(params["planes"],
                                          self._normalize(pts), tables)
        embed_pos = self.pos_encode(self._normalize01(pts)).to(
            embed[0].dtype)
        return decoder_lib.decoder_apply(params["decoder"], embed,
                                         embed_pos).float()

    @torch.no_grad()
    def query_tables(self, params: Dict) -> Dict:
        """Every plane packed once (`interp.pack_corners`) in
        `compute_dtype`, for the chunked queries of meshing and rendering:
        {"xy": [per level], ...}."""
        return {name: [interp.pack_corners(p.to(self.compute_dtype))
                       for p in params["planes"][name]]
                for name in ("xy", "xz", "yz")}

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
        if not (self.perturb and (u is not None or generator is not None)):
            return z_vals
        mids = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
        upper = torch.cat([mids, z_vals[:, -1:]], -1)
        lower = torch.cat([z_vals[:, :1], mids], -1)
        n_rays, S = z_vals.shape
        n_total, offset = (n_rays, 0) if rng_block is None else rng_block
        if u is None:
            u = torch.rand((int(n_total), S), generator=generator,
                           device=z_vals.device)
        if rng_block is not None:
            u = u[int(offset):int(offset) + n_rays]
        return lower + (upper - lower) * u

    def render_rays(self, params: Dict, rays_o: torch.Tensor,
                    rays_d: torch.Tensor, target_d: Optional[torch.Tensor],
                    generator: Optional[torch.Generator] = None,
                    u: Optional[torch.Tensor] = None,
                    tables: Optional[Dict] = None,
                    rng_block=None) -> Dict:
        """Render a batch of rays [R, 3] with depth-guided samples, or
        without a target depth with n_samples uniform in [near, far]
        (perturbed per bin when `training.perturb` is set and `u` or a
        generator is given; `rng_block`: see `_perturb`)."""
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
        return {"rgb": rgb_map, "depth": depth_map, "disp_map": disp_map,
                "acc_map": acc_map, "depth_var": depth_var,
                "z_vals": z_vals, "raw": raw, "weights": weights}

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

    def get_loss_from_ret(self, ret: Dict, rgb=True, sdf=True,
                          depth=True) -> torch.Tensor:
        """Weighted total loss."""
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
        return loss


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
