"""Coordinate encodings.

Port of `mneslam_tpu/ops/encodings.py`: OneBlob (the Replica configs'
`pos.enc`; each coordinate in [0, 1] encoded by tinycudann's quartic
kernel against n_bins bin centers), Frequency (sin/cos of 2^k pi x),
SphericalHarmonics (real basis, degree <= 4) and Identity, with the JAX
package's layouts and constants. `get_encoder` takes JAX's parameter
surface; an encoding JAX does not know raises with its message.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch


def one_blob_encode(x: torch.Tensor, n_bins: int = 16) -> torch.Tensor:
    """x [..., D] -> [..., D * n_bins], coordinate-major (all bins of x[0],
    then of x[1], ...)."""
    centers = (torch.arange(n_bins, dtype=x.dtype, device=x.device) + 0.5) \
        / n_bins
    t = (x[..., None] - centers) * n_bins                   # [..., D, n_bins]
    # quartic kernel: 15/16 (1 - t^2)^2 on |t| < 1, else 0
    enc = torch.where(t.abs() < 1.0, (15.0 / 16.0) * (1.0 - t * t) ** 2,
                      torch.zeros((), dtype=x.dtype, device=x.device))
    return enc.flatten(-2)


def frequency_encode(x: torch.Tensor, n_frequencies: int = 12
                     ) -> torch.Tensor:
    """x [..., D] -> [..., D * 2F]: per coordinate its F sines, then its F
    cosines of 2^k pi x (k = 0 .. F-1)."""
    freqs = (2.0 ** torch.arange(n_frequencies, dtype=x.dtype,
                                 device=x.device)) * math.pi
    ang = x[..., None] * freqs                              # [..., D, F]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).flatten(-2)


def spherical_harmonics_encode(d: torch.Tensor, degree: int = 4
                               ) -> torch.Tensor:
    """Real spherical-harmonics basis of unit directions d [..., 3] up to
    `degree` (<= 4) -> [..., degree ** 2]."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree > 1:
        out += [-0.48860251190291987 * y,
                0.48860251190291987 * z,
                -0.48860251190291987 * x]
    if degree > 2:
        xy, yz, xz = x * y, y * z, x * z
        xx, yy, zz = x * x, y * y, z * z
        out += [1.0925484305920792 * xy,
                -1.0925484305920792 * yz,
                0.31539156525252005 * (3.0 * zz - 1.0),
                -1.0925484305920792 * xz,
                0.5462742152960396 * (xx - yy)]
    if degree > 3:
        xx, yy, zz = x * x, y * y, z * z
        out += [-0.5900435899266435 * y * (3 * xx - yy),
                2.890611442640554 * x * y * z,
                -0.4570457994644658 * y * (5 * zz - 1),
                0.3731763325901154 * z * (5 * zz - 3),
                -0.4570457994644658 * x * (5 * zz - 1),
                1.445305721320277 * z * (xx - yy),
                -0.5900435899266435 * x * (xx - 3 * yy)]
    return torch.stack(out, dim=-1)


def get_encoder(encoding: str, input_dim: int = 3, n_bins: int = 16,
                n_frequencies: int = 12, degree: int = 4
                ) -> Tuple[Callable[[torch.Tensor], torch.Tensor], int]:
    """(encode_fn, output_dim) for `encoding`, matched by substring and
    case as in the JAX package."""
    enc = encoding.lower()
    if "blob" in enc:
        return (lambda x: one_blob_encode(x, n_bins)), input_dim * n_bins
    if "freq" in enc:
        return ((lambda x: frequency_encode(x, n_frequencies)),
                input_dim * 2 * n_frequencies)
    if "spherical" in enc:
        return (lambda x: spherical_harmonics_encode(x, degree)), degree ** 2
    if "identity" in enc:
        return (lambda x: x), input_dim
    raise ValueError(f"unknown encoding: {encoding}")
