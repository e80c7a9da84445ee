"""Coordinate encodings.

Port of the OneBlob encoding in `mneslam_tpu/ops/encodings.py` (the only
encoding the Replica configs use): each coordinate in [0, 1] is encoded by
tinycudann's quartic kernel against n_bins bin centers.
"""

from __future__ import annotations

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


def get_encoder(encoding: str, input_dim: int = 3, n_bins: int = 16
                ) -> Tuple[Callable[[torch.Tensor], torch.Tensor], int]:
    """(encode_fn, output_dim) for `encoding`; OneBlob only."""
    if "blob" in encoding.lower():
        return (lambda x: one_blob_encode(x, n_bins)), input_dim * n_bins
    raise ValueError(f"encoding {encoding!r} is not ported; only OneBlob is")
