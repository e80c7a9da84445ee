"""Multi-resolution hash-grid encoding (Instant-NGP semantics).

Port of `mneslam_tpu/ops/hashgrid.py`: a trainable table [L, T, F] and
trilinear interpolation of each level's corner features; a level whose
grid fits the table indexes it densely, the others through the spatial
hash. No caller in the package uses it (the configs' `grid.enc` surface
keeps it); the table is a leaf tensor and plain autograd gives its
gradient.

The JAX package hashes in uint32 with wraparound. Torch has no full
uint32 arithmetic, so each product is taken in int64 and masked to its
low 32 bits before the XOR and the modulo: the indices equal JAX's bit
for bit.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF


def level_resolutions(n_levels: int = 16, base_resolution: int = 16,
                      desired_resolution: int = 512) -> List[int]:
    """Per-level grid resolutions, growing geometrically from the base to
    the desired resolution."""
    if n_levels == 1:
        return [base_resolution]
    scale = np.exp2(np.log2(desired_resolution / base_resolution)
                    / (n_levels - 1))
    return [int(np.floor(base_resolution * scale ** lvl))
            for lvl in range(n_levels)]


def init_hash_grid(generator: torch.Generator, n_levels: int = 16,
                   n_features_per_level: int = 2,
                   log2_hashmap_size: int = 16, base_resolution: int = 16,
                   desired_resolution: int = 512, device=None
                   ) -> Tuple[Dict, List[int]]:
    """-> (params {"table": [L, T, F] leaf ~ U(-1e-4, 1e-4)},
    resolutions)."""
    T = 2 ** log2_hashmap_size
    u = torch.rand((n_levels, T, n_features_per_level), generator=generator,
                   device=device)
    table = ((2.0 * u - 1.0) * 1e-4).requires_grad_(True)
    res = level_resolutions(n_levels, base_resolution, desired_resolution)
    return {"table": table}, res


def corner_index(cx: torch.Tensor, cy: torch.Tensor, cz: torch.Tensor,
                 res: int, T: int) -> torch.Tensor:
    """Table rows of integer corners (int64 [N] each): the dense index
    when the level's (res + 1)^3 nodes fit the table, else the spatial
    hash (x * p0 ^ y * p1 ^ z * p2) mod T in 32-bit unsigned arithmetic."""
    if (res + 1) ** 3 <= T:
        return (cx * (res + 1) + cy) * (res + 1) + cz
    h = ((cx * _PRIMES[0]) & _MASK32) ^ ((cy * _PRIMES[1]) & _MASK32) \
        ^ ((cz * _PRIMES[2]) & _MASK32)
    return h % T


def hash_grid_encode(params: Dict, x: torch.Tensor,
                     resolutions: List[int]) -> torch.Tensor:
    """x [..., 3] in [0, 1] -> [..., L * F] trilinear hash features (level
    after level)."""
    table = params["table"]
    L, T, F = table.shape
    flat = x.reshape(-1, 3)
    outs = []
    for lvl, res in enumerate(resolutions):
        p = torch.clamp(flat, 0.0, 1.0) * res
        p0 = torch.floor(p).to(torch.int32)
        w = p - p0
        p0 = torch.clamp(p0, 0, res).long()
        acc = None
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    cx = torch.clamp(p0[:, 0] + dx, max=res)
                    cy = torch.clamp(p0[:, 1] + dy, max=res)
                    cz = torch.clamp(p0[:, 2] + dz, max=res)
                    idx = corner_index(cx, cy, cz, res, T)
                    wgt = ((w[:, 0] if dx else 1 - w[:, 0])
                           * (w[:, 1] if dy else 1 - w[:, 1])
                           * (w[:, 2] if dz else 1 - w[:, 2]))
                    term = table[lvl, idx] * wgt[:, None]
                    acc = term if acc is None else acc + term
        outs.append(acc)
    return torch.cat(outs, dim=-1).reshape(*x.shape[:-1], L * F)
