"""Map weights drawn from the seed, on the device, in two large calls.

The tri-plane map's parameters as the configuration shapes them: every
plane ~ 0.01 N(0, 1) and every decoder matrix [in, out] ~ U(-1/sqrt(in),
1/sqrt(in)) (the program's initialisation), drawn as one normal and one
uniform tensor and cut into leaves. The same tensors go to the program and
to the reference; the shapes come from the reference
(`reference.scene.param_shapes`), and the program's leaves must match them.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def draw(shapes: Dict[str, Tuple[int, ...]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """{path: shape} -> {path: float32 tensor on `device`}; a path is
    "planes/<xy|xz|yz>/<level>" or "decoder/<sdf|color>/<layer>"."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    planes = sorted(p for p in shapes if p.startswith("planes/"))
    mats = sorted(p for p in shapes if p.startswith("decoder/"))
    n_planes = sum(math.prod(shapes[p]) for p in planes)
    n_mats = sum(math.prod(shapes[p]) for p in mats)
    normal = torch.randn(n_planes, generator=g, device=device)
    uniform = torch.rand(n_mats, generator=g, device=device)
    out, off = {}, 0
    for p in planes:
        n = math.prod(shapes[p])
        out[p] = (0.01 * normal[off:off + n]).reshape(shapes[p])
        off += n
    off = 0
    for p in mats:
        n = math.prod(shapes[p])
        fan_in = shapes[p][0]
        out[p] = ((2.0 * uniform[off:off + n] - 1.0)
                  / math.sqrt(fan_in)).reshape(shapes[p])
        off += n
    return out
