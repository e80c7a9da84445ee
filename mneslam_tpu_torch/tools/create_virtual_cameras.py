"""Virtual evaluation viewpoints near a keyframe trajectory.

    python -m mneslam_tpu_torch.tools.create_virtual_cameras \
        --poses key_est_poses.npy --out virtual_cams.npy [--n 100] \
        [--trans 0.1] [--rot 0.1] [--seed 0] [--device cuda|cpu]

Samples `--n` unseen camera poses for depth-L1 evaluation: each is a
keyframe pose (drawn uniformly from the [K, 4, 4] c2w stack) left-multiplied
by exp of a random twist, translation ~ N(0, trans^2) and rotation
~ N(0, rot^2) per axis (`np.random.default_rng(seed)`, drawn in the
reference's order), mapped through `ops/lie.exp` and `matrix` on
`--device`. Writes a float32 [n, 4, 4] `.npy`. Runs on the GPU unless
`--device cpu` is given.

Port of the repository's `tools/create_virtual_cameras.py`.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def virtual_cameras(poses: np.ndarray, n: int, trans: float, rot: float,
                    seed: int, device) -> np.ndarray:
    """[K, 4, 4] c2w -> [n, 4, 4] float32 perturbed c2w."""
    from ..ops import lie

    rng = np.random.default_rng(seed)
    base_idx = rng.integers(0, len(poses), n)
    xi = np.stack([np.concatenate([trans * rng.standard_normal(3),
                                   rot * rng.standard_normal(3)])
                   for _ in base_idx]).reshape(n, 6)
    T = lie.matrix(lie.exp(torch.tensor(xi, dtype=torch.float32,
                                        device=device))).cpu().numpy()
    return np.stack([T[k] @ poses[i] for k, i in enumerate(base_idx)]
                    ).astype(np.float32).reshape(n, 4, 4)


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--poses", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--trans", type=float, default=0.1)
    ap.add_argument("--rot", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    device = resolve_device(args.device)
    cams = virtual_cameras(np.load(args.poses), args.n, args.trans,
                           args.rot, args.seed, device)
    np.save(args.out, cams)
    print(f"{args.n} virtual cameras -> {args.out}")
    return cams


if __name__ == "__main__":
    main()
