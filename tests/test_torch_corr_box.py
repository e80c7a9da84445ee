"""The box design's tile rule (`kernels.corr_window.box_path_share`, the
rule of `kernels/csrc/corr_box.cuh`) against a tile-by-tile loop, on the
CPU.

A (real edge, 4 x 4 pixel tile, level) takes the box path when every pixel
of the tile (fewer at the ragged edge) has a slab start s with s >= 0,
s + 7 w2p <= R - 8 (no window row clamps) and s mod w2p + 8 <= w2p (no
window row wraps), and the box, (y span + 8) x (x span + 8) padded rows,
holds at most BOX_ROWS rows. Integer counts: the shares must agree
exactly.
"""

import numpy as np
import pytest
import torch

from mneslam_tpu_torch.kernels import corr_window as kcw
from mneslam_tpu_torch.tools.prof_corr import kernel_inputs, smooth_coords

torch.set_num_threads(1)


def _loop_share(xs, level_rows, w2ps, W, mask):
    E, HW, L = xs.shape
    H = HW // W
    th, tw = kcw.TILE
    shares = []
    for lvl in range(L):
        rows, w2p = level_rows[lvl], w2ps[lvl]
        box = total = 0
        for e in range(E):
            if not mask[e]:
                continue
            for ty in range(0, H, th):
                for tx in range(0, W, tw):
                    s = np.array([xs[e, y * W + x, lvl]
                                  for y in range(ty, min(ty + th, H))
                                  for x in range(tx, min(tx + tw, W))],
                                 np.int64)
                    ys, xc = s // w2p, s % w2p
                    ok = bool(((s >= 0) & (s + 7 * w2p <= rows - 8)
                               & (xc + 8 <= w2p)).all())
                    n = (ys.max() - ys.min() + 8) * (xc.max() - xc.min() + 8)
                    box += ok and n <= kcw.BOX_ROWS
                    total += 1
        shares.append(box / total)
    return shares


def _case(case):
    """-> xs [E, HW, 4] int32, level rows, widths, W, mask."""
    H, W, E = (13, 21, 5) if case == "ragged" else (16, 24, 5)
    rng = np.random.default_rng(0)
    fmaps = torch.as_tensor(rng.standard_normal((3, 32, H, W)),
                            dtype=torch.float32)
    if case == "scattered":
        coords = np.stack([rng.uniform(-20, W + 20, (E, H, W)),
                           rng.uniform(-20, H + 20, (E, H, W))], -1)
    else:
        coords = smooth_coords(E, H, W, seed=3,
                               step=25.0 * (case == "step"))
    _, levels, w2ps, xs = kernel_inputs(
        fmaps, torch.as_tensor(coords, dtype=torch.float32))
    if case == "clamp_wrap":
        for lvl, w2p in enumerate(w2ps):
            xs[0, :W * 4, lvl] -= 6 * w2p             # clamps at the top
            xs[1, -W * 4:, lvl] += 9 * w2p            # clamps at the bottom
            s = xs[2, W:3 * W, lvl]
            xs[2, W:3 * W, lvl] = s - s % w2p + w2p - 2   # wraps
    mask = torch.tensor([1, 1, 1, 0, 1], dtype=torch.int32)
    return xs, [lv.shape[1] for lv in levels], w2ps, W, mask


@pytest.mark.parametrize("case", ["smooth", "scattered", "step",
                                  "clamp_wrap", "ragged"])
def test_box_path_share_matches_a_tile_loop(case):
    xs, level_rows, w2ps, W, mask = _case(case)
    got = kcw.box_path_share(xs, level_rows, w2ps, W, mask)
    ref = _loop_share(xs.numpy(), level_rows, w2ps, W, mask.numpy())
    assert got == pytest.approx(ref, abs=1e-6)
    if case in ("smooth", "ragged"):
        assert min(got) == 1.0
    elif case == "scattered":
        assert max(got) < 0.1
    else:
        assert 0.0 < got[0] < 1.0


def test_box_path_share_counts_only_real_edges():
    xs, level_rows, w2ps, W, mask = _case("clamp_wrap")
    every = kcw.box_path_share(xs, level_rows, w2ps, W)
    clean = torch.tensor([0, 0, 0, 1, 1], dtype=torch.int32)
    only_clean = kcw.box_path_share(xs, level_rows, w2ps, W, clean)
    assert min(only_clean) == 1.0 and every[0] < 1.0
