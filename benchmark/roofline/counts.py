"""Operations and bytes of the measured work, counted from shapes.

`scatter_rows_bytes`: the least bytes of one row scatter-add (kernel 1):
each update's index and values read once, each touched row written once.
The FLOP counts below count the arithmetic that the method needs for a
step, from its shapes, all in float32 (the configurations state float32
and the program turns TF32 off); they leave out what they cannot count
from shapes (comparisons, index arithmetic, copies), so a share of the
peak computed from them is a lower bound of the true one.
"""

from __future__ import annotations

from typing import Dict


def scatter_rows_bytes(n_updates: int, width: int, value_bytes: int,
                       index_bytes: int, touched_rows: int) -> int:
    return (n_updates * (width * value_bytes + index_bytes)
            + touched_rows * width * 4)


def decoder_dims(cfg):
    C = int(cfg["model"]["c_dim"])
    dec = cfg["decoder"]
    n_pos = 3 * int(cfg["pos"]["n_bins"])
    geo = int(dec["geo_feat_dim"])
    sdf = [2 * C + n_pos] + [dec["hidden_dim"]] * (dec["num_layers"] - 1) \
        + [1 + geo]
    col = [n_pos + geo] + [dec["hidden_dim_color"]] * (
        dec["num_layers_color"] - 1) + [3]
    return sdf, col


def _matmul_flops(n: int, dims) -> int:
    return sum(2 * n * a * b for a, b in zip(dims[:-1], dims[1:]))


def query_flops(cfg, n_points: int) -> int:
    """Forward of the map at n points: six bilinear samples of C channels
    (4 weights, then 4 multiply-adds a channel), the three orientations
    summed per level, the OneBlob encoding (about 6 operations a bin) and
    the two decoders."""
    C = int(cfg["model"]["c_dim"])
    n_bins = int(cfg["pos"]["n_bins"])
    sdf, col = decoder_dims(cfg)
    per_point = 6 * (8 + 8 * C) + 2 * 2 * C + 3 * n_bins * 6
    return n_points * per_point + _matmul_flops(n_points, sdf) \
        + _matmul_flops(n_points, col)


def composite_flops(n_rays: int, n_samples: int) -> int:
    """Weights (two sigmoids, a product), the colour sigmoid, the sums of
    colour and depth: about 20 operations a sample."""
    return 20 * n_rays * n_samples


def mapping_iteration_flops(cfg, n_params: int) -> Dict[str, int]:
    """One mapping iteration: the forward at (sample + min_pixels_cur) x
    (n_samples_d + n_range_d) points, its backward to every parameter
    (the decoders' two products a layer, the bilinear corners' 4 C
    products and 4 C sums a sample and plane), and Adam over every
    parameter element (about 12 operations each)."""
    tr, mp = cfg["training"], cfg["mapping"]
    rays = int(mp["sample"]) + int(mp["min_pixels_cur"])
    S = int(tr["n_samples_d"]) + int(tr["n_range_d"])
    n = rays * S
    C = int(cfg["model"]["c_dim"])
    sdf, col = decoder_dims(cfg)
    fwd = query_flops(cfg, n) + composite_flops(rays, S)
    bwd = 2 * (_matmul_flops(n, sdf) + _matmul_flops(n, col)) \
        + n * 6 * 8 * C + 2 * composite_flops(rays, S)
    return {"fp32": fwd + bwd + 12 * n_params}


def alignment_flops(cfg, n_rays: int, iters: int) -> Dict[str, int]:
    """One render alignment: the teacher render, then `iters` target
    renders with their backward to the pose (the decoders' input products
    only, the frozen maps take no gradient; the bilinear coordinates' 12 C
    operations a sample and plane)."""
    S = int(cfg["training"]["n_samples"])
    n = n_rays * S
    C = int(cfg["model"]["c_dim"])
    sdf, col = decoder_dims(cfg)
    render = query_flops(cfg, n) + composite_flops(n_rays, S)
    back = _matmul_flops(n, sdf) + _matmul_flops(n, col) + n * 6 * 12 * C \
        + 2 * composite_flops(n_rays, S)
    return {"fp32": render + iters * (render + back)}
