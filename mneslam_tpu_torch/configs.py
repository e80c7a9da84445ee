"""Built-in configurations, as plain dicts (no YAML needed to use them).

`ROOM0` holds the values of `configs/Replica/replica.yaml` merged with
`configs/Replica/room0.yaml` for every key the mapping slice reads. Use it
as `make_config(ROOM0)`. It keeps the file's `dataset: replica` and
`mode: slam`; a caller without the Replica frames overrides `dataset`
(e.g. `synthetic`) and sets `mode: mapping`.
"""

from __future__ import annotations

ROOM0 = {
    "dataset": "replica",
    "mode": "slam",
    "scale": 1,
    "data": {"sc_factor": 1, "output": "output", "exp_name": "room0"},
    "mapping": {
        "sample": 2048,
        "iters": 50,
        "first_iters": 500,
        "keyframe_every": 5,
        "n_pixels": 0.05,
        "min_pixels_cur": 100,
        "filter_depth": False,
        "lr_embed": 0.005,
        "lr_decoder": 0.01,
        "w_sdf_fs": 5,
        "w_sdf_center": 200,
        "w_sdf_tail": 30,
        "bound": [[-1.0, 7.0], [-1.3, 3.7], [-1.7, 1.4]],
    },
    "grid": {"oneGrid": True},
    "pos": {"enc": "OneBlob", "n_bins": 16},
    "decoder": {
        "geo_feat_dim": 15,
        "hidden_dim": 32,
        "num_layers": 2,
        "num_layers_color": 2,
        "hidden_dim_color": 32,
    },
    "cam": {
        "H": 680, "W": 1200,
        "fx": 600.0, "fy": 600.0, "cx": 599.5, "cy": 339.5,
        "near": 0, "far": 10, "depth_trunc": 100.0,
    },
    "training": {
        "rgb_weight": 5.0,
        "depth_weight": 0.1,
        "sdf_weight": 1200,
        "fs_weight": 10,
        "smooth_weight": 0,
        "n_samples": 256,
        "n_samples_d": 32,
        "range_d": 0.1,
        "n_range_d": 11,
        "n_importance": 0,
        "perturb": 1,
        "white_bkgd": False,
        "trunc": 0.1,
        "is_co_sdf": True,
    },
    "planes_res": {"coarse": 0.02, "fine": 0.01, "bound_dividable": 0.02},
    "model": {"c_dim": 32, "truncation": 0.1, "input_ch": 64,
              "input_ch_pos": 48},
}
