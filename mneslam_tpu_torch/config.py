"""Config dicts: defaults, deep merge, and YAML files with `inherit_from`.

The port's own copy of `mneslam_tpu/config.py` (same defaults, same merge
rules), so that the port imports nothing of the JAX package. A config file
may name a parent via `inherit_from`; parents load first and children
deep-merge over them. `yaml` is imported only inside `load_config`, so code
that builds configs programmatically needs no PyYAML.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional


def deep_update(base: Dict[str, Any], overlay: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge `overlay` into `base` (in place, returns base)."""
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            deep_update(base[k], v)
        else:
            base[k] = v
    return base


def load_config(path: str, default_path: Optional[str] = None) -> Dict[str, Any]:
    """Load a YAML config, resolving its `inherit_from` chain."""
    import yaml

    with open(path, "r") as f:
        cfg = yaml.safe_load(f) or {}

    parent = cfg.get("inherit_from") or default_path
    if parent is not None:
        base = load_config(parent)
    else:
        base = {}
    cfg.pop("inherit_from", None)
    return deep_update(base, cfg)


# Defaults covering the reference's Replica parameter surface
# (`configs/Replica/replica.yaml`) so unit tests and synthetic runs can build
# small configs by overriding only what they need.
_DEFAULTS: Dict[str, Any] = {
    "dataset": "synthetic",
    "scale": 1,
    "stride": 1,
    "data": {"downsample": 1, "sc_factor": 1, "translation": 0,
             "output": "output", "exp_name": "exp"},
    "mapping": {
        "sample": 2048,
        "iters": 50,
        "loop_iters": 100,
        "distill_iters": 100,
        "lr_embed": 0.005,
        "lr_embed_color": 0.005,
        "lr_decoder": 0.01,
        "lr_rot": 0.001,
        "lr_trans": 0.001,
        "keyframe_every": 5,
        "map_every": 5,
        "n_pixels": 0.05,
        "first_iters": 500,
        "optim_cur": True,
        "min_pixels_cur": 100,
        "filter_depth": False,
        # the row-sharded mapper (parallel/mesh.py; used on a world of
        # more than one rank): fold placement in the backward, "after" or
        # "before", and one pack + all-gather per k iterations
        "shard_plane_rows": False,
        "shard_fold": "after",
        "shard_gather_every": 1,
        "w_sdf_fs": 5,
        "w_sdf_center": 200,
        "w_sdf_tail": 30,
        "bound": [[-1, 1], [-1, 1], [-1, 1]],
        "marching_cubes_bound": [[-1, 1], [-1, 1], [-1, 1]],
    },
    "tracking": {
        "buffer": 64,
        "beta": 0.75,
        "warmup": 8,
        "upsample": False,
        "motion_filter": {"thresh": 4.0, "batch": 8},
        "frontend": {
            "enable_loop": True,
            "keyframe_thresh": 4.0,
            "window": 25,
            "radius": 1,
            "max_factors": 75,
            "nms": 0,
            "thresh": 25.0,
        },
        "backend": {
            "thresh": 25.0,
            "radius": 1,
            "nms": 5,
            "loop_window": 25,
            "loop_thresh": 25.0,
            "loop_radius": 1,
            "loop_nms": 12,
            "corr_chunk": 256,
            "dist_cache": {"enabled": True,
                           "pose_tol": 1.0e-4, "disp_tol": 1.0e-3},
        },
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
        "H": 120, "W": 160,
        "fx": 120.0, "fy": 120.0, "cx": 79.5, "cy": 59.5,
        "png_depth_scale": 6553.5,
        "crop_edge": 0,
        "near": 0.0, "far": 5.0,
        "depth_trunc": 100.0,
        "H_edge": 0, "W_edge": 0,
        "H_out": 120, "W_out": 160,
    },
    "training": {
        "rgb_weight": 5.0,
        "depth_weight": 0.1,
        "sdf_weight": 1200,
        "fs_weight": 10,
        "eikonal_weight": 0,
        "smooth_weight": 0,
        "smooth_pts": 32,
        "smooth_vox": 0.1,
        "smooth_margin": 0.05,
        "n_samples": 256,
        "n_samples_d": 32,
        "range_d": 0.1,
        "n_range_d": 11,
        "n_importance": 0,
        "perturb": 1,
        "white_bkgd": False,
        "trunc": 0.1,
        "rot_rep": "axis_angle",
        "rgb_missing": 0.05,
        "is_co_sdf": True,
    },
    "mesh": {"resolution": 128, "vis": 50, "voxel_eval": 0.05, "voxel_final": 0.03,
             "render_color": False},
    "meshing": {"level_set": 0, "resolution": 0.05, "mesh_bound_scale": 1.02},
    "planes_res": {"coarse": 0.24, "fine": 0.12, "bound_dividable": 0.24},
    "c_planes_res": {"coarse": 0.24, "fine": 0.12},
    "model": {"c_dim": 32, "truncation": 0.1, "input_ch": 64, "input_ch_pos": 48},
    "distillation": {"use_bound_overlap": True},
    "loop_closure": {
        "pose_decay_sigma": 10.0,
        "pose_decay_min_weight": 0.1,
        "mode": "gated",
        "accept_loss": 0.05,
        "accept_ratio": 0.25,
        "map_aligned": False,
    },
    "loop_detection": {
        "enabled": False,
        "sim_threshold": 0.8,
        "min_time_diff": 20,
        "loop_launch_th": 20,
        "min_matches_for_fusion": 3,
    },
}


def default_config() -> Dict[str, Any]:
    return copy.deepcopy(_DEFAULTS)


def make_config(overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Defaults + deep overrides — the programmatic entry used by tests."""
    cfg = default_config()
    if overrides:
        deep_update(cfg, overrides)
    return cfg
