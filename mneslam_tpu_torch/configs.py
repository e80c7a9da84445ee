"""Built-in configurations, as plain dicts (no YAML needed to use them).

`ROOM0` holds the values of `configs/Replica/replica.yaml` merged with
`configs/Replica/room0.yaml` for every key the mapping, tracking, meshing
and multi-agent slices read (`tracking.motion_filter.batch` and the `backend`
extras come from the defaults, as in the JAX package). Use it as
`make_config(ROOM0)`. It keeps the file's `dataset: replica` and `mode:
slam`; a caller without the Replica frames overrides `dataset` (e.g.
`synthetic`).
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
        "marching_cubes_bound": [[-1.0, 7.0], [-1.3, 3.7], [-1.7, 1.4]],
        "global_ba_every": 10,
        "loop_iters": 100,
        "distill_iters": 100,
        "lr_rot": 0.001,
        "lr_trans": 0.001,
    },
    "tracking": {
        "pretrained": "checkpoints/droid.pth",
        "buffer": 250,
        "beta": 0.75,
        "warmup": 12,
        "upsample": True,
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
        "H": 680, "W": 1200,
        "fx": 600.0, "fy": 600.0, "cx": 599.5, "cy": 339.5,
        "near": 0, "far": 10, "depth_trunc": 100.0,
        "H_edge": 0, "W_edge": 0, "H_out": 320, "W_out": 640,
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
    "mesh": {"resolution": 512, "vis": 50, "voxel_eval": 0.05,
             "voxel_final": 0.02},
    "meshing": {"level_set": 0, "resolution": 0.02, "mesh_bound_scale": 1.02},
    "planes_res": {"coarse": 0.02, "fine": 0.01, "bound_dividable": 0.02},
    # read with grid.oneGrid: false (replica.yaml sets oneGrid: True)
    "c_planes_res": {"coarse": 0.08, "fine": 0.02},
    "model": {"c_dim": 32, "truncation": 0.1, "input_ch": 64,
              "input_ch_pos": 48},
    "distillation": {"use_bound_overlap": True},
    "loop_closure": {"pose_decay_sigma": 10.0, "pose_decay_min_weight": 0.1},
    "loop_detection": {
        "enabled": True,
        "sim_threshold": 0.8,
        "min_time_diff": 20,
        "loop_launch_th": 20,
        "min_matches_for_fusion": 3,
    },
    "model_name": "VGG16-NetVLAD-Pitts30K",
    "checkpoints": {
        "VGG16-NetVLAD-Pitts30K": "checkpoints/VGG16-NetVLAD-Pitts30K.mat",
        "VGG16-NetVLAD-TokyoTM": "checkpoints/VGG16-NetVLAD-TokyoTM.mat",
    },
    "loop_bound": {
        "bound_0": [[-1.0, 7.0], [-1.3, 3.7], [-1.7, 1.4]],
        "bound_1": [[-1.0, 7.0], [-1.3, 3.7], [-1.7, 1.4]],
    },
}
