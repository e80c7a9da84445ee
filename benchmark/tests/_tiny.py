"""A tiny size of every cell, for CPU runs of the harness in tests."""

TINY = {"config": {"cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0,
                           "cx": 15.5, "cy": 11.5},
                   "planes_res": {"coarse": 0.5, "fine": 0.25,
                                  "bound_dividable": 0.5},
                   "mapping": {"sample": 64, "min_pixels_cur": 8,
                               "first_iters": 5, "iters": 3,
                               "loop_iters": 4},
                   "training": {"n_samples": 16}},
        "traffic": {"distinct_keyframes": 4, "capacity_keyframes": 12,
                    "check_closures": 2}}
