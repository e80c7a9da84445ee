"""PyTorch/CUDA port of MNESLAM-TPU for one NVIDIA H100.

A second package beside the JAX reference (`mneslam_tpu`): the same module
layout, the same data layouts at the public functions, and hand-written
CUDA kernels where the JAX package used Pallas. It imports torch and numpy
only. Entry points (`slam.MNESLAM`, `cli.main`) run on the GPU unless the
caller passes `device="cpu"`; without a GPU they raise.

This slice covers single-agent mapping-only mode (ground-truth poses,
online tri-plane map training); see ROADMAP.md for what is still to come.
"""
