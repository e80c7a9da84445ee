"""H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W power limit) and
the least time a piece of work could take on the card.

The bound arithmetic is a copy of `mneslam_tpu_torch/tools/measure.py`
(`bound_ms`), kept here so that a change to the program cannot move it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}


def bound_s(nbytes: float, flops: float = 0.0,
            precision: str = "fp32") -> float:
    """The larger of bytes over the memory rate and operations over the
    peak of `precision`, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS[precision])
