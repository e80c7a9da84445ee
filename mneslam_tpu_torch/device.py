"""Device selection and numeric policy for the port.

Every entry point resolves its `device` argument here: the default is the
GPU, and asking for it on a machine without one raises instead of falling
back to the CPU. The port computes in float32 throughout, so TF32 is turned
off for both matrix products and cuDNN (the JAX package's
`training.render_dtype: float32` default).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` ("cuda", "cuda:N", "cpu" or a torch.device) -> torch.device.

    Raises RuntimeError for a CUDA device when no GPU is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {device!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def make_generator(device: torch.device, seed: int) -> torch.Generator:
    """A seeded generator on `device` (the port's stand-in for a
    `jax.random` key stream)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g
