"""NCHW conv-net primitives over parameter dicts with torch-layout weights.

Port of `mneslam_tpu/models/nn.py`. Parameters are plain dicts
{"weight": [out, in, kh, kw], "bias": [out]} (the published `droid.pth`
layout), and activations follow the weight dtype: bf16 weights run the
conv stack in bf16 (the reference tracker runs under fp16 autocast).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F


def conv2d(p: Dict, x: torch.Tensor, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """NCHW conv; `x` is cast to the weight dtype first."""
    w = p["weight"]
    if x.dtype != w.dtype:
        x = x.to(w.dtype)
    return F.conv2d(x, w, p.get("bias"), stride=stride, padding=padding)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch InstanceNorm2d defaults: no affine, per (sample, channel)
    over HW, biased variance."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


def init_conv(generator: torch.Generator, in_ch: int, out_ch: int, k: int,
              bias: bool = True, device=None) -> Dict:
    """Kaiming-normal init (fan_out mode, as extractor.py:92-94)."""
    std = math.sqrt(2.0 / (out_ch * k * k))
    p = {"weight": std * torch.randn((out_ch, in_ch, k, k),
                                     generator=generator, device=device)}
    if bias:
        p["bias"] = torch.zeros((out_ch,), device=device)
    return p


class _ClipGrad(torch.autograd.Function):
    """Identity forward; backward zeroes gradient entries that are NaN or
    larger than `clip` in magnitude (tracker/modules/clipping.py)."""

    @staticmethod
    def forward(ctx, x, clip):
        ctx.clip = clip
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
        g = torch.where(g.abs() > ctx.clip, torch.zeros_like(g), g)
        return g, None


def clip_grad_custom(x: torch.Tensor, clip: float = 0.01) -> torch.Tensor:
    """GradientClip: the port's counterpart of the JAX `custom_vjp`."""
    return _ClipGrad.apply(x, clip)
