"""SDF / color MLP decoders as plain functions over a weight dict.

Port of `mneslam_tpu/models/decoder.py`: bias-free ReLU MLPs (2 layers x
32 hidden at the Replica settings). Weights keep the JAX layout
[in, out] and apply as `x @ W`, so converted JAX weights load as they are.
With `grid.oneGrid: false` the colour net also sees the colour planes'
features.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch


def init_mlp(dims: Sequence[int], generator: torch.Generator,
             device) -> List[torch.Tensor]:
    """Bias-free MLP weights [in, out] for layer sizes dims[0] -> ... ->
    dims[-1], drawn U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (nn.Linear's init)."""
    out = []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        bound = 1.0 / math.sqrt(fan_in)
        u = torch.rand((fan_in, fan_out), generator=generator, device=device)
        out.append((2.0 * u - 1.0) * bound)
    return out


def mlp_apply_blocks(weights: List[torch.Tensor],
                     xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """`relu MLP(concat(xs, -1))` without the concat: the first layer's
    weight is split by rows, concat(xs) @ W == sum_i xs[i] @ W_i."""
    w0 = weights[0]
    h, off = None, 0
    for x in xs:
        part = x @ w0[off:off + x.shape[-1]]
        h = part if h is None else h + part
        off += x.shape[-1]
    if off != w0.shape[0]:
        raise ValueError(f"inputs give {off} features, weight expects "
                         f"{w0.shape[0]}")
    if len(weights) == 1:
        return h
    h = torch.relu(h)
    for w in weights[1:-1]:
        h = torch.relu(h @ w)
    return h @ weights[-1]


def decoder_dims(config):
    """(sdf layer sizes, color layer sizes). The colour net's input is the
    positional encoding and the geometric feature, and with
    `grid.oneGrid: false` the colour planes' features too."""
    dec = config["decoder"]
    input_ch = config["model"]["input_ch"]
    input_ch_pos = config["model"]["input_ch_pos"]
    geo = dec["geo_feat_dim"]
    sdf_dims = ([input_ch + input_ch_pos]
                + [dec["hidden_dim"]] * (dec["num_layers"] - 1) + [1 + geo])
    color_in = input_ch_pos + geo
    if not bool(config["grid"]["oneGrid"]):
        color_in += input_ch
    color_dims = ([color_in]
                  + [dec["hidden_dim_color"]] * (dec["num_layers_color"] - 1)
                  + [3])
    return sdf_dims, color_dims


def init_decoder(config, generator: torch.Generator,
                 device) -> Dict[str, List[torch.Tensor]]:
    """{sdf, color} weights of `decoder_dims`' sizes."""
    sdf_dims, color_dims = decoder_dims(config)
    return {"sdf": init_mlp(sdf_dims, generator, device),
            "color": init_mlp(color_dims, generator, device)}


def decoder_apply(params: Dict[str, List[torch.Tensor]],
                  embed: Sequence[torch.Tensor], embed_pos: torch.Tensor,
                  embed_color: Optional[Sequence[torch.Tensor]] = None
                  ) -> torch.Tensor:
    """(plane feature blocks, pos enc[, colour-plane feature blocks]) ->
    raw [N, 4] = (rgb logits, sdf). The colour net's blocks come in the
    JAX order [embed_pos, *embed_color, geo_feat]."""
    h = mlp_apply_blocks(params["sdf"], [*embed, embed_pos])
    sdf, geo_feat = h[..., :1], h[..., 1:]
    rgb = mlp_apply_blocks(params["color"],
                           [embed_pos, *(embed_color or ()), geo_feat])
    return torch.cat([rgb, sdf], dim=-1)
