"""DROID tracker networks: feature/context encoders and the ConvGRU update.

Port of `mneslam_tpu/models/droid_net.py`. Parameters are nested dicts and
lists of tensors whose paths mirror the torch module names of the
published `droid.pth`, so `load_droid_weights` is a rename plus the
reference's 2-channel head slicing. Every apply is batched over a leading
edge/frame axis; the GraphAgg segment mean is `index_add_` with an explicit
edge mask, so padded edge slots stay inert.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .nn import clip_grad_custom, conv2d, init_conv, instance_norm

DIM = 32
CORR_PLANES = 4 * (2 * 3 + 1) ** 2  # 4 levels x 7x7 window = 196

_GRU_CONVS = ("convz", "convr", "convq", "w", "convz_glo", "convr_glo",
              "convq_glo")


# ---------------------------------------------------------------------------
# BasicEncoder
# ---------------------------------------------------------------------------

def _norm(x: torch.Tensor, norm: str) -> torch.Tensor:
    return instance_norm(x) if norm == "instance" else x


def _res_block(p: Dict, x: torch.Tensor, norm: str, stride: int):
    y = F.relu(_norm(conv2d(p["conv1"], x, stride=stride, padding=1), norm))
    y = F.relu(_norm(conv2d(p["conv2"], y, padding=1), norm))
    if stride > 1:
        x = _norm(conv2d(p["downsample"], x, stride=stride), norm)
    return F.relu(x + y)


def encoder_apply(p: Dict, x: torch.Tensor, norm: str) -> torch.Tensor:
    """[N, 3, H, W] -> [N, out_dim, H/8, W/8] (extractor.py:110-126)."""
    x = F.relu(_norm(conv2d(p["conv1"], x, stride=2, padding=3), norm))
    for layer, stride in (("layer1", 1), ("layer2", 2), ("layer3", 2)):
        x = _res_block(p[layer][0], x, norm, stride)
        x = _res_block(p[layer][1], x, norm, 1)
    return conv2d(p["conv2"], x)


def init_encoder(generator: torch.Generator, out_dim: int,
                 device=None) -> Dict:
    def conv(i, o, k):
        return init_conv(generator, i, o, k, device=device)

    def block(in_ch, ch, stride):
        p = {"conv1": conv(in_ch, ch, 3), "conv2": conv(ch, ch, 3)}
        if stride > 1:
            p["downsample"] = conv(in_ch, ch, 1)
        return p

    return {
        "conv1": conv(3, DIM, 7),
        "layer1": [block(DIM, DIM, 1), block(DIM, DIM, 1)],
        "layer2": [block(DIM, 2 * DIM, 2), block(2 * DIM, 2 * DIM, 1)],
        "layer3": [block(2 * DIM, 4 * DIM, 2), block(4 * DIM, 4 * DIM, 1)],
        "conv2": conv(4 * DIM, out_dim, 1),
    }


# ---------------------------------------------------------------------------
# ConvGRU with global context gating (gru.py:5-33), the reference form
# ---------------------------------------------------------------------------

def gru_apply(p: Dict, net: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
    net_inp = torch.cat([net, inp.to(net.dtype)], dim=1)
    glo = torch.sigmoid(conv2d(p["w"], net)) * net
    glo = glo.mean(dim=(2, 3), keepdim=True)

    z = torch.sigmoid(conv2d(p["convz"], net_inp, padding=1)
                      + conv2d(p["convz_glo"], glo))
    r = torch.sigmoid(conv2d(p["convr"], net_inp, padding=1)
                      + conv2d(p["convr_glo"], glo))
    q = torch.tanh(conv2d(p["convq"], torch.cat([r * net, inp.to(r.dtype)],
                                                 dim=1), padding=1)
                   + conv2d(p["convq_glo"], glo))
    return (1 - z) * net + z * q


def init_gru(generator: torch.Generator, h: int = 128, i: int = 320,
             device=None) -> Dict:
    def conv(i_, o, k):
        return init_conv(generator, i_, o, k, device=device)

    return {"convz": conv(h + i, h, 3), "convr": conv(h + i, h, 3),
            "convq": conv(h + i, h, 3), "w": conv(h, h, 1),
            "convz_glo": conv(h, h, 1), "convr_glo": conv(h, h, 1),
            "convq_glo": conv(h, h, 1)}


# ---------------------------------------------------------------------------
# UpdateModule (droid_net.py:70-140)
# ---------------------------------------------------------------------------

def update_apply(p: Dict, net: torch.Tensor, inp: torch.Tensor,
                 corr: torch.Tensor, flow: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One GRU update: net [E,128,h,w], inp [E,128,h,w], corr [E,196,h,w],
    flow [E,4,h,w] -> (net, delta [E,h,w,2] fp32, weight [E,h,w,2] fp32)."""
    if flow is None:
        flow = torch.zeros((net.shape[0], 4) + tuple(net.shape[2:]),
                           dtype=net.dtype, device=net.device)
    c = F.relu(conv2d(p["corr_encoder"][0], corr))
    c = F.relu(conv2d(p["corr_encoder"][1], c, padding=1))
    f = F.relu(conv2d(p["flow_encoder"][0], flow, padding=3))
    f = F.relu(conv2d(p["flow_encoder"][1], f, padding=1))

    net = gru_apply(p["gru"], net.to(c.dtype),
                    torch.cat([inp.to(c.dtype), c, f], dim=1))

    d = F.relu(conv2d(p["delta"][0], net, padding=1))
    delta = clip_grad_custom(conv2d(p["delta"][1], d, padding=1))
    w = F.relu(conv2d(p["weight"][0], net, padding=1))
    weight = torch.sigmoid(clip_grad_custom(conv2d(p["weight"][1], w,
                                                   padding=1)))
    # downstream geometry (reprojection targets, BA) runs fp32
    delta = delta.permute(0, 2, 3, 1).float()
    weight = weight.permute(0, 2, 3, 1).float()
    return net, delta, weight


def agg_apply(p: Dict, net: torch.Tensor, ii: torch.Tensor,
              mask: torch.Tensor, num_frames: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GraphAgg (droid_net.py:34-67): masked per-source-frame mean of the
    hidden state -> damping eta [E, h, w] (per edge, fp32) and the upsample
    mask per FRAME [num_frames, 576, h, w] in the net dtype."""
    h1 = F.relu(conv2d(p["conv1"], net, padding=1))
    m = mask.to(h1.dtype)
    ii = ii.long()
    summed = torch.zeros((num_frames,) + tuple(h1.shape[1:]), dtype=h1.dtype,
                         device=h1.device)
    summed.index_add_(0, ii, h1 * m[:, None, None, None])
    count = torch.zeros((num_frames,), dtype=h1.dtype, device=h1.device)
    count.index_add_(0, ii, m)
    mean = summed / count.clamp(min=1.0)[:, None, None, None]
    # conv(mean[ii]) == conv(mean)[ii]: the head convs run on the frame
    # means, gathered per edge afterwards
    h2 = F.relu(conv2d(p["conv2"], mean, padding=1))
    eta_n = F.softplus(clip_grad_custom(conv2d(p["eta"][0], h2, padding=1)))
    upmask_n = conv2d(p["upmask"][0], h2)
    return (0.01 * eta_n[ii, 0]).float(), upmask_n


def init_update(generator: torch.Generator, device=None) -> Dict:
    def conv(i, o, k):
        return init_conv(generator, i, o, k, device=device)

    return {
        "corr_encoder": [conv(CORR_PLANES, 128, 1), conv(128, 128, 3)],
        "flow_encoder": [conv(4, 128, 7), conv(128, 64, 3)],
        "weight": [conv(128, 128, 3), conv(128, 2, 3)],
        "delta": [conv(128, 128, 3), conv(128, 2, 3)],
        "gru": init_gru(generator, device=device),
        "agg": {
            "conv1": conv(128, 128, 3),
            "conv2": conv(128, 128, 3),
            "eta": [conv(128, 1, 3)],
            "upmask": [conv(128, 8 * 8 * 9, 1)],
        },
    }


def init_droid_net(generator: torch.Generator, device=None) -> Dict:
    """Random DROID weights (the JAX package's init; `jax.random` streams
    cannot be replayed, so the values differ from the JAX init)."""
    return {"fnet": init_encoder(generator, 128, device),
            "cnet": init_encoder(generator, 256, device),
            "update": init_update(generator, device)}


# ---------------------------------------------------------------------------
# convex upsampling (droid_net.py:9-31)
# ---------------------------------------------------------------------------

def cvx_upsample(data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """data [B, ht, wd, dim], mask [B, 576, ht, wd] -> [B, 8ht, 8wd, dim]."""
    B, ht, wd, dim = data.shape
    x = data.permute(0, 3, 1, 2)
    m = torch.softmax(mask.reshape(B, 9, 8, 8, ht, wd), dim=1)
    xp = F.pad(x, (1, 1, 1, 1))
    patches = torch.stack([xp[:, :, dy:dy + ht, dx:dx + wd]
                           for dy in range(3) for dx in range(3)], dim=2)
    up = torch.einsum("bdkhw,bkijhw->bdijhw", patches, m.to(patches.dtype))
    up = up.permute(0, 4, 2, 5, 3, 1)                 # [B, ht, 8, wd, 8, dim]
    return up.reshape(B, 8 * ht, 8 * wd, dim)


# ---------------------------------------------------------------------------
# image feature helpers (motion_filter.py:22-37)
# ---------------------------------------------------------------------------

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """[N, 3, H, W] in [0, 1] -> ImageNet-normalised (per-channel
    scalars: no host-to-device copy)."""
    return torch.stack([(images[:, c] - m) / s for c, (m, s) in
                        enumerate(zip(IMAGE_MEAN, IMAGE_STD))], dim=1)


def feature_encoder(params: Dict, images: torch.Tensor) -> torch.Tensor:
    """fnet: normalised images -> [N, 128, H/8, W/8]."""
    return encoder_apply(params["fnet"], images, norm="instance")


def context_encoder(params: Dict, images: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cnet -> (net = tanh [N,128,h,w], inp = relu [N,128,h,w])."""
    out = encoder_apply(params["cnet"], images, norm="none")
    net, inp = out.split(out.shape[1] // 2, dim=1)
    return torch.tanh(net), F.relu(inp)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def map_params(params, fn):
    """Apply `fn` to every tensor of a nested dict/list tree."""
    if isinstance(params, dict):
        return {k: map_params(v, fn) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [map_params(v, fn) for v in params]
    return fn(params)


def cast_params(params: Dict, dtype: torch.dtype) -> Dict:
    """Cast the tracker weights (activations follow via conv2d)."""
    return map_params(params, lambda t: t.to(dtype))


def params_dtype(params: Dict) -> torch.dtype:
    """The dtype of the first weight (float32 for an empty tree)."""
    leaves = []
    map_params(params, leaves.append)
    return leaves[0].dtype if leaves else torch.float32


def load_droid_weights(path: str, device="cpu") -> Dict:
    """The published droid.pth state dict -> the params tree, with the
    reference loader's surgery (mneslam_mp.py:142-154): strip 'module.',
    slice the delta/weight output heads to 2 channels."""
    sd = {k.replace("module.", ""): v for k, v in
          torch.load(path, map_location="cpu", weights_only=True).items()}
    for name in ("update.weight.2", "update.delta.2"):
        sd[name + ".weight"] = sd[name + ".weight"][:2]
        sd[name + ".bias"] = sd[name + ".bias"][:2]

    def conv(prefix):
        p = {"weight": sd[prefix + ".weight"].float().to(device)}
        if prefix + ".bias" in sd:
            p["bias"] = sd[prefix + ".bias"].float().to(device)
        return p

    def block(prefix, stride):
        p = {"conv1": conv(prefix + ".conv1"), "conv2": conv(prefix + ".conv2")}
        if stride > 1:
            p["downsample"] = conv(prefix + ".downsample.0")
        return p

    def encoder(prefix):
        return {
            "conv1": conv(prefix + ".conv1"),
            "layer1": [block(f"{prefix}.layer1.{i}", 1) for i in range(2)],
            "layer2": [block(f"{prefix}.layer2.{i}", s)
                       for i, s in ((0, 2), (1, 1))],
            "layer3": [block(f"{prefix}.layer3.{i}", s)
                       for i, s in ((0, 2), (1, 1))],
            "conv2": conv(prefix + ".conv2"),
        }

    return {
        "fnet": encoder("fnet"),
        "cnet": encoder("cnet"),
        "update": {
            "corr_encoder": [conv("update.corr_encoder.0"),
                             conv("update.corr_encoder.2")],
            "flow_encoder": [conv("update.flow_encoder.0"),
                             conv("update.flow_encoder.2")],
            "weight": [conv("update.weight.0"), conv("update.weight.2")],
            "delta": [conv("update.delta.0"), conv("update.delta.2")],
            "gru": {k: conv("update.gru." + k) for k in _GRU_CONVS},
            "agg": {
                "conv1": conv("update.agg.conv1"),
                "conv2": conv("update.agg.conv2"),
                "eta": [conv("update.agg.eta.0")],
                "upmask": [conv("update.agg.upmask.0")],
            },
        },
    }
