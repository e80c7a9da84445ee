"""NetVLAD place-recognition descriptors and a deterministic stub.

Port of `mneslam_tpu/agents/netvlad.py`: the VGG16 convolution backbone up
to conv5_3 (no classification head, no last ReLU and pool), the NetVLAD
layer (K = 64 clusters, intra-normalisation), the 4096-d whitening, the
MatConvNet `.mat` importer, random weights for shape tests, and
`stub_descriptor`, a handcrafted global descriptor (tile colours and
gradient statistics, L2-normalised) with the same cosine-similarity
interface for runs without the checkpoint. Parameters keep the JAX
package's tree: {"convs": [{"weight" [out, in, 3, 3], "bias"}] x 13,
"score_w" [K, D], "centers" [D, K], "mean" [3], optionally "whiten_w"
[4096, D K], "whiten_b" [4096]}. The convolutions run in cuDNN; the
whitening is one matrix product.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..models.nn import conv2d

# VGG16's convolutions up to conv5_3; "M" = 2 x 2 max-pool
VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512]


def vgg_backbone_apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, 3, H, W] (0-255, mean subtracted) -> [B, 512, H/16, W/16]."""
    n_convs = sum(1 for c in VGG_CFG if c != "M")
    conv_i = 0
    for spec in VGG_CFG:
        if spec == "M":
            x = F.max_pool2d(x, 2, 2)
        else:
            x = conv2d(params["convs"][conv_i], x, padding=1)
            conv_i += 1
            if conv_i < n_convs:  # the last conv has no ReLU (head removed)
                x = F.relu(x)
    return x


def _l2n(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x / x.norm(dim=dim, keepdim=True).clamp(min=1e-12)


def netvlad_layer_apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, C, N] -> [B, C K]: soft-assignment over K clusters, residuals
    summed per cluster (sum_n a_kn x_cn - c_ck sum_n a_kn, one matrix
    product in place of the [B, C, K, N] residual tensor),
    intra-normalised, flattened and normalised."""
    scores = torch.softmax(torch.einsum("kc,bcn->bkn", params["score_w"], x),
                           dim=1)                               # [B, K, N]
    desc = torch.einsum("bkn,bcn->bck", scores, x) \
        - params["centers"][None] * scores.sum(-1)[:, None, :]  # [B, C, K]
    desc = _l2n(desc, 1).reshape(desc.shape[0], -1)
    return _l2n(desc, 1)


def netvlad_apply(params: Dict, image: torch.Tensor) -> torch.Tensor:
    """image [B, 3, H, W] in [0, 1] -> descriptor [B, 4096] (whitened) or
    [B, D K] without the whitening weights."""
    x = (image * 255.0).clamp(0.0, 255.0) - params["mean"][None, :, None,
                                                          None]
    feat = vgg_backbone_apply(params, x)
    feat = _l2n(feat.reshape(feat.shape[0], feat.shape[1], -1), 1)
    desc = netvlad_layer_apply(params, feat)
    if "whiten_w" in params:
        desc = _l2n(desc @ params["whiten_w"].T + params["whiten_b"], 1)
    return desc


def load_netvlad_mat(path: str, device="cpu") -> Dict:
    """Parse the MatConvNet struct checkpoint: the first 13 conv layers
    (S x S x IN x OUT), layer 30 the NetVLAD layer (score D x K, centres
    stored negated), layer 33 the whitening (1 x 1 x IN x OUT)."""
    from scipy.io import loadmat

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    mat = loadmat(path, struct_as_record=False, squeeze_me=True)
    layers = mat["net"].layers
    convs = []
    for lyr in layers:
        if getattr(lyr, "type", "") == "conv" and len(convs) < 13:
            w = np.asarray(lyr.weights[0], np.float32)
            b = np.asarray(lyr.weights[1], np.float32)
            convs.append({"weight": t(w.transpose(3, 2, 0, 1)),
                          "bias": t(b.reshape(-1))})
    score_w = np.asarray(layers[30].weights[0], np.float32)       # D x K
    centers = -np.asarray(layers[30].weights[1], np.float32)      # D x K
    # averageImage may be [H, W, 3], [1, 1, 3] or squeezed: its first three
    # flat values are pixel [0, 0]'s channel means
    mean = np.asarray(mat["net"].meta.normalization.averageImage,
                      np.float32).reshape(-1)[:3]
    w = np.asarray(layers[33].weights[0], np.float32).squeeze()   # IN x OUT
    b = np.asarray(layers[33].weights[1], np.float32).squeeze()
    return {"convs": convs, "score_w": t(score_w.T), "centers": t(centers),
            "mean": t(mean), "whiten_w": t(w.T), "whiten_b": t(b)}


def init_netvlad_random(generator: torch.Generator, whiten: bool = True,
                        device="cpu") -> Dict:
    """Random weights (shape tests; the descriptors mean nothing)."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    convs, in_ch = [], 3
    for spec in VGG_CFG:
        if spec == "M":
            continue
        convs.append({"weight": 0.05 * normal(spec, in_ch, 3, 3),
                      "bias": torch.zeros((spec,), device=device)})
        in_ch = spec
    params = {"convs": convs, "score_w": 0.1 * normal(64, 512),
              "centers": 0.1 * normal(512, 64),
              "mean": torch.tensor([123.68, 116.779, 103.939],
                                   device=device)}
    if whiten:
        params["whiten_w"] = 0.02 * normal(4096, 512 * 64)
        params["whiten_b"] = torch.zeros((4096,), device=device)
    return params


def stub_descriptor(image: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """Deterministic handcrafted descriptor [dim] of an image [H, W, 3]:
    4 x 4 tile means of the colour and of the absolute x / y gradients of
    the grey image, zero-padded to `dim` and L2-normalised. Near views
    correlate strongly and distant ones do not, which is all the
    loop-closure logic needs in tests."""
    H, W, _ = image.shape
    g = 4
    hs, ws = H // g, W // g
    img = image[: hs * g, : ws * g]
    tiles = img.reshape(g, hs, g, ws, 3).mean(dim=(1, 3))          # [4, 4, 3]
    grey = image.mean(-1)
    gx = (grey[:, 1:] - grey[:, :-1]).abs()[: hs * g, : ws * g - 1]
    gy = (grey[1:] - grey[:-1]).abs()[: hs * g - 1, : ws * g]
    gxt = gx[: hs * g, : (ws - 1) * g].reshape(g, hs, g, -1).mean(dim=(1, 3))
    gyt = gy[: (hs - 1) * g, : ws * g].reshape(g, -1, g, ws).mean(dim=(1, 3))
    feat = torch.cat([tiles.reshape(-1), gxt.reshape(-1), gyt.reshape(-1)])
    feat = F.pad(feat, (0, max(0, dim - feat.shape[0])))[:dim]
    return feat / feat.norm().clamp(min=1e-12)


def make_descriptor_fn(config, device="cpu"):
    """Descriptor extractor: NetVLAD when `checkpoints[model_name]` names a
    file that exists (a `.npz` written by `utils/params_io`, else the
    `.mat`), else the stub. The extractor takes an image [H, W, 3] in
    [0, 1] (a tensor, or an array moved to `device`) -> [D] tensor."""
    name = config.get("model_name", "VGG16-NetVLAD-Pitts30K")
    path = (config.get("checkpoints", {}) or {}).get(name)

    def to_dev(a):
        if isinstance(a, torch.Tensor):
            return a
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    if path and os.path.exists(str(path)):
        if str(path).endswith(".npz"):
            from ..utils.params_io import load_pytree_npz
            params = load_pytree_npz(str(path), device=device)
        else:
            params = load_netvlad_mat(str(path), device=device)

        def fn(image_hw3):
            img = to_dev(image_hw3).clamp(0.0, 1.0).permute(2, 0, 1)[None]
            with torch.no_grad():
                return netvlad_apply(params, img)[0]

        return fn
    return lambda image_hw3: stub_descriptor(to_dev(image_hw3))
