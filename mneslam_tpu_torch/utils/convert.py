"""Carry JAX-package parameters (and Adam moments) into the port.

The input is the JAX `SceneRep.init_params` tree with every leaf already a
numpy array (nested dicts and lists; the caller applies
`jax.tree.map(np.asarray, ...)`), so this module needs no JAX. Planes stay
[C, H, W] and decoder weights stay [in, out]: the port applies them as
`x @ W`, as the JAX package does, so nothing is transposed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.scene_rep import param_items


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(v, fn) for v in tree]
    return fn(tree)


def params_from_jax(tree_of_numpy: Dict, device="cpu") -> Dict:
    """JAX params tree of numpy arrays -> the port's parameter dict of
    float32 leaf tensors with requires_grad."""
    return _map_tree(tree_of_numpy, lambda a: torch.tensor(
        np.asarray(a, np.float32), device=device, requires_grad=True))


def params_to_numpy(params: Dict) -> Dict:
    """The port's parameter dict -> the same tree of numpy arrays (the
    JAX package's layout)."""
    return _map_tree(params, lambda t: t.detach().cpu().numpy())


def load_adam_moments(optimizer: torch.optim.Optimizer, params: Dict,
                      mu: Dict, nu: Dict, count: int):
    """Set `optimizer`'s Adam state from optax's first and second moments.

    mu, nu: trees shaped like the params (numpy leaves; the caller merges
    optax's per-group moment trees); count: optax's step count. Every
    parameter of `params` gets exp_avg = mu, exp_avg_sq = nu, step = count.
    """
    mu_items = dict(param_items(mu))
    nu_items = dict(param_items(nu))
    for path, p in param_items(params):
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.tensor(np.asarray(mu_items[path], np.float32),
                                    device=p.device),
            "exp_avg_sq": torch.tensor(np.asarray(nu_items[path], np.float32),
                                       device=p.device),
        }
