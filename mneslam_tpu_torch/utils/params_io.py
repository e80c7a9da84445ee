"""Self-describing flat `.npz` files of parameter trees.

Port of `mneslam_tpu/utils/params_io.py`, file for file: each key is the
JSON list of a leaf's path steps, ["d", key] for a dict entry and
["s", index] for a list entry, so a file loads with no template and nested
dicts and lists come back as they were. A file written by either package
loads in the other. `slam.MNESLAM` reads a `.npz` `tracking.pretrained`
through it, `agents.netvlad.make_descriptor_fn` a `.npz` NetVLAD.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, path + (["d", str(k)],))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (["s", i],))
    else:
        yield list(path), tree


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_pytree_npz(path: str, tree: Any) -> None:
    """Write a tree of dicts and lists of arrays (tensors or numpy) to one
    `.npz`, through a temporary name and a rename."""
    arrays = {json.dumps(p): _to_numpy(v) for p, v in _flatten(tree)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_pytree_npz(path: str, device="cpu") -> Any:
    """Rebuild the nested dict / list tree, leaves as tensors on
    `device`."""
    root: Dict = {}

    def insert(container, steps, value):
        kind, key = steps[0]
        last = len(steps) == 1
        if kind == "d":
            if last:
                container[key] = value
            else:
                insert(container.setdefault(
                    key, {} if steps[1][0] == "d" else []), steps[1:], value)
        else:
            while len(container) <= key:
                container.append(None)
            if last:
                container[key] = value
            else:
                if container[key] is None:
                    container[key] = {} if steps[1][0] == "d" else []
                insert(container[key], steps[1:], value)

    with np.load(path, allow_pickle=False) as data:
        for enc in data.files:
            steps = [(k, v) for k, v in json.loads(enc)]
            insert(root, steps, torch.as_tensor(data[enc], device=device))
    return root
