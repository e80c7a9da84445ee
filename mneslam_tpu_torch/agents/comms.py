"""Inter-agent communication backends.

Port of `mneslam_tpu/agents/comms.py`. An explicit interface with two
backends:

  * `InMemoryComms`: every agent in one process (the round-robin runner);
    the exchange is plain shared host state.
  * `FileComms`: the on-disk protocol for one process per agent: atomic
    temporary-file-and-rename writes of `agent_<rank>/key_est_poses.npy`,
    `key_timestamps.npy`, `latest_checkpoint.npz` and
    `descriptors/<n>.npz`.

The files are the JAX package's, file for file and key for key: a
checkpoint's parameter keys are the JAX tree paths ("['planes']/['xy']/[0]",
`pack_params`) and its metadata keys carry the prefix "__meta_". So a JAX
agent and a port agent read each other's descriptors, keyframes and
checkpoints.

Exchanged payloads: descriptor entries {descriptor, kf_id, agent_id}, each
agent's keyframe poses and timestamps, and map checkpoints (parameters +
{"bound"}).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.droid_net import map_params
from ..models.scene_rep import checkpoint_key, param_items


class Comms:
    def add_descriptor(self, entry: Dict) -> None:
        raise NotImplementedError

    def descriptors(self) -> List[Dict]:
        raise NotImplementedError

    def publish_keyframes(self, rank: int, poses: np.ndarray,
                          timestamps: np.ndarray) -> None:
        raise NotImplementedError

    def get_keyframes(self, rank: int
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        raise NotImplementedError

    def publish_checkpoint(self, rank: int, params, meta: Dict) -> None:
        raise NotImplementedError

    def get_checkpoint(self, rank: int):
        raise NotImplementedError


class InMemoryComms(Comms):
    def __init__(self):
        self._db: List[Dict] = []
        self._kf: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._ckpt: Dict[int, Tuple[Any, Dict]] = {}

    def add_descriptor(self, entry: Dict) -> None:
        self._db.append(dict(entry))

    def descriptors(self) -> List[Dict]:
        return list(self._db)

    def publish_keyframes(self, rank, poses, timestamps):
        self._kf[rank] = (np.asarray(poses).copy(),
                          np.asarray(timestamps).copy())

    def get_keyframes(self, rank):
        return self._kf.get(rank)

    def publish_checkpoint(self, rank, params, meta):
        # a detached copy on the params' device: a reader gets the map as
        # it was at the publish, as with JAX's immutable arrays
        self._ckpt[rank] = (map_params(params, lambda t: t.detach().clone()),
                            dict(meta))

    def get_checkpoint(self, rank):
        return self._ckpt.get(rank)


class FileComms(Comms):
    """Atomic-rename file exchange. The descriptor DB is one directory of
    npz files per agent, which every agent scans."""

    def __init__(self, out_dir: str, rank: int):
        self.out_dir = out_dir
        self.rank = rank
        self._desc_count = 0
        os.makedirs(os.path.join(self._agent_dir(rank), "descriptors"),
                    exist_ok=True)

    def _agent_dir(self, rank: int) -> str:
        return os.path.join(self.out_dir, f"agent_{rank}")

    @staticmethod
    def _atomic_save(path: str, save_fn):
        tmp = path + ".tmp"
        save_fn(tmp)
        os.replace(tmp, path)

    def add_descriptor(self, entry: Dict) -> None:
        d = os.path.join(self._agent_dir(self.rank), "descriptors")
        path = os.path.join(d, f"{self._desc_count:06d}.npz")
        self._atomic_save(path, lambda p: _savez_exact(p, {
            "descriptor": np.asarray(entry["descriptor"]),
            "kf_id": np.asarray(entry["kf_id"]),
            "agent_id": np.asarray(entry["agent_id"])}))
        self._desc_count += 1

    def descriptors(self) -> List[Dict]:
        out = []
        if not os.path.isdir(self.out_dir):
            return out
        for name in sorted(os.listdir(self.out_dir)):
            ddir = os.path.join(self.out_dir, name, "descriptors")
            if not os.path.isdir(ddir):
                continue
            for f in sorted(os.listdir(ddir)):
                if not f.endswith(".npz"):
                    continue
                try:
                    with np.load(os.path.join(ddir, f)) as z:
                        out.append({"descriptor": z["descriptor"],
                                    "kf_id": int(z["kf_id"]),
                                    "agent_id": int(z["agent_id"])})
                except (OSError, ValueError):
                    pass  # a torn read of a concurrent write: skip it
        return out

    def publish_keyframes(self, rank, poses, timestamps):
        d = self._agent_dir(rank)
        os.makedirs(d, exist_ok=True)
        self._atomic_save(os.path.join(d, "key_est_poses.npy"),
                          lambda p: _save_exact(p, np.asarray(poses)))
        self._atomic_save(os.path.join(d, "key_timestamps.npy"),
                          lambda p: _save_exact(p, np.asarray(timestamps)))

    def get_keyframes(self, rank):
        d = self._agent_dir(rank)
        pp = os.path.join(d, "key_est_poses.npy")
        tp = os.path.join(d, "key_timestamps.npy")
        if not (os.path.exists(pp) and os.path.exists(tp)):
            return None
        return np.load(pp), np.load(tp)

    def publish_checkpoint(self, rank, params, meta):
        d = self._agent_dir(rank)
        os.makedirs(d, exist_ok=True)
        arrays = pack_params(params)
        for k, v in meta.items():
            arrays["__meta_" + k] = np.asarray(v)
        self._atomic_save(os.path.join(d, "latest_checkpoint.npz"),
                          lambda p: _savez_exact(p, arrays))

    def get_checkpoint(self, rank):
        """-> ({JAX path key: array}, {meta key: array}) or None."""
        path = os.path.join(self._agent_dir(rank), "latest_checkpoint.npz")
        if not os.path.exists(path):
            return None
        with np.load(path) as data:
            params_flat = {k: data[k] for k in data.files
                           if not k.startswith("__meta_")}
            meta = {k[len("__meta_"):]: data[k] for k in data.files
                    if k.startswith("__meta_")}
        return params_flat, meta


def _savez_exact(path: str, arrays: Dict[str, np.ndarray]):
    """np.savez appends .npz: write to the exact temporary path instead."""
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def _save_exact(path: str, array: np.ndarray):
    """np.save appends .npy: write to the exact temporary path instead."""
    with open(path, "wb") as f:
        np.save(f, array)


def pack_params(params) -> Dict[str, np.ndarray]:
    """Parameter tree -> {JAX path key: numpy array}."""
    return {checkpoint_key(p): (t.detach().cpu().numpy()
                          if isinstance(t, torch.Tensor) else np.asarray(t))
            for p, t in param_items(params)}


def unpack_params(template, flat: Dict[str, np.ndarray], device=None):
    """{JAX path key: array} -> a tree shaped like `template`, leaves as
    float32 tensors on `device` (default: the template leaf's) that take
    no gradient."""
    def build(tree, path):
        if isinstance(tree, dict):
            return {k: build(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [build(v, path + (i,)) for i, v in enumerate(tree)]
        dev = device if device is not None else tree.device
        return torch.as_tensor(
            np.asarray(flat[checkpoint_key(path)], np.float32), device=dev)

    return build(template, ())
