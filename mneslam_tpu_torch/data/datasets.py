"""Dataset factory.

Port of `get_dataset` from `mneslam_tpu/data/datasets.py`, synthetic branch
only. The file loaders (Replica, ScanNet, TUM, Indoor, Outdoor) are not
ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from .synthetic import SyntheticBoxDataset


def get_dataset(config):
    """Factory keyed on config['dataset']."""
    name = config["dataset"]
    if name == "synthetic":
        return SyntheticBoxDataset(
            config, num_frames=config["data"].get("num_frames", 24))
    raise ValueError(
        f"dataset {name!r} has no loader in mneslam_tpu_torch yet; "
        "only 'synthetic' is ported")
