"""Run-to-run determinism of the tracking-parity check's GPU side, and the
parts of its GPU-vs-CPU gap.

    python -m mneslam_tpu_torch.tools.prof_determinism

The check (`chip_smoke.py` phase 4, `tracking_parity_run` below) runs two
factor-graph updates (correlation, ConvGRU, windowed BA) of one tiny
keyframe buffer with fixed random DROID weights, on the GPU and on the CPU,
in fp32. This probe prints one JSON line with
  modes: the GPU side twice in each of three settings (default; cuDNN's
      deterministic algorithms only; `torch.use_deterministic_algorithms`
      throughout), each run against the CPU and the two runs against each
      other (0.0: bit-identical), with the warnings of the operations that
      have no deterministic version;
  repeats: whether a repeated call on the same CUDA inputs changes the
      result, for `index_add_` with the dense BA's duplicate segment ids
      and for the ConvGRU's fp32 3x3 convolution;
  by_update: the deterministic GPU side against the CPU after one update
      and after two, with the GPU's correlation through kernel 2 (`pallas`)
      and through the plain slab gather (`xla`);
  conv: that 3x3 convolution alone, GPU against CPU on the same inputs.
cuBLAS reads CUBLAS_WORKSPACE_CONFIG when CUDA starts; `main` sets it first.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import warnings
from typing import Sequence

import numpy as np
import torch


def tracking_parity_run(dev, updates: int = 2) -> dict:
    """`updates` factor-graph updates (correlation, ConvGRU, windowed BA)
    of one tiny keyframe buffer with fixed random DROID weights on `dev`,
    fp32 -> {name: result on the CPU}."""
    from ..models import droid_net
    from ..ops import lie
    from ..tracking.graph import FactorGraph
    from ..utils.convert import video_state_from_numpy

    B, HT, WD = 8, 12, 16
    rng = np.random.default_rng(0)
    xi = (0.05 * rng.normal(size=(B, 6))).astype(np.float32)
    xi[0] = 0.0
    feats = rng.normal(size=(3, B, 128, HT, WD)).astype(np.float32)
    disps = (0.4 + 0.2 * rng.random((B, HT, WD))).astype(np.float32)
    arrays = {
        "timestamps": np.arange(B, dtype=np.float32),
        "poses": lie.exp(torch.tensor(xi)).numpy(),
        "poses_gt": np.tile(np.eye(4, dtype=np.float32), (B, 1, 1)),
        "disps": disps, "disps_sens": disps,
        "fmaps": feats[0], "nets": np.tanh(feats[1]),
        "inps": np.maximum(feats[2], 0.0),
        "damping": np.full((B, HT, WD), 1e-6, np.float32),
    }
    params = droid_net.init_droid_net(torch.Generator().manual_seed(0))
    intr = np.array([12.0, 12.0, 7.5, 5.5], np.float32)
    p = droid_net.map_params(params, lambda t: t.to(dev))
    st = video_state_from_numpy(arrays, device=dev)
    g = FactorGraph(B, HT, WD, capacity=24, params=p,
                    intrinsics=torch.tensor(intr, device=dev), window=8)
    g.add_neighborhood_factors(st, 0, 6, r=2)
    with torch.no_grad():
        for _ in range(updates):
            st = g.update(st, t0=1, t1=6, use_inactive=True)
    n = g.n_active
    return {"poses": st.poses.cpu(), "disps": st.disps.cpu(),
            "target": g.target[:n].cpu(), "weight": g.weight[:n].cpu()}


@contextlib.contextmanager
def deterministic(algorithms: bool, cudnn: bool):
    """torch.use_deterministic_algorithms(algorithms, warn_only=True) and
    cudnn.deterministic = cudnn (cudnn.benchmark off) inside the block,
    the previous settings after it; yields the warnings raised inside
    (the operations that have no deterministic implementation)."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(algorithms, warn_only=True)
    torch.backends.cudnn.deterministic = cudnn
    torch.backends.cudnn.benchmark = False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            yield caught
        finally:
            torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
            torch.backends.cudnn.deterministic = prev[2]
            torch.backends.cudnn.benchmark = prev[3]


def repeat_diff(a: dict, b: dict) -> dict:
    """Largest |a - b| per output of two runs (0.0: bit-identical)."""
    return {k: float((a[k] - b[k]).abs().max()) for k in a}


def _conv_inputs():
    """The probes' convolution: [24, 128, 12, 16] inputs (24 edges at the
    check's 12 x 16), a 128 -> 128 3x3 weight, on the CPU."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((24, 128, 12, 16), generator=g)
    w = torch.randn((128, 128, 3, 3), generator=g) * 0.03
    return x, w


def repeats() -> dict:
    """Each suspect operation of the tracking path called six times on the
    same CUDA inputs, by default: does any result differ from the first?"""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(1)
    idx = torch.randint(0, 8, (24,), generator=g).cuda()
    vals = torch.randn((24, 12 * 16 * 36), generator=g).cuda()
    x, w = (t.cuda() for t in _conv_inputs())
    out = {}
    for name, fn in (
            ("index_add_", lambda: torch.zeros(
                (8, vals.shape[1]), device="cuda").index_add_(0, idx, vals)),
            ("conv2d", lambda: F.conv2d(x, w, padding=1))):
        first = fn()
        out[name] = any(not torch.equal(first, fn()) for _ in range(5))
    return out


def run() -> dict:
    """The readings of the module docstring -> dict (needs a GPU)."""
    import torch.nn.functional as F

    from ..device import resolve_device
    from .prof_corr import corr_impl

    resolve_device("cuda")  # TF32 off, as the port runs
    cpu = {u: tracking_parity_run("cpu", u) for u in (1, 2)}
    out = {"modes": {}}
    for mode, (algorithms, cudnn) in (("default", (False, False)),
                                      ("cudnn", (False, True)),
                                      ("deterministic", (True, True))):
        with deterministic(algorithms, cudnn) as caught:
            a, b = (tracking_parity_run("cuda") for _ in range(2))
        out["modes"][mode] = {
            "run1_vs_cpu": repeat_diff(a, cpu[2]),
            "run2_vs_cpu": repeat_diff(b, cpu[2]),
            "run1_vs_run2": repeat_diff(a, b),
            "warnings": sorted({str(x.message)[:160] for x in caught})}
    out["repeats"] = repeats()
    out["by_update"] = {}
    for impl in ("pallas", "xla"):
        with corr_impl(impl), deterministic(True, True):
            for u in (1, 2):
                out["by_update"][f"{impl}/{u}"] = repeat_diff(
                    tracking_parity_run("cuda", u), cpu[u])
    x, w = _conv_inputs()
    ref = F.conv2d(x, w, padding=1)
    got = F.conv2d(x.cuda(), w.cuda(), padding=1).cpu()
    out["conv"] = {"max_abs_diff": float((got - ref).abs().max()),
                   "max_abs": float(ref.abs().max())}
    return out


def main(argv: Sequence[str] = None) -> int:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(
        argv)
    print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
