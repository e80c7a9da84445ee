"""The port stands alone: importing every module of `mneslam_tpu_torch`
loads neither JAX nor the JAX package, and no source file names them."""

import os
import pkgutil
import re
import subprocess
import sys

import mneslam_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(mneslam_tpu_torch.__file__)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG], prefix="mneslam_tpu_torch."))


def test_every_module_imports_without_jax():
    mods = _modules()
    for m in ("kernels.scatter_add_rows", "kernels.corr_window", "slam",
              "models.nn", "models.droid_net", "ops.lie", "ops.projective",
              "ops.correlation", "ops.ba", "tracking.video",
              "tracking.graph", "tracking.motion_filter",
              "tracking.frontend", "tracking.tracker", "ops.ba_sparse",
              "tracking.dist_cache", "tracking.backend",
              "tracking.trajectory_filler", "eval.ate",
              "kernels.scatter_cluster", "kernels.scatter_rows_blocked",
              "kernels.scatter_rows_bucketed",
              "tools.measure", "tools.prof_corr", "tools.prof_scatter",
              "tools.scatter_ablation", "tools.scatter_bf16_ablation",
              "ops.mc", "mapping.mesher",
              "mapping.cull", "eval.recon", "utils.vis",
              "tools.eval_recon", "tools.prof_determinism",
              "ops.rotations", "utils.params_io", "agents.comms",
              "agents.netvlad", "agents.loop_detector", "agents.fusion",
              "agents.runner", "cli", "data.image_io", "data.datasets",
              "tools.validate_dataset", "tools.eval_ate",
              "tools.import_weights", "parallel.mesh", "parallel.fleet",
              "ops.hashgrid", "ops.encodings"):
        assert f"mneslam_tpu_torch.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'optax' or m == 'mneslam_tpu' or "
        "m.startswith('mneslam_tpu.'))\n"
        "print('BAD', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout


# an import of jax / optax / the JAX package, or a dotted reference to it
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|optax)\b"
                       r"|^\s*(import|from)\s+mneslam_tpu\b(?!_torch)"
                       r"|\bmneslam_tpu\.")


def test_sources_name_no_jax():
    hits = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(root, f)
                with open(path) as fh:
                    hits += [f"{path}:{i}: {line.strip()}"
                             for i, line in enumerate(fh, 1)
                             if FORBIDDEN.search(line)]
    assert not hits, hits
    helper = os.path.join(REPO, "tests", "_torch_dist.py")
    with open(helper) as fh:
        hits += [f"{helper}:{i}: {line.strip()}" for i, line in
                 enumerate(fh, 1) if FORBIDDEN.search(line)]
    assert not hits, hits
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from mneslam_tpu.ops import interp")
    assert not FORBIDDEN.search("from mneslam_tpu_torch.ops import interp")


def test_distributed_test_ranks_load_no_jax():
    """The ranks of the distributed CPU tests (`tests/_torch_dist.py`) run
    the port alone: importing their module and every case's imports loads
    no JAX."""
    code = (
        "import sys\n"
        "import tests._torch_dist as d\n"
        "import mneslam_tpu_torch.parallel.fleet, mneslam_tpu_torch.cli\n"
        "import mneslam_tpu_torch.tools.validate_dataset\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('mneslam_tpu.'))\n"
        "print('BAD', bad, sorted(d.CASES))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
