"""Port parity: the port's `tools/import_weights.py` and `tools/eval_ate.py`
(`mneslam_tpu_torch/tools/`) against the repository's tools, on the fake
checkpoints of tests/test_import_tool.py and two trajectory files.

Weights: the `.npz` the port's tool writes loads in the JAX package, and
the JAX package's loads in the port, every array bit for bit. Trajectory
metrics: the printed lines equal the JAX tool's, character for character.
"""

import contextlib
import importlib.util
import io
import os
import sys

import jax
import numpy as np
import pytest
import torch

from mneslam_tpu.agents import netvlad as jnv
from mneslam_tpu.models import droid_net as jdroid
from mneslam_tpu.utils import params_io as jpio
from mneslam_tpu_torch.models.scene_rep import param_items
from mneslam_tpu_torch.tools import eval_ate, import_weights
from mneslam_tpu_torch.utils import params_io

torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(__file__), "..")


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            main(argv)
        except SystemExit as e:
            code = int(e.code or 0)
    return code, out.getvalue(), err.getvalue()


def _assert_trees_equal(port_tree, jax_tree):
    """A port tree (tensors) and a JAX tree: the same paths and arrays."""
    jflat = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    pflat = dict(param_items(port_tree))
    assert len(jflat) == len(pflat)
    for path, v in jflat:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        np.testing.assert_array_equal(pflat[key].numpy(), np.asarray(v),
                                      err_msg=str(key))


def test_import_droid_npz_reads_in_both_packages(tmp_path):
    from test_droid_import import make_fake_checkpoint

    pth = str(tmp_path / "droid.pth")
    sd = make_fake_checkpoint(pth)
    out = str(tmp_path / "droid.npz")
    code, stdout, stderr = _run(import_weights.main,
                                [pth, "--out", out, "--device", "cpu"])
    assert code == 0, stdout + stderr
    assert "smoke OK" in stdout and "validated" in stdout
    ref = jdroid.load_droid_weights(pth)
    # the port's file in the JAX package, the JAX package's in the port
    _assert_trees_equal(params_io.load_pytree_npz(out),
                        jpio.load_pytree_npz(out))
    _assert_trees_equal(params_io.load_pytree_npz(out), ref)
    jout = str(tmp_path / "droid_jax.npz")
    jpio.save_pytree_npz(jout, ref)
    _assert_trees_equal(params_io.load_pytree_npz(jout), ref)
    with np.load(out) as a, np.load(jout) as b:
        assert sorted(a.files) == sorted(b.files)
    np.testing.assert_array_equal(
        params_io.load_pytree_npz(out)["fnet"]["conv1"]["weight"].numpy(),
        sd["module.fnet.conv1.weight"].numpy())


def test_import_droid_rejects_a_bad_checkpoint(tmp_path):
    import json

    with open(import_weights.MANIFEST) as f:
        manifest = json.load(f)
    with open(os.path.join(REPO, "tests", "fixtures",
                           "droid_state_dict_manifest.json")) as f:
        assert json.load(f) == manifest
    rng = np.random.default_rng(0)
    sd = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for k, s in manifest.items()}
    sd.pop("module.fnet.conv1.bias")
    sd["module.something.else"] = torch.zeros(3)
    sd["module.cnet.conv1.weight"] = torch.zeros(1, 2, 3)
    pth = str(tmp_path / "bad.pth")
    torch.save(sd, pth)
    code, _, stderr = _run(import_weights.main, [
        pth, "--out", str(tmp_path / "bad.npz"), "--device", "cpu"])
    assert code == 1
    for what in ("missing keys", "unexpected keys", "shape mismatches"):
        assert what in stderr
    assert not os.path.exists(tmp_path / "bad.npz")


def test_import_netvlad_npz_reads_in_both_packages(tmp_path):
    pytest.importorskip("scipy")
    from netvlad_fixture import make_fake_netvlad_mat

    mat = str(tmp_path / "vlad.mat")
    _, score, _ = make_fake_netvlad_mat(mat)
    out = str(tmp_path / "vlad.npz")
    code, stdout, stderr = _run(import_weights.main,
                                [mat, "--out", out, "--device", "cpu"])
    assert code == 0, stdout + stderr
    assert "smoke OK: one descriptor, 4096-d, unit norm" in stdout
    os.remove(mat)
    ported = params_io.load_pytree_npz(out)
    np.testing.assert_array_equal(ported["score_w"].numpy(), score.T)
    _assert_trees_equal(ported, jpio.load_pytree_npz(out))
    del ported
    # the JAX descriptor factory takes the port's file
    fn = jnv.make_descriptor_fn({"model_name": "X", "checkpoints": {"X": out}})
    desc = np.asarray(fn(np.full((48, 64, 3), 0.5, np.float32)))
    assert desc.shape == (4096,) and np.isfinite(desc).all()


def _jax_eval_ate():
    spec = importlib.util.spec_from_file_location(
        "jax_eval_ate", os.path.join(REPO, "tools", "eval_ate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def main(argv):
        old = sys.argv
        sys.argv = ["eval_ate.py"] + argv
        try:
            mod.main()
        finally:
            sys.argv = old

    return main


@pytest.mark.parametrize("sim3", [False, True])
def test_eval_ate_prints_the_jax_tools_lines(tmp_path, sim3):
    rng = np.random.default_rng(0)
    n = 40
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, :3, 3] = np.cumsum(rng.normal(0, 0.05, (n, 3)), axis=0)
    est = gt.copy()
    # a rotated, scaled and shifted copy with noise (+ 3 extra poses)
    a = 0.3
    R = np.asarray([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                    [0, 0, 1]])
    est[:, :3, 3] = 0.8 * gt[:, :3, 3] @ R.T + [0.1, -0.2, 0.3] \
        + rng.normal(0, 0.01, (n, 3))
    est = np.concatenate([est, est[:3]])
    np.save(tmp_path / "gt.npy", gt)
    np.save(tmp_path / "est.npy", est)
    argv = ["--est", str(tmp_path / "est.npy"), "--gt",
            str(tmp_path / "gt.npy")] + (["--sim3"] if sim3 else [])
    code, out, _ = _run(eval_ate.main, argv)
    jcode, jout, _ = _run(_jax_eval_ate(), argv)
    assert code == jcode == 0
    assert out == jout and out.startswith("rmse: ")
    m = eval_ate.main(argv)
    assert m["n"] == n
    # the noise is 0.01 per axis, scaled by 1 / 0.8: only Sim(3) undoes
    # the scale and comes near it
    assert (m["rmse"] < 0.03) == sim3
