"""The port's `mneslam_tpu_torch/tools/eval_synthetic` against the
repository's `tools/eval_synthetic.py`, on the CPU at a tiny size. The JAX
script runs at import, so its JAX side is the same sequence of
`mneslam_tpu` calls as `tools/eval_synthetic.py:45-90` on a tiny config;
its overrides and report keys are read from the script itself
(`make_config` stopped at its call, the source's JSON keys). The SLAM
tools are in tests/test_torch_eval_slam_tools.py."""

import contextlib
import importlib.util
import io
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mneslam_tpu import config as jconfig
from mneslam_tpu_torch import config as pconfig
from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
from mneslam_tpu_torch.tools import eval_synthetic as psynth

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")


def load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_main(mod, argv, monkeypatch) -> str:
    """A JAX tool's `main()` with `sys.argv` patched -> what it printed."""
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["tool"] + argv)
    with contextlib.redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


TINY_SYNTH = {
    "mapping": {"bound": [[-2.2, 2.2]] * 3,
                "marching_cubes_bound": [[-2.05, 2.05]] * 3,
                "sample": 256, "min_pixels_cur": 32, "first_iters": 60,
                "iters": 10},
    "planes_res": {"coarse": 0.44, "fine": 0.22, "bound_dividable": 0.22},
    "cam": {"H": 40, "W": 56, "fx": 35.0, "fy": 35.0, "cx": 27.5,
            "cy": 19.5, "near": 0.0, "far": 8.0, "depth_trunc": 100.0},
    "training": {"n_range_d": 9, "n_samples_d": 8, "range_d": 0.25,
                 "trunc": 0.15},
    "model": {"c_dim": 16, "input_ch": 32, "input_ch_pos": 48,
              "truncation": 0.15},
    "meshing": {"resolution": 0.2},
}
SYNTH_FRAMES, SYNTH_KF, SYNTH_HELD_OUT, SYNTH_ITERS = 12, (2, 4, 6, 8, 10), \
    (3, 7), 10
# Spreads of this tiny run over seeds 0-5, measured on the CPU (port / JAX):
# held-out PSNR std 0.63 / 1.1 dB, depth L1 std 0.22 / 0.20 cm, vertices
# std 190 / 200 of about 7000, wall accuracy std 0.11 / 0.07 cm (means
# 1.89 / 1.76 cm). The random streams differ, so one run of each may differ
# by the spread of a difference of two draws: about 3 standard deviations
# of it (and the accuracy's 0.13 cm gap of means).
SYNTH_PSNR_TOL_DB = 4.0
SYNTH_L1_TOL_CM = 1.0
SYNTH_VERTS_RTOL = 0.12
SYNTH_ACC_TOL_CM = 0.5


def jax_eval_synthetic(seed=0):
    """tools/eval_synthetic.py:45-90 on the tiny config, in the JAX
    package."""
    from mneslam_tpu.data.rays import rays_from_pose
    from mneslam_tpu.data.synthetic import SyntheticBoxDataset as JDS
    from mneslam_tpu.mapping.mapper import Mapper
    from mneslam_tpu.mapping.mesher import extract_mesh
    from mneslam_tpu.models.scene_rep import SceneRep

    cfg = jconfig.make_config(TINY_SYNTH)
    ds = JDS(cfg, num_frames=SYNTH_FRAMES, half=2.0)
    scene = SceneRep(cfg)
    mapper = Mapper(cfg, scene, num_kf=len(SYNTH_KF) + 1,
                    rays_per_kf=ds.num_rays_to_save)
    state = mapper.init_state(jax.random.PRNGKey(seed))
    f0 = {k: jnp.asarray(v) for k, v in ds[0].items()}
    state, _ = mapper.first_frame_mapping(state, f0, jnp.asarray(ds[0]["c2w"]),
                                          jax.random.PRNGKey(seed + 1))
    n_kf = 0
    for fid in SYNTH_KF:
        it = ds[fid]
        fr = {k: jnp.asarray(v) for k, v in it.items()}
        k = jax.random.fold_in(jax.random.PRNGKey(seed + 2), fid)
        state = mapper.add_keyframe(state, jnp.asarray(fid), fr,
                                    jnp.asarray(it["c2w"]), k)
        state, _ = mapper.optimize(state, fr, jnp.asarray(it["c2w"]),
                                   jax.random.fold_in(k, 1),
                                   iters=SYNTH_ITERS)
        n_kf += 1
    psnrs, l1s = [], []
    for fid in SYNTH_HELD_OUT:
        it = ds[fid]
        ro, rd = rays_from_pose(jnp.asarray(it["direction"]).reshape(-1, 3),
                                jnp.asarray(it["c2w"]))
        depth, rgb = scene.render_image_rays(
            state.params, ro, rd, jnp.asarray(it["depth"]).reshape(-1),
            chunk=8192)
        mse = float(np.mean(np.square(np.asarray(rgb)
                                      - it["rgb"].reshape(-1, 3))))
        psnrs.append(-10 * np.log10(mse))
        l1s.append(float(np.mean(np.abs(np.asarray(depth)
                                        - it["depth"].reshape(-1)))) * 100)
    verts, _, _ = extract_mesh(scene, state.params, cfg, save_path=None)
    acc = float(np.mean(np.abs(2.0 - np.max(np.abs(verts), axis=1)))) * 100
    return {"keyframes": n_kf + 1,
            "novel_view_psnr_db": float(np.mean(psnrs)),
            "novel_view_depth_l1_cm": float(np.mean(l1s)),
            "mesh_verts": len(verts), "mesh_wall_accuracy_cm": acc}


def test_eval_synthetic_run_matches_jax():
    cfg = pconfig.make_config(TINY_SYNTH)
    ds = SyntheticBoxDataset(cfg, num_frames=SYNTH_FRAMES, half=2.0)
    got = psynth.run(cfg, ds, SYNTH_KF, SYNTH_HELD_OUT, SYNTH_ITERS, "cpu")
    ref = jax_eval_synthetic()
    assert all(np.isfinite(v) for v in got.values()
               if isinstance(v, float)), got
    assert got["keyframes"] == ref["keyframes"] == len(SYNTH_KF) + 1
    assert abs(got["novel_view_psnr_db"] - ref["novel_view_psnr_db"]) \
        <= SYNTH_PSNR_TOL_DB, (got, ref)
    assert abs(got["novel_view_depth_l1_cm"]
               - ref["novel_view_depth_l1_cm"]) <= SYNTH_L1_TOL_CM, (got, ref)
    assert abs(got["mesh_verts"] - ref["mesh_verts"]) \
        <= SYNTH_VERTS_RTOL * ref["mesh_verts"], (got, ref)
    assert abs(got["mesh_wall_accuracy_cm"] - ref["mesh_wall_accuracy_cm"]) \
        <= SYNTH_ACC_TOL_CM, (got, ref)
    # the report's keys are the JAX script's (its closing json.dumps)
    with open(os.path.join(TOOLS, "eval_synthetic.py")) as f:
        src = f.read()
    block = src[src.rindex("print(json.dumps({"):]
    assert set(got) == set(re.findall(r'"(\w+)":', block))


class _StopTool(Exception):
    pass


@pytest.mark.parametrize("flags", [[], ["--fast"], ["--bf16"],
                                   ["--fast", "--bf16"]])
def test_eval_synthetic_config_is_the_scripts(flags, monkeypatch):
    """The port's `config` is the JAX script's overrides, flag for flag
    (the script stopped at its make_config call), and `main` maps the
    script's keyframe ids and held-out views."""
    seen = {}

    def capture(ov):
        seen["jax"] = ov
        raise _StopTool

    monkeypatch.setattr(jconfig, "make_config", capture)
    monkeypatch.setattr(sys, "argv", ["eval_synthetic.py"] + flags)
    with pytest.raises(_StopTool):
        load_jax_tool("eval_synthetic")
    monkeypatch.setattr(psynth, "make_config", lambda ov: ov)
    assert psynth.config("--fast" in flags, "--bf16" in flags) == seen["jax"]
    assert psynth.KEYFRAME_IDS == tuple(range(2, 120, 2))
    assert psynth.HELD_OUT == (31, 61, 91)
    assert psynth.iters_for("--fast" in flags) == \
        seen["jax"]["mapping"]["iters"]
