"""The slice as a whole on the CPU: a shipped config run on a dataset folder
through the port's user entry points, at a tiny size.

A TUM folder written from the box room (`write_tum_sequence`: 8-bit colour
and 16-bit depth PNGs, depth 10-20 ms after colour, ground truth at 100 Hz,
one colour frame without depth) under a yaml that inherits
configs/TUM/fr1_desk.yaml with tiny widths:
- both onboarding tools give the same rows and exit 0;
- the port's loader gives the box room's frames back to the PNGs'
  quantisation (colour 1/510, depth 1/10000 m) and its poses within 1e-6,
  and the JAX loader's frames bit for bit;
- `cli.main --mode slam --device cpu` with the oracle update
  (`validate_dataset.OracleMNESLAM`): APE (Sim(3)) under 5 cm and both
  meshes;
- `cli.main --mode mapping --device cpu` with room0_fast.yaml's bf16 render:
  fp32 parameters, and each keyframe's PSNR within 0.5 dB of the same run
  in fp32.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch
import yaml

pytest.importorskip("cv2")

import test_validate_dataset as jtv  # noqa: E402
from mneslam_tpu.config import load_config as jload_config  # noqa: E402
from mneslam_tpu.config import default_config as jdefault_config  # noqa
from mneslam_tpu.config import deep_update as jdeep_update  # noqa: E402
from mneslam_tpu.data import datasets as jdatasets  # noqa: E402
import mneslam_tpu_torch.slam as slam_mod  # noqa: E402
from mneslam_tpu_torch import cli  # noqa: E402
from mneslam_tpu_torch.config import (default_config, deep_update,  # noqa
                                      load_config)
from mneslam_tpu_torch.data import datasets  # noqa: E402
from mneslam_tpu_torch.data.synthetic import (SyntheticBoxDataset,  # noqa
                                              write_tum_sequence)
from mneslam_tpu_torch.models.scene_rep import param_leaves  # noqa: E402
from mneslam_tpu_torch.tools import validate_dataset as tvd  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 14
TINY = {
    "cam": {"H": 64, "W": 96, "fx": 77.6, "fy": 77.5, "cx": 47.8,
            "cy": 38.3, "H_out": 64, "W_out": 96},
    "planes_res": {"coarse": 0.44, "fine": 0.22, "bound_dividable": 0.22},
    "model": {"c_dim": 16, "input_ch": 32, "input_ch_pos": 48},
    "training": {"n_range_d": 9, "n_samples_d": 8},
    "mapping": {"sample": 256, "min_pixels_cur": 48, "first_iters": 40,
                "iters": 6, "keyframe_every": 4,
                "marching_cubes_bound": [[-1.0, 1.0]] * 3},
    "meshing": {"resolution": 0.1},
    "tracking": {"buffer": 24, "warmup": 5,
                 "motion_filter": {"thresh": -1.0, "batch": 4},
                 "frontend": {"keyframe_thresh": -1.0, "window": 25,
                              "max_factors": 30}},
    "loop_detection": {"enabled": False},
}


@pytest.fixture
def tum(tmp_path, monkeypatch):
    """The folder and the yaml (fr1_desk.yaml's inherit chain resolves from
    the repository's root)."""
    monkeypatch.chdir(REPO)
    cfg = deep_update(default_config(), load_config(
        os.path.join(REPO, "configs", "TUM", "fr1_desk.yaml")))
    deep_update(cfg, TINY)
    box = SyntheticBoxDataset(cfg, num_frames=N_FRAMES, half=0.95)
    folder = str(tmp_path / "rgbd_dataset_freiburg1_desk")
    info = write_tum_sequence(box, folder)
    path = str(tmp_path / "fr1_desk_files.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"inherit_from": os.path.join(
            REPO, "configs", "TUM", "fr1_desk.yaml"), **TINY,
            "data": {"datadir": folder, "output": str(tmp_path / "out"),
                     "exp_name": "fr1_desk"}}, f)
    return box, folder, path, info


def _rows(main, argv):
    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        try:
            main(argv)
        except SystemExit as e:
            code = int(e.code or 0)
    return code, [ln for ln in out.getvalue().splitlines()
                  if ln.startswith(("[PASS]", "[WARN]", "[FAIL]"))]


def test_tum_folder_loads_and_onboards(tum):
    box, folder, path, info = tum
    assert info == {"frames": N_FRAMES, "rgb_lines": N_FRAMES + 1,
                    "gt_lines": 5 * (N_FRAMES - 1) + 1}
    argv = [folder, "--kind", "tum", "--config", path, "--no-smoke"]

    def jmain(a):
        import sys

        old, sys.argv = sys.argv, ["validate_dataset.py"] + a
        try:
            jtv.vd.main()
        finally:
            sys.argv = old

    (code, rows), (jcode, jrows) = _rows(tvd.main, argv), _rows(jmain, argv)
    assert code == jcode == 0 and rows == jrows
    assert not [r for r in rows if not r.startswith("[PASS]")], rows

    cfg = deep_update(default_config(), load_config(path))
    jcfg = jdeep_update(jdefault_config(), jload_config(path))
    ds, jds = datasets.get_dataset(cfg), jdatasets.get_dataset(jcfg)
    assert isinstance(ds, datasets.TUMDataset) and len(ds) == N_FRAMES
    for i in (0, N_FRAMES // 2, N_FRAMES - 1):
        a, b, ref = ds[i], jds[i], box[i]
        for key in ("rgb", "depth"):
            np.testing.assert_array_equal(a[key], b[key])
        np.testing.assert_allclose(a["c2w"], b["c2w"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(a["c2w"], ref["c2w"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(a["rgb"], ref["rgb"], atol=0.5 / 255 + 1e-6,
                                   rtol=0)
        np.testing.assert_allclose(a["depth"], ref["depth"],
                                   atol=0.5 / 5000 + 1e-6, rtol=0)


def test_cli_slam_on_the_tum_folder(tum, monkeypatch):
    _, folder, path, _ = tum
    monkeypatch.setattr(slam_mod, "MNESLAM", tvd.OracleMNESLAM)
    res = cli.main(["--config", path, "--mode", "slam", "--device", "cpu"])
    assert res["tracked_keyframes"] == N_FRAMES
    assert res["ate"]["rmse"] < 0.05
    assert res["mesh_verts"] > 0 and res["mesh_verts_culled"] > 0
    out = os.path.join(os.path.dirname(path), "out", "fr1_desk", "agent_0")
    for name in ("mesh/final_mesh.ply", "mesh/final_mesh_culled.ply",
                 "est_poses.npy", "metrics_traj.txt"):
        assert os.path.exists(os.path.join(out, name)), name


def _cli_mapping(path, render_dtype, monkeypatch):
    """`cli.main --mode mapping --device cpu` on the yaml with
    room0_fast.yaml's training keys, the render in `render_dtype`."""
    with open(os.path.join(REPO, "configs", "Replica",
                           "room0_fast.yaml")) as f:
        fast = yaml.safe_load(f)
    assert fast["training"]["render_dtype"] == "bfloat16"
    with open(path) as f:
        over = yaml.safe_load(f)
    over["training"].update(fast["training"], render_dtype=render_dtype)
    over["data"]["exp_name"] = render_dtype
    with open(path, "w") as f:
        yaml.safe_dump(over, f)
    agents = []

    class Kept(slam_mod.MNESLAM):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            agents.append(self)

    with monkeypatch.context() as m:
        m.setattr(slam_mod, "MNESLAM", Kept)
        cli.main(["--config", path, "--mode", "mapping", "--device", "cpu"])
    return agents[0]


def test_cli_bf16_mapping_on_the_tum_folder(tum, monkeypatch):
    """room0_fast.yaml's keys (bf16 render, 8 depth samples) on the TUM
    folder through `cli.main --mode mapping`: fp32 parameters, finite
    metrics, and each keyframe's PSNR within 0.5 dB of the same run
    rendered in fp32 from the same generator draws (measured: 0.05 dB)."""
    _, folder, path, _ = tum
    slam = _cli_mapping(path, "bfloat16", monkeypatch)
    ref = _cli_mapping(path, "float32", monkeypatch)
    assert slam.scene.compute_dtype == torch.bfloat16
    assert ref.scene.compute_dtype == torch.float32
    psnr = [m["psnr"] for m in slam.metrics_log]
    ref_psnr = [m["psnr"] for m in ref.metrics_log]
    assert len(psnr) == len(ref_psnr) >= 3 and np.isfinite(psnr).all()
    np.testing.assert_allclose(psnr, ref_psnr, atol=0.5, rtol=0)
    assert all(p.dtype == torch.float32 and bool(torch.isfinite(p).all())
               for p in param_leaves(slam.map_state.params))
    with open(os.path.join(slam.out_dir, "metrics.jsonl")) as f:
        assert len([json.loads(ln) for ln in f]) == len(psnr)
