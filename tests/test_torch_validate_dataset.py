"""Port parity: the port's onboarding tool (`mneslam_tpu_torch/tools/
validate_dataset.py`) against the repository's `tools/validate_dataset.py`
on the folders of tests/test_validate_dataset.py: the same PASS / WARN /
FAIL rows, word for word, and the same exit code. Then the port's full
smoke (the oracle SLAM run) once, on the CPU at 64 x 96.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest

pytest.importorskip("cv2")

import test_validate_dataset as jtv  # noqa: E402
from mneslam_tpu_torch.tools import validate_dataset as tvd  # noqa: E402

ROW = re.compile(r"^\[(PASS|WARN|FAIL)\] .*$", re.M)


def _run(main, argv):
    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        try:
            main(argv)
        except SystemExit as e:
            code = int(e.code or 0)
    return code, [m.group(0) for m in ROW.finditer(out.getvalue())]


def _jax_main(argv):
    import sys

    old = sys.argv
    sys.argv = ["validate_dataset.py"] + argv
    try:
        jtv.vd.main()
    finally:
        sys.argv = old


def _assert_agree(argv, want_code):
    (jcode, jrows), (code, rows) = _run(_jax_main, argv), _run(tvd.main,
                                                               argv)
    assert rows == jrows
    assert code == jcode == want_code, (code, jcode, rows)
    return rows


def _replica(tmp_path, **kw):
    return jtv.make_replica(tmp_path, **kw)


@pytest.mark.parametrize("case,want", [
    ("ok", 0), ("missing_depth", 1), ("bad_pose", 1), ("depth_scale", 1),
    ("resolution", 1), ("no_config", 0)])
def test_replica_cases_agree(tmp_path, case, want):
    d = _replica(tmp_path, bad_pose=case == "bad_pose")
    if case == "missing_depth":
        os.remove(d / "results" / "depth000003.png")
    cfg = jtv.cam_cfg_yaml(
        tmp_path, scale=1.0 if case == "depth_scale" else 1000.0,
        **({"H": 96, "W": 128} if case == "resolution" else {}))
    argv = [str(d), "--kind", "replica", "--no-smoke"]
    if case != "no_config":
        argv += ["--config", cfg]
    rows = _assert_agree(argv, want)
    if case == "no_config":
        assert any(r.startswith("[WARN] intrinsics") for r in rows)


def test_scannet_inf_pose_warns_in_both(tmp_path):
    d = tmp_path / "scannet"
    for sub in ("color", "depth", "pose"):
        (d / sub).mkdir(parents=True)
    for i in range(5):
        jtv.write_frame(d / "color" / f"{i}.jpg", d / "depth" / f"{i}.png",
                        seed=i)
        c2w = np.eye(4)
        c2w[0, 3] = 0.02 * i
        if i == 3:
            c2w[:3, 3] = np.inf
        np.savetxt(str(d / "pose" / f"{i}.txt"), c2w)
    rows = _assert_agree([str(d), "--kind", "scannet", "--config",
                          jtv.cam_cfg_yaml(tmp_path), "--no-smoke"], 0)
    assert any(r.startswith("[WARN] non-finite poses") for r in rows)


def test_indoor_layout_agrees(tmp_path):
    d = tmp_path / "indoor"
    (d / "color").mkdir(parents=True)
    (d / "depth_holefilling").mkdir()
    for i in range(4):
        jtv.write_frame(d / "color" / f"{i:04d}.jpg",
                        d / "depth_holefilling" / f"{i:04d}.png", seed=i)
    (d / "traj.txt").write_text(
        "\n".join(jtv.pose_line(0.02 * i) for i in range(4)) + "\n")
    _assert_agree([str(d), "--kind", "indoor", "--config",
                   jtv.cam_cfg_yaml(tmp_path), "--no-smoke"], 0)


def test_tum_association_agrees(tmp_path):
    d = tmp_path / "tum"
    (d / "rgb").mkdir(parents=True)
    (d / "depth").mkdir()
    rgb_lines, depth_lines, gt_lines = [], [], []
    for i in range(5):
        t = 100.0 + 0.1 * i
        jtv.write_frame(d / "rgb" / f"{t:.3f}.png",
                        d / "depth" / f"{t:.3f}.png", seed=i)
        rgb_lines.append(f"{t:.4f} rgb/{t:.3f}.png")
        depth_lines.append(f"{t + 0.01:.4f} depth/{t:.3f}.png")
        gt_lines.append(f"{t - 0.005:.4f} {0.02 * i} 0 0 0 0 0 1")
    for name, lines in [("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("groundtruth.txt", gt_lines)]:
        (d / name).write_text("# header\n" + "\n".join(lines) + "\n")
    cfg = jtv.cam_cfg_yaml(tmp_path, scale=5000.0)
    argv = [str(d), "--kind", "tum", "--config", cfg, "--no-smoke"]
    _assert_agree(argv, 0)
    (d / "groundtruth.txt").write_text(
        "# header\n" + "\n".join(
            f"{900.0 + 0.1 * i:.4f} {0.02 * i} 0 0 0 0 0 1"
            for i in range(5)) + "\n")
    rows = _assert_agree(argv, 1)
    assert any(r.startswith("[FAIL] tum association coverage") for r in rows)


def test_port_full_smoke_on_the_cpu(tmp_path):
    """The whole command with its smoke: 5 frames at 64 x 96 through the
    port's `MNESLAM.run_slam` on the CPU with the oracle update."""
    d = _replica(tmp_path, n=6)
    code, rows = _run(tvd.main, [
        str(d), "--kind", "replica", "--config", jtv.cam_cfg_yaml(tmp_path),
        "--smoke-frames", "5", "--out", str(tmp_path / "smoke_out"),
        "--device", "cpu"])
    assert code == 0, rows
    smoke = [r for r in rows if "smoke" in r]
    assert smoke and all(r.startswith("[PASS]") for r in smoke), smoke
    assert any("trajectory vs dataset GT" in r for r in smoke)
