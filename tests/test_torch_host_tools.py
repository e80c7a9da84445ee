"""The port's tools `flow_loop_detect`, `create_virtual_cameras`,
`trace_ops`, `vis_cameras` and `visualizer` (`mneslam_tpu_torch/tools/`)
against the repository's `tools/` counterparts, on the CPU at small sizes:
both tools on the same files, their outputs compared."""

import csv
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mneslam_tpu_torch.config import make_config
from mneslam_tpu_torch.data.image_io import write_png
from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset
from mneslam_tpu_torch.ops import mc
from mneslam_tpu_torch.tools import create_virtual_cameras as pcams
from mneslam_tpu_torch.tools import eval_multiagent_synthetic as pma
from mneslam_tpu_torch.tools import eval_slam_synthetic as pslam_tool
from mneslam_tpu_torch.tools import eval_synthetic as psynth
from mneslam_tpu_torch.tools import flow_loop_detect as pflow
from mneslam_tpu_torch.tools import trace_ops as ptrace
from mneslam_tpu_torch.tools import vis_cameras as pvis
from mneslam_tpu_torch.tools import visualizer as pviz
from test_droid_import import make_fake_checkpoint
from test_torch_eval_tools import load_jax_tool, run_jax_main

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# flows of the same fake droid.pth on the same images, fp32 on the CPU in
# both packages: measured within 3.1e-7 relative (convolution sums in
# another order)
FLOW_RTOL = 1e-5
# the virtual cameras: one float32 exp and product per camera in each
# package
CAMS_ATOL = 1e-6


# ---------------------------------------------------------------------------
# flow_loop_detect
# ---------------------------------------------------------------------------

def write_frames(path, H, W, ids):
    """Box-room frames at H x W as 8-bit PNGs -> their paths."""
    cfg = make_config({"cam": {"H": H, "W": W, "fx": W / 2, "fy": W / 2,
                               "cx": W / 2 - 0.5, "cy": H / 2 - 0.5}})
    ds = SyntheticBoxDataset(cfg, num_frames=8)
    paths = []
    for i in ids:
        p = os.path.join(path, f"frame{i}.png")
        write_png(p, np.round(ds[i]["rgb"][..., ::-1] * 255.0)
                  .astype(np.uint8))
        paths.append(p)
    return paths


def test_flow_loop_detect_matches_jax(tmp_path, monkeypatch):
    """The same PNGs (72 x 100, resized to 64 x 96 by cv2 on the 8-bit
    image in both tools) and the same fake droid.pth: the same pairs, the
    flows within FLOW_RTOL, the same minimum-flow pair."""
    pytest.importorskip("cv2")
    paths = write_frames(str(tmp_path), 72, 100, (0, 1, 4, 6))
    (tmp_path / "a.txt").write_text("\n".join(paths[:2]) + "\n")
    (tmp_path / "b.txt").write_text("\n".join(paths[2:]) + "\n\n")
    weights = str(tmp_path / "droid.pth")
    make_fake_checkpoint(weights)
    argv = ["--list_a", str(tmp_path / "a.txt"), "--list_b",
            str(tmp_path / "b.txt"), "--weights", weights, "--H", "64",
            "--W", "96"]
    jout = run_jax_main(load_jax_tool("flow_loop_detect"),
                        argv + ["--out", str(tmp_path / "j.csv")],
                        monkeypatch)
    got = pflow.main(argv + ["--out", str(tmp_path / "p.csv"),
                             "--device", "cpu"])
    with open(tmp_path / "j.csv") as f:
        jrows = list(csv.reader(f))
    with open(tmp_path / "p.csv") as f:
        prows = list(csv.reader(f))
    assert prows[0] == jrows[0] == ["image_a", "image_b", "flow_px"]
    assert len(prows) == 5
    assert [r[:2] for r in prows] == [r[:2] for r in jrows]
    np.testing.assert_allclose([float(r[2]) for r in prows[1:]],
                               [float(r[2]) for r in jrows[1:]],
                               rtol=FLOW_RTOL)
    assert got["best"][:2] == tuple(
        jout.split("min-flow pair: ")[1].split(" (")[0].split(" <-> "))


def test_flow_loop_detect_images_load_as_cv2(tmp_path):
    """A PNG at the tool's size loads without a resize, equal to cv2's
    decode; another size is resized by cv2 on the 8-bit image."""
    cv2 = pytest.importorskip("cv2")
    (p,) = write_frames(str(tmp_path), 64, 96, (3,))
    ref = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
    img = pflow.load_image(p, 64, 96, torch.device("cpu"))
    np.testing.assert_array_equal(img.numpy(),
                                  ref.transpose(2, 0, 1) / np.float32(255))
    small = pflow.load_image(p, 32, 48, torch.device("cpu"))
    np.testing.assert_array_equal(
        small.numpy(),
        cv2.resize(ref, (48, 32)).transpose(2, 0, 1) / np.float32(255))


# ---------------------------------------------------------------------------
# create_virtual_cameras
# ---------------------------------------------------------------------------

def test_create_virtual_cameras_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    poses = np.tile(np.eye(4, dtype=np.float32), (7, 1, 1))
    poses[:, :3, 3] = rng.standard_normal((7, 3))
    poses[:, :3, :3] = np.linalg.qr(rng.standard_normal((7, 3, 3)))[0]
    np.save(tmp_path / "poses.npy", poses)
    argv = ["--poses", str(tmp_path / "poses.npy"), "--n", "9", "--trans",
            "0.2", "--rot", "0.3", "--seed", "4"]
    run_jax_main(load_jax_tool("create_virtual_cameras"),
                 argv + ["--out", str(tmp_path / "j.npy")], monkeypatch)
    got = pcams.main(argv + ["--out", str(tmp_path / "p.npy"),
                             "--device", "cpu"])
    ref = np.load(tmp_path / "j.npy")
    saved = np.load(tmp_path / "p.npy")
    assert saved.dtype == ref.dtype == np.float32
    assert saved.shape == ref.shape == (9, 4, 4)
    np.testing.assert_array_equal(saved, got)
    np.testing.assert_allclose(saved, ref, atol=CAMS_ATOL)


# ---------------------------------------------------------------------------
# trace_ops
# ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


def test_trace_ops_frontend_edges_are_the_tools(monkeypatch):
    """The frontend target's edges are tools/trace_ops.py:81-85's: its
    run_frontend stopped at add_factors (the DROID init and the graph
    replaced by recorders)."""
    import mneslam_tpu.models.droid_net as jdroid
    import mneslam_tpu.tracking.graph as jgraph
    import mneslam_tpu.tracking.video as jvideo

    seen = {}

    class Graph:
        def __init__(self, *args, **kw):
            seen["graph"] = kw

        def add_factors(self, state, ii, jj):
            seen["edges"] = (np.asarray(ii), np.asarray(jj))
            raise _Stop

    class State:
        def _replace(self, **kw):
            return self

    monkeypatch.setattr(jdroid, "init_droid_net",
                        lambda key: {"w": jnp.zeros((1,))})
    monkeypatch.setattr(jvideo, "init_video", lambda *a, **kw: State())
    monkeypatch.setattr(jgraph, "FactorGraph", Graph)
    with pytest.raises(_Stop):
        load_jax_tool("trace_ops").run_frontend()
    ii, jj = ptrace.frontend_edges(26, 75)
    np.testing.assert_array_equal(ii, seen["edges"][0])
    np.testing.assert_array_equal(jj, seen["edges"][1])
    assert (seen["graph"]["window"], seen["graph"]["max_factors"],
            seen["graph"]["capacity"]) == (32, 75, 91)
    defaults = ptrace.run_frontend.__defaults__
    assert defaults == (4, 320, 640, 64, 32, 75, 26)
    assert ptrace.run_mapping.__defaults__ == (10, 320, 640, 4.0, 0.04,
                                               0.02, 2048, 100, 32)


@pytest.mark.parametrize("target", ["mapping", "frontend"])
def test_trace_ops_table_on_the_cpu(target, capsys):
    dev = torch.device("cpu")
    if target == "mapping":
        step, n = ptrace.run_mapping(dev, n_reps=2, H=40, W=56, bound=2.0,
                                     coarse=0.44, fine=0.22, sample=64,
                                     min_pixels_cur=16, n_samples_d=8)
    else:
        step, n = ptrace.run_frontend(dev, n_reps=1, H=64, W=64, buffer=8,
                                      window=8, factors=10, n_kf=6)
    rep = ptrace.profile_table(step, n, dev, top_k=12)
    out = capsys.readouterr().out
    assert "host total self time" in out
    assert 0 < len(rep["rows"]) <= 12 and rep["total_ms_per_rep"] > 0
    assert all(ms >= 0 and 0 <= pct <= 100 for _, ms, pct in rep["rows"])
    assert rep["rows"][0][1] >= rep["rows"][-1][1]


# ---------------------------------------------------------------------------
# vis_cameras and visualizer (matplotlib)
# ---------------------------------------------------------------------------

class _Ax:
    """Records ax.plot calls."""

    def __init__(self):
        self.calls = []

    def plot(self, *args, **kw):
        self.calls.append(([np.asarray(a, float) for a in args], kw))


def test_vis_cameras_segments_match_jax(tmp_path):
    jtool = load_jax_tool("vis_cameras")
    rng = np.random.default_rng(1)
    poses = np.tile(np.eye(4), (9, 1, 1))
    poses[:, :3, 3] = rng.standard_normal((9, 3))
    poses[:, :3, :3] = np.linalg.qr(rng.standard_normal((9, 3, 3)))[0]
    bound = [[-1, 3], [-1, 1], [-2, 1]]
    axes = []
    for tool in (jtool, pvis):
        ax = _Ax()
        tool.add_frusta(ax, poses, 0.1, "tab:blue", 2, "estimated")
        tool.add_cuboid(ax, bound)
        axes.append(ax)
    (ja, pa) = axes
    assert len(pa.calls) == len(ja.calls) == 5 * 8 + 1 + 12
    for (pargs, pkw), (jargs, jkw) in zip(pa.calls, ja.calls):
        assert pkw == jkw
        for p, j in zip(pargs, jargs):
            np.testing.assert_array_equal(p, j)


def test_vis_cameras_writes_a_png(tmp_path):
    pytest.importorskip("matplotlib")
    poses = np.tile(np.eye(4), (9, 1, 1))
    poses[:, 0, 3] = np.linspace(0.0, 2.0, 9)
    np.save(tmp_path / "poses.npy", poses)
    out = tmp_path / "cams.png"
    got = pvis.main(["--poses", str(tmp_path / "poses.npy"), "--gt",
                     str(tmp_path / "poses.npy"), "--bound",
                     "[[-1,3],[-1,1],[-1,1]]", "--every", "2", "--out",
                     str(out)])
    assert got == str(out)
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert out.stat().st_size > 10_000


def _run_folder(path):
    """A run folder of small files: est_poses.npy, metrics.jsonl, two
    PLYs (with and without colours) and a file that is not a mesh."""
    os.makedirs(os.path.join(path, "mesh"))
    poses = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    poses[:, 0, 3] = np.linspace(0.0, 1.0, 6)
    np.save(os.path.join(path, "est_poses.npy"), poses)
    with open(os.path.join(path, "metrics.jsonl"), "w") as f:
        for step in range(4):
            f.write(f'{{"step": {step * 5}, "loss": {0.5 / (step + 1)}, '
                    f'"psnr": {18 + step}}}\n')
        f.write('{"stage": "mesh", "seconds": 1.5}\n')
    verts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
                       np.float32)
    faces = np.asarray([[0, 1, 2], [0, 1, 3], [0, 2, 3]], np.int32)
    mc.save_ply(os.path.join(path, "mesh", "b_mesh.ply"), verts, faces,
                np.full((4, 3), 0.5, np.float32))
    mc.save_ply(os.path.join(path, "mesh", "a_mesh.ply"), verts, faces)
    with open(os.path.join(path, "mesh", "notes.txt"), "w") as f:
        f.write("not a mesh\n")
    return poses


def test_visualizer_matches_jax(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    lines = {}
    for tag in ("jax", "port"):
        run = str(tmp_path / tag)
        poses = _run_folder(run)
        gt = str(tmp_path / f"{tag}_gt.npy")
        np.save(gt, poses + 0.01)
        argv = ["--run", run, "--gt", gt]
        if tag == "jax":
            out = run_jax_main(load_jax_tool("visualizer"), argv, monkeypatch)
            lines[tag] = out.strip().splitlines()
        else:
            lines[tag] = pviz.main(argv)
        lines[tag] = [ln.replace(run, "RUN") for ln in lines[tag]]
        for name in ("trajectory.png", "curves.png"):
            assert os.path.getsize(os.path.join(run, "vis", name)) > 1000
    assert lines["port"] == lines["jax"]
    assert len(lines["port"]) == 4


# ---------------------------------------------------------------------------
# every device tool: the GPU by default, raising without one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tool,argv", [
    (psynth, []), (pslam_tool, []), (pma, []),
    (pflow, ["--list_a", "a.txt", "--list_b", "b.txt"]),
    (pcams, ["--poses", "p.npy", "--out", "o.npy"]),
    (ptrace, ["mapping"])])
def test_device_tools_default_to_cuda(tool, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tool.main(argv)


def test_tools_keep_the_jax_tools_flags():
    """Every tool takes its JAX counterpart's flags; the device tools add
    `--device`. The two SLAM tools share `--out` and `--device` through
    eval_slam_synthetic's `parser`."""
    def flags(*paths):
        src = ""
        for path in paths:
            with open(path) as f:
                src += f.read()
        return set(re.findall(r'add_argument\(\s*"(--[\w-]+)"', src))

    host_only = ("vis_cameras", "visualizer")
    for name, ports in [
            ("eval_synthetic", (psynth,)),
            ("eval_slam_synthetic", (pslam_tool,)),
            ("eval_multiagent_synthetic", (pma,)),
            ("flow_loop_detect", (pflow,)),
            ("create_virtual_cameras", (pcams,)),
            ("vis_cameras", (pvis,)), ("visualizer", (pviz,))]:
        jflags = flags(os.path.join(REPO, "tools", f"{name}.py"))
        added = set() if name in host_only else {"--device"}
        got = flags(*(p.__file__ for p in ports))
        if name == "eval_multiagent_synthetic":
            got |= {"--out", "--device"}
        assert jflags, name
        assert got == jflags | added, name
