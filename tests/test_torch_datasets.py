"""Port parity: the file dataset loaders (`mneslam_tpu_torch/data/
datasets.py`) against `mneslam_tpu.data.datasets` on folders the tests
write in each dataset's layout (as tests/test_datasets.py does).

Tolerances: decoded images and depths bit for bit, except where a resize
or the undistortion runs (1e-6, tests/test_torch_image_io.py); poses
within 1e-6; ray directions within 1e-6.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from mneslam_tpu.config import make_config as jmake_config  # noqa: E402
from mneslam_tpu.data import datasets as jdatasets  # noqa: E402
from mneslam_tpu_torch.config import make_config  # noqa: E402
from mneslam_tpu_torch.data import datasets, image_io  # noqa: E402
from mneslam_tpu_torch.data.synthetic import SyntheticBoxDataset  # noqa

H, W = 32, 40
CAM = {"H": H, "W": W, "fx": 30.0, "fy": 31.0, "cx": 19.5, "cy": 15.5,
       "png_depth_scale": 1000.0, "crop_edge": 0}


def _cfgs(kind, datadir, cam=None, **top):
    over = {"cam": dict(CAM, **(cam or {})), "mapping": {"n_pixels": 0.05},
            "data": {"downsample": 1, "datadir": str(datadir)},
            "dataset": kind, **top}
    return jmake_config(over), make_config(over)


def _frame(rgb_path, depth_path, seed, hw=(H, W), depth_hw=None):
    """A noisy colour frame and a sloped 16-bit depth map; depth_hw gives
    the depth its own size (Outdoor)."""
    rng = np.random.default_rng(seed)
    cv2.imwrite(str(rgb_path), rng.integers(0, 256, hw + (3,), np.uint8))
    dh, dw = depth_hw or hw
    depth = (1500 + 40 * np.arange(dw)[None, :] + 13 * np.arange(dh)[:, None]
             + seed).astype(np.uint16)
    cv2.imwrite(str(depth_path), depth)


def _pose(i):
    """A rigid c2w with a rotation about a tilted axis and a translation."""
    a = 0.1 * i + 0.2
    c, s = np.cos(a), np.sin(a)
    R = np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ np.asarray(
        [[1, 0, 0], [0, np.cos(0.3), -np.sin(0.3)],
         [0, np.sin(0.3), np.cos(0.3)]])
    c2w = np.eye(4)
    c2w[:3, :3] = R
    c2w[:3, 3] = [0.1 * i, -0.05 * i, 1.0 + 0.02 * i]
    return c2w


def _pose_line(i):
    return " ".join(repr(float(v)) for v in _pose(i).reshape(-1))


def _assert_same(ds, jds, atol_rgb=0.0, atol_depth=0.0):
    assert len(ds) == len(jds) > 0
    assert (ds.H, ds.W, ds.fx, ds.fy, ds.cx, ds.cy) == (
        jds.H, jds.W, jds.fx, jds.fy, jds.cx, jds.cy)
    assert ds.num_rays_to_save == jds.num_rays_to_save
    for i in range(len(ds)):
        a, b = ds[i], jds[i]
        assert a["frame_id"] == b["frame_id"]
        for key in ("c2w", "rgb", "depth", "direction"):
            assert a[key].dtype == np.float32, key
            assert a[key].shape == np.asarray(b[key]).shape, key
        np.testing.assert_allclose(a["c2w"], b["c2w"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(a["rgb"], b["rgb"], atol=atol_rgb, rtol=0)
        np.testing.assert_allclose(a["depth"], b["depth"], atol=atol_depth,
                                   rtol=0)
        np.testing.assert_allclose(a["direction"], np.asarray(b["direction"]),
                                   atol=1e-6, rtol=0)


def make_replica(root, n=5, depth_hw=None):
    (root / "results").mkdir(parents=True)
    for i in range(n):
        _frame(root / "results" / f"frame{i:06d}.jpg",
               root / "results" / f"depth{i:06d}.png", i, depth_hw=depth_hw)
    (root / "traj.txt").write_text(
        "\n".join(_pose_line(i) for i in range(n)) + "\n")
    return root


@pytest.mark.parametrize("window", [(0, -1), (1, 4)])
def test_replica_matches_jax(tmp_path, window):
    d = make_replica(tmp_path / "replica")
    jcfg, cfg = _cfgs("replica", d, start_index=window[0],
                      end_index=window[1])
    jcfg["data"]["sc_factor"] = cfg["data"]["sc_factor"] = 1.5
    ds, jds = datasets.get_dataset(cfg), jdatasets.get_dataset(jcfg)
    assert isinstance(ds, datasets.ReplicaDataset)
    assert len(ds) == (5 if window[1] == -1 else 3)
    _assert_same(ds, jds)
    # the index window starts at the window's first pose, sc_factor scales
    # the translation and the depth, Y / Z columns flipped
    c2w = _pose(window[0])
    np.testing.assert_allclose(ds[0]["c2w"][:3, 3], 1.5 * c2w[:3, 3],
                               atol=1e-6)
    np.testing.assert_allclose(ds[0]["c2w"][:3, 1], -c2w[:3, 1], atol=1e-6)
    np.testing.assert_allclose(ds[0]["depth"][0, 0],
                               (1500 + window[0]) / 1000.0 * 1.5, rtol=1e-6)


def test_replica_undistortion_matches_jax(tmp_path):
    d = make_replica(tmp_path / "replica_dist", n=2)
    dist = [0.2, -0.05, 0.001, 0.001, 0.0]
    jcfg, cfg = _cfgs("replica", d, cam={"distortion": dist})
    ds = datasets.get_dataset(cfg)
    _assert_same(ds, jdatasets.get_dataset(jcfg), atol_rgb=1e-6)
    plain = datasets.get_dataset(_cfgs("replica", d)[1])
    assert np.abs(ds[0]["rgb"] - plain[0]["rgb"]).max() > 1e-3
    np.testing.assert_array_equal(ds[0]["depth"], plain[0]["depth"])


def test_replica_resizes_colour_to_the_depth(tmp_path):
    """Colour frames at twice the depth's size: resized (cv2 INTER_LINEAR)
    to the depth's 16 x 20."""
    d = tmp_path / "replica_big"
    (d / "results").mkdir(parents=True)
    for i in range(2):
        _frame(d / "results" / f"frame{i:06d}.jpg",
               d / "results" / f"depth{i:06d}.png", i, hw=(2 * H, 2 * W),
               depth_hw=(H // 2, W // 2))
    (d / "traj.txt").write_text(_pose_line(0) + "\n" + _pose_line(1) + "\n")
    jcfg, cfg = _cfgs("replica", d, cam={"H": H // 2, "W": W // 2})
    ds = datasets.get_dataset(cfg)
    assert ds[0]["rgb"].shape == (H // 2, W // 2, 3)
    _assert_same(ds, jdatasets.get_dataset(jcfg), atol_rgb=1e-6)


def make_scannet(root, n=4, inf_pose=None):
    for sub in ("color", "depth", "pose"):
        (root / sub).mkdir(parents=True)
    # numbered names whose lexical order differs from the numeric one
    for k, i in enumerate([0, 1, 2, 10][:n]):
        _frame(root / "color" / f"{i}.jpg", root / "depth" / f"{i}.png", k)
        c2w = _pose(k)
        if inf_pose == k:
            c2w[:3, 3] = np.inf
        np.savetxt(str(root / "pose" / f"{i}.txt"), c2w)
    return root


@pytest.mark.parametrize("crop", [0, 3])
def test_scannet_matches_jax(tmp_path, crop):
    d = make_scannet(tmp_path / "scannet", inf_pose=2)
    jcfg, cfg = _cfgs("scannet", d, cam={"crop_edge": crop})
    ds, jds = datasets.get_dataset(cfg), jdatasets.get_dataset(jcfg)
    assert isinstance(ds, datasets.ScannetDataset)
    assert ds[0]["rgb"].shape == (H - 2 * crop, W - 2 * crop, 3)
    assert (ds.cx, ds.cy) == (19.5 - crop, 15.5 - crop)
    # the inf-pose frame is loaded as it is, as in the JAX package
    assert not np.isfinite(ds.poses[2]).all()
    finite = [i for i in range(len(ds)) if i != 2]
    for i in finite:
        np.testing.assert_allclose(ds[i]["c2w"], jds[i]["c2w"], atol=1e-6)
    np.testing.assert_array_equal(ds[2]["c2w"], jds[2]["c2w"])
    # frame 3 is file 10.* (numeric order)
    np.testing.assert_allclose(ds[3]["c2w"][:3, 3], _pose(3)[:3, 3],
                               atol=1e-6)
    ds.poses[2] = jds.poses[2] = np.eye(4, dtype=np.float32)
    _assert_same(ds, jds)


def test_indoor_world_alignment_and_depth_scale(tmp_path):
    d = tmp_path / "indoor"
    (d / "color").mkdir(parents=True)
    (d / "depth_holefilling").mkdir()
    for i in range(3):
        _frame(d / "color" / f"{i:04d}.jpg",
               d / "depth_holefilling" / f"{i:04d}.png", i)
    (d / "traj.txt").write_text(
        "\n".join(_pose_line(i) for i in range(3)) + "\n")
    jcfg, cfg = _cfgs("indoor", d, cam={"crop_edge": 2}, start_index=1)
    ds, jds = datasets.get_dataset(cfg), jdatasets.get_dataset(jcfg)
    assert isinstance(ds, datasets.IndoorDataset) and len(ds) == 2
    _assert_same(ds, jds)
    want = datasets.IndoorDataset.WORLD_ALIGN @ _pose(1)
    want[:3, 1:3] *= -1
    np.testing.assert_allclose(ds[0]["c2w"], want, atol=1e-6)
    # depth / 65535 * 100, whatever png_depth_scale says
    np.testing.assert_allclose(ds[0]["depth"][0, 0],
                               (1500 + 1 + 13 * 2 + 40 * 2) / 65535 * 100,
                               rtol=1e-6)


def test_outdoor_resizes_depth_to_the_colour(tmp_path):
    d = make_replica(tmp_path / "outdoor", n=3, depth_hw=(H // 2, W // 2))
    jcfg, cfg = _cfgs("outdoor", d)
    ds, jds = datasets.get_dataset(cfg), jdatasets.get_dataset(jcfg)
    assert isinstance(ds, datasets.OutdoorDataset)
    assert ds[0]["depth"].shape == (H, W)
    _assert_same(ds, jds, atol_depth=1e-6)


def write_tum(root, n=5, drop=(), gt_rate=0.1, dt_depth=0.01):
    """A TUM folder: rgb/depth lists, ground truth as `t tx ty tz qx qy qz
    qw`; colour frames in `drop` get no depth within 0.08 s."""
    from scipy.spatial.transform import Rotation

    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rgb_lines, depth_lines, gt_lines = [], [], []
    for i in range(n):
        t = 100.0 + 0.1 * i
        image_io.write_png(str(root / "rgb" / f"{t:.4f}.png"),
                           np.random.default_rng(i).integers(
                               0, 256, (H, W, 3), np.uint8), filter_type=4)
        image_io.write_png(str(root / "depth" / f"{t:.4f}.png"),
                           np.full((H, W), 5000 + 100 * i, np.uint16))
        rgb_lines.append(f"{t:.6f} rgb/{t:.4f}.png")
        if i not in drop:
            depth_lines.append(f"{t + dt_depth:.6f} depth/{t:.4f}.png")
    for k in range(int(0.1 * (n + 1) / gt_rate)):
        t = 100.0 + gt_rate * k - 0.003
        c2w = _pose(k)
        q = Rotation.from_matrix(c2w[:3, :3]).as_quat()    # x y z w
        gt_lines.append(f"{t:.6f} " + " ".join(
            f"{v:.9f}" for v in [*c2w[:3, 3], *q]))
    for name, lines in [("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("groundtruth.txt", gt_lines)]:
        (root / name).write_text("# header\n# more\n" + "\n".join(lines)
                                 + "\n")
    return root


def test_tum_association_and_quaternions_match_jax(tmp_path):
    d = write_tum(tmp_path / "tum", n=6, drop=(3,), gt_rate=0.01)
    jcfg, cfg = _cfgs("tum", d, cam={"png_depth_scale": 5000.0})
    ds, jds = datasets.get_dataset(cfg), jdatasets.get_dataset(jcfg)
    assert isinstance(ds, datasets.TUMDataset)
    assert len(ds) == 5                          # frame 3 dropped
    assert ds.timestamps == jds.timestamps
    assert 100.3 not in [round(t, 4) for t in ds.timestamps]
    _assert_same(ds, jds)
    # the quaternion order: [qx, qy, qz, qw] -> R, then the Y / Z flips
    want = _pose(40)
    want[:3, 1:3] *= -1
    np.testing.assert_allclose(ds[3]["c2w"], want, atol=1e-6)
    np.testing.assert_allclose(ds[0]["depth"], 1.0, rtol=1e-6)


def test_tum_index_window(tmp_path):
    d = write_tum(tmp_path / "tum_win", n=5)
    jcfg, cfg = _cfgs("tum", d, cam={"png_depth_scale": 5000.0},
                      start_index=1, end_index=3)
    ds = datasets.get_dataset(cfg)
    assert len(ds) == 2 and ds[0]["frame_id"] == 0
    _assert_same(ds, jdatasets.get_dataset(jcfg))


def test_get_dataset_builds_every_kind(tmp_path):
    roots = {"replica": make_replica(tmp_path / "r", n=2),
             "outdoor": make_replica(tmp_path / "o", n=2),
             "scannet": make_scannet(tmp_path / "s", n=2),
             "tum": write_tum(tmp_path / "t", n=2)}
    ind = tmp_path / "i"
    (ind / "color").mkdir(parents=True)
    (ind / "depth_holefilling").mkdir()
    _frame(ind / "color" / "0.jpg", ind / "depth_holefilling" / "0.png", 0)
    (ind / "traj.txt").write_text(_pose_line(0) + "\n")
    roots["indoor"] = ind
    assert set(datasets.LOADERS) == set(roots)
    for kind, root in roots.items():
        ds = datasets.get_dataset(_cfgs(kind, root)[1])
        assert type(ds) is datasets.LOADERS[kind] and len(ds) >= 1, kind
    cfg = _cfgs("synthetic", tmp_path)[1]
    cfg["data"]["num_frames"] = 3
    assert isinstance(datasets.get_dataset(cfg), SyntheticBoxDataset)
    cfg["dataset"] = "kitti"
    with pytest.raises(ValueError, match="kitti"):
        datasets.get_dataset(cfg)
