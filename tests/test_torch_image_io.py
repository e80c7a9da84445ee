"""Port parity: the port's image I/O (`mneslam_tpu_torch/data/image_io.py`)
against cv2, which the JAX loaders decode with.

Tolerances: PNG files bit for bit (samples, shape, dtype, channel order);
the float32 colour resize within 1e-6 (cv2 INTER_LINEAR and F.interpolate
weight in float32 with other roundings); undistortion within 1e-6, since
both round the source coordinates to 1/32 pixel (measured: 1.2e-7, one
float32 ulp near 1, at 480 x 640 with TUM fr1's coefficients).
"""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from mneslam_tpu.data import datasets as jdatasets  # noqa: E402
from mneslam_tpu_torch.data import image_io  # noqa: E402


def _images(H=48, W=64, seed=0):
    """Smooth gradients with noisy rows: every filter type wins some row
    of cv2's adaptive choice, and the wrap-around of the byte sums is
    exercised."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W]
    rgb = np.stack([(3 * xx + yy) % 256, (5 * yy) % 256, (xx ^ yy) % 256],
                   -1).astype(np.uint8)
    rgb[::5] = rng.integers(0, 256, rgb[::5].shape)
    depth = (1000 + 37 * xx + 11 * yy).astype(np.uint16)
    depth[3:6] = rng.integers(0, 65536, depth[3:6].shape)
    return {"rgb": rgb, "depth16": depth, "gray": rgb[..., 1].copy(),
            "rgba": np.concatenate([rgb, rgb[..., :1]], -1),
            "rgb16": rgb.astype(np.uint16) * 257 + 1}


@pytest.mark.parametrize("name", ["rgb", "depth16", "gray", "rgba", "rgb16"])
def test_read_png_matches_cv2_on_cv2_files(tmp_path, name):
    img = _images()[name]
    path = str(tmp_path / f"{name}.png")
    assert cv2.imwrite(path, img)
    got = image_io.read_png(path)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(image_io.imread_color(path),
                                  jdatasets._imread_color(path))
    np.testing.assert_array_equal(image_io.imread_depth(path),
                                  jdatasets._imread_depth(path))


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_write_png_every_filter_bit_for_bit(tmp_path, filter_type):
    """The port's writer with each filter type on every row: cv2 and the
    port's reader both read back the array exactly."""
    for name in ("rgb", "depth16", "rgba"):
        img = _images(seed=filter_type)[name]
        path = str(tmp_path / f"{name}_{filter_type}.png")
        image_io.write_png(path, img, filter_type=filter_type)
        np.testing.assert_array_equal(
            cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
        np.testing.assert_array_equal(image_io.read_png(path), img)


def test_png_reader_rejects_bad_files(tmp_path):
    path = str(tmp_path / "x.png")
    image_io.write_png(path, _images()["rgb"])
    data = bytearray(open(path, "rb").read())
    data[40] ^= 0xFF                       # inside the IDAT payload
    bad = str(tmp_path / "bad.png")
    open(bad, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        image_io.read_png(bad)
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.read_png(__file__)


def test_jpeg_goes_through_cv2_or_names_it(tmp_path, monkeypatch):
    path = str(tmp_path / "f.jpg")
    cv2.imwrite(path, _images()["rgb"])
    np.testing.assert_array_equal(image_io.imread_color(path),
                                  jdatasets._imread_color(path))
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(ImportError, match=r"cv2.*f\.jpg|f\.jpg.*cv2"):
        image_io.imread_color(path)
    # PNG needs no image package
    png = str(tmp_path / "d.png")
    image_io.write_png(png, _images()["depth16"])
    assert image_io.imread_depth(png).dtype == np.float32


@pytest.mark.parametrize("src,dst", [((48, 64), (24, 32)), ((30, 40),
                                                            (48, 64)),
                                     ((48, 64), (35, 51))])
def test_resize_linear_matches_cv2(src, dst):
    rng = np.random.default_rng(1)
    for shape in (src + (3,), src):
        img = rng.uniform(size=shape).astype(np.float32)
        got = image_io.resize_linear(img, dst[1], dst[0])
        ref = jdatasets._resize_color(img, dst[1], dst[0])
        assert got.shape == ref.shape and got.dtype == ref.dtype
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("H,W,intr,dist", [
    (32, 40, (30.0, 30.0, 19.5, 15.5), [0.2, -0.05, 0.001, 0.001, 0.0]),
    (96, 128, (103.5, 103.3, 63.7, 51.1),
     [0.2624, -0.9531, -0.0054, 0.0026, 1.1633]),
    (40, 56, (35.0, 35.0, 27.5, 19.5), [-0.1, 0.02, 0.0, 0.0]),
])
def test_undistort_matches_cv2(H, W, intr, dist):
    fx, fy, cx, cy = intr
    img = np.random.default_rng(2).uniform(size=(H, W, 3)).astype(
        np.float32)
    K = np.eye(3)
    K[0, 0], K[0, 2], K[1, 1], K[1, 2] = fx, cx, fy, cy
    ref = cv2.undistort(img, K, np.asarray(dist, np.float64))
    got = image_io.undistort(img, fx, fy, cx, cy, dist)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert np.abs(got - img).max() > 1e-3   # it moved the pixels


def test_undistort_map_is_on_the_1_32_grid():
    uv = image_io.undistort_map(8, 10, 9.0, 9.0, 4.5, 3.5,
                                [0.3, 0.1, 0.01, -0.01, 0.05])
    np.testing.assert_array_equal(uv * 32, np.rint(uv * 32))
    assert os.path.basename(image_io.__file__) == "image_io.py"
