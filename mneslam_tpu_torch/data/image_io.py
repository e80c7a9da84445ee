"""Image files of the datasets: PNG with no image package, JPEG through cv2.

The port's own counterpart of `_imread_color` / `_imread_depth` /
`_resize_color` and `BaseDataset._undistort` in
`mneslam_tpu/data/datasets.py`:

- `read_png` / `write_png`: a PNG codec built on the standard library's
  `zlib` and numpy (8- and 16-bit gray, RGB and RGBA, not interlaced, all
  five scanline filters). `read_png` returns what
  `cv2.imread(path, cv2.IMREAD_UNCHANGED)` returns, bit for bit (colour in
  BGR order, 16-bit samples as native uint16). Every depth map of the five
  datasets is a PNG, and so are TUM's colour frames.
- `imread_color` / `imread_depth`: `cv2.imread(path)` as RGB float32 in
  [0, 1], and `cv2.imread(path, IMREAD_UNCHANGED)` as float32. A PNG is
  decoded by `read_png`; any other file (the JPEG colour frames of Replica,
  ScanNet, Indoor and Outdoor) by cv2, imported when such a file is read.
  Without cv2 that raises an ImportError naming the file: there is no
  second JPEG decoder, because another libjpeg's settings can change the
  last bit.
- `resize_linear`: cv2.resize's INTER_LINEAR on float32 images (half-pixel
  centres, no antialiasing) through `F.interpolate` on the host.
- `undistort`: `cv2.undistort(img, K, dist)` with the new camera matrix K:
  the forward Brown-Conrady map (k1, k2, p1, p2[, k3]) sampled bilinearly
  with zero borders (`grid_sample`). As in cv2, the map's source
  coordinates are rounded to 1/32 pixel (cv2 remaps through fixed-point
  CV_16SC2 maps, INTER_TAB_SIZE 32).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch
import torch.nn.functional as F

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (gray, RGB, RGBA); palette and gray + alpha
# images are not read
_CHANNELS = {0: 1, 2: 3, 6: 4}
# cv2's fixed-point remap: source coordinates in 1/32 pixel
INTER_TAB_SIZE = 32


def is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == PNG_SIGNATURE


def _chunks(data: bytes):
    """(type, payload) of each chunk after the signature; raises on a
    truncated chunk or a CRC mismatch."""
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("PNG: truncated chunk header")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        end = pos + 12 + length
        if end > len(data):
            raise ValueError(f"PNG: truncated {kind!r} chunk")
        (crc,) = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG: CRC mismatch in the {kind!r} chunk")
        yield kind, payload
        pos = end
        if kind == b"IEND":
            return


def _paeth(a, b, c):
    """The Paeth predictor, elementwise on int16 arrays."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, stride: int,
              bpp: int) -> np.ndarray:
    """Undo the scanline filters: raw [height, 1 + stride] (filter byte,
    then the row) -> [height, stride] uint8.

    Rows filtered with None, Sub or Up are undone a row at a time (Sub by a
    running sum). Average and Paeth depend on the reconstructed byte to the
    left, so where any row uses them every row is undone along
    anti-diagonals of pixels (bpp bytes each): pixel (r, i) needs only
    (r, i - 1), (r - 1, i) and (r - 1, i - 1), all on earlier diagonals,
    so each diagonal is one vectorised step over the rows it crosses."""
    ftype = raw[:, 0]
    rows = raw[:, 1:].astype(np.int16)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown filter type {int(ftype.max())}")
    out = np.zeros((height, stride), np.int16)
    if not np.isin(ftype, (3, 4)).any():
        prev = np.zeros(stride, np.int16)
        for r in range(height):
            f, x = ftype[r], rows[r]
            if f == 1:
                x = np.cumsum(x.reshape(-1, bpp), axis=0).reshape(-1)
            elif f == 2:
                x = x + prev
            prev = out[r] = x & 0xFF
        return out.astype(np.uint8)
    width = stride // bpp
    # skewed layout: diagonal k = r + i is row k + 2 of `rec`, pixel row r
    # is column r + 1, so (r, i - 1) and (r - 1, i) lie on diagonal k - 1
    # and (r - 1, i - 1) on k - 2, each a slice; never-written entries are
    # the zeros left of and above the image
    r_all = np.arange(height)[:, None]
    i_all = np.arange(width)[None, :]
    k_all = (r_all + i_all).reshape(-1)
    r_flat = np.broadcast_to(r_all, (height, width)).reshape(-1)
    filt = np.zeros((height + width + 1, height + 1, bpp), np.int16)
    filt[k_all + 2, r_flat + 1] = rows.reshape(height * width, bpp)
    rec = np.zeros_like(filt)
    f_col = np.zeros(height + 1, np.int16)
    f_col[1:] = ftype
    for k in range(height + width - 1):
        lo, hi = max(0, k - width + 1) + 1, min(height, k + 1) + 1
        a = rec[k + 1, lo:hi]              # left
        b = rec[k + 1, lo - 1:hi - 1]      # above
        c = rec[k, lo - 1:hi - 1]          # above left
        f = f_col[lo:hi, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        rec[k + 2, lo:hi] = (filt[k + 2, lo:hi] + pred) & 0xFF
    return rec[k_all + 2, r_flat + 1].reshape(height, stride).astype(
        np.uint8)


def read_png(path: str) -> np.ndarray:
    """A non-interlaced 8- or 16-bit gray / RGB / RGBA PNG -> numpy, as
    `cv2.imread(path, cv2.IMREAD_UNCHANGED)`: [H, W] for gray, [H, W, 3]
    BGR, [H, W, 4] BGRA; uint8 or uint16."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(
            f"{path}: PNG colour type {ctype}, bit depth {depth}, interlace "
            f"{interlace}: only non-interlaced 8- or 16-bit gray, RGB and "
            f"RGBA are read")
    channels = _CHANNELS[ctype]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: PNG data holds {raw.size} bytes, the "
                         f"header implies {height * (stride + 1)}")
    img = _unfilter(raw.reshape(height, stride + 1), height, stride, bpp)
    if depth == 16:
        img = img.view(">u2").astype(np.uint16)
    img = img.reshape((height, width) if channels == 1
                      else (height, width, channels))
    if channels >= 3:
        img = np.ascontiguousarray(img[..., [2, 1, 0, 3][:channels]])
    return img


def _filter_rows(img: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """Filter every row of img [H, stride] uint8 with one filter type."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pred = [0, a, b, (a + b) >> 1, _paeth(a, b, c)][ftype]
    return ((x - pred) & 0xFF).astype(np.uint8)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def write_png(path: str, img: np.ndarray, filter_type: int = 2) -> None:
    """Write uint8 / uint16 [H, W] gray, [H, W, 3] BGR or [H, W, 4] BGRA
    (cv2.imwrite's channel order) as a PNG, every row with `filter_type`
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"write_png takes uint8 or uint16, got {img.dtype}")
    if filter_type not in range(5):
        raise ValueError(f"filter_type must be 0-4, got {filter_type}")
    channels = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}.get(channels)
    if ctype is None:
        raise ValueError(f"write_png takes 1, 3 or 4 channels, got "
                         f"{channels}")
    height, width = img.shape[:2]
    if channels >= 3:
        img = img[..., [2, 1, 0, 3][:channels]]
    depth = 16 if img.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    rows = rows.view(np.uint8).reshape(height, -1)
    bpp = channels * depth // 8
    body = np.concatenate(
        [np.full((height, 1), filter_type, np.uint8),
         _filter_rows(rows, bpp, filter_type)], axis=1)
    header = struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(body.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _cv2(path: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"reading {path} needs cv2 (opencv-python): the port decodes "
            f"only PNG files itself") from e
    return cv2


def imread_unchanged(path: str) -> np.ndarray:
    """`cv2.imread(path, cv2.IMREAD_UNCHANGED)`."""
    if is_png(path):
        return read_png(path)
    cv2 = _cv2(path)
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(f"cv2 could not read {path}")
    return img


def imread_color(path: str) -> np.ndarray:
    """RGB float32 [H, W, 3] in [0, 1]: `imread_color_u8` divided by 255."""
    return imread_color_u8(path).astype(np.float32) / 255.0


def imread_color_u8(path: str) -> np.ndarray:
    """RGB uint8 [H, W, 3]: `cv2.imread(path)` (3 channels, 8 bits: a gray
    image repeated, alpha dropped, 16-bit samples shifted right by 8) in
    RGB order."""
    if is_png(path):
        img = read_png(path)
        if img.dtype == np.uint16:
            img = (img >> 8).astype(np.uint8)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        rgb = img[..., 2::-1]
    else:
        cv2 = _cv2(path)
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(f"cv2 could not read {path}")
        rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return np.ascontiguousarray(rgb)


def imread_depth(path: str) -> np.ndarray:
    """The raw depth samples as float32 [H, W]."""
    return imread_unchanged(path).astype(np.float32)


def resize_linear(img: np.ndarray, W: int, H: int) -> np.ndarray:
    """`cv2.resize(img, (W, H))` (INTER_LINEAR) of a float32 [h, w] or
    [h, w, C] image: bilinear with half-pixel centres and no antialiasing.
    Interpolated in float64: cv2 places each source coordinate in double
    precision, which float32 coordinates miss by up to 4e-6 at a 64-pixel
    row."""
    img = np.asarray(img, np.float32)
    if img.shape[:2] == (H, W):
        return img.copy()
    t = torch.from_numpy(img.astype(np.float64))
    t = t[None, None] if t.dim() == 2 else t.permute(2, 0, 1)[None]
    out = F.interpolate(t, size=(H, W), mode="bilinear",
                        align_corners=False, antialias=False)[0]
    out = out[0] if img.ndim == 2 else out.permute(1, 2, 0)
    return np.ascontiguousarray(out.numpy().astype(np.float32))


def undistort_map(H: int, W: int, fx: float, fy: float, cx: float,
                  cy: float, dist) -> np.ndarray:
    """Source pixel (u, v) [H, W, 2] float64 of each undistorted pixel:
    the forward Brown-Conrady model of `cv2.initUndistortRectifyMap` with
    R = I and the new camera matrix equal to K, rounded to 1/32 pixel."""
    d = np.zeros(5, np.float64)
    coeffs = np.asarray(dist, np.float64).reshape(-1)
    if coeffs.size not in (4, 5):
        raise ValueError(f"cam.distortion takes k1, k2, p1, p2[, k3], got "
                         f"{coeffs.size} values")
    d[:coeffs.size] = coeffs
    k1, k2, p1, p2, k3 = d
    y, x = np.meshgrid((np.arange(H) - cy) / fy, (np.arange(W) - cx) / fx,
                       indexing="ij")
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    xy2 = 2.0 * x * y
    kr = 1.0 + ((k3 * r2 + k2) * r2 + k1) * r2
    u = fx * (x * kr + p1 * xy2 + p2 * (r2 + 2.0 * x2)) + cx
    v = fy * (y * kr + p1 * (r2 + 2.0 * y2) + p2 * xy2) + cy
    return np.stack([np.rint(u * INTER_TAB_SIZE),
                     np.rint(v * INTER_TAB_SIZE)], axis=-1) / INTER_TAB_SIZE


def undistort(img: np.ndarray, fx: float, fy: float, cx: float, cy: float,
              dist) -> np.ndarray:
    """`cv2.undistort(img, K, dist)` of a float32 [H, W, C] image: bilinear
    samples at `undistort_map`'s source pixels, zero outside the image.
    Sampled in float64, so each weight is its 1/32 step exactly."""
    H, W = img.shape[:2]
    uv = undistort_map(H, W, fx, fy, cx, cy, dist)
    grid = torch.from_numpy(np.stack(
        [2.0 * uv[..., 0] / (W - 1) - 1.0, 2.0 * uv[..., 1] / (H - 1) - 1.0],
        axis=-1))[None]
    src = torch.from_numpy(np.asarray(img, np.float64))
    src = src[None, None] if src.dim() == 2 else src.permute(2, 0, 1)[None]
    out = F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=True)[0]
    out = out[0] if img.ndim == 2 else out.permute(1, 2, 0)
    return np.ascontiguousarray(out.numpy().astype(np.float32))
