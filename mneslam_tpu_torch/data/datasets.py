"""Dataset loaders: Replica, ScanNet, Indoor (INS), Outdoor, TUM, synthetic.

Port of `mneslam_tpu/data/datasets.py`. Every item is the same dict:
{frame_id, c2w [4, 4] float32 (OpenGL, -z forward), rgb [H, W, 3] in
[0, 1], depth [H, W] in metres, direction [H, W, 3] camera rays}, numpy on
the host (the SLAM loop moves them to the device), with per-agent
`start_index` / `end_index` windows for trajectory splits.

Pose conventions as in the JAX package: Replica / ScanNet / Outdoor / TUM
flip the Y and Z columns of the stored c2w; Indoor first applies its fixed
world alignment and scales depth by 100 / 65535. ScanNet frames whose pose
is not finite are loaded as they are (`tools/validate_dataset` reports
them). Images go through `image_io`: PNG with no image package, JPEG
through cv2. `cam.distortion` undistorts the colour image only, at its raw
resolution, before any resize.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from . import image_io
from .rays import get_camera_rays
from .synthetic import SyntheticBoxDataset


class BaseDataset:
    def __init__(self, cfg):
        self.cfg = cfg
        down = cfg["data"].get("downsample", 1)
        self.png_depth_scale = cfg["cam"]["png_depth_scale"]
        self.H = cfg["cam"]["H"] // down
        self.W = cfg["cam"]["W"] // down
        self.fx = cfg["cam"]["fx"] // down if down > 1 else cfg["cam"]["fx"]
        self.fy = cfg["cam"]["fy"] // down if down > 1 else cfg["cam"]["fy"]
        self.cx = cfg["cam"]["cx"] // down if down > 1 else cfg["cam"]["cx"]
        self.cy = cfg["cam"]["cy"] // down if down > 1 else cfg["cam"]["cy"]
        self.crop_edge = cfg["cam"].get("crop_edge", 0)
        self.distortion = (np.asarray(cfg["cam"]["distortion"], np.float64)
                           if "distortion" in cfg["cam"] else None)
        self.sc_factor = cfg["data"].get("sc_factor", 1)
        self.t0 = cfg.get("start_index", 0)
        self.t1 = cfg.get("end_index", -1)
        if self.t1 == -1:
            self.t1 = None
        self.rays_d: Optional[np.ndarray] = None
        total = (self.H - 2 * self.crop_edge) * (self.W - 2 * self.crop_edge)
        self.num_rays_to_save = int(total * cfg["mapping"]["n_pixels"])

    def _directions(self) -> np.ndarray:
        if self.rays_d is None:
            self.rays_d = get_camera_rays(self.H, self.W, self.fx, self.fy,
                                          self.cx, self.cy).numpy()
        return self.rays_d

    def __len__(self):
        return self.num_frames

    def _crop_intrinsics(self):
        """ScanNet / Indoor: the crop_edge band leaves the image."""
        if self.crop_edge > 0:
            self.H -= 2 * self.crop_edge
            self.W -= 2 * self.crop_edge
            self.cx -= self.crop_edge
            self.cy -= self.crop_edge

    def _color(self, path: str) -> np.ndarray:
        """The colour frame, undistorted at raw resolution with the raw
        intrinsics (never the depth); no-op without cam.distortion."""
        rgb = image_io.imread_color(path)
        if self.distortion is None:
            return rgb
        return image_io.undistort(rgb, self.fx, self.fy, self.cx, self.cy,
                                  self.distortion)

    def _scaled_depth(self, path: str) -> np.ndarray:
        return (image_io.imread_depth(path) / self.png_depth_scale
                * self.sc_factor)

    def _item(self, index, rgb, depth, c2w) -> Dict:
        return {
            "frame_id": index,
            "c2w": np.asarray(c2w, np.float32),
            "rgb": rgb.astype(np.float32),
            "depth": depth.astype(np.float32),
            "direction": self._directions(),
        }


def _flip_yz(c2w: np.ndarray) -> np.ndarray:
    """The stored (OpenCV) camera axes to OpenGL: Y and Z columns negated."""
    c2w[:3, 1] *= -1
    c2w[:3, 2] *= -1
    return c2w


class ReplicaDataset(BaseDataset):
    """Replica: results/frame*.jpg + depth*.png + traj.txt."""

    def __init__(self, cfg, basedir):
        super().__init__(cfg)
        self.basedir = basedir
        self.img_files = sorted(glob.glob(
            f"{basedir}/results/frame*.jpg"))[self.t0:self.t1]
        self.depth_paths = sorted(glob.glob(
            f"{basedir}/results/depth*.png"))[self.t0:self.t1]
        self.num_frames = len(self.img_files)
        self.poses = self._load_poses(os.path.join(basedir, "traj.txt"))
        self.frame_ids = list(range(self.num_frames))

    def _load_poses(self, path) -> List[np.ndarray]:
        with open(path) as f:
            lines = f.readlines()[self.t0:self.t1]
        poses = []
        for i in range(self.num_frames):
            c2w = _flip_yz(np.asarray(list(map(float, lines[i].split())),
                                      np.float64).reshape(4, 4))
            c2w[:3, 3] *= self.sc_factor
            poses.append(c2w.astype(np.float32))
        return poses

    def __getitem__(self, index):
        rgb = self._color(self.img_files[index])
        depth = self._scaled_depth(self.depth_paths[index])
        H, W = depth.shape
        rgb = image_io.resize_linear(rgb, W, H)
        return self._item(self.frame_ids[index], rgb, depth,
                          self.poses[index])


class ScannetDataset(BaseDataset):
    """ScanNet: color/*.jpg, depth/*.png, pose/*.txt, sorted by number."""

    def __init__(self, cfg, basedir):
        super().__init__(cfg)
        self.basedir = basedir

        def listing(sub, ext):
            paths = glob.glob(os.path.join(basedir, sub, f"*.{ext}"))
            return sorted(paths, key=lambda x: int(
                os.path.basename(x).split(".")[0]))[self.t0:self.t1]

        self.img_files = listing("color", "jpg")
        self.depth_paths = listing("depth", "png")
        self.poses = [_flip_yz(np.loadtxt(p).reshape(4, 4)).astype(np.float32)
                      for p in listing("pose", "txt")]
        self.frame_ids = list(range(len(self.img_files)))
        self.num_frames = len(self.img_files)
        self._crop_intrinsics()

    def __getitem__(self, index):
        rgb = self._color(self.img_files[index])
        depth = self._scaled_depth(self.depth_paths[index])
        H, W = depth.shape
        rgb = image_io.resize_linear(rgb, W, H)
        e = self.crop_edge
        if e > 0:
            rgb = rgb[e:-e, e:-e]
            depth = depth[e:-e, e:-e]
        return self._item(self.frame_ids[index], rgb, depth,
                          self.poses[index])


class IndoorDataset(BaseDataset):
    """INS indoor: depth_holefilling PNGs scaled by 100 / 65535, poses
    pre-multiplied by the fixed world alignment."""

    WORLD_ALIGN = np.asarray(
        [[0.970296, -0.241922, 0.0, -0.789423],
         [0.241922, 0.970296, 0.0, -6.085402],
         [0.0, 0.0, 1.0, 0.0],
         [0.0, 0.0, 0.0, 1.0]]
    )

    def __init__(self, cfg, basedir):
        super().__init__(cfg)
        self.basedir = basedir
        self.img_files = sorted(glob.glob(
            os.path.join(basedir, "color", "*.jpg")))[self.t0:self.t1]
        self.depth_paths = sorted(glob.glob(os.path.join(
            basedir, "depth_holefilling", "*.png")))[self.t0:self.t1]
        with open(os.path.join(basedir, "traj.txt")) as f:
            lines = f.readlines()[self.t0:self.t1]
        self.poses = []
        for line in lines:
            c2w = np.asarray(list(map(float, line.split())),
                             np.float64).reshape(4, 4)
            self.poses.append(
                _flip_yz(self.WORLD_ALIGN @ c2w).astype(np.float32))
        self.frame_ids = list(range(len(self.img_files)))
        self.num_frames = len(self.img_files)
        self._crop_intrinsics()

    def __getitem__(self, index):
        rgb = self._color(self.img_files[index])
        depth = image_io.imread_depth(self.depth_paths[index]) / 65535.0 \
            * 100.0
        H, W = depth.shape
        rgb = image_io.resize_linear(rgb, W, H)
        e = self.crop_edge
        if e > 0:
            rgb = rgb[e:-e, e:-e]
            depth = depth[e:-e, e:-e]
        return self._item(self.frame_ids[index], rgb, depth,
                          self.poses[index])


class OutdoorDataset(ReplicaDataset):
    """Outdoor: the Replica layout; the depth is resized to the colour
    frame's size."""

    def __init__(self, cfg, basedir):
        cfg = dict(cfg)
        cfg.setdefault("start_index", 0)
        cfg.setdefault("end_index", -1)
        super().__init__(cfg, basedir)

    def __getitem__(self, index):
        rgb = self._color(self.img_files[index])
        depth = self._scaled_depth(self.depth_paths[index])
        depth = image_io.resize_linear(depth, rgb.shape[1], rgb.shape[0])
        return self._item(self.frame_ids[index], rgb, depth,
                          self.poses[index])


def read_tum_list(path: str):
    """A TUM list file (rgb.txt, depth.txt, groundtruth.txt) -> [(timestamp,
    [the line's other fields])], comments and blank lines skipped."""
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            rows.append((float(parts[0]), parts[1:]))
    return rows


class TUMDataset(BaseDataset):
    """TUM RGB-D: rgb.txt / depth.txt / groundtruth.txt; each colour frame
    takes the nearest depth frame and ground-truth pose, and is dropped
    when either lies more than `max_dt` seconds away. Ground truth is
    `t tx ty tz qx qy qz qw`."""

    def __init__(self, cfg, basedir, max_dt: float = 0.08):
        super().__init__(cfg)
        self.basedir = basedir
        from ..ops import lie

        rgb_list = read_tum_list(os.path.join(basedir, "rgb.txt"))
        depth_list = read_tum_list(os.path.join(basedir, "depth.txt"))
        gt_list = read_tum_list(os.path.join(basedir, "groundtruth.txt"))
        d_ts = np.asarray([t for t, _ in depth_list])
        g_ts = np.asarray([t for t, _ in gt_list])

        self.img_files, self.depth_paths, self.poses, self.timestamps = \
            [], [], [], []
        for t, (rgb_path,) in rgb_list:
            di = int(np.argmin(np.abs(d_ts - t)))
            gi = int(np.argmin(np.abs(g_ts - t)))
            if abs(d_ts[di] - t) > max_dt or abs(g_ts[gi] - t) > max_dt:
                continue
            tx, ty, tz, qx, qy, qz, qw = map(float, gt_list[gi][1][:7])
            R = lie.quat_to_matrix(torch.tensor(
                [qx, qy, qz, qw], dtype=torch.float32)).numpy()
            c2w = np.eye(4, dtype=np.float64)
            c2w[:3, :3] = R
            c2w[:3, 3] = [tx, ty, tz]
            self.img_files.append(os.path.join(basedir, rgb_path))
            self.depth_paths.append(os.path.join(basedir,
                                                 depth_list[di][1][0]))
            self.poses.append(_flip_yz(c2w).astype(np.float32))
            self.timestamps.append(t)

        sl = slice(self.t0, self.t1)
        self.img_files = self.img_files[sl]
        self.depth_paths = self.depth_paths[sl]
        self.poses = self.poses[sl]
        self.timestamps = self.timestamps[sl]
        self.frame_ids = list(range(len(self.img_files)))
        self.num_frames = len(self.img_files)

    def __getitem__(self, index):
        rgb = self._color(self.img_files[index])
        depth = self._scaled_depth(self.depth_paths[index])
        H, W = depth.shape
        rgb = image_io.resize_linear(rgb, W, H)
        return self._item(self.frame_ids[index], rgb, depth,
                          self.poses[index])


LOADERS = {
    "replica": ReplicaDataset,
    "scannet": ScannetDataset,
    "indoor": IndoorDataset,
    "outdoor": OutdoorDataset,
    "tum": TUMDataset,
}


def get_dataset(config):
    """Factory keyed on config['dataset']: `synthetic` or one of
    `LOADERS` on config['data']['datadir']."""
    name = config["dataset"]
    if name == "synthetic":
        return SyntheticBoxDataset(
            config, num_frames=config["data"].get("num_frames", 24))
    if name not in LOADERS:
        raise ValueError(f"unknown dataset {name!r}: synthetic or one of "
                         f"{sorted(LOADERS)}")
    return LOADERS[name](config, config["data"]["datadir"])
