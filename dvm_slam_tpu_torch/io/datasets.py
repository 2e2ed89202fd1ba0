"""Dataset loaders: EuRoC / TUM / KITTI monocular, stereo and RGB-D sequences.

Port of `dvm_slam_tpu/io/datasets.py`. Replaces the reference's rosbag
replay path (EuRoC bags remapped to `robotN/camera/image_color` by
`central_management_interface/main.py:270-317` and the KITTI->rosbag
converter `src/tools/kittiToRos.ipynb`): direct folder readers yielding
(timestamp, grayscale float32 [H,W]) streams, plus a multi-agent splitter
that hands out overlapping sub-sequences to N agents (the reference
evaluates multi-agent runs by splitting one sequence across robots).

Images are read by the port's own PNG reader (`io/png.py`: the values
Pillow's `convert("L")` gives, bit for bit, and a depth map's raw 16-bit
units), so the loaders need no image library; ground truth goes through the
port's `geometry/lie`.
"""

from __future__ import annotations

import csv
import os
from typing import Iterator, List, Tuple

import numpy as np
import torch

from ..geometry import lie
from . import png


def _read_gray(path: str) -> np.ndarray:
    return png.read_gray(path)


class ImageSequence:
    """A timestamped list of image paths, loaded lazily."""

    def __init__(self, stamps: List[float], paths: List[str]):
        assert len(stamps) == len(paths)
        self.stamps = stamps
        self.paths = paths

    def __len__(self):
        return len(self.paths)

    def __iter__(self) -> Iterator[Tuple[float, np.ndarray]]:
        for t, p in zip(self.stamps, self.paths):
            yield t, _read_gray(p)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return ImageSequence(self.stamps[i], self.paths[i])
        return self.stamps[i], _read_gray(self.paths[i])

    def split_for_agents(self, n_agents: int, overlap: float = 0.25):
        """Split into n sub-sequences with fractional overlap — the
        multi-agent evaluation setup (each robot replays part of the route)."""
        n = len(self)
        seg = int(n / (n_agents - (n_agents - 1) * overlap)) if n_agents > 1 else n
        step = int(seg * (1 - overlap))
        out = []
        for a in range(n_agents):
            lo = max(n - seg, 0) if a == n_agents - 1 else min(a * step, max(n - seg, 0))
            out.append(self[lo:lo + seg])
        return out


def load_euroc(root: str, cam: str = "cam0") -> ImageSequence:
    """EuRoC ASL format: `<root>/mav0/cam0/{data.csv,data/*.png}`
    (timestamps in ns)."""
    base = os.path.join(root, "mav0", cam)
    if not os.path.isdir(base):
        base = os.path.join(root, cam)  # tolerate stripped layouts
    csv_path = os.path.join(base, "data.csv")
    stamps, paths = [], []
    with open(csv_path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            stamps.append(int(row[0]) * 1e-9)
            paths.append(os.path.join(base, "data", row[1].strip()))
    return ImageSequence(stamps, paths)


def load_tum(root: str) -> ImageSequence:
    """TUM RGB-D format: `<root>/rgb.txt` lines `timestamp path`."""
    stamps, paths = [], []
    with open(os.path.join(root, "rgb.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, p = line.split()[:2]
            stamps.append(float(t))
            paths.append(os.path.join(root, p))
    return ImageSequence(stamps, paths)


def load_kitti(root: str, cam: int = 0) -> ImageSequence:
    """KITTI odometry format: `<root>/image_{cam}/*.png` + `times.txt`."""
    img_dir = os.path.join(root, f"image_{cam}")
    with open(os.path.join(root, "times.txt")) as f:
        stamps = [float(line) for line in f if line.strip()]
    names = sorted(os.listdir(img_dir))
    paths = [os.path.join(img_dir, n) for n in names]
    n = min(len(stamps), len(paths))
    return ImageSequence(stamps[:n], paths[:n])


class StereoSequence:
    """Timestamped rectified stereo pairs, loaded lazily. Pairs are matched
    by nearest timestamp within `max_dt` (EuRoC cam0/cam1 share stamps)."""

    def __init__(self, left: ImageSequence, right: ImageSequence,
                 max_dt: float = 0.005):
        rs = np.asarray(right.stamps)
        stamps, lp, rp = [], [], []
        for t, p in zip(left.stamps, left.paths):
            j = int(np.argmin(np.abs(rs - t))) if len(rs) else -1
            if j >= 0 and abs(rs[j] - t) <= max_dt:
                stamps.append(t)
                lp.append(p)
                rp.append(right.paths[j])
        self.stamps = stamps
        self.left_paths = lp
        self.right_paths = rp

    def __len__(self):
        return len(self.stamps)

    def __iter__(self):
        for t, pl, pr in zip(self.stamps, self.left_paths, self.right_paths):
            yield t, _read_gray(pl), _read_gray(pr)

    def __getitem__(self, i):
        return (self.stamps[i], _read_gray(self.left_paths[i]),
                _read_gray(self.right_paths[i]))


class RgbdSequence:
    """Timestamped RGB + registered depth (TUM RGB-D association by nearest
    stamp, the role of the dataset's associate.py; depth stays in raw sensor
    units — System.track_rgbd applies depth_map_factor)."""

    def __init__(self, rgb: ImageSequence, depth: ImageSequence,
                 max_dt: float = 0.02):
        ds = np.asarray(depth.stamps)
        stamps, rp, dp = [], [], []
        for t, p in zip(rgb.stamps, rgb.paths):
            j = int(np.argmin(np.abs(ds - t))) if len(ds) else -1
            if j >= 0 and abs(ds[j] - t) <= max_dt:
                stamps.append(t)
                rp.append(p)
                dp.append(depth.paths[j])
        self.stamps = stamps
        self.rgb_paths = rp
        self.depth_paths = dp

    def __len__(self):
        return len(self.stamps)

    def _read_depth(self, path):
        return png.read_raw(path)  # 16-bit depth kept raw

    def __iter__(self):
        for t, pr, pd in zip(self.stamps, self.rgb_paths, self.depth_paths):
            yield t, _read_gray(pr), self._read_depth(pd)

    def __getitem__(self, i):
        return (self.stamps[i], _read_gray(self.rgb_paths[i]),
                self._read_depth(self.depth_paths[i]))


def load_euroc_stereo(root: str) -> StereoSequence:
    """EuRoC cam0 (left) + cam1 (right). NOTE: raw EuRoC is unrectified —
    feed pre-rectified folders, or accept the small distortion error."""
    return StereoSequence(load_euroc(root, "cam0"), load_euroc(root, "cam1"))


def load_kitti_stereo(root: str) -> StereoSequence:
    """KITTI odometry grayscale stereo: image_0 (left) + image_1 (right),
    already rectified."""
    return StereoSequence(load_kitti(root, 0), load_kitti(root, 1))


def load_tum_rgbd(root: str) -> RgbdSequence:
    """TUM RGB-D: `rgb.txt` + `depth.txt` (16-bit png, factor 5000)."""
    rgb = load_tum(root)
    stamps, paths = [], []
    with open(os.path.join(root, "depth.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, p = line.split()[:2]
            stamps.append(float(t))
            paths.append(os.path.join(root, p))
    return RgbdSequence(rgb, ImageSequence(stamps, paths))


def load_groundtruth_tum(path: str):
    """TUM-style ground truth: `ts tx ty tz qx qy qz qw` per line.
    Returns (stamps [N], poses_cw [N,7] wxyz+t convention used internally)."""
    stamps, rows = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.replace(",", " ").split()]
            ts, tx, ty, tz, qx, qy, qz, qw = vals[:8]
            stamps.append(ts)
            rows.append([qw, qx, qy, qz, tx, ty, tz])
    if not rows:
        return np.asarray(stamps), np.zeros((0, 7))
    # file stores camera->world (T_wc); convert to T_cw wxyz-first, in f32
    T_wc = torch.as_tensor(np.asarray(rows, np.float32))
    return np.asarray(stamps), lie.se3_inv(T_wc).numpy()
