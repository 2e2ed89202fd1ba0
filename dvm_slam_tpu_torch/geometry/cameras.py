"""Pinhole camera with radial-tangential keypoint undistortion.

Port of the pinhole part of `dvm_slam_tpu/geometry/cameras.py` (KB8 fisheye
waits for the sensor-mode slice). As in the reference, distortion is removed
from detected keypoints once per frame, so all downstream geometry works on
ideal pinhole coordinates. `K = [fx, fy, cx, cy]`, `dist = [k1, k2, p1, p2,
(k3)]`.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def pinhole_project(K, p):
    """Project camera-frame points `p [...,3]`. Returns (uv [...,2], valid
    [...] bool), valid iff depth > 0."""
    z = p[..., 2]
    zs = torch.where(torch.abs(z) < _EPS, _EPS, z)
    u = K[..., 0] * p[..., 0] / zs + K[..., 2]
    v = K[..., 1] * p[..., 1] / zs + K[..., 3]
    return torch.stack([u, v], dim=-1), z > _EPS


def pinhole_unproject(K, uv):
    """Pixel [...,2] -> normalized ray at z=1, [...,3]."""
    x = (uv[..., 0] - K[..., 2]) / K[..., 0]
    y = (uv[..., 1] - K[..., 3]) / K[..., 1]
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def _radtan_coeffs(dist):
    k3 = dist[4] if dist.shape[-1] > 4 else torch.zeros_like(dist[0])
    return dist[0], dist[1], dist[2], dist[3], k3


def radtan_distort(dist, xy):
    """Apply [k1,k2,p1,p2,(k3)] distortion to normalized coords [...,2]."""
    k1, k2, p1, p2, k3 = _radtan_coeffs(dist)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def radtan_undistort(dist, xy_d, iters: int = 10):
    """Invert radtan distortion by fixed-point iteration
    (cv::undistortPoints semantics)."""
    k1, k2, p1, p2, k3 = _radtan_coeffs(dist)
    xd, yd = xy_d[..., 0], xy_d[..., 1]
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        inv = 1.0 / torch.clamp(radial, min=_EPS)
        x, y = (xd - dx) * inv, (yd - dy) * inv
    return torch.stack([x, y], dim=-1)


def undistort_pixels(K, dist, uv, iters: int = 10):
    """Undistort pixel keypoints: distorted px -> ideal pinhole px."""
    xy_d = pinhole_unproject(K, uv)[..., :2]
    xy = radtan_undistort(dist, xy_d, iters)
    u = K[..., 0] * xy[..., 0] + K[..., 2]
    v = K[..., 1] * xy[..., 1] + K[..., 3]
    return torch.stack([u, v], dim=-1)
