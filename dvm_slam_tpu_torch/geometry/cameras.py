"""Camera models: pinhole with radial-tangential keypoint undistortion, and
Kannala-Brandt-8 fisheye.

Port of `dvm_slam_tpu/geometry/cameras.py`. As in the reference, distortion
is removed from detected keypoints once per frame, so all downstream geometry
works on ideal pinhole coordinates: pinhole `K = [fx, fy, cx, cy]`, `dist =
[k1, k2, p1, p2, (k3)]`; KB8 `params = [fx, fy, cx, cy, k1, k2, k3, k4]`.
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


# --------------------------------------------------------------------------
# Kannala-Brandt 8 (fisheye)
# --------------------------------------------------------------------------

def _theta_poly(k, theta):
    t2 = theta * theta
    return theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))


def kb8_project(params, p):
    """KB8 projection (`KannalaBrandt8::project`): the theta-polynomial
    fisheye. Returns (uv [...,2], valid [...]), valid iff z > 1e-6."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r2 = x * x + y * y
    small = r2 < 1e-14
    r = torch.sqrt(torch.where(small, 1.0, r2))
    d = _theta_poly(params[4:8], torch.atan2(r, z))
    scale = torch.where(small, torch.zeros_like(r), d / r)
    # an on-axis point projects to the principal point
    u = torch.where(small, fx * 0 + cx, fx * x * scale + cx)
    v = torch.where(small, fy * 0 + cy, fy * y * scale + cy)
    return torch.stack([u, v], dim=-1), z > 1e-6


def kb8_unproject(params, uv, iters: int = 10):
    """Invert the theta polynomial by `iters` Newton steps
    (`KannalaBrandt8::unproject`). Returns the ray at z = 1, [...,3]."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k = params[4:8]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    d = torch.sqrt(torch.clamp(mx * mx + my * my, min=1e-18))
    theta_d = torch.clamp(d, -torch.pi / 2, torch.pi / 2)
    theta = theta_d
    for _ in range(iters):
        t2 = theta * theta
        f = _theta_poly(k, theta) - theta_d
        fp = 1.0 + t2 * (3 * k[0] + t2 * (5 * k[1] + t2 * (7 * k[2] + 9 * t2 * k[3])))
        theta = theta - f / torch.where(torch.abs(fp) < _EPS, _EPS, fp)
    scale = torch.where(d < 1e-9, 1.0, torch.tan(theta) / d)
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


# --------------------------------------------------------------------------
# dispatch by model name
# --------------------------------------------------------------------------

PINHOLE = "pinhole"
KB8 = "kb8"


def project(model: str, params, p):
    if model == PINHOLE:
        return pinhole_project(params[:4], p)
    if model == KB8:
        return kb8_project(params, p)
    raise ValueError(f"unknown camera model {model!r}")


def unproject(model: str, params, uv):
    if model == PINHOLE:
        return pinhole_unproject(params[:4], uv)
    if model == KB8:
        return kb8_unproject(params, uv)
    raise ValueError(f"unknown camera model {model!r}")


def intrinsic_matrix(params):
    """[..., fx fy cx cy ...] -> [..., 3, 3] K."""
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack([fx, z, cx, z, fy, cy, z, z, o], dim=-1).reshape(params.shape[:-1] + (3, 3))
