"""Synthetic textured-plane world with exact ground-truth trajectories.

Port of `make_texture`, `PlaneWorld.render`, `PlaneWorld.render_depth`,
`PlaneWorld.render_stereo` and `smooth_trajectory` from `dvm_slam_tpu/io/synthetic.py`. The texture and the
plane layout come from the same numpy `RandomState` draws in the same order,
so both packages build the same world; rendering is z-buffered ray/plane
intersection with bilinear texture sampling, on the device the world lives
on.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import lie
from ..ops import pyramid


def make_texture(rng, size=1024, octaves=4):
    """Multi-octave value-noise texture with strong local contrast."""
    tex = np.zeros((size, size), np.float32)
    for o in range(octaves):
        s = 8 << o
        small = rng.rand(s, s).astype(np.float32)
        w = pyramid.resize_weights(s, size)
        tex += (w.T @ small) @ w * np.float32(0.5 ** o)
    tex -= tex.min()
    tex *= 255.0 / max(tex.max(), 1e-6)
    # sparse bright blobs => strong corners at all scales
    n_blob = size * size // 512
    ys = rng.randint(2, size - 3, n_blob)
    xs = rng.randint(2, size - 3, n_blob)
    amp = rng.rand(n_blob).astype(np.float32) * 120 - 60
    for y, x, a in zip(ys, xs, amp):
        tex[y - 2:y + 3, x - 2:x + 3] += a
    return np.clip(tex, 0, 255).astype(np.float32)


def _mod(x, y: float):
    """`jnp.mod` for floats: fmod, shifted into the divisor's sign."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


class PlaneWorld:
    """World of textured z-planes: a deep background plane plus bounded
    foreground patches at varying depth."""

    def __init__(self, seed=0, tex_size=1024, plane_z=6.0, extent=24.0,
                 n_patches=8, depth_range=(0.45, 0.90), spread=(0.5, 0.3),
                 patch_half=(0.04, 0.14), device=None):
        rng = np.random.RandomState(seed)
        self.texture = torch.from_numpy(make_texture(rng, tex_size)).to(device)
        self.tex_size = tex_size
        self.extent = extent
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        d_lo, d_hi = depth_range
        sx, sy = spread
        h_lo, h_hi = patch_half
        # planes: (z, xmin, xmax, ymin, ymax); first = unbounded background
        planes = [(plane_z, -extent, extent, -extent, extent)]
        for _ in range(n_patches):
            z = plane_z * (d_lo + (d_hi - d_lo) * rng.rand())
            cx = (rng.rand() - 0.5) * extent * sx
            cy = (rng.rand() - 0.5) * extent * sy
            half = extent * (h_lo + (h_hi - h_lo) * rng.rand())
            planes.append((z, cx - half, cx + half, cy - half, cy + half))
        self.planes = np.asarray(planes, np.float32)

    def _rays(self, T_cw, K, h, w):
        T_wc = lie.se3_inv(T_cw)
        c = lie.se3_t(T_wc)
        dev = self.device
        v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                              torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
        d_cam = torch.stack([(u - K[2]) / K[0], (v - K[3]) / K[1], torch.ones_like(u)], dim=-1)
        d_w = lie.quat_rotate(lie.se3_q(T_wc)[None, None], d_cam)
        dz = torch.where(torch.abs(d_w[..., 2]) < 1e-9, 1e-9, d_w[..., 2])
        return c, d_w, dz

    def _hits(self, T_cw, K, h, w):
        """Nearest plane hit per pixel: (t [h,w] (inf = none), world xy of
        the hit [h,w,2], plane index [h,w] f32)."""
        T_cw = torch.as_tensor(T_cw, dtype=torch.float32, device=self.device)
        K = torch.as_tensor(K, dtype=torch.float32, device=self.device)
        c, d_w, dz = self._rays(T_cw, K, h, w)
        best_t = torch.full((h, w), float("inf"), device=self.device)
        best_xy = torch.zeros((h, w, 2), device=self.device)
        best_pi = torch.zeros((h, w), device=self.device)
        for pi, (z, x0p, x1p, y0p, y1p) in enumerate(self.planes.tolist()):
            t = (float(np.float32(z)) - c[2]) / dz
            pw = c[None, None] + t[..., None] * d_w
            inside = ((t > 1e-3) & (pw[..., 0] >= x0p) & (pw[..., 0] <= x1p)
                      & (pw[..., 1] >= y0p) & (pw[..., 1] <= y1p))
            closer = inside & (t < best_t)
            best_t = torch.where(closer, t, best_t)
            best_xy = torch.where(closer[..., None], pw[..., :2], best_xy)
            best_pi = torch.where(closer, float(pi), best_pi)
        return best_t, best_xy, best_pi

    def render(self, T_cw, K, h: int, w: int):
        """Render a [h,w] f32 image from world->camera pose T_cw."""
        best_t, best_xy, best_pi = self._hits(T_cw, K, h, w)
        best_off = best_pi * 137.0  # texture offset per plane decorrelates patches
        hit = torch.isfinite(best_t)
        n = self.tex_size
        tx = (best_xy[..., 0] / self.extent + 0.5) * (n - 1) + best_off
        ty = (best_xy[..., 1] / self.extent + 0.5) * (n - 1) + best_off * 0.7
        tx = _mod(tx, n - 1.001)
        ty = _mod(ty, n - 1.001)
        x0 = torch.floor(tx).to(torch.int64)
        y0 = torch.floor(ty).to(torch.int64)
        fx = tx - x0
        fy = ty - y0
        tex = self.texture
        val = (
            tex[y0, x0] * (1 - fx) * (1 - fy)
            + tex[y0, x0 + 1] * fx * (1 - fy)
            + tex[y0 + 1, x0] * (1 - fx) * fy
            + tex[y0 + 1, x0 + 1] * fx * fy
        )
        return torch.where(hit, val, 0.0)

    def render_depth(self, T_cw, K, h: int, w: int):
        """Ray-traced z-depth map [h,w] (0 where no surface is hit): the ray
        parameter multiplies a unit-z camera direction, so it is the depth."""
        best_t, _, _ = self._hits(T_cw, K, h, w)
        return torch.where(torch.isfinite(best_t), best_t, 0.0)

    def render_stereo(self, T_cw, K, h: int, w: int, baseline: float):
        """Rectified stereo pair: the right camera is the left one moved by
        +baseline along its x-axis, T_cw_right = Trans(-b) o T_cw_left.
        Returns (img_l, img_r)."""
        T_cw = torch.as_tensor(T_cw, dtype=torch.float32, device=self.device)
        shift = torch.tensor([1.0, 0.0, 0.0, 0.0, -baseline, 0.0, 0.0], dtype=torch.float32,
                             device=self.device)
        return self.render(T_cw, K, h, w), self.render(lie.se3_mul(shift, T_cw), K, h, w)


def smooth_trajectory(n_frames: int, lateral=2.5, forward=1.0, yaw=0.15,
                      seed=1, z_amp=0.1):
    """Smooth camera trajectory (list of world->camera SE3 [7] numpy f32):
    a sideways arc with mild yaw and height variation."""
    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        cx = lateral * np.sin(s * np.pi)
        cy = z_amp * np.sin(2 * np.pi * s * 2)
        cz = forward * s
        yaw_i = yaw * np.sin(s * np.pi)
        q = lie.so3_exp(torch.tensor([0.0, yaw_i, 0.0], dtype=torch.float32))
        c = torch.tensor([cx, cy, cz], dtype=torch.float32)
        poses.append(lie.se3_inv(torch.cat([q, c])).numpy())
    return poses


def vi_trajectory(n_frames: int, fps: float = 10.0, imu_rate: float = 100.0, lateral=2.0,
                  forward=0.5, yaw=0.08, z_amp=0.1, g=(0.0, 0.0, -9.81)):
    """An analytic camera (= body) trajectory with exact IMU samples: the
    continuous-time `smooth_trajectory` sampled at the camera rate, and for
    each frame the IMU chunk (acc, gyro, dts) covering (t_{i-1}, t_i],
    derived from the same pose function by central differences in f64 (the
    rotations through the f32 Lie functions, as the reference's).

    Returns (poses_T_cw [N] of numpy [7], imu_chunks [N] of (acc [M,3],
    gyro [M,3], dts [M]) with chunk 0 empty, vel_w [N,3])."""
    g = np.asarray(g, np.float64)
    T_total = (n_frames - 1) / fps
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731

    def center(t):
        s = t / max(T_total, 1e-9)
        return np.array([lateral * np.sin(s * np.pi), z_amp * np.sin(4 * np.pi * s),
                         forward * s], np.float64)

    def rot_wc(t):   # body (= camera) -> world
        s = t / max(T_total, 1e-9)
        return np.asarray(lie.quat_to_matrix(lie.so3_exp(f32([0.0, yaw * np.sin(s * np.pi), 0.0]))),
                          np.float64)

    eps = 1e-4

    def vel(t):
        return (center(t + eps) - center(t - eps)) / (2 * eps)

    def acc_w(t):
        return (vel(t + eps) - vel(t - eps)) / (2 * eps)

    poses, chunks, vels = [], [], []
    dti = 1.0 / imu_rate
    for i in range(n_frames):
        t = i / fps
        q = lie.quat_from_matrix(f32(rot_wc(t)))
        poses.append(lie.se3_inv(torch.cat([q, f32(center(t))])).numpy())
        vels.append(vel(t).astype(np.float32))
        if i == 0:
            chunks.append((np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                           np.zeros((0,), np.float32)))
            continue
        tt = np.arange(t - 1.0 / fps, t - 1e-9, dti)
        accs, gyrs = [], []
        for tk in tt:
            R0, R1 = rot_wc(tk), rot_wc(tk + dti)
            w = np.asarray(lie.so3_log(lie.quat_from_matrix(f32(R0.T @ R1)))) / dti
            accs.append((R0.T @ (acc_w(tk) - g)).astype(np.float32))
            gyrs.append(w.astype(np.float32))
        chunks.append((np.stack(accs), np.stack(gyrs), np.full(len(tt), dti, np.float32)))
    return poses, chunks, np.stack(vels)
