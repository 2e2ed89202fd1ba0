"""Image pyramid + separable Gaussian blur.

Port of `dvm_slam_tpu/ops/pyramid.py`. Two choices keep the port on the
reference's numbers:

* The level resize is `jax.image.resize(..., "linear")`, which antialiases
  with a triangle kernel stretched by the scale when it downscales — it is
  not `F.interpolate`. `resize_weights` builds the same separable weight
  matrices in numpy (the recipe of JAX's `scale_and_translate`, f32), and
  `resize` applies them as two f32 matmuls.
* The blur copies the reference's edge-padded shift-multiply-add in f32
  rather than a convolution, whose TF32 and summation order would differ.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def level_scales(n_levels: int, scale_factor: float):
    """Per-level scale factors (level 0 = 1.0), like `mvScaleFactor`."""
    return [scale_factor ** i for i in range(n_levels)]


def level_shapes(h: int, w: int, n_levels: int, scale_factor: float):
    """Static (h, w) of each pyramid level (`cvRound(W/scale)` sizing)."""
    return [
        (int(round(h / s)), int(round(w / s)))
        for s in level_scales(n_levels, scale_factor)
    ]


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] f32 weights of JAX's linear (triangle) resize along one
    axis, antialiased when downscaling (`compute_weight_mat` semantics)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=64)
def _weights_on(n_in: int, n_out: int, device: str):
    return torch.from_numpy(resize_weights(n_in, n_out)).to(device)


def resize(img, h: int, w: int):
    """Linear (antialiased-down) resize of [H,W] f32 to [h,w]: rows first,
    then columns, as two f32 matmuls."""
    H, W = img.shape[-2:]
    dev = str(img.device)
    out = img
    if h != H:
        out = _weights_on(H, h, dev).T @ out
    if w != W:
        out = out @ _weights_on(W, w, dev)
    return out


def build_pyramid(img, n_levels: int, scale_factor: float):
    """Grayscale image [H,W] float32 -> list of n_levels tensors, each level
    resized from the previous one."""
    h, w = img.shape[-2], img.shape[-1]
    shapes = level_shapes(h, w, n_levels, scale_factor)
    levels = [img]
    for lv in range(1, n_levels):
        levels.append(resize(levels[-1], *shapes[lv]))
    return levels


def _gaussian_kernel1d(ksize: int, sigma: float):
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur with replicate padding, [...,H,W]: explicit
    f32 shifted multiply-adds, rows then columns."""
    k = _gaussian_kernel1d(ksize, sigma)
    r = ksize // 2
    h, w = img.shape[-2], img.shape[-1]
    dev = img.device
    rows = torch.arange(-r, h + r, device=dev).clamp(0, h - 1)
    xp = img[..., rows, :]
    out = torch.zeros_like(img)
    for i in range(ksize):
        out = out + float(k[i]) * xp[..., i:i + h, :]
    cols = torch.arange(-r, w + r, device=dev).clamp(0, w - 1)
    xp = out[..., cols]
    out = torch.zeros_like(img)
    for i in range(ksize):
        out = out + float(k[i]) * xp[..., i:i + w]
    return out
