"""Keypoint orientation (intensity centroid) + steered rBRIEF descriptors.

Port of `dvm_slam_tpu/ops/orb_descriptor.py`. The sampling pattern is the
same numpy recipe from the same seed, so both packages test the same pixel
pairs. Descriptors stay unpacked: [N, 256] uint8 in {0,1}.

`orient_and_describe` (one level) and `orient_and_describe_levels` (a frame)
here are the plain PyTorch twin of the CUDA kernel in `ops/orb_kernel.py`
(`csrc/orb_describe.cu`). Twin and kernel compute every float in the same
order, so on the card they agree bit for bit:

* the moments are summed in the order of 256 threads: thread t adds the
  patch elements t, t+256, t+512, t+768 in turn, then a pairwise tree halves
  the 256 partial sums (`_thread_tree_sum`); the kernel's warp plays the 256
  threads, lane l as threads l + 32j;
* every multiply and add is rounded on its own (eager PyTorch fuses nothing;
  the kernel is compiled without FMA contraction);
* rotated offsets round half to even (`torch.round`, `rintf` in CUDA).

Against the JAX package the moments differ only in summation order (f32
ulps), which moves the angle by far less than 1e-4 and flips a descriptor bit
only when a rotated offset lands within an ulp of a .5 boundary.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

PATCH_SIZE = 31
HALF_PATCH = 15
DESC_BITS = 256
THREADS = 256  # threads of the moments' summation order = descriptor bits

_PATTERN_SEED = 20240131  # the reference's framework-wide seed


def _make_pattern():
    """[256, 4] int32 (x1, y1, x2, y2), Gaussian sigma=patch/5, |coord|<=13."""
    rs = np.random.RandomState(_PATTERN_SEED)
    sigma = PATCH_SIZE / 5.0
    return np.clip(np.round(rs.randn(DESC_BITS, 4) * sigma), -13, 13).astype(np.int32)


PATTERN = _make_pattern()


def _circular_mask_rows():
    """Boolean [31,31] circular mask of radius HALF_PATCH."""
    r = HALF_PATCH
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    return (x * x + y * y) <= r * r + 1


_CIRC_MASK = _circular_mask_rows()


@functools.lru_cache(maxsize=16)
def _consts_on(device: torch.device, dtype: torch.dtype):
    """(pattern [256,4], flat circular mask, flat row offsets, flat column
    offsets) on `device`, uploaded once: an upload per call would make the
    host wait for the device."""
    r = HALF_PATCH
    d = torch.arange(-r, r + 1, dtype=dtype)
    ys = d[:, None].expand(PATCH_SIZE, PATCH_SIZE).reshape(-1)
    xs = d[None, :].expand(PATCH_SIZE, PATCH_SIZE).reshape(-1)
    mask = torch.from_numpy(_CIRC_MASK.reshape(-1)).to(dtype)
    pattern = torch.from_numpy(PATTERN).to(dtype)
    return tuple(t.to(device) for t in (pattern, mask, ys, xs))


def _round_i32(x):
    return torch.round(x).to(torch.int32)


def _gather_patches(img, xy, size: int):
    """[N, size, size] patches around the rounded keypoints, centres clamped
    so every read is in-bounds (valid keypoints lie >= 16 px inside, so the
    clamp only moves invalid slots)."""
    h, w = img.shape
    half = size // 2
    cx = _round_i32(xy[:, 0]).clamp(half, w - half - 1)
    cy = _round_i32(xy[:, 1]).clamp(half, h - half - 1)
    d = torch.arange(-half, half + 1, device=img.device, dtype=torch.int32)
    rows = cy[:, None, None] + d[None, :, None]
    cols = cx[:, None, None] + d[None, None, :]
    return img[rows.long(), cols.long()]


def _thread_tree_sum(terms):
    """Sum [N, L] (L <= 4*THREADS) over L in the CUDA kernel's order."""
    n, L = terms.shape
    slots = -(-L // THREADS)
    padded = torch.nn.functional.pad(terms, (0, slots * THREADS - L)).reshape(n, slots, THREADS)
    acc = torch.zeros((n, THREADS), dtype=terms.dtype, device=terms.device)
    for s in range(slots):
        acc = acc + padded[:, s]
    width = THREADS
    while width > 1:
        width //= 2
        acc = acc[:, :width] + acc[:, width:2 * width]
    return acc[:, 0]


def moments(img, xy):
    """Intensity-centroid moments (m01, m10) per keypoint (`IC_Angle`).

    img: raw (unblurred) pyramid level [H,W]; xy: [N,2] level coords."""
    patches = _gather_patches(img, xy, PATCH_SIZE).reshape(xy.shape[0], PATCH_SIZE * PATCH_SIZE)
    _, mask, ys, xs = _consts_on(img.device, img.dtype)
    pm = patches * mask
    return _thread_tree_sum(pm * ys), _thread_tree_sum(pm * xs)


def _dir_from_moments(m01, m10):
    """Unit steering direction (ca, sa) straight from the moments — the
    algebraic form of (cos(atan2), sin(atan2)) that the reference and the
    kernel both use."""
    rlen = torch.sqrt(m01 * m01 + m10 * m10)
    safe = rlen > 1e-9
    inv = torch.where(safe, 1.0 / torch.where(safe, rlen, 1.0), 0.0)
    return torch.where(safe, m10 * inv, 1.0), torch.where(safe, m01 * inv, 0.0)


def descriptors(img_blur, xy, ca, sa):
    """Steered rBRIEF: [N,256] uint8 bits in {0,1}.

    Pattern offsets are rotated by the keypoint direction (ca, sa) from
    `_dir_from_moments` and rounded half to even; samples outside the image
    are clamped to its edge."""
    h, w = img_blur.shape
    pat = _consts_on(img_blur.device, img_blur.dtype)[0]
    ca, sa = ca[:, None], sa[:, None]
    cx = _round_i32(xy[:, 0])[:, None]
    cy = _round_i32(xy[:, 1])[:, None]

    def sample(px, py):
        # row offset = round(x sin + y cos), col offset = round(x cos - y sin)
        rx = _round_i32(px[None, :] * ca - py[None, :] * sa)
        ry = _round_i32(px[None, :] * sa + py[None, :] * ca)
        c = (cx + rx).clamp(0, w - 1)
        r = (cy + ry).clamp(0, h - 1)
        return img_blur[r.long(), c.long()]

    v1 = sample(pat[:, 0], pat[:, 1])
    v2 = sample(pat[:, 2], pat[:, 3])
    return (v1 < v2).to(torch.uint8)


def orient_and_describe(img_raw, img_blur, xy):
    """Plain twin of the K1 kernel on one level: (angle [N] f32, desc [N,256]
    uint8)."""
    m01, m10 = moments(img_raw, xy)
    ca, sa = _dir_from_moments(m01, m10)
    return torch.atan2(m01, m10), descriptors(img_blur, xy, ca, sa)


def orient_and_describe_levels(raws, blurs, xy, offsets):
    """Plain twin of the K1 kernel on a whole frame: level l's keypoints are
    `xy[offsets[l]:offsets[l+1]]` on `raws[l]` / `blurs[l]`. Returns the
    frame's (angle [F] f32, desc [F,256] uint8), levels in order."""
    outs = [orient_and_describe(raw, blur, xy[a:b])
            for raw, blur, a, b in zip(raws, blurs, offsets[:-1], offsets[1:])]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
