"""Stereo correspondence for rectified pairs, and the RGB-D depth lookup.

Port of `dvm_slam_tpu/ops/stereo.py` (`Frame::ComputeStereoMatches` and
`Frame::ComputeStereoFromRGBD`). The coarse stage is one masked dense
Hamming matrix (row band, disparity range, level band); the subpixel stage
slides an 11x11 SAD window +/-5 px over gathered image strips for every
match at once, then fits a parabola; a median pass drops outliers. The
reference computes all of it outside Pallas, so it stays PyTorch here.

The reference's constants: descriptor gate (TH_HIGH + TH_LOW) / 2 = 75, row
band 2 scale(level_r), disparity in (0, fx], level band +/-1, the parabola
rejected outside [-1, 1], the median gate 1.5 * 1.4 * median SAD. Gather
indices are clamped to the image explicitly (JAX clamps out-of-range
gathers silently), and the median is JAX's (the mean of the two middle
values of an even count).
"""

from __future__ import annotations

import torch

from . import matching

TH_ORB = (matching.TH_HIGH + matching.TH_LOW) // 2  # 75
_W = 5        # SAD half-window (11x11)
_SLIDE = 5    # +/- slide range


def _sad_refine_level(img_l, img_r, xl, yl, xr0, ok):
    """SAD subpixel refinement at one pyramid level. img_l/img_r [H,W] level
    images; xl, yl, xr0 [F] level coordinates (xr0: the coarse right x); ok
    [F] the rows to refine. Returns (inc [F], delta [F], sad_best [F], good
    [F])."""
    H, W = img_l.shape
    dev = img_l.device
    rxr0 = torch.round(xr0)
    ixl = torch.round(xl).to(torch.int64).clamp(_W, W - 1 - _W)
    iyl = torch.round(yl).to(torch.int64).clamp(_W, H - 1 - _W)
    ixr = rxr0.to(torch.int64).clamp(_W + _SLIDE, W - 1 - _W - _SLIDE)

    dw = torch.arange(-_W, _W + 1, device=dev)
    rows = (iyl[:, None, None] + dw[None, :, None]).clamp(0, H - 1)
    patch_l = img_l[rows, (ixl[:, None, None] + dw[None, None, :]).clamp(0, W - 1)]  # [F,11,11]
    patch_l = patch_l - patch_l[:, _W, _W][:, None, None]        # centre-normalized
    ds = torch.arange(-_W - _SLIDE, _W + _SLIDE + 1, device=dev)
    strip = img_r[rows, (ixr[:, None, None] + ds[None, None, :]).clamp(0, W - 1)]   # [F,11,21]
    strip = strip - strip[:, _W, _W + _SLIDE][:, None, None]
    # the windows at each slide offset: [F, 11 (slide), 11, 11]
    wins = strip.unfold(2, 2 * _W + 1, 1).permute(0, 2, 1, 3)
    sad = torch.sum(torch.abs(patch_l[:, None] - wins), dim=(2, 3))  # [F,11]
    best = torch.argmin(sad, dim=1)                                  # the first minimum
    sad_best = torch.gather(sad, 1, best[:, None])[:, 0]
    # a parabola over (best-1, best, best+1); hits at the slide's ends are rejected
    interior = (best > 0) & (best < 2 * _SLIDE)
    bi = best.clamp(1, 2 * _SLIDE - 1)[:, None]
    d_m1 = torch.gather(sad, 1, bi - 1)[:, 0]
    d_0 = torch.gather(sad, 1, bi)[:, 0]
    d_p1 = torch.gather(sad, 1, bi + 1)[:, 0]
    denom = 2.0 * (d_m1 + d_p1 - 2.0 * d_0)
    delta = torch.where(torch.abs(denom) > 1e-9, (d_m1 - d_p1) / denom, 2.0)
    good = interior & (delta >= -1.0) & (delta <= 1.0) & ok
    # the shift the clamp applied to ixr
    inc = (best - _SLIDE).to(torch.float32) + (ixr.to(torch.float32) - rxr0)
    return inc, torch.where(good, delta, 0.0), sad_best, good


def coarse_matches(xy_l, level_l, desc_l, valid_l, xy_r, level_r, desc_r, valid_r, fx,
                   s_r):
    """The coarse stage: each left keypoint's best right descriptor within
    the row band 2 scale(level_r), a disparity in (0, fx] and the level band
    +/-1, at most TH_ORB bits away. Returns (right index [F], -1 where none;
    ok [F])."""
    dist = matching.hamming_matrix(desc_l, desc_r)
    row_band = torch.abs(xy_l[:, 1:2] - xy_r[None, :, 1]) <= 2.0 * s_r[None, :]
    disp = xy_l[:, 0:1] - xy_r[None, :, 0]
    disp_ok = (disp > 0.0) & (disp <= fx)            # minZ = b -> maxD = fx
    lvl_ok = torch.abs(level_l[:, None] - level_r[None, :]) <= 1
    mask = row_band & disp_ok & lvl_ok & valid_l[:, None] & valid_r[None, :]
    ridx, _, ok = matching.masked_best_match(dist, mask, TH_ORB)
    return ridx, ok


def compute_stereo_matches(xy_l, level_l, desc_l, valid_l, xy_r, level_r, desc_r, valid_r,
                           pyr_l, pyr_r, fx, baseline, scale_factor: float = 1.2,
                           n_levels: int = 8):
    """Rectified-stereo correspondence (`Frame::ComputeStereoMatches`).
    xy_* are level-0 raw pixel coordinates; pyr_l / pyr_r the level images
    of both views (the extraction's pyramid). Returns (u_right [F], depth
    [F]) in level-0 pixels and world units, -1 where there is no match."""
    from ..mapping.local_mapping import _nanmedian

    dev = xy_l.device
    F = xy_l.shape[0]
    bf = fx * baseline
    scales = torch.tensor([scale_factor ** i for i in range(n_levels)], dtype=torch.float32,
                          device=dev)
    lvl_l = level_l.to(torch.int64)
    s_l = scales[lvl_l.clamp(0, n_levels - 1)]
    s_r = scales[level_r.to(torch.int64).clamp(0, n_levels - 1)]

    ridx, ok = coarse_matches(xy_l, level_l, desc_l, valid_l, xy_r, level_r, desc_r, valid_r,
                              fx, s_r)
    ur0_l0 = xy_r[ridx.clamp(min=0), 0]                # coarse uR, level-0 px

    # ---- subpixel: the SAD slide at the left keypoint's level -------------
    inc_all = torch.zeros((F,), dtype=torch.float32, device=dev)
    delta_all = torch.zeros((F,), dtype=torch.float32, device=dev)
    sad_all = torch.full((F,), torch.inf, dtype=torch.float32, device=dev)
    good_all = torch.zeros((F,), dtype=torch.bool, device=dev)
    for lv in range(n_levels):
        here = ok & (lvl_l == lv)
        s = scales[lv]   # a tensor divisor: CUDA turns a Python-scalar divisor into a reciprocal
        inc, delta, sad, good = _sad_refine_level(pyr_l[lv], pyr_r[lv], xy_l[:, 0] / s,
                                                  xy_l[:, 1] / s, ur0_l0 / s, here)
        inc_all = torch.where(here, inc, inc_all)
        delta_all = torch.where(here, delta, delta_all)
        sad_all = torch.where(here, sad, sad_all)
        good_all = torch.where(here, good, good_all)

    u_right = ur0_l0 + s_l * (inc_all + delta_all)
    disparity = xy_l[:, 0] - u_right
    good = good_all & (disparity > 0.0) & (disparity <= fx)
    u_right = torch.where(good, u_right, -1.0)

    # ---- the median outlier pass ----------------------------------------
    med = _nanmedian(torch.where(good, sad_all, torch.nan))
    med = torch.where(torch.isfinite(med), med, 0.0)
    keep = good & (sad_all < 1.5 * 1.4 * med + 1e-6)
    u_right = torch.where(keep, u_right, -1.0)
    depth = torch.where(keep, bf / torch.clamp(xy_l[:, 0] - u_right, min=1e-6), -1.0)
    return u_right, depth


def compute_stereo_from_rgbd(xy_raw, valid, depth_map, bf, depth_factor):
    """Sample the registered depth image at each (raw) keypoint and
    synthesize the virtual right coordinate uR = u - bf/d. depth_map in sensor
    units; depth_factor scales to meters. Returns (u_right [F], depth [F]),
    -1 where depth is missing."""
    H, W = depth_map.shape
    xi = torch.round(xy_raw[:, 0]).to(torch.int64).clamp(0, W - 1)
    yi = torch.round(xy_raw[:, 1]).to(torch.int64).clamp(0, H - 1)
    d = depth_map[yi, xi].to(torch.float32) * depth_factor
    ok = valid & (d > 0.0)
    u_right = torch.where(ok, xy_raw[:, 0] - bf / torch.clamp(d, min=1e-6), -1.0)
    return u_right, torch.where(ok, d, -1.0)
