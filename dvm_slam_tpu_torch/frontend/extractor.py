"""ORB feature extraction: pyramid -> FAST -> orientation -> rBRIEF.

Port of `dvm_slam_tpu/frontend/extractor.py`: monocular frames of a pinhole
or a KB8 fisheye camera, rectified stereo pairs and RGB-D frames. A
grayscale image becomes a fixed-capacity `Frame` of keypoints and unpacked
binary descriptors; invalid slots carry `valid=False`.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import NamedTuple, Optional

import torch

from ..geometry import cameras
from ..ops import fast, orb_descriptor, orb_kernel, pyramid, stereo
from ..utils import profiling


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Static extraction parameters. Defaults follow the reference's EuRoC
    settings: 1250 features, 8 levels x1.2, FAST thresholds 20 -> 7."""

    height: int
    width: int
    n_features: int = 1250
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th: float = 20.0
    min_th: float = 7.0
    cell: int = 35
    # kernel backend (the reference's `use_pallas`), for K1 here and for the
    # BA kernels K2/K3 of the mapper chain that `autonomous_step` runs:
    # None = the CUDA kernels for CUDA tensors, the plain versions for CPU
    # tensors; False = always the plain versions; True = always the kernels
    # (raises on the CPU)
    use_kernel: Optional[bool] = None

    @property
    def scales(self):
        return tuple(pyramid.level_scales(self.n_levels, self.scale_factor))

    @property
    def level_budgets(self):
        """Features per level, geometric in 1/scale (ORBextractor ctor
        semantics)."""
        f = 1.0 / self.scale_factor
        n = self.n_features
        raw = [n * (1 - f) / (1 - f ** self.n_levels) * (f ** i) for i in range(self.n_levels)]
        return tuple(max(8, int(round(r))) for r in raw)

    @property
    def capacity(self):
        return sum(self.level_budgets)

    @property
    def level_offsets(self):
        """Level l's keypoint slots are [level_offsets[l], level_offsets[l+1])."""
        return tuple(itertools.accumulate(self.level_budgets, initial=0))

    @property
    def sigma2(self):
        """Per-level variance of keypoint position, `mvLevelSigma2`."""
        return tuple(s * s for s in self.scales)


class Frame(NamedTuple):
    """Fixed-capacity feature set of one image; leading dim F =
    config.capacity. Stereo and RGB-D frames also carry `ur` (the right
    view's u, virtual for RGB-D; -1 mono) and `depth` (metric, -1 unknown);
    monocular frames leave them None."""

    xy: torch.Tensor        # [F,2] float32 undistorted keypoints, level-0 px
    xy_raw: torch.Tensor    # [F,2] float32 raw (distorted) keypoints, level-0 px
    level: torch.Tensor     # [F] int32 pyramid level
    angle: torch.Tensor     # [F] float32 orientation (radians)
    response: torch.Tensor  # [F] float32 FAST score
    desc: torch.Tensor      # [F,256] uint8 bits in {0,1}
    valid: torch.Tensor     # [F] bool
    ur: Optional[torch.Tensor] = None
    depth: Optional[torch.Tensor] = None

    @property
    def capacity(self):
        return self.xy.shape[-2]


def _orient_and_describe(raws, blurs, xy, offsets, use_kernel):
    if use_kernel is False:
        return orb_descriptor.orient_and_describe_levels(raws, blurs, xy, offsets)
    if use_kernel and xy.device.type != "cuda":
        raise ValueError(f"use_kernel=True needs CUDA tensors, got {xy.device}")
    return orb_kernel.orient_and_describe_levels(raws, blurs, xy, offsets)


@functools.lru_cache(maxsize=16)
def _slot_consts(budgets, scales, device):
    """(level [F] int32, scale [F,1] float32) of every keypoint slot, on
    `device` once: an upload per frame would make the host wait."""
    lvl = torch.cat([torch.full((b,), lv, dtype=torch.int32) for lv, b in enumerate(budgets)])
    scale = torch.cat([torch.full((b, 1), s, dtype=torch.float32) for b, s in zip(budgets, scales)])
    return lvl.to(device), scale.to(device)


def _detect(img, config: FrontendConfig):
    """Pyramid and each level's blur, then FAST per level: (raws, blurs, xy
    [F,2] in level px, score [F], valid [F]), each level contiguous for K1."""
    img = img.to(torch.float32)
    with profiling.span("frontend.pyramid"):
        levels = pyramid.build_pyramid(img, config.n_levels, config.scale_factor)
        raws = [im.contiguous() for im in levels]
        blurs = [pyramid.gaussian_blur(im).contiguous() for im in levels]
    with profiling.span("frontend.fast"):
        dets = [fast.detect_level(im, config.ini_th, config.min_th, config.cell, budget)
                for im, budget in zip(levels, config.level_budgets)]
    xys, scores, valids = zip(*dets)
    return raws, blurs, torch.cat(xys), torch.cat(scores), torch.cat(valids)


def _frame(xy_lv, score, valid, ang, desc, config: FrontendConfig):
    lvl, scale = _slot_consts(config.level_budgets, config.scales, xy_lv.device)
    xy = xy_lv * scale  # level px -> level-0 px, the f32 product `xy * s` of each level
    return Frame(xy=xy, xy_raw=xy, level=lvl.clone(), angle=ang, response=score, desc=desc,
                 valid=valid)


def extract(img, config: FrontendConfig):
    """Grayscale [H,W] (0..255, any dtype) -> Frame with keypoints in RAW
    px; `make_frame` undistorts them. FAST and the blur run per level, then
    one K1 call describes the whole frame."""
    raws, blurs, xy_lv, score, valid = _detect(img, config)
    ang, desc = _orient_and_describe(raws, blurs, xy_lv, config.level_offsets, config.use_kernel)
    return _frame(xy_lv, score, valid, ang, desc, config)


def extract_batch(imgs, config: FrontendConfig):
    """A frames [A,H,W] -> A Frames equal to A `extract` calls, bit for bit.
    Each frame's pyramid, FAST and blur run in turn; then ONE K1 call
    describes every frame's levels (A x n_levels entries of the level table,
    at most `orb_kernel.MAX_LEVELS`), and its rows are split back per frame."""
    dets = [_detect(img, config) for img in imgs]
    F = config.capacity
    offsets = [0] + [a * F + o for a in range(len(dets)) for o in config.level_offsets[1:]]
    raws = [r for d in dets for r in d[0]]
    blurs = [b for d in dets for b in d[1]]
    ang, desc = _orient_and_describe(raws, blurs, torch.cat([d[2] for d in dets]), offsets,
                                     config.use_kernel)
    return [_frame(xy_lv, score, valid, ang[a * F:(a + 1) * F], desc[a * F:(a + 1) * F], config)
            for a, (_, _, xy_lv, score, valid) in enumerate(dets)]


def _undistort_frame(f: Frame, K, dist, camera_model: str = "pinhole"):
    """Ideal pinhole keypoints from the raw ones: radial-tangential
    undistortion, or for "kb8" the fisheye keypoints rectified onto the
    pinhole with the same (fx, fy, cx, cy) (`kb8_unproject`, then pinhole
    projection; `dist` holds k1..k4)."""
    if camera_model == "kb8":
        rays = cameras.kb8_unproject(torch.cat([K[:4], dist[:4]]), f.xy_raw)
        xy_un, _ = cameras.pinhole_project(K[:4], rays)
    else:
        xy_un = cameras.undistort_pixels(K, dist, f.xy_raw)
    return f._replace(xy=torch.where(f.valid[:, None], xy_un, f.xy_raw))


@profiling.traced("frontend.make_frame")
def make_frame(img, K, dist, config: FrontendConfig, camera_model: str = "pinhole"):
    """Monocular frame (`Frame.cc:371`): extract, then undistort the
    keypoints ("pinhole": radial-tangential; "kb8": rectified fisheye
    keypoints, so every later stage stays pinhole)."""
    return _undistort_frame(extract(img, config), K, dist, camera_model)


def make_frame_stereo(img_l, img_r, K, dist, config: FrontendConfig, baseline):
    """Rectified stereo frame (`Frame.cc:149`): pyramid, FAST and the blur
    for each view, then ONE K1 call describes both views (a level table of
    2 x n_levels entries); the dense-Hamming + SAD correspondence
    (`ops/stereo.py`) gives each left keypoint its right u and depth. The
    left view's keypoints and descriptors make the frame. The pair is
    rectified, so `dist` applies to neither view (pass zeros)."""
    det_l, det_r = _detect(img_l, config), _detect(img_r, config)
    F = config.capacity
    offsets = list(config.level_offsets) + [F + o for o in config.level_offsets[1:]]
    ang, desc = _orient_and_describe(det_l[0] + det_r[0], det_l[1] + det_r[1],
                                     torch.cat([det_l[2], det_r[2]]), offsets,
                                     config.use_kernel)
    fl = _frame(*det_l[2:], ang[:F], desc[:F], config)
    fr = _frame(*det_r[2:], ang[F:], desc[F:], config)
    ur, depth = stereo.compute_stereo_matches(
        fl.xy_raw, fl.level, fl.desc, fl.valid, fr.xy_raw, fr.level, fr.desc, fr.valid,
        det_l[0], det_r[0], K[0], baseline, scale_factor=config.scale_factor,
        n_levels=config.n_levels)
    return _undistort_frame(fl, K, dist)._replace(ur=ur, depth=depth)


def make_frame_rgbd(img, depth_map, K, dist, config: FrontendConfig, bf,
                    depth_factor: float = 1.0):
    """RGB-D frame (`Frame.cc:265`): mono extraction + depth lookup at each
    keypoint, virtual right coordinate uR = u - bf/d (bf = fx * virtual
    baseline)."""
    f = extract(img, config)
    ur, depth = stereo.compute_stereo_from_rgbd(f.xy_raw, f.valid, depth_map, bf, depth_factor)
    return _undistort_frame(f, K, dist)._replace(ur=ur, depth=depth)
