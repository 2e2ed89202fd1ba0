"""RGB-D keypoint depth (`Frame::ComputeStereoFromRGBD`).

Port of `compute_stereo_from_rgbd` from `dvm_slam_tpu/ops/stereo.py`; the
rectified-stereo SAD search of that module waits for the sensor-mode slice.
"""

from __future__ import annotations

import torch


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
