"""RANSAC Sim(3) solver between two keyframes from matched map points.

Port of `dvm_slam_tpu/loopclosing/sim3_solver.py` (`Sim3Solver`): Horn's
closed form on 3-point minimal sets, verified by two-way reprojection (chi2
9.210 x level variance per direction), every hypothesis solved and verified
in one batched pass. Inputs are map points in each keyframe's camera frame,
so the result S12 maps camera-2 coordinates to camera-1 coordinates.

The random draws are an input: the Gumbel noise [iters, N] that the
reference draws from a key.
"""

from __future__ import annotations

import torch

from ..geometry import alignment, lie
from ..geometry.two_view import sample_indices

CHI2_2D_99 = 9.210
ITERS = 300


def _project(p, K):
    z = torch.clamp(p[..., 2], min=1e-9)
    return torch.stack([K[0] * p[..., 0] / z + K[2], K[1] * p[..., 1] / z + K[3]], -1)


def _check(S12, pc1, pc2, uv1, uv2, sigma2_1, sigma2_2, mask, K):
    """Two-way reprojection inliers of hypotheses S12 [...,8]: ([...] count,
    [...,N] inliers)."""
    S21 = lie.sim3_inv(S12)
    p2in1 = lie.sim3_apply(S12[..., None, :], pc2)
    p1in2 = lie.sim3_apply(S21[..., None, :], pc1)
    e1 = torch.sum((_project(p2in1, K) - uv1) ** 2, -1)
    e2 = torch.sum((_project(p1in2, K) - uv2) ** 2, -1)
    inl = (mask & (e1 < CHI2_2D_99 * sigma2_1) & (e2 < CHI2_2D_99 * sigma2_2)
           & (p2in1[..., 2] > 0) & (p1in2[..., 2] > 0))
    return torch.sum(inl, dim=-1), inl


def ransac_sim3(noise, pc1, pc2, uv1, uv2, sigma2_1, sigma2_2, mask, K,
                with_scale: bool = True):
    """noise: [I,N] Gumbel noise, one row per hypothesis; pc1, pc2: [N,3]
    matched map points in camera-1 / camera-2 frames; uv1, uv2: [N,2] their
    keypoints; sigma2_1, sigma2_2: [N] level variances; mask: [N] valid
    matches; K: [4]. Returns (S12 [8], inliers [N] bool, n_inliers)."""
    idx = sample_indices(noise, mask, 3)                            # [I,3]
    hyps = alignment.horn_sim3(pc2[idx], pc1[idx], with_scale=with_scale)   # [I,8]
    counts, inls = _check(hyps, pc1, pc2, uv1, uv2, sigma2_1, sigma2_2, mask, K)
    best = torch.argmax(counts)
    inl = inls[best]
    # refit on the inliers with the full closed form, kept if no worse
    S = alignment.umeyama(pc2, pc1, mask=inl.to(pc1.dtype), with_scale=with_scale)
    n_ref, inl_ref = _check(S, pc1, pc2, uv1, uv2, sigma2_1, sigma2_2, mask, K)
    better = n_ref >= counts[best]
    return (torch.where(better, S, hyps[best]), torch.where(better, inl_ref, inl),
            torch.maximum(n_ref, counts[best]))
