"""Trajectory evaluation: ATE and RPE with Sim(3) alignment.

Port of `dvm_slam_tpu/eval/metrics.py`: `ate_rmse` aligns camera centers
with Umeyama (Sim3 by default) and takes the RMS of the residuals; `rpe` is
the translation RMSE over frame pairs a fixed delta apart. Poses come in as
numpy arrays or tensors on any device; the evaluation runs in f32 on the
CPU and returns numpy arrays and Python floats.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import alignment, lie


def _poses(poses_cw):
    if isinstance(poses_cw, torch.Tensor):
        return poses_cw.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(poses_cw, np.float32))


def camera_centers(poses_cw):
    """[N,7] (or [7]) world->camera SE3 -> [N,3] camera centers in world."""
    return lie.se3_t(lie.se3_inv(_poses(poses_cw))).numpy()


def ate_rmse(est_cw, gt_cw, correct_scale: bool = True):
    """Absolute trajectory error after Sim3 (or SE3) alignment.

    est_cw, gt_cw: [N,7] world->camera poses, aligned by index. Returns
    (rmse, aligned_est_centers [N,3], sim3 [8])."""
    est_c = torch.as_tensor(camera_centers(est_cw))
    gt_c = torch.as_tensor(camera_centers(gt_cw))
    S = alignment.umeyama(est_c, gt_c, with_scale=correct_scale)
    est_aligned = lie.sim3_apply(S[None], est_c).numpy()
    err = est_aligned - gt_c.numpy()
    rmse = float(np.sqrt(np.mean(np.sum(err * err, axis=-1))))
    return rmse, est_aligned, S.numpy()


def rpe(est_cw, gt_cw, delta: int = 1):
    """Relative pose error: translation RMSE over frame pairs `delta` apart."""
    est, gt = _poses(est_cw), _poses(gt_cw)
    n = est.shape[0] - delta
    if n <= 0:
        return 0.0
    de = lie.se3_mul(lie.se3_inv(est[delta:]), est[:n])
    dg = lie.se3_mul(lie.se3_inv(gt[delta:]), gt[:n])
    rel = lie.se3_mul(lie.se3_inv(dg), de)
    sq = torch.sum(lie.se3_t(rel) ** 2, dim=-1)
    return float(torch.sqrt(torch.mean(sq)))
