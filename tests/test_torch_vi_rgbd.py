"""The port's IMU-RGB-D `System` stepped against the JAX `System`: the
VI scene of `tests/test_torch_vi_system.py` with the rendered depth in
meters (depth_map_factor 1) and a virtual baseline of 0.2 m, 34 frames
along the 34-frame trajectory of `test_imu_stereo_end_to_end`. Held as
`lockstep` holds a depth sensor: per call the same state, IMU flag and
keyframe count, poses within 1e-3 before the IMU-init call and 1e-2
after; the same chain and preintegration windows at the end; a metric
live trajectory (path-length ratio in [0.8, 1.25])."""

import os
import sys

import numpy as np
import torch

import jax.numpy as jnp

from dvm_slam_tpu.geometry import lie as jlie

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_vi_system import (POSE_ATOL_DEPTH, POSE_ATOL_POST,  # noqa: E402
                                  assert_chains_agree, lockstep)

torch.set_num_threads(2)


def test_imu_rgbd_steps_with_reference():
    sj, st, log = lockstep("imu-rgbd", 34, 34)
    assert log["init_at"] is not None, "the IMU never initialized"
    assert log["worst_pre"] <= POSE_ATOL_DEPTH, log["diffs"]
    assert log["worst_post"] <= POSE_ATOL_POST, log["diffs"]
    assert st.get_tracking_state() == "OK"
    assert_chains_agree(sj, st)
    idx = sorted(log["poses"])
    est = np.stack([np.asarray(jlie.se3_t(jlie.se3_inv(jnp.asarray(log["poses"][i]))))
                    for i in idx])
    gt = np.stack([np.asarray(jlie.se3_t(jlie.se3_inv(jnp.asarray(log["gt"][i]))))
                   for i in idx])
    ratio = np.linalg.norm(np.diff(est, axis=0), axis=1).sum() / \
        np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    assert 0.8 < ratio < 1.25, ratio
