"""Follow-the-leader P-controller.

Behavioral port of `src/motion_controller/motion_controller/follow_the_leader.py`:
the follower holds a position/rotation offset relative to the leader's pose
with proportional linear/angular gains and speed clamps (defaults match the
reference: gains 1.0, max speeds 1.0, rotation offset pi/2).

A copy of `dvm_slam_tpu/control/follow.py` (numpy only): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import numpy as np


class FollowTheLeader:
    def __init__(self, position_offset=(0.0, 0.0), rotation_offset=np.pi / 2,
                 linear_gain=1.0, angular_gain=1.0,
                 max_linear_speed=1.0, max_angular_speed=1.0):
        self.position_offset = np.asarray(position_offset, float)
        self.rotation_offset = rotation_offset
        self.linear_gain = linear_gain
        self.angular_gain = angular_gain
        self.max_linear_speed = max_linear_speed
        self.max_angular_speed = max_angular_speed

    def step(self, my_xy, my_yaw, leader_xy, leader_yaw):
        """Returns (v_xy [2] world-frame linear velocity, w yaw rate)."""
        # target = leader pose composed with the offset in the leader frame
        c, s = np.cos(leader_yaw), np.sin(leader_yaw)
        R = np.array([[c, -s], [s, c]])
        target_xy = np.asarray(leader_xy, float) + R @ self.position_offset
        target_yaw = leader_yaw + self.rotation_offset

        v = self.linear_gain * (target_xy - np.asarray(my_xy, float))
        n = np.linalg.norm(v)
        if n > self.max_linear_speed:
            v *= self.max_linear_speed / n
        dyaw = (target_yaw - my_yaw + np.pi) % (2 * np.pi) - np.pi
        w = np.clip(self.angular_gain * dyaw,
                    -self.max_angular_speed, self.max_angular_speed)
        return v, float(w)
