"""Velocity -> robot command mapping.

Behavioral port of `src/motion_controller/motion_controller/helpers/driver.py`:
clamps speeds and maps a world/body velocity to the robot-type-specific twist
(the RoboMaster platform flips the y/z signs).

A copy of `dvm_slam_tpu/control/driver.py` (numpy only): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

ROBOMASTER = "robomaster"
SIM = "sim"
SIM_GROUND_TRUTH = "sim_ground_truth"


@dataclasses.dataclass
class Twist:
    linear_x: float = 0.0
    linear_y: float = 0.0
    angular_z: float = 0.0


class Driver:
    def __init__(self, robot_type: str = SIM, max_linear_speed=1.0,
                 max_angular_speed=1.0, send_fn=None):
        self.robot_type = robot_type
        self.max_linear_speed = max_linear_speed
        self.max_angular_speed = max_angular_speed
        self.send_fn = send_fn
        self.last_cmd = Twist()

    def drive(self, linear_velocity, angular_velocity: float = 0.0) -> Twist:
        v = np.asarray(linear_velocity, float)
        n = np.linalg.norm(v)
        if n > self.max_linear_speed:
            v = v * (self.max_linear_speed / n)
        w = float(np.clip(angular_velocity, -self.max_angular_speed,
                          self.max_angular_speed))
        if self.robot_type == ROBOMASTER:
            cmd = Twist(linear_x=v[0], linear_y=-v[1], angular_z=-w)
        else:  # sim variants use the direct convention
            cmd = Twist(linear_x=v[0], linear_y=v[1], angular_z=w)
        self.last_cmd = cmd
        if self.send_fn is not None:
            self.send_fn(cmd)
        return cmd
