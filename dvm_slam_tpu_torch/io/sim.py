"""Kinematic robot simulation in the synthetic world.

Replaces `src/webots_sim` (`webots_sim/robot_driver.py`): a velocity-driven
robot whose `cmd_vel` maps to world-frame velocity with z-only (yaw)
rotation (`robot_driver.py:25-80`), carrying a camera that renders the
textured world and publishing exact ground-truth poses — the no-hardware
multi-robot harness.

Port of `dvm_slam_tpu/io/sim.py`: the camera renders through the port's
`synthetic.PlaneWorld` on the device the world was built on (`PlaneWorld(...,
device="cuda")`), the poses come from the port's `geometry/lie`, and `step`
hands back host arrays as the reference's does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import lie
from . import synthetic


class SimRobot:
    """Planar robot: state (x, y, yaw); camera at height `cam_y`, looking +z
    into the textured world, panned by yaw (rotation about camera y)."""

    def __init__(self, world: synthetic.PlaneWorld, K, height: int, width: int,
                 start_xy=(0.0, 0.0), start_yaw: float = 0.0, cam_y: float = 0.0,
                 dt: float = 0.05):
        self.world = world
        self.K = torch.as_tensor(np.asarray(K, np.float32), device=world.device)
        self.h, self.w = height, width
        self.x, self.y = float(start_xy[0]), float(start_xy[1])
        self.yaw = float(start_yaw)
        self.cam_y = cam_y
        self.dt = dt
        self.t = 0.0
        self.cmd = (0.0, 0.0, 0.0)  # vx, vy (robot frame), wz

    def set_cmd_vel(self, vx: float, vy: float, wz: float = 0.0):
        self.cmd = (float(vx), float(vy), float(wz))

    def ground_truth_pose(self):
        """World->camera SE3 [7] (exact)."""
        q = lie.so3_exp(torch.tensor([0.0, self.yaw, 0.0], dtype=torch.float32))
        c = torch.tensor([self.x, self.cam_y + self.y, 0.0], dtype=torch.float32)
        return lie.se3_inv(torch.cat([q, c])).numpy()

    def step(self):
        """Advance one tick; returns (t, image [H,W] f32, gt_pose T_cw [7])."""
        vx, vy, wz = self.cmd
        # cmd_vel is in the robot frame; rotate by yaw only (z-rotation in
        # the reference's ground plane == our camera-y pan plane)
        c, s = np.cos(self.yaw), np.sin(self.yaw)
        self.x += (c * vx - s * vy) * self.dt
        self.y += (s * vx + c * vy) * self.dt
        self.yaw += wz * self.dt
        self.t += self.dt
        T_cw = self.ground_truth_pose()
        img = self.world.render(T_cw, self.K, self.h, self.w)
        return self.t, img.cpu().numpy(), T_cw


class SimulationServer:
    """Multi-robot stepping harness (`local_simulation_server.py` analog):
    owns N robots in one world and steps them in lockstep."""

    def __init__(self, world, K, height, width, starts, dt=0.05):
        self.robots = {
            i + 1: SimRobot(world, K, height, width, start_xy=xy,
                            start_yaw=yaw, dt=dt)
            for i, (xy, yaw) in enumerate(starts)
        }

    def set_cmd_vel(self, robot_id: int, vx, vy, wz=0.0):
        self.robots[robot_id].set_cmd_vel(vx, vy, wz)

    def step_all(self):
        return {rid: r.step() for rid, r in self.robots.items()}

    def positions(self):
        return {rid: (r.x, r.y) for rid, r in self.robots.items()}
