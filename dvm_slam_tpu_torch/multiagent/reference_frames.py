"""Sim(3) reference-frame tree.

Mirrors `ReferenceFrameManager` (`src/slam_system/include/reference_frame_manager.h`):
every agent starts with `world -> robotN/origin` (the reference initializes
it with a 90-degree rotation about x to map camera-z-forward onto world-up
conventions, `reference_frame_manager.h:5-15`); after a merge the loser
re-parents its origin under the winner's origin and composes
`world_to_origin = world_to_parent * parent_to_current`
(`reference_frame_manager.h:17-22`).

Port of `dvm_slam_tpu/multiagent/reference_frames.py`: the frames are [8]
numpy Sim3s, composed in f32 on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import lie


def _initial_world_to_origin():
    q = lie.so3_exp(torch.tensor([np.pi / 2, 0.0, 0.0], dtype=torch.float32))
    return torch.cat([q, torch.zeros(3), torch.ones(1)]).numpy()


class ReferenceFrameManager:
    def __init__(self, agent_id: int):
        self.agent_id = agent_id
        self.origin_frame = f"robot{agent_id}/origin"
        self.parent_frame = "world"
        self.world_to_origin = _initial_world_to_origin()  # Sim3 [8]

    def set_parent_frame(self, parent_agent_id: int, parent_to_current):
        """Re-parent after a merge: `parent_to_current` is the Sim3 taking
        this agent's (old) origin coordinates into the parent's origin
        coordinates... composed exactly like `setParentFrame`."""
        self.parent_frame = f"robot{parent_agent_id}/origin"
        self.world_to_origin = lie.sim3_mul(
            torch.as_tensor(np.asarray(self.world_to_origin, np.float32)),
            torch.as_tensor(np.asarray(parent_to_current, np.float32))).numpy()

    def tree(self):
        return {
            "frame": self.origin_frame,
            "parent": self.parent_frame,
            "world_to_origin": self.world_to_origin.tolist(),
        }
