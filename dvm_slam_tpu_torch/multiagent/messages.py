"""Typed inter-agent message schema.

One-to-one with the reference's ROS 2 IDL (`src/interfaces/msg/*.msg`,
`srv/*.srv` — see SURVEY.md §2.2): same channel names, same payloads, with
boost-serialized maps replaced by `codec.MapPacket` blobs and DDS replaced by
a pluggable transport (loopback in-process, or any byte pipe).

UUIDs travel as (hi, lo) uint64 pairs == the reference's 16-byte
`Uuid.msg`.

A copy of `dvm_slam_tpu/multiagent/messages.py`, line for line: the port imports
nothing of the JAX package, and the two copies keep the wire identical.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

Uuid = Tuple[int, int]


def uuid_key(u) -> Uuid:
    a = np.asarray(u, np.uint64).reshape(2)
    return (int(a[0]), int(a[1]))


@dataclasses.dataclass
class Sim3Transform:
    """`Sim3Transform.msg`: quaternion + translation + scale."""
    q: np.ndarray   # [4] wxyz
    t: np.ndarray   # [3]
    s: float

    def as_sim3(self):
        return np.concatenate([self.q, self.t, [self.s]]).astype(np.float32)

    @staticmethod
    def from_sim3(S):
        S = np.asarray(S)
        return Sim3Transform(q=S[0:4].copy(), t=S[4:7].copy(), s=float(S[7]))


@dataclasses.dataclass
class KeyFrameBowVector:
    """`KeyFrameBowVector.msg`: sparse BoW of one keyframe."""
    uuid: Uuid
    keys: np.ndarray    # [n] int64 word ids
    values: np.ndarray  # [n] float64 weights


@dataclasses.dataclass
class NewKeyFrameBows:
    """`NewKeyFrameBows.msg` topic payload."""
    sender_agent_id: int
    bows: List[KeyFrameBowVector]


@dataclasses.dataclass
class NewKeyFrames:
    """`NewKeyFrames.msg`: incremental keyframe+point sharing (post-merge)."""
    sender_agent_id: int
    serialized_map: bytes
    reference_key_frame_uuid: Optional[Uuid] = None
    next_reference_key_frame_uuid: Optional[Uuid] = None


@dataclasses.dataclass
class SuccessfullyMerged:
    """`SuccessfullyMerged.msg` broadcast."""
    sender_agent_id: int
    receiver_agent_id: int
    successfully_merged: bool
    implicit_merge: bool = False
    merged_key_frame_uuids: List[Uuid] = dataclasses.field(default_factory=list)
    all_key_frames_in_map: List[Uuid] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class MapToAttemptMerge:
    """`MapToAttemptMerge.msg`: full own-KF map pushed to a peer."""
    sender_agent_id: int
    serialized_map: bytes
    merge_candidate_key_frame_uuids: List[Uuid] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class IsLostFromBaseMap:
    """`IsLostFromBaseMap.msg`."""
    sender_agent_id: int
    is_lost: bool


@dataclasses.dataclass
class LoopClosureTriggers:
    """`LoopClosureTriggers.msg`."""
    sender_agent_id: int
    trigger_key_frame_uuids: List[Uuid]


@dataclasses.dataclass
class ChangeCoordinateFrame:
    """`ChangeCoordinateFrame.msg`: re-root an agent group's frame."""
    sender_agent_id: int
    parent_agent_id: int
    transform: Sim3Transform


@dataclasses.dataclass
class GetCurrentMapRequest:
    """`GetCurrentMap.srv` request."""
    sender_agent_id: int
    merge_candidate_key_frame_uuids: List[Uuid]


@dataclasses.dataclass
class GetCurrentMapResponse:
    sender_agent_id: int
    serialized_map: bytes
    merge_candidate_key_frame_uuids: List[Uuid]


@dataclasses.dataclass
class GetMapPointsRequest:
    """`GetMapPoints.srv` request (empty in the reference)."""
    sender_agent_id: int


@dataclasses.dataclass
class GetMapPointsResponse:
    uuids: np.ndarray      # [n,2] uint64
    positions: np.ndarray  # [n,3] float32


# channel names, mirroring the reference topic set (peer.cpp:15-31)
CH_NEW_KEY_FRAMES = "new_key_frames"
CH_NEW_KEY_FRAME_BOWS = "new_key_frame_bows"
CH_SUCCESSFULLY_MERGED = "successfully_merged"
CH_IS_LOST = "is_lost_from_base_map"
CH_LOOP_CLOSURE_TRIGGERS = "loop_closure_triggers"
CH_CHANGE_COORDINATE_FRAME = "change_coordinate_frame"
CH_MAP_TO_ATTEMPT_MERGE = "map_to_attempt_merge"
SRV_GET_CURRENT_MAP = "get_current_map"
SRV_GET_MAP_POINTS = "get_map_points"
