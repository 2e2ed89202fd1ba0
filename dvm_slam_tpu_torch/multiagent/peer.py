"""Per-remote-agent state: dedup sets, merge bookkeeping, lead-node logic.

Mirrors `Peer` (`src/slam_system/src/peer.cpp`, `include/peer.h`): the four
sent-uuid dedup sets (`peer.h:64-67`), the asymmetric successfully-merged
flags (`peer.h:70-72`), and `isLeadNodeInGroup` = lowest agentId among the
merged group (`peer.cpp:46-53`, `orb_slam3_wrapper.cpp:1238-1246`).

A copy of `dvm_slam_tpu/multiagent/peer.py`, line for line: the port imports
nothing of the JAX package, and the two copies keep the wire identical.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Set

from .messages import Uuid


@dataclasses.dataclass
class PeerState:
    agent_id: int
    # dedup sets (peer.h:64-67)
    sent_key_frame_uuids: Set[Uuid] = dataclasses.field(default_factory=set)
    sent_key_frame_bow_uuids: Set[Uuid] = dataclasses.field(default_factory=set)
    sent_loop_closure_trigger_uuids: Set[Uuid] = dataclasses.field(default_factory=set)
    sent_map_point_uuids: Set[Uuid] = dataclasses.field(default_factory=set)
    # merge state (asymmetric: we know what *we* merged and what they announce)
    successfully_merged: bool = False          # our map includes theirs
    remote_successfully_merged: bool = False   # they announced merging ours
    is_lost_from_base_map: bool = False
    # uuids of their keyframes known to be in the shared map
    known_key_frame_uuids: Set[Uuid] = dataclasses.field(default_factory=set)
    reference_key_frame_uuid: Optional[Uuid] = None


class PeerTable:
    def __init__(self, my_id: int, peer_ids):
        self.my_id = my_id
        self.peers = {pid: PeerState(pid) for pid in peer_ids if pid != my_id}

    def __getitem__(self, pid: int) -> PeerState:
        return self.peers[pid]

    def __iter__(self):
        return iter(self.peers.values())

    def ids(self):
        return sorted(self.peers)

    def merged_group(self):
        """Agent ids in my merged group, including me."""
        return sorted(
            [self.my_id]
            + [p.agent_id for p in self.peers.values() if p.successfully_merged]
        )

    def is_lead_node(self) -> bool:
        """Lead node = lowest agentId in the merged group
        (`orb_slam3_wrapper.cpp:1238-1246`)."""
        return self.my_id == self.merged_group()[0]

    def lowest_merged_peer(self):
        merged = [p.agent_id for p in self.peers.values() if p.successfully_merged]
        return min(merged) if merged else None
