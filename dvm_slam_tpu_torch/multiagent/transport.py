"""Pluggable inter-agent transport.

Replaces ROS 2 DDS pub/sub + services (`peer.cpp:15-31`,
`orb_slam3_wrapper.cpp:76-108`): an abstract byte-free (in-process objects)
or byte-based bus with per-(agent, channel) FIFO queues and synchronous
service calls. `LoopbackTransport` is the N-agents-one-host harness the
reference itself uses for evaluation (N ros_mono processes on one machine);
a socket transport can implement the same interface for real distribution.

QoS: reliable, keep-last-10 per channel (`orb_slam3_wrapper.cpp:39`) —
modelled by bounded deques that drop the oldest.

A copy of `dvm_slam_tpu/multiagent/transport.py`, line for line: the port imports
nothing of the JAX package, and the two copies keep the wire identical.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Tuple

QUEUE_DEPTH = 10


class LoopbackTransport:
    """In-process bus. Addressing: publish(sender, target, channel, msg) —
    target None = broadcast to every other registered agent."""

    def __init__(self):
        self.queues: Dict[Tuple[int, str], collections.deque] = {}
        self.services: Dict[Tuple[int, str], Callable] = {}
        self.agents = set()
        self.bytes_sent: Dict[str, int] = collections.defaultdict(int)
        self.msgs_sent: Dict[str, int] = collections.defaultdict(int)

    # -- registration --------------------------------------------------
    def register(self, agent_id: int):
        self.agents.add(agent_id)

    def register_service(self, agent_id: int, name: str, handler: Callable):
        self.services[(agent_id, name)] = handler

    # -- pub/sub --------------------------------------------------------
    def publish(self, sender: int, target, channel: str, msg):
        targets = [target] if target is not None else [
            a for a in self.agents if a != sender
        ]
        size = getattr(msg, "serialized_map", None)
        self.msgs_sent[channel] += len(targets)
        if isinstance(size, (bytes, bytearray)):
            self.bytes_sent[channel] += len(size) * len(targets)
        for t in targets:
            q = self.queues.setdefault((t, channel), collections.deque(maxlen=QUEUE_DEPTH))
            q.append((sender, msg))

    def poll(self, agent_id: int, channel: str):
        """Drain all pending messages on a channel: [(sender, msg), ...]."""
        q = self.queues.get((agent_id, channel))
        if not q:
            return []
        out = list(q)
        q.clear()
        return out

    # -- services ---------------------------------------------------------
    def call(self, caller: int, target: int, name: str, request):
        """Synchronous service call (the reference uses async clients with
        response callbacks; cooperative scheduling makes sync equivalent)."""
        handler = self.services.get((target, name))
        if handler is None:
            return None
        resp = handler(caller, request)
        size = getattr(resp, "serialized_map", None)
        self.msgs_sent[name] += 1
        if isinstance(size, (bytes, bytearray)):
            self.bytes_sent[name] += len(size)
        return resp

    # -- accounting (evaluation.ipynb bandwidth cells equivalent) ---------
    def bandwidth_report(self):
        return {
            "bytes_by_channel": dict(self.bytes_sent),
            "msgs_by_channel": dict(self.msgs_sent),
        }
