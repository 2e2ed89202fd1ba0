"""TCP socket transport: cross-process/cross-host agent communication.

The DDS-replacement for genuinely distributed agents (the reference runs one
ROS 2 node per robot over DDS; SURVEY.md §5 maps cross-host exchange to a
host-side byte transport). Same interface as `LoopbackTransport`
(register/publish/poll/call/bandwidth_report) so `SlamAgent` is
transport-agnostic; peer-to-peer with a static peer table — no central
broker, mirroring the reference's static {1,2,3} topology
(`orb_slam3_wrapper.cpp:110-121`).

Wire format: 8-byte little-endian length + `wirecodec` envelope
  (kind, sender, channel, payload [, req_id])
The envelope codec is a typed allowlist serializer (no pickle — a reachable
listening port must never be a code-execution primitive; the reference's DDS
messages carry data only). Map payloads inside messages are already
`codec.MapPacket` blobs (zlib, C++-codec compatible).

A copy of `dvm_slam_tpu/multiagent/socket_transport.py`, line for line: the port imports
nothing of the JAX package, and the two copies keep the wire identical.
"""

from __future__ import annotations

import collections
import socket
import socketserver
import struct
import threading
import uuid as uuid_mod

from . import wirecodec

QUEUE_DEPTH = 10
MAX_FRAME_BYTES = 1 << 30  # refuse absurd length prefixes before allocating


def _send_frame(sock, obj):
    payload = wirecodec.dumps(obj)
    sock.sendall(struct.pack("<Q", len(payload)) + payload)
    return len(payload)


def _recv_frame(sock):
    hdr = b""
    while len(hdr) < 8:
        chunk = sock.recv(8 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    (n,) = struct.unpack("<Q", hdr)
    if n > MAX_FRAME_BYTES:
        return None  # protocol violation: drop the connection
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            return None
        buf += chunk
    try:
        return wirecodec.loads(bytes(buf))
    except (ValueError, TypeError):
        return None  # malformed/hostile frame: drop the connection


class SocketTransport:
    """One instance per agent process.

    peers: {agent_id: (host, port)} including this agent's own entry."""

    def __init__(self, agent_id: int, peers: dict):
        self.agent_id = agent_id
        self.peers = dict(peers)
        self.queues = {}
        self.services = {}
        self._pending = {}
        self._lock = threading.Lock()
        self.bytes_sent = collections.defaultdict(int)
        self.msgs_sent = collections.defaultdict(int)

        host, port = self.peers[agent_id]
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    msg = _recv_frame(self.request)
                    if msg is None:
                        return
                    outer._on_message(msg, self.request)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        self._conns = {}

    # -- internals ---------------------------------------------------------

    def _on_message(self, msg, sock):
        kind = msg[0]
        if kind == "pub":
            _, sender, channel, payload = msg
            with self._lock:
                q = self.queues.setdefault(
                    channel, collections.deque(maxlen=QUEUE_DEPTH)
                )
                q.append((sender, payload))
        elif kind == "req":
            _, sender, name, payload, req_id = msg
            handler = self.services.get(name)
            resp = handler(sender, payload) if handler else None
            _send_frame(sock, ("resp", self.agent_id, name, resp, req_id))
        elif kind == "resp":
            _, sender, name, payload, req_id = msg
            with self._lock:
                ev = self._pending.get(req_id)
            if ev is not None:
                ev["resp"] = payload
                ev["event"].set()

    def _connect(self, target: int):
        conn = self._conns.get(target)
        if conn is not None:
            return conn
        host, port = self.peers[target]
        s = socket.create_connection((host, port), timeout=10.0)
        self._conns[target] = s
        return s

    # -- LoopbackTransport interface -----------------------------------------

    def register(self, agent_id: int):
        pass  # peers are static

    def register_service(self, agent_id: int, name: str, handler):
        assert agent_id == self.agent_id
        self.services[name] = handler

    def publish(self, sender: int, target, channel: str, msg):
        targets = [target] if target is not None else [
            a for a in self.peers if a != self.agent_id
        ]
        for t in targets:
            try:
                s = self._connect(t)
                n = _send_frame(s, ("pub", sender, channel, msg))
                self.bytes_sent[channel] += n
                self.msgs_sent[channel] += 1
            except OSError:
                self._conns.pop(t, None)  # peer down: drop (best effort)

    def poll(self, agent_id: int, channel: str):
        with self._lock:
            q = self.queues.get(channel)
            if not q:
                return []
            out = list(q)
            q.clear()
        return out

    def call(self, caller: int, target: int, name: str, request, timeout=30.0):
        req_id = uuid_mod.uuid4().hex
        ev = {"event": threading.Event(), "resp": None}
        with self._lock:
            self._pending[req_id] = ev
        try:
            # dedicated connection per call keeps responses unambiguous
            host, port = self.peers[target]
            with socket.create_connection((host, port), timeout=timeout) as s:
                n = _send_frame(s, ("req", caller, name, request, req_id))
                self.msgs_sent[name] += 1
                self.bytes_sent[name] += n
                resp_msg = _recv_frame(s)
                if resp_msg is None:
                    return None
                return resp_msg[3]
        except OSError:
            return None
        finally:
            with self._lock:
                self._pending.pop(req_id, None)

    def bandwidth_report(self):
        return {
            "bytes_by_channel": dict(self.bytes_sent),
            "msgs_by_channel": dict(self.msgs_sent),
        }

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        for s in self._conns.values():
            try:
                s.close()
            except OSError:
                pass
