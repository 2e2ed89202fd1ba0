"""The multi-agent layer of the port against the JAX package: the map codec,
the typed wire (`wirecodec`), the loopback and TCP transports, the peer
table, the frame tree, `SlamAgent`'s merge, splice, scale-alignment and
asynchronous global-BA units, and the `System` checkpoint.

The wire is the contract: packets, frames and checkpoints written by one
package are read by the other, byte for byte where the inputs are the same.
The agent units run a JAX agent and a port agent on identical inputs: a map
built from numpy seeds (`test_torch_mapping._build_map`, padded to the
front end's 161 feature slots) and its Sim3-transformed copy with fresh
uuids (creator 2). Where the reference draws, the port replays the JAX
agent's keys (`agent_noise_replay`). Tolerances are stated per test.
"""

import dataclasses
import os
import socket
import struct
import sys
import time
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvm_slam_tpu.frontend.extractor import FrontendConfig as JFrontendConfig
from dvm_slam_tpu.geometry import lie as jlie
from dvm_slam_tpu.io import config as jcfg
from dvm_slam_tpu.loopclosing import merge as jmerge
from dvm_slam_tpu.mapping import map_state as jms
from dvm_slam_tpu.models import system as jsys
from dvm_slam_tpu.multiagent import agent as jagent
from dvm_slam_tpu.multiagent import codec as jcodec
from dvm_slam_tpu.multiagent import messages as jmsgs
from dvm_slam_tpu.multiagent import reference_frames as jrf
from dvm_slam_tpu.multiagent import socket_transport as jsock
from dvm_slam_tpu.multiagent import transport as jtransport
from dvm_slam_tpu.multiagent import wirecodec as jwire
from dvm_slam_tpu.placerec import database as jdb
from dvm_slam_tpu.placerec import vocabulary as jvoc
from dvm_slam_tpu.tracking import tracker as jtrk

from dvm_slam_tpu_torch import convert
from dvm_slam_tpu_torch.mapping import local_mapping as tlm
from dvm_slam_tpu_torch.mapping import map_state as tms
from dvm_slam_tpu_torch.models import system as tsys
from dvm_slam_tpu_torch.multiagent import agent as tagent
from dvm_slam_tpu_torch.multiagent import codec as tcodec
from dvm_slam_tpu_torch.multiagent import messages as tmsgs
from dvm_slam_tpu_torch.multiagent import reference_frames as trf
from dvm_slam_tpu_torch.multiagent import socket_transport as tsock
from dvm_slam_tpu_torch.multiagent import transport as ttransport
from dvm_slam_tpu_torch.multiagent import wirecodec as twire
from dvm_slam_tpu_torch.multiagent.peer import PeerTable

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_mapping import K, KF_CAP, N_KF, N_LEVELS, PT_CAP, SF, _build_map  # noqa: E402
from test_torch_placerec import gumbel_rows  # noqa: E402

torch.set_num_threads(2)

FEAT = 161            # FrontendConfig(96x128, 160 features, 4 levels).capacity
S_ATOL = 1e-3         # S_ab and the scale alignment's Sim3
POSE_ATOL = 1e-4      # the essential graph on identical inputs
# the global BA's poses on the merged (doubled) map, identical inputs: the
# reference's own result moves by 3.1e-2 when its points move by 1e-6 (8 LM
# x 40 PCG steps on a near-degenerate gauge); `test_torch_loopclosing.py`
# holds global BA to 1e-4 on a well-conditioned map
GBA_MERGE_ATOL = 3e-2
MAP_ATOL = 1e-3       # a splice's poses after fusion and its local BA
WELD_ATOL = 2e-2      # a whole merge's poses (the welding BA is chaotic here, fault n)


def _np(x):
    return np.array(x)


def _pad_features(jm, F=FEAT):
    """`_build_map`'s map with its feature axis padded to F slots (empty)."""
    d = {k: _np(v) for k, v in jm._asdict().items()}
    pad = F - d["kf_xy"].shape[1]
    fill = {"kf_xy": 0, "kf_level": 0, "kf_angle": 0, "kf_desc": 0, "kf_feat_valid": False,
            "kf_obs": -1, "kf_ur": -1.0}
    for k, v in fill.items():
        shape = (d[k].shape[0], pad) + d[k].shape[2:]
        d[k] = np.concatenate([d[k], np.full(shape, v, d[k].dtype)], 1)
    return jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


def _meta(n_kf, n_pt, creator, seed):
    meta = jms.MapMeta.create(KF_CAP, PT_CAP, agent_id=creator)
    rng = np.random.RandomState(seed)
    meta.kf_uuid[:n_kf] = meta.new_uuids(n_kf, rng)
    meta.kf_creator[:n_kf] = creator
    meta.pt_uuid[:n_pt] = meta.new_uuids(n_pt, rng)
    meta.pt_creator[:n_pt] = creator
    return meta


def _copy_meta(meta, cls):
    return cls(**{k: v.copy() if isinstance(v, np.ndarray) else v
                  for k, v in convert.map_meta_to_numpy(meta).items()})


def _port_meta(meta):
    return _copy_meta(meta, tms.MapMeta)


def _port_map(jm):
    return convert.map_state_from_numpy({k: _np(v) for k, v in jm._asdict().items()})


@pytest.fixture(scope="module")
def maps():
    return _maps()


def _maps():
    """Map A (agent 1's) and its copy B under a Sim3 (creator 2, fresh uuids),
    a vocabulary trained on A's descriptors and A's BoWs."""
    jm = _pad_features(_build_map())
    n_pt = int(jm.n_pt)
    metaA = _meta(N_KF, n_pt, 1, 1)
    S = jnp.concatenate([jlie.so3_exp(jnp.asarray([0.02, -0.05, 0.03])),
                         jnp.asarray([0.3, -0.1, 0.2, 1.2])])
    mB = jmerge.transform_map(jm, S)
    metaB = _meta(N_KF, n_pt, 2, 2)
    valid = _np(jm.kf_feat_valid)
    voc = jvoc.train(_np(jm.kf_desc)[valid][:3000], branch=6, depth=2, seed=0)
    levels, idf = voc.device_arrays()
    bows = np.stack([_np(jvoc.bow_vector(levels, idf, jm.kf_desc[s], jm.kf_feat_valid[s],
                                         voc.branch, voc.n_words)) for s in range(N_KF)])
    return dict(mA=jm, metaA=metaA, mB=mB, metaB=metaB, S=_np(S), voc=voc, bows=bows)


def _configs():
    fc = JFrontendConfig(height=96, width=128, n_features=160, n_levels=N_LEVELS)
    jc = jtrk.TrackerConfig(frontend=fc, kf_cap=KF_CAP, pt_cap=PT_CAP)
    return jc, convert.tracker_config_from_dict(dataclasses.asdict(jc))


def agent_noise_replay(agent, key):
    """Make the port's `agent` draw the JAX agent's keys: the agent key
    split once per merge attempt and once per scale alignment (300 and 500
    Gumbel rows), and per protocol record the reference's chunks of
    `proto_pad` = 2 new slots, its key split into 3 each, subkey 1 + j for
    the chunk's j-th own keyframe."""
    state = [key]

    def split_once():
        state[0], sub = jax.random.split(state[0])
        return sub

    def protocol(own_flags):
        out = []
        for c0 in range(0, len(own_flags), 2):
            keys = jax.random.split(state[0], 3)
            state[0] = keys[0]
            own = [f for f in own_flags[c0:c0 + 2] if f]
            out += [gumbel_rows(keys[1 + j], 300, agent.map.feat_capacity)
                    for j in range(len(own))]
        return out

    agent._sim3_noise = lambda n: gumbel_rows(split_once(), 300, n)
    agent._align_noise = lambda n: gumbel_rows(split_once(), 500, n)
    agent._protocol_noise = protocol


def _agents(maps, agent_id=1, peer_ids=(1, 2)):
    """A JAX agent and a port agent (each on its own loopback bus) holding
    map A, its metadata and BoW database."""
    jc, tc = _configs()
    voc = maps["voc"]
    tvoc = convert.vocabulary_from_numpy(convert.vocabulary_to_numpy(voc))
    jbus, tbus = jtransport.LoopbackTransport(), ttransport.LoopbackTransport()
    ja = jagent.SlamAgent(agent_id, jc, K, np.zeros(4, np.float32), voc, jbus, list(peer_ids),
                          autonomous=False)
    ta = tagent.SlamAgent(agent_id, tc, K, np.zeros(4, np.float32), tvoc, tbus, list(peer_ids),
                          autonomous=False, device="cpu")
    n_pt = int(maps["mA"].n_pt)
    db = jdb.add_many(jdb.create(KF_CAP, voc.n_words), jnp.arange(N_KF, dtype=jnp.int32),
                      jnp.asarray(maps["bows"]))
    for bus in (jbus, tbus):
        for pid in peer_ids:
            bus.register(pid)
    for a, m, meta, dbx in ((ja, maps["mA"], _copy_meta(maps["metaA"], jms.MapMeta), db),
                            (ta, _port_map(maps["mA"]), _copy_meta(maps["metaA"], tms.MapMeta),
                             convert.bow_database_from_numpy(convert.bow_database_to_numpy(db)))):
        a.tracker.map = m
        meta.agent_id = agent_id
        a.tracker.meta = meta
        a.tracker.n_kf_host = N_KF
        a.tracker.state = "OK"
        a.db = dbx
        a._db_slots = set(range(N_KF))
    assert int(ta.map.n_pt) == n_pt
    return ja, ta, jbus, tbus


def _packet_bytes(m, meta, slots, codec_mod, port=False):
    mask = np.zeros(KF_CAP, bool)
    mask[list(slots)] = True
    if port:
        return codec_mod.extract_submap(_port_map(m), _port_meta(meta), mask).to_bytes()
    return codec_mod.extract_submap(m, meta, mask).to_bytes()


# --------------------------------------------------------------------------
# the map codec
# --------------------------------------------------------------------------

class TestCodec:
    def test_pack_roundtrip_identical(self):
        rng = np.random.RandomState(0)
        arrays = {"a": rng.randn(3, 4).astype(np.float32),
                  "b": rng.randint(0, 255, (2, 5)).astype(np.uint8),
                  "c": np.asarray([[1, 2]], np.uint64), "m": rng.rand(4) > 0.5,
                  "i": rng.randint(-5, 5, (3,)).astype(np.int32)}
        blob = tcodec.pack_arrays(arrays)
        assert blob == jcodec.pack_arrays(arrays)
        out = jcodec.unpack_arrays(blob)
        back = tcodec.unpack_arrays(blob)
        assert set(out) == set(back) == set(arrays)
        for k in arrays:
            np.testing.assert_array_equal(back[k], arrays[k])
            np.testing.assert_array_equal(out[k], arrays[k])

    def test_submap_bytes_identical_both_ways(self, maps):
        """The same map and mask give the same packet bytes in both packages,
        and either package's packet materializes to the same map."""
        for slots in ((0, 2, 3), range(N_KF)):
            bj = _packet_bytes(maps["mA"], maps["metaA"], slots, jcodec)
            bt = _packet_bytes(maps["mA"], maps["metaA"], slots, tcodec, port=True)
            assert bt == bj
            pj, pt = jcodec.MapPacket.from_bytes(bt), tcodec.MapPacket.from_bytes(bj)
            mj, metaj = jcodec.materialize(pj, FEAT)
            mt, metat = tcodec.materialize(pt, FEAT, device="cpu")
            for name, w in mj._asdict().items():
                g = getattr(mt, name).numpy()
                assert g.shape == np.shape(w), name
                np.testing.assert_array_equal(g, _np(w), err_msg=name)
            for f in ("kf_uuid", "pt_uuid", "kf_creator", "pt_creator"):
                np.testing.assert_array_equal(getattr(metat, f), getattr(metaj, f))

    def test_materialize_pads_smaller_feature_capacity(self, maps):
        blob = _packet_bytes(maps["mA"], maps["metaA"], (1,), jcodec)
        mB, _ = tcodec.materialize(tcodec.MapPacket.from_bytes(blob), FEAT + 7, device="cpu")
        assert mB.feat_capacity == FEAT + 7
        assert (mB.kf_obs[0, FEAT:] == -1).all() and not mB.kf_feat_valid[0, FEAT:].any()
        assert (mB.kf_ur[0, FEAT:] == -1.0).all()
        with pytest.raises(ValueError):
            tcodec.materialize(tcodec.MapPacket.from_bytes(blob), FEAT - 1, device="cpu")

    def test_hostile_packets_raise_valueerror_only(self, maps):
        """`tests/test_merge_units.py:80`'s hostile packets, on the port's
        parser: ValueError and nothing else."""
        good = _packet_bytes(maps["mA"], maps["metaA"], (0,), tcodec, port=True)
        raw = zlib.decompress(good[8:])
        bad = bytearray(raw)
        bad[9 + raw[8]] = 250        # the first array's dtype code
        cases = {"truncated": good[:25],
                 "flipped_byte": good[:40] + bytes([good[40] ^ 0xFF]) + good[41:],
                 "unknown_dtype": struct.pack("<Q", len(bad)) + zlib.compress(bytes(bad), 6),
                 "empty": b"", "garbage": b"\x00" * 64,
                 "bomb": struct.pack("<Q", 1 << 40) + zlib.compress(b"\x00" * 1000)}
        for name, blob in cases.items():
            with pytest.raises(ValueError, match="packet"):
                tcodec.MapPacket.from_bytes(blob)


# --------------------------------------------------------------------------
# the typed wire
# --------------------------------------------------------------------------

def _messages(mod, blob):
    u = (11, 22)
    return [
        mod.NewKeyFrameBows(1, [mod.KeyFrameBowVector(uuid=u, keys=np.arange(5, dtype=np.int64),
                                                      values=np.linspace(0, 1, 5))]),
        mod.NewKeyFrames(2, blob, reference_key_frame_uuid=u),
        mod.SuccessfullyMerged(1, 2, True, merged_key_frame_uuids=[u],
                               all_key_frames_in_map=[u, (3, 4)]),
        mod.MapToAttemptMerge(1, blob, [u]),
        mod.IsLostFromBaseMap(2, True),
        mod.LoopClosureTriggers(1, [u]),
        mod.ChangeCoordinateFrame(2, 1, mod.Sim3Transform.from_sim3(
            np.asarray([1, 0, 0, 0, 0.5, 0.25, 0.0, 1.2], np.float32))),
        mod.GetCurrentMapRequest(2, [u]),
        mod.GetCurrentMapResponse(1, blob, [u]),
        mod.GetMapPointsRequest(2),
        mod.GetMapPointsResponse(uuids=np.asarray([[1, 2]], np.uint64),
                                 positions=np.ones((1, 3), np.float32)),
        {"x": [1, 2.5, "s", None, (True, False)], "arr": np.eye(3, dtype=np.float64)},
    ]


def _same_value(a, b):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _same_value(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_value(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_value(a[k], b[k])
    else:
        assert a == b


class TestWirecodec:
    def test_each_package_decodes_the_others_frames(self, maps):
        blob = _packet_bytes(maps["mA"], maps["metaA"], (0,), jcodec)
        for src, dst, msrc in ((jwire, twire, jmsgs), (twire, jwire, tmsgs)):
            for m in _messages(msrc, blob):
                frame = src.dumps(m)
                back = dst.loads(frame)
                _same_value(m, back)
                assert dst.dumps(back) == frame
                if dataclasses.is_dataclass(back):
                    assert type(back).__module__.startswith(dst.__name__.rsplit(".", 1)[0])

    def test_refuses_unregistered_and_hostile(self):
        @dataclasses.dataclass
        class Evil:
            x: int

        with pytest.raises((ValueError, TypeError)):
            twire.dumps(Evil(1))
        for frame in (b"", b"\xff", struct.pack("<B", 6) + struct.pack("<Q", 1 << 62)):
            with pytest.raises(ValueError):
                twire.loads(frame)


# --------------------------------------------------------------------------
# transports, peers, frames (the reference's own assertions on the copies)
# --------------------------------------------------------------------------

class TestTransportPeers:
    def test_pubsub_and_services(self):
        bus = ttransport.LoopbackTransport()
        for a in (1, 2, 3):
            bus.register(a)
        bus.publish(1, None, "ch", "hello")
        assert bus.poll(2, "ch") == [(1, "hello")]
        assert bus.poll(3, "ch") == [(1, "hello")]
        assert bus.poll(1, "ch") == []
        bus.publish(1, 2, "ch", "direct")
        assert bus.poll(2, "ch") == [(1, "direct")]
        bus.register_service(2, "svc", lambda caller, req: req * 2)
        assert bus.call(1, 2, "svc", 21) == 42

    def test_queue_depth(self):
        bus = ttransport.LoopbackTransport()
        bus.register(1)
        bus.register(2)
        for i in range(20):
            bus.publish(1, 2, "ch", i)
        assert [m for _, m in bus.poll(2, "ch")] == list(range(10, 20))  # keep-last-10

    def test_lead_node(self):
        p = PeerTable(2, [1, 2, 3])
        assert p.is_lead_node()
        p[1].successfully_merged = True
        assert not p.is_lead_node()
        assert p.lowest_merged_peer() == 1
        p3 = PeerTable(1, [1, 2, 3])
        p3[2].successfully_merged = True
        assert p3.is_lead_node()

    def test_reference_frames_match(self):
        fj, ft = jrf.ReferenceFrameManager(2), trf.ReferenceFrameManager(2)
        np.testing.assert_allclose(ft.world_to_origin, fj.world_to_origin, atol=1e-7)
        S = np.asarray([0.9, 0.1, -0.2, 0.3, 0.4, 0.5, -0.6, 1.3], np.float32)
        S[:4] /= np.linalg.norm(S[:4])
        fj.set_parent_frame(1, S)
        ft.set_parent_frame(1, S)
        assert ft.tree()["parent"] == fj.tree()["parent"] == "robot1/origin"
        np.testing.assert_allclose(ft.world_to_origin, fj.world_to_origin, atol=1e-6)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _wait_poll(bus, agent, channel, tries=200):
    for _ in range(tries):
        out = bus.poll(agent, channel)
        if out:
            return out
        time.sleep(0.01)
    return []


@pytest.fixture
def buses():
    peers = {i: ("127.0.0.1", _free_port()) for i in (1, 2, 3)}
    ts = {i: tsock.SocketTransport(i, peers) for i in (1, 2, 3)}
    yield ts
    for t in ts.values():
        t.close()


class TestSocketTransport:
    """`tests/test_socket_transport.py` on the port's copy."""

    def test_direct_and_broadcast(self, buses):
        buses[1].publish(1, 2, "ch", "direct")
        assert _wait_poll(buses[2], 2, "ch") == [(1, "direct")]
        buses[1].publish(1, None, "bcast", {"x": 1})
        assert _wait_poll(buses[2], 2, "bcast") == [(1, {"x": 1})]
        assert _wait_poll(buses[3], 3, "bcast") == [(1, {"x": 1})]
        assert buses[1].poll(1, "bcast") == []

    def test_service_roundtrip(self, buses):
        buses[2].register_service(2, "svc", lambda caller, req: (caller, req * 2))
        assert buses[1].call(1, 2, "svc", 21) == (1, 42)

    def test_queue_depth_keep_last_10(self, buses):
        for i in range(20):
            buses[1].publish(1, 2, "q", i)
        time.sleep(0.3)
        out = [m for _, m in buses[2].poll(2, "q")]
        assert len(out) <= 10 and out[-1] == 19

    def test_peer_down_is_best_effort(self, buses):
        buses[3].close()
        buses[1].publish(1, 3, "ch", "lost")
        assert buses[1].call(1, 3, "svc", 1) is None

    def test_jax_and_port_exchange_a_map_packet(self, maps):
        """A JAX `SocketTransport` (agent 1) and a port one (agent 2) on
        localhost: a `MapPacket` each way, a service call each way."""
        peers = {1: ("127.0.0.1", _free_port()), 2: ("127.0.0.1", _free_port())}
        bj, bt = jsock.SocketTransport(1, peers), tsock.SocketTransport(2, peers)
        try:
            blob_j = _packet_bytes(maps["mA"], maps["metaA"], (0, 1), jcodec)
            blob_t = _packet_bytes(maps["mA"], maps["metaA"], (2, 3), tcodec, port=True)
            bj.publish(1, 2, jmsgs.CH_NEW_KEY_FRAMES, jmsgs.NewKeyFrames(1, blob_j))
            bt.publish(2, 1, tmsgs.CH_NEW_KEY_FRAMES, tmsgs.NewKeyFrames(2, blob_t))
            (s2, m2), = _wait_poll(bt, 2, tmsgs.CH_NEW_KEY_FRAMES)
            (s1, m1), = _wait_poll(bj, 1, jmsgs.CH_NEW_KEY_FRAMES)
            assert (s1, s2) == (2, 1)
            assert isinstance(m2, tmsgs.NewKeyFrames) and isinstance(m1, jmsgs.NewKeyFrames)
            assert m2.serialized_map == blob_j and m1.serialized_map == blob_t
            assert tcodec.MapPacket.from_bytes(m2.serialized_map).n_kf == 2
            bt.register_service(2, tmsgs.SRV_GET_MAP_POINTS, lambda c, r: tmsgs.GetMapPointsResponse(
                uuids=np.asarray([[7, 8]], np.uint64), positions=np.zeros((1, 3), np.float32)))
            resp = bj.call(1, 2, jmsgs.SRV_GET_MAP_POINTS, jmsgs.GetMapPointsRequest(1))
            assert isinstance(resp, jmsgs.GetMapPointsResponse)
            np.testing.assert_array_equal(resp.uuids, [[7, 8]])
            bj.register_service(1, "echo", lambda c, r: r)
            assert bt.call(2, 1, "echo", {"a": np.arange(3)})["a"].tolist() == [0, 1, 2]
            assert bj.bandwidth_report()["bytes_by_channel"][jmsgs.CH_NEW_KEY_FRAMES] > 0
        finally:
            bj.close()
            bt.close()


# --------------------------------------------------------------------------
# SlamAgent units, JAX agent against port agent on identical inputs
# --------------------------------------------------------------------------

def _se3(rot, t):
    return _np(jlie.se3(jlie.so3_exp(jnp.asarray(rot, jnp.float32)), jnp.asarray(t, jnp.float32)))


def _gba_case(a, port):
    """`tests/test_async_gba_unit.py`'s fake asynchronous result: every
    snapshot pose times dT, points + 0.1, anchor 1."""
    dT = _se3([0.0, 0.04, 0.0], [0.15, 0.0, -0.1])
    res_pose = _np(jax.vmap(lambda T: jlie.se3_mul(T, jnp.asarray(dT)))(
        jnp.asarray(_np(a.map.kf_pose))))
    res_pt = _np(a.map.pt_pos) + 0.1
    mk = (lambda x: torch.from_numpy(x)) if port else jnp.asarray
    return {"res_pose": mk(res_pose), "res_pt": mk(res_pt), "n_kf": 3, "n_pt": 4, "anchor": 1,
            "t0": 0.0}


class TestAgentAsyncGBA:
    def test_poll_gba_corrects_tracker_continuation(self, maps):
        """The map takes the snapshot's poses and the tracker continuation the
        same anchor correction, T' = T T_anchor_live^-1 T_anchor_gba; the
        velocity is untouched."""
        ja, ta, _, _ = _agents(maps)
        T_last = _se3([0.0, 0.1, 0.0], [0.5, 0.0, 0.2])
        out = {}
        for name, a, port in (("jax", ja, False), ("port", ta, True)):
            a.tracker.last_pose = torch.from_numpy(T_last) if port else jnp.asarray(T_last)
            v0 = _np(a.tracker.velocity).copy()
            a._pending_gba = pg = _gba_case(a, port)
            corr = jlie.se3_mul(jlie.se3_inv(jnp.asarray(_np(a.map.kf_pose[1]))),
                                jnp.asarray(_np(pg["res_pose"][1])))
            a._poll_gba(block=True)
            assert any(e[0] == "gba_applied" for e in a.log)
            np.testing.assert_allclose(_np(a.map.kf_pose[:3]), _np(pg["res_pose"][:3]), atol=1e-5)
            np.testing.assert_allclose(_np(a.tracker.last_pose),
                                       _np(jlie.se3_mul(jnp.asarray(T_last), corr)), atol=1e-5)
            np.testing.assert_allclose(_np(a.tracker.velocity), v0, atol=1e-7)
            out[name] = (_np(a.map.kf_pose), _np(a.map.pt_pos), _np(a.tracker.last_pose))
        for g, w in zip(out["port"], out["jax"]):
            np.testing.assert_allclose(g, w, atol=1e-5)

    def test_splice_aborts_inflight_gba(self, maps):
        """A peer's keyframe packet supersedes the in-flight solve."""
        blob = _packet_bytes(maps["mB"], maps["metaB"], (4,), jcodec)
        ja, ta, _, _ = _agents(maps)
        for a, port, mod in ((ja, False, jmsgs), (ta, True, tmsgs)):
            a._pending_gba = _gba_case(a, port)
            a._receive_new_key_frames(mod.NewKeyFrames(2, blob))
            assert a._pending_gba is None
            assert ("gba_aborted", "kf_splice") in a.log
            a._poll_gba(block=True)
            assert not any(e[0] == "gba_applied" for e in a.log)


def _capture_merge(a):
    """Wrap `_do_merge`, `_run_pose_graph` and `_dispatch_gba` to record
    S_ab, the essential graph's inputs and output, and the global BA's
    input map and result."""
    rec = {}
    do_merge, run_pg, dispatch = a._do_merge, a._run_pose_graph, a._dispatch_gba

    def dm(peer_id, mB, metaB, S_ab, weld_kf):
        rec["S_ab"], rec["weld"] = _np(S_ab), weld_kf
        return do_merge(peer_id, mB, metaB, S_ab, weld_kf)

    def pg(m, anchor, pre):
        rec["pg_in"], rec["pg_pre"] = {k: _np(v) for k, v in m._asdict().items()}, _np(pre)
        out = run_pg(m, anchor, pre)
        rec["pg_out"] = _np(out.kf_pose)
        return out

    def gba(merged, weld_kf):
        rec["gba_in"] = {k: _np(v) for k, v in merged._asdict().items()}
        dispatch(merged, weld_kf)
        rec["gba_pose"], rec["gba_pt"] = (_np(a._pending_gba["res_pose"]),
                                          _np(a._pending_gba["res_pt"]))

    a._do_merge, a._run_pose_graph, a._dispatch_gba = dm, pg, gba
    return rec


class TestAgentMerge:
    def test_attempt_merge_matches_reference(self, maps):
        """Agent 1 merges the Sim3-transformed copy of its map (agent 2's, one
        candidate uuid), the port replaying the JAX agent's key. The same
        weld keyframe, merged slots, uuids and observation tables, S_ab to
        S_ATOL (and inverting the copy's transform); then the essential
        graph and the global BA of the port on the reference's own inputs
        (the welded map, the splice-time poses) to POSE_ATOL / GBA_MERGE_ATOL.
        The whole merge's poses agree to WELD_ATOL only: the welding BA on
        this doubled map moves the reference's own poses by 1.7e-3 when one
        point moves by 1e-6 (fault n)."""
        ja, ta, jbus, tbus = _agents(maps)
        agent_noise_replay(ta, jax.random.PRNGKey(1001))
        blob = _packet_bytes(maps["mB"], maps["metaB"], range(N_KF), jcodec)
        cand = [jmsgs.uuid_key(maps["metaB"].kf_uuid[3])]
        rj, rt = _capture_merge(ja), _capture_merge(ta)
        assert ja._attempt_merge(2, blob, cand) and ta._attempt_merge(2, blob, cand)
        assert rt["weld"] == rj["weld"]
        np.testing.assert_allclose(rt["S_ab"], rj["S_ab"], atol=S_ATOL)
        S_inv = _np(jlie.sim3_inv(jnp.asarray(maps["S"])))
        assert abs(rt["S_ab"][7] - S_inv[7]) < 0.01
        assert int(ta.map.n_kf) == int(ja.map.n_kf) == 2 * N_KF
        np.testing.assert_array_equal(ta.map.kf_valid.numpy(), _np(ja.map.kf_valid))
        np.testing.assert_array_equal(ta.meta.kf_uuid, ja.meta.kf_uuid)
        np.testing.assert_array_equal(rt["pg_in"]["kf_obs"], rj["pg_in"]["kf_obs"])
        np.testing.assert_allclose(rt["pg_pre"], rj["pg_pre"], atol=1e-5)
        np.testing.assert_allclose(rt["pg_out"], rj["pg_out"], atol=WELD_ATOL)

        # the essential graph on the reference's welded map
        out = tagent.SlamAgent._run_pose_graph(ta, convert.map_state_from_numpy(rj["pg_in"]),
                                               rj["weld"], torch.from_numpy(rj["pg_pre"]))
        np.testing.assert_allclose(out.kf_pose.numpy(), rj["pg_out"], atol=POSE_ATOL)
        # the global BA on the reference's merged map
        res, _ = tlm.global_ba(convert.map_state_from_numpy(rj["gba_in"]), ta.tracker.K, iters=8,
                               n_levels=N_LEVELS, scale_factor=SF)
        np.testing.assert_allclose(res.kf_pose.numpy(), rj["gba_pose"], atol=GBA_MERGE_ATOL)
        assert np.isfinite(res.pt_pos.numpy()).all()

        gj, gt = ja._pending_gba, ta._pending_gba
        assert (gt["n_kf"], gt["n_pt"], gt["anchor"]) == (gj["n_kf"], gj["n_pt"], gj["anchor"])
        for a in (ja, ta):
            assert ("merged", 2) in a.log and a.peers[2].successfully_merged
            a.flush_gba()
            assert any(e[0] == "gba_applied" for e in a.log)
            assert a.check_invariants()
        np.testing.assert_allclose(ta.map.kf_pose.numpy(), _np(ja.map.kf_pose),
                                   atol=GBA_MERGE_ATOL)
        # the SuccessfullyMerged broadcasts agree field by field
        (_, mt), = tbus.poll(2, tmsgs.CH_SUCCESSFULLY_MERGED)
        (_, mj), = jbus.poll(2, jmsgs.CH_SUCCESSFULLY_MERGED)
        _same_value(mj, mt)

    def test_receive_new_key_frames_matches_reference(self, maps):
        """Three keyframes of the copy, re-based into A's frame (fresh uuids):
        the splice, fusion and local BA give the same slots and, to
        MAP_ATOL, the same poses."""
        Sinv = jlie.sim3_inv(jnp.asarray(maps["S"]))
        mB = jmerge.transform_map(maps["mB"], Sinv)
        blob = _packet_bytes(mB, maps["metaB"], (1, 3, 4), jcodec)
        ja, ta, _, _ = _agents(maps)
        ja._receive_new_key_frames(jmsgs.NewKeyFrames(2, blob))
        ta._receive_new_key_frames(tmsgs.NewKeyFrames(2, blob))
        assert int(ta.map.n_kf) == int(ja.map.n_kf) == N_KF + 3
        assert int(ta.map.n_pt) == int(ja.map.n_pt)
        np.testing.assert_array_equal(ta.map.kf_valid.numpy(), _np(ja.map.kf_valid))
        np.testing.assert_array_equal(ta.meta.kf_creator, ja.meta.kf_creator)
        np.testing.assert_allclose(ta.map.kf_pose.numpy(), _np(ja.map.kf_pose), atol=MAP_ATOL)
        assert ta.tracker.map_epoch == 1 and ta.check_invariants()
        assert ta.peers[2].sent_key_frame_uuids == ja.peers[2].sent_key_frame_uuids

    def test_update_map_scale_matches_reference(self, maps):
        """Agent 2, merged with agent 1, aligns its map to agent 1's points
        (its own under a Sim3 of scale 1.3): the same Sim3 to S_ATOL, the
        same re-based map and trajectory, the AIMD interval reset."""
        rng = np.random.RandomState(3)
        n = 620
        jm = jms.create(KF_CAP, PT_CAP, FEAT)
        pos = rng.randn(n, 3).astype(np.float32) * 2.0 + [0, 0, 6]
        jm = jm._replace(pt_pos=jm.pt_pos.at[:n].set(pos), pt_valid=jm.pt_valid.at[:n].set(True),
                         n_pt=jnp.int32(n), kf_pose=jm.kf_pose.at[0].set(jnp.asarray(
                             _se3([0.0, 0.1, 0.0], [0.2, 0.0, 0.1]))),
                         kf_valid=jm.kf_valid.at[0].set(True), n_kf=jnp.int32(1))
        meta = _meta(1, n, 2, 5)
        S = _np(jnp.concatenate([jlie.so3_exp(jnp.asarray([0.0, 0.2, 0.0])),
                                 jnp.asarray([1.0, 0.0, 0.5, 1.3])]))
        dst = _np(jlie.sim3_apply(jnp.asarray(S), jnp.asarray(pos)))
        dst[::7] += rng.randn(len(dst[::7]), 3).astype(np.float32)   # outliers
        out = {}
        for name, port in (("jax", False), ("port", True)):
            jc, tc = _configs()
            bus = (ttransport if port else jtransport).LoopbackTransport()
            mod = tmsgs if port else jmsgs
            voc = convert.vocabulary_from_numpy(convert.vocabulary_to_numpy(maps["voc"])) \
                if port else maps["voc"]
            kw = dict(device="cpu") if port else {}
            a = (tagent if port else jagent).SlamAgent(2, tc if port else jc, K, np.zeros(4),
                                                       voc, bus, [1, 2], autonomous=False, **kw)
            bus.register(1)
            bus.register_service(1, mod.SRV_GET_MAP_POINTS, lambda c, r, mod=mod:
                                 mod.GetMapPointsResponse(uuids=meta.pt_uuid[:n].copy(),
                                                          positions=dst.copy()))
            a.tracker.map = _port_map(jm) if port else jm
            a.tracker.meta = _port_meta(meta) if port else meta
            a.tracker.n_kf_host = 1
            a.tracker.state = "OK"
            T0 = _se3([0.0, 0.05, 0.0], [0.1, 0.0, 0.0])
            a.tracker.last_pose = torch.from_numpy(T0) if port else jnp.asarray(T0)
            a.tracker.trajectory = [(0.0, T0.copy(), "OK"), (0.1, T0 * 1.0, "OK")]
            a.peers[1].successfully_merged = True
            if port:
                agent_noise_replay(a, jax.random.PRNGKey(1002))
            a._update_map_scale(5.0)
            (_, tgt, s), = [e for e in a.log if e[0] == "scale_aligned"]
            out[name] = dict(s=s, pos=_np(a.map.pt_pos[:n]), kf=_np(a.map.kf_pose[0]),
                             lp=_np(a.tracker.last_pose), interval=a._scale_interval,
                             traj=np.stack([_np(T) for _, T, _ in a.tracker.trajectory]))
        j, p = out["jax"], out["port"]
        assert abs(p["s"] - j["s"]) < S_ATOL and abs(j["s"] - 1.3) < 0.01
        assert p["interval"] == j["interval"] == tagent.SCALE_ALIGN_BASE_INTERVAL
        np.testing.assert_allclose(p["pos"], j["pos"], atol=2e-3)
        for k in ("kf", "lp", "traj"):
            np.testing.assert_allclose(p[k], j[k], atol=1e-3)

    def test_no_tensor_in_any_message(self, maps):
        """Every message a port agent publishes or answers holds numpy arrays,
        bytes and Python scalars only."""
        ja, ta, jbus, tbus = _agents(maps)
        sent = []
        publish = tbus.publish

        def spy(sender, target, channel, msg):
            sent.append(msg)
            return publish(sender, target, channel, msg)

        tbus.publish = spy
        ta.peers[2].successfully_merged = True
        ta._send_new_key_frames()
        ta.tracker.state = "LOST"
        ta._update_is_lost()
        sent.append(ta._srv_get_current_map(2, tmsgs.GetCurrentMapRequest(2, [])))
        sent.append(ta._srv_get_map_points(2, tmsgs.GetMapPointsRequest(2)))
        ta._apply_frame_change(0, torch.tensor([1, 0, 0, 0, 0.1, 0, 0, 1.1]))
        assert len(sent) >= 4

        def walk(v):
            assert not isinstance(v, torch.Tensor), type(v)
            if dataclasses.is_dataclass(v):
                for f in dataclasses.fields(v):
                    walk(getattr(v, f.name))
            elif isinstance(v, (list, tuple)):
                for x in v:
                    walk(x)
            elif isinstance(v, dict):
                for x in v.values():
                    walk(x)

        for m in sent:
            walk(m)
            jwire.loads(twire.dumps(m))          # and the JAX package reads it


# --------------------------------------------------------------------------
# the System checkpoint
# --------------------------------------------------------------------------

def _system_settings():
    s = jcfg.SystemSettings()
    s.camera = jcfg.CameraSettings(fx=float(K[0]), fy=float(K[1]), cx=float(K[2]),
                                   cy=float(K[3]), width=128, height=96,
                                   dist=(0.0, 0.0, 0.0, 0.0), fps=10.0)
    s.orb = jcfg.OrbSettings(n_features=160, n_levels=N_LEVELS)
    s.kf_capacity = KF_CAP
    s.pt_capacity = PT_CAP
    return s


def _install(system, maps, port):
    t = system.tracker
    t.map = _port_map(maps["mA"]) if port else maps["mA"]
    t.meta = _port_meta(maps["metaA"]) if port else maps["metaA"]
    t.meta.agent_id = system.agent_id
    t.n_kf_host = N_KF
    t.state = "OK"
    T = _np(maps["mA"].kf_pose[N_KF - 1])
    t.last_pose = torch.from_numpy(T.copy()) if port else jnp.asarray(T)
    t.kf_timestamps = {s: 0.1 * s for s in range(N_KF)}
    t.trajectory = [(0.1 * s, _np(maps["mA"].kf_pose[s]), "OK") for s in range(N_KF)]


class TestSystemCheckpoint:
    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_checkpoint_crosses_packages(self, maps, tmp_path, writer):
        """A checkpoint written by one package loads in the other exactly as
        in the writer's own package; both packages write the same bytes for
        the same state."""
        settings = _system_settings()
        tsettings = convert.system_settings_from_dict(dataclasses.asdict(settings))
        sj = jsys.System(settings, agent_id=1)
        st = tsys.System(tsettings, agent_id=1, device="cpu")
        _install(sj, maps, False)
        _install(st, maps, True)
        pj, pt = str(tmp_path / "jax.atlas"), str(tmp_path / "port.atlas")
        sj.save_atlas(pj)
        st.save_atlas(pt)
        assert open(pj, "rb").read() == open(pt, "rb").read()
        path = pj if writer == "jax" else pt
        rj = jsys.System(settings, agent_id=1)
        rt = tsys.System(tsettings, agent_id=1, device="cpu")
        rj.load_atlas(path)
        rt.load_atlas(path)
        for name, w in rj.map._asdict().items():
            g, w = getattr(rt.map, name).numpy(), _np(w)
            if g.dtype.kind == "f":
                np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)
            else:
                np.testing.assert_array_equal(g, w, err_msg=name)
        for f in ("kf_uuid", "pt_uuid", "kf_creator", "pt_creator"):
            np.testing.assert_array_equal(getattr(rt.tracker.meta, f), getattr(rj.tracker.meta, f))
        tj, tt = rj.tracker, rt.tracker
        assert tt.state == tj.state == "OK" and tt.n_kf_host == tj.n_kf_host == N_KF
        assert tt.kf_timestamps == tj.kf_timestamps
        np.testing.assert_array_equal(tt.last_pose.numpy(), _np(tj.last_pose))
        assert len(tt.trajectory) == len(tj.trajectory) == N_KF
        for (a, Ta, sa), (b, Tb, sb) in zip(tt.trajectory, tj.trajectory):
            assert a == b and sa == sb
            np.testing.assert_array_equal(_np(Ta), _np(Tb))
        # the loaded port System serializes the same packet as the writer's map
        assert tcodec.MapPacket.from_bytes(rt.serialize_map()).n_kf == N_KF

    def test_corrupt_checkpoint_refused(self, maps, tmp_path):
        settings = convert.system_settings_from_dict(dataclasses.asdict(_system_settings()))
        st = tsys.System(settings, agent_id=1, device="cpu")
        _install(st, maps, True)
        path = str(tmp_path / "a.atlas")
        st.save_atlas(path)
        data = bytearray(open(path, "rb").read())
        data[-5] ^= 0xFF
        open(path, "wb").write(bytes(data))
        with pytest.raises(IOError, match="checksum"):
            tsys.System(settings, agent_id=1, device="cpu").load_atlas(path)
