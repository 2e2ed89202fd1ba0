"""The native map codec and a mixed three-agent run.

`multiagent/native_codec.py`: `native/mapcodec.cpp` built here by the
host's g++ into `build/dvm_slam_tpu_torch/`, held to `tests/test_native.py`'s
cases: blobs byte-identical to the port's and the JAX package's
`codec.pack_arrays` and each decodable by the others, a `MapPacket`
through it, corruption detected; and `use_native_in_codec` routing the
port's `MapPacket` through it until `restore_codec`.

The mixed run is `tests/test_three_agents.py`'s layout (chained overlaps:
agent 1 on frames 0..45, agent 2 on 28..77, agent 3 on 62..109 of
`smooth_trajectory(110, lateral=2.6, forward=0.7, yaw=0.08)`, a keyframe at
least every 4 frames, the console's mapper with 5 BA iterations) with a
JAX `SlamAgent` as agent 1 and two port `SlamAgent`s (CPU) as agents 2 and 3
on one `LoopbackTransport`, the port's wire through the native codec. It
runs at 150x200, 300 features on 4 levels: the smallest shape tried at
which the JAX-only run merges every pair (at 135x180 and 180x240 no pair
merges, at 120x160 no agent initializes). The port agents' two-view RANSAC
replays the draws JAX agents 2 and 3 would make (fault o). Every pair must
merge, one of them implicitly through the transitive rule, every agent must
end in agent 1's frame tree, and every map must hold keyframes of all
three creators with its host mirrors in sync.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dvm_slam_tpu.frontend.extractor import FrontendConfig, make_frame
from dvm_slam_tpu.io import synthetic as jsyn
from dvm_slam_tpu.mapping import local_mapping as jlm
from dvm_slam_tpu.multiagent import agent as jagent
from dvm_slam_tpu.multiagent import codec as jcodec
from dvm_slam_tpu.placerec import vocabulary as jvoc
from dvm_slam_tpu.tracking import tracker as jtrk

from dvm_slam_tpu_torch import convert
from dvm_slam_tpu_torch.mapping import local_mapping as tlm
from dvm_slam_tpu_torch.multiagent import agent as tagent
from dvm_slam_tpu_torch.multiagent import codec as tcodec
from dvm_slam_tpu_torch.multiagent import native_codec
from dvm_slam_tpu_torch.multiagent import transport as ttransport

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_system import reference_noise  # noqa: E402

torch.set_num_threads(2)

H, W, N_FEATURES, N_LEVELS = 150, 200, 300, 4
K = np.array([260.0, 260.0, 160.0, 120.0], np.float32) * (W / 320.0)
SEGMENTS = {1: (0, 46), 2: (28, 78), 3: (62, 110)}


def _arrays(rng):
    return {
        "a": rng.randn(5, 7).astype(np.float32),
        "b": rng.randint(0, 255, (3, 4, 2)).astype(np.uint8),
        "u": rng.randint(0, 2 ** 62, (4, 2)).astype(np.uint64),
        "m": rng.rand(9) > 0.5,
        "i": rng.randint(-100, 100, (6,)).astype(np.int32),
        "l": rng.randint(-100, 100, (2, 3)).astype(np.int64),
    }


class TestNativeCodec:
    def test_builds_here(self):
        assert native_codec.available(), native_codec.build_error()
        assert "build" in native_codec._build.build_log["mapcodec"]["path"]

    @pytest.mark.parametrize("enc", ["native", "port", "jax"])
    @pytest.mark.parametrize("dec", ["native", "port", "jax"])
    def test_cross_parity(self, enc, dec):
        rng = np.random.RandomState(0)
        arrays = _arrays(rng)
        pack = {"native": native_codec.pack_arrays, "port": tcodec.pack_arrays,
                "jax": jcodec.pack_arrays}
        unpack = {"native": native_codec.unpack_arrays, "port": tcodec.unpack_arrays,
                  "jax": jcodec.unpack_arrays}
        blob = pack[enc](arrays)
        assert blob == jcodec.pack_arrays(arrays)
        out = unpack[dec](blob)
        assert set(out) == set(arrays)
        for k in arrays:
            np.testing.assert_array_equal(out[k], arrays[k])

    def test_mappacket_via_native(self):
        rng = np.random.RandomState(1)
        pkt_arrays = {"kf_uuid": rng.randint(0, 2 ** 60, (2, 2)).astype(np.uint64),
                      "pt_pos": rng.randn(10, 3).astype(np.float32)}
        out = tcodec.unpack_arrays(native_codec.pack_arrays(pkt_arrays))
        np.testing.assert_array_equal(out["kf_uuid"], pkt_arrays["kf_uuid"])

    def test_corruption_detected(self):
        rng = np.random.RandomState(2)
        blob = bytearray(native_codec.pack_arrays({"a": rng.randn(4).astype(np.float32)}))
        blob[12] ^= 0xFF
        with pytest.raises(Exception):
            native_codec.unpack_arrays(bytes(blob))

    def test_use_native_in_codec_routes_packets(self):
        """The swap routes `MapPacket.to_bytes` through the native pack, the
        bytes unchanged; `restore_codec` puts the Python pack back."""
        rng = np.random.RandomState(3)
        fields = {f: np.asarray(v) for f, v in _arrays(rng).items()}
        python_pack = tcodec.pack_arrays
        try:
            assert native_codec.use_native_in_codec()
            assert tcodec.pack_arrays is native_codec.pack_arrays
            assert tcodec.pack_arrays(fields) == python_pack(fields)
            assert native_codec.use_native_in_codec()      # a second call changes nothing
            assert tcodec.pack_arrays_python is python_pack
        finally:
            native_codec.restore_codec()
        assert tcodec.pack_arrays is python_pack


@pytest.fixture(scope="module")
def three_agent_run():
    world = jsyn.PlaneWorld(seed=3, tex_size=1024, plane_z=6.0, extent=34.0)
    traj = jsyn.smooth_trajectory(110, lateral=2.6, forward=0.7, yaw=0.08)
    cfg = jtrk.TrackerConfig(
        frontend=FrontendConfig(height=H, width=W, n_features=N_FEATURES, n_levels=N_LEVELS),
        kf_cap=96, pt_cap=6144, fps=4.0)
    descs = []
    for i in range(0, 110, 12):
        im = world.render(jnp.asarray(traj[i]), jnp.asarray(K), H, W)
        f = make_frame(im, jnp.asarray(K), jnp.zeros(4), cfg.frontend)
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    voc = jvoc.train(np.concatenate(descs)[:6000], branch=8, depth=2, seed=0)
    tcfg = convert.tracker_config_from_dict(dataclasses.asdict(cfg))
    tvoc = convert.vocabulary_from_numpy(convert.vocabulary_to_numpy(voc))
    mapper = dict(n_neighbors=4, ba_local=8, ba_fixed=8, ba_pts=2048, ba_iters=5)

    bus = ttransport.LoopbackTransport()
    agents = {1: jagent.SlamAgent(1, cfg, K, np.zeros(4, np.float32), voc, bus, [1, 2, 3],
                                  mapper=jlm.LocalMapper(**mapper))}
    for aid in (2, 3):
        a = tagent.SlamAgent(aid, tcfg, K, np.zeros(4, np.float32), tvoc, bus, [1, 2, 3],
                             mapper=tlm.LocalMapper(**mapper),
                             device="cpu")
        a.tracker._ransac_noise = reference_noise(aid)
        agents[aid] = a
    steps = max(hi - lo for lo, hi in SEGMENTS.values())
    assert native_codec.use_native_in_codec()
    try:
        for t in range(steps):
            for aid, (lo, hi) in SEGMENTS.items():
                if lo + t < hi:
                    img = np.asarray(world.render(jnp.asarray(traj[lo + t]), jnp.asarray(K), H, W))
                    agents[aid].process_image(img, t * 0.1)
        for a in agents.values():
            a.flush()
        for e in range(8):
            for a in agents.values():
                a.run_once((steps + e) * 0.1)
    finally:
        native_codec.restore_codec()
    return agents


class TestMixedThreeAgents:
    def test_all_pairs_merged(self, three_agent_run):
        agents = three_agent_run
        for a in agents.values():
            for p in a.peers:
                assert p.successfully_merged, (
                    f"agent {a.agent_id} not merged with {p.agent_id}; "
                    f"logs: {[x.log for x in agents.values()]}")
        assert any(e[0] == "implicit_merge" for a in agents.values() for e in a.log)

    def test_frame_tree_converged_on_agent1(self, three_agent_run):
        agents = three_agent_run
        assert agents[1].frames.parent_frame == "world"
        assert agents[2].frames.parent_frame == "robot1/origin"
        assert agents[3].frames.parent_frame in ("robot1/origin", "robot2/origin")

    def test_shared_maps_hold_all_creators(self, three_agent_run):
        for aid, a in three_agent_run.items():
            n = int(a.map.n_kf)
            valid = np.asarray(a.map.kf_valid[:n])
            assert {1, 2, 3} <= set(int(c) for c in a.meta.kf_creator[:n][valid]), aid

    def test_invariants(self, three_agent_run):
        for a in three_agent_run.values():
            assert a.check_invariants()
