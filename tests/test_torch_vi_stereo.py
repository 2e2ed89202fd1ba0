"""The port's IMU-stereo `System` stepped against the JAX `System`, then
the inertial merge (MergeInertialBA) of `tests/test_vi_pipeline.py::
TestMergeInertialBA` with a port agent 1.

The stepped run is `test_imu_stereo_end_to_end`'s 34 frames, held as
`test_torch_vi_system.lockstep` holds them (a depth sensor: poses within
1e-3 before the IMU-init call, 1e-2 after). The merge welds a JAX
IMU-stereo System's map of frames 14-33 into system 1: the JAX agent on its
own tracker, the port agent on the same tracker state replayed into the
port (map, metadata, keyframe chain, preintegrations, velocities, biases),
so both welding BAs start from identical inputs. Held: every chain
velocity within 1e-2 and the biases within 5e-3 of the JAX agent's (one
VI BA on identical inputs, but on the doubled geometry of a merge, whose
f32 solves amplify rounding, ROADMAP fault t: 2.4e-3 measured on the
velocities, 1.4e-3 on the biases), at least 3 chain keyframes within 0.6
m/s of
ground truth, |bias_g| < 0.2, |bias_a| < 1.0, and the global BA folded.
"""

import os
import sys

import numpy as np
import torch

import jax.numpy as jnp

from dvm_slam_tpu.geometry import lie as jlie
from dvm_slam_tpu.multiagent import agent as jagent
from dvm_slam_tpu.multiagent import codec as jcodec
from dvm_slam_tpu.multiagent import transport as jtransport
from dvm_slam_tpu.placerec import vocabulary as jvocab

from dvm_slam_tpu_torch import convert
from dvm_slam_tpu_torch.mapping import map_state as tms
from dvm_slam_tpu_torch.multiagent import agent as tagent
from dvm_slam_tpu_torch.multiagent import codec as tcodec
from dvm_slam_tpu_torch.multiagent import transport as ttransport

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_vi_system import (POSE_ATOL_DEPTH, POSE_ATOL_POST,  # noqa: E402
                                  assert_chains_agree, build_pair, call, lockstep, scene)

torch.set_num_threads(2)

N = 34
VEL_ATOL = 1e-2    # the weld of a doubled map is chaotic in f32 (ROADMAP fault t)
BIAS_ATOL = 5e-3


def _replay(jt, tt):
    """The JAX tracker's map, metadata and host state into the port's."""
    tt.map = convert.map_state_from_numpy({k: np.asarray(v) for k, v in jt.map._asdict().items()})
    meta = convert.map_meta_to_numpy(jt.meta)
    tt.meta = tms.MapMeta(**{k: v for k, v in meta.items()})
    convert.tracker_host_state_from_numpy(tt, convert.tracker_host_state_to_numpy(jt))


def test_imu_stereo_steps_and_merges_with_reference():
    sj, st, log = lockstep("imu-stereo", N, N)
    assert log["init_at"] is not None, "the IMU never initialized"
    assert log["worst_pre"] <= POSE_ATOL_DEPTH, log["diffs"]
    assert log["worst_post"] <= POSE_ATOL_POST, log["diffs"]
    assert st.get_tracking_state() == "OK"
    assert_chains_agree(sj, st)
    # the live trajectory is metric (tests/test_vi_pipeline.py:280-282)
    idx = sorted(log["poses"])
    est = np.stack([np.asarray(jlie.se3_t(jlie.se3_inv(jnp.asarray(log["poses"][i]))))
                    for i in idx])
    gt = np.stack([np.asarray(jlie.se3_t(jlie.se3_inv(jnp.asarray(log["gt"][i]))))
                   for i in idx])
    ratio = np.linalg.norm(np.diff(est, axis=0), axis=1).sum() / \
        np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    assert 0.8 < ratio < 1.25, ratio

    # system 2 over frames 14..33 (JAX), its map through the codec
    s2, _ = build_pair("imu-stereo")
    world, poses, chunks, vels = scene(N)
    K = jnp.asarray(s2.settings.camera.K())
    for i in range(14, N):
        call(s2, "imu-stereo", world, poses[i], K, (i - 14) * 0.1, chunks[i])
    mask = np.asarray(s2.map.kf_valid).copy()
    mask[int(s2.map.n_kf):] = False
    blob = jcodec.extract_submap(s2.map, s2.tracker.meta, mask).to_bytes()

    rng = np.random.RandomState(0)
    voc = jvocab.train((rng.rand(600, 256) > 0.5).astype(np.uint8), branch=6, depth=2, seed=0)
    tvoc = convert.vocabulary_from_numpy(convert.vocabulary_to_numpy(voc))
    cfg = sj.settings.tracker_config()
    jt = sj.tracker
    jt.flush_pipeline()
    _replay(jt, st.tracker)
    weld_kf = jt.kf_chain[-1]
    out = {}
    for name in ("jax", "port"):
        port = name == "port"
        bus = (ttransport if port else jtransport).LoopbackTransport()
        if port:
            a = tagent.SlamAgent(1, convert.tracker_config_from_dict(
                convert.tracker_config_to_dict(st.tracker.config)), np.asarray(K),
                np.zeros(4, np.float32), tvoc, bus, [1, 2], autonomous=False, device="cpu")
            a.tracker = st.tracker
            mB, metaB = tcodec.materialize(tcodec.MapPacket.from_bytes(blob),
                                           cfg.frontend.capacity, device="cpu")
            S = torch.from_numpy(np.asarray(jlie.sim3_identity()))
        else:
            a = jagent.SlamAgent(1, cfg, np.asarray(K), np.zeros(4, np.float32), voc, bus,
                                 [1, 2], autonomous=False)
            a.tracker = jt
            mB, metaB = jcodec.materialize(jcodec.MapPacket.from_bytes(blob),
                                           cfg.frontend.capacity)
            S = np.asarray(jlie.sim3_identity())
        a.tracker.meta.agent_id = 1
        a._do_merge(2, mB, metaB, S, weld_kf)
        assert ("merged", 2) in a.log, a.log
        t = a.tracker
        out[name] = dict(vel={s: np.asarray(t.kf_vel[s]) for s in t.kf_chain},
                         bg=np.asarray(t.bias_g), ba=np.asarray(t.bias_a), agent=a,
                         ts=dict(t.kf_timestamps), chain=list(t.kf_chain))
    j, p = out["jax"], out["port"]
    assert p["chain"] == j["chain"]
    dv = {s: float(np.abs(p["vel"][s] - j["vel"][s]).max()) for s in j["chain"]}
    assert max(dv.values()) <= VEL_ATOL, dv
    db = max(float(np.abs(p[k] - j[k]).max()) for k in ("bg", "ba"))
    assert db <= BIAS_ATOL, (dv, db)
    checked = 0
    for s in p["chain"][-6:]:
        i = int(round(p["ts"][s] * 10.0))
        if 0 <= i < N:
            assert np.linalg.norm(p["vel"][s] - vels[i]) < 0.6, (s, i)
            checked += 1
    assert checked >= 3
    assert np.linalg.norm(p["bg"]) < 0.2 and np.linalg.norm(p["ba"]) < 1.0
    p["agent"].flush_gba()
    assert any(e[0] == "gba_applied" for e in p["agent"].log)
