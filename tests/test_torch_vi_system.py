"""The port's IMU-monocular `System` stepped against the JAX `System`.

The JAX tests' VI scene (`tests/test_vi_pipeline.py`): 320x240, 600
features, kf 64, pt 4096, camera 10 fps, IMU 100 Hz, `PlaneWorld(seed=3,
tex_size=1024, extent=30)` along `vi_trajectory(..., lateral=2.0,
forward=0.5, z_amp=0.3)`. Both facades take every frame in turn. The port's
two-view RANSAC replays the JAX tracker's draws (`reference_noise`), and in
both the pipelined VI lane retires a record as soon as the next one is
dispatched (`_record_ready` true, as the CPU always does; on the card it
depends on the device's speed, ROADMAP fault s).

Held per call: the same state, the same IMU-initialized flag (so the same
IMU-init call), the same keyframe count, and poses within POSE_ATOL_*:
after the IMU-init call 1e-2 (the init's f32 SVD and the VI BA's
equilibrated solve part in the last bits); before it 1e-3 for a depth
sensor, but 3e-2 for the monocular camera, whose two-view init parts by
1.5e-3 (f32 RANSAC solvers, ROADMAP fault o) and whose free-scale window
carries that apart to 2.3e-2 by frame 14 (fault n); the metric re-base at
the IMU init brings it back under 1e-2. At the end: the same keyframe
frames and chain, and each chain keyframe's preintegration window over the
same samples (dT equal) with dR, dV, dP within 1e-3.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dvm_slam_tpu.io import config as jcfg
from dvm_slam_tpu.io import synthetic as jsyn
from dvm_slam_tpu.models import system as jsys

from dvm_slam_tpu_torch import convert
from dvm_slam_tpu_torch.io import synthetic as tsyn
from dvm_slam_tpu_torch.models import system as tsys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_system import reference_noise  # noqa: E402

torch.set_num_threads(2)

AGENT = 1
FPS = 10.0
BASELINE = {"imu-monocular": 0.0, "imu-stereo": 0.12, "imu-rgbd": 0.2}
POSE_ATOL_PRE = 3e-2    # monocular, before the IMU init (faults n, o)
POSE_ATOL_DEPTH = 1.5e-2  # stereo and RGB-D, before the IMU init
POSE_ATOL_POST = 1e-2   # after the IMU-init call
PRE_ATOL = 1e-3


def vi_settings(mode):
    s = jcfg.SystemSettings()
    s.camera = jcfg.CameraSettings(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320,
                                   height=240, dist=(0.0, 0.0, 0.0, 0.0), fps=FPS,
                                   baseline=BASELINE[mode])
    s.orb = jcfg.OrbSettings(n_features=600)
    s.kf_capacity = 64
    s.pt_capacity = 4096
    s.imu = jcfg.ImuSettings(frequency=100.0)
    return s


def build_pair(mode):
    """The JAX System and the port's (CPU) on the same settings, agent 1."""
    s = vi_settings(mode)
    sj = jsys.System(s, sensor=mode, agent_id=AGENT)
    sj.tracker._record_ready = lambda rec: True
    st = tsys.System(convert.system_settings_from_dict(dataclasses.asdict(s)), sensor=mode,
                     agent_id=AGENT, device="cpu")
    st.tracker._ransac_noise = reference_noise(AGENT)
    st.tracker._record_ready = lambda rec: True
    return sj, st


def scene(n_traj):
    world = jsyn.PlaneWorld(seed=3, tex_size=1024, plane_z=6.0, extent=30.0)
    poses, chunks, vels = jsyn.vi_trajectory(n_traj, fps=FPS, imu_rate=100.0, lateral=2.0,
                                             forward=0.5, z_amp=0.3)
    return world, poses, chunks, vels


def call(sysm, mode, world, pose, K, ts, chunk, blank=False):
    """One `track_*_inertial` call with the frame rendered by the JAX world
    (the same numpy input for both packages)."""
    T = jnp.asarray(pose)
    if mode == "imu-monocular":
        img = (np.zeros((240, 320), np.float32) if blank
               else np.asarray(world.render(T, K, 240, 320)))
        return sysm.track_monocular_inertial(img, ts, *chunk)
    if mode == "imu-stereo":
        il, ir = world.render_stereo(T, K, 240, 320, BASELINE[mode])
        return sysm.track_stereo_inertial(np.asarray(il), np.asarray(ir), ts, *chunk)
    return sysm.track_rgbd_inertial(np.asarray(world.render(T, K, 240, 320)),
                                    np.asarray(world.render_depth(T, K, 240, 320)), ts, *chunk)


def lockstep(mode, n, n_traj, blank=()):
    """Both facades through frames 0..n-1 of an `n_traj`-frame trajectory
    (those in `blank` black), compared per call. Returns (jax System, port
    System, log)."""
    sj, st = build_pair(mode)
    world, poses, chunks, vels = scene(n_traj)
    K = jnp.asarray(sj.settings.camera.K())
    log = dict(init_at=None, worst_pre=0.0, worst_post=0.0, poses={}, vels=vels,
               gt=poses)
    for i in range(n):
        pj = call(sj, mode, world, poses[i], K, i / FPS, chunks[i], i in blank)
        pt = call(st, mode, world, poses[i], K, i / FPS, chunks[i], i in blank)
        tj, tt = sj.tracker, st.tracker
        assert (pj is None) == (pt is None), f"frame {i}: pose {pj} against {pt}"
        assert tt.state == tj.state, f"frame {i}: state {tt.state} against {tj.state}"
        assert tt.imu_initialized == tj.imu_initialized, f"frame {i}: IMU init differs"
        assert tt.n_kf_host == tj.n_kf_host, f"frame {i}: {tt.n_kf_host} keyframes " \
                                             f"against {tj.n_kf_host}"
        if log["init_at"] is None and tt.imu_initialized:
            log["init_at"] = i
        if pj is not None:
            d = float(np.abs(np.asarray(pt.cpu()) - np.asarray(pj)).max())
            key = "worst_post" if log["init_at"] not in (None, i) else "worst_pre"
            log[key] = max(log[key], d)
            log["poses"][i] = np.asarray(pt.cpu())
            log.setdefault("diffs", {})[i] = d
    return sj, st, log


def assert_chains_agree(sj, st):
    tj, tt = sj.tracker, st.tracker
    tj.flush_pipeline()
    tt.flush_pipeline()
    assert tt.kf_chain == tj.kf_chain
    assert sorted(tt.kf_timestamps.items()) == sorted(tj.kf_timestamps.items())
    assert sorted(tt.kf_preint) == sorted(tj.kf_preint)
    for s in tj.kf_preint:
        a = convert.preintegrated_to_numpy(tj.kf_preint[s])
        b = convert.preintegrated_to_numpy(tt.kf_preint[s])
        assert abs(float(a["dT"]) - float(b["dT"])) <= 1e-6, f"slot {s}: another window"
        for k in ("dR", "dV", "dP"):
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=PRE_ATOL, err_msg=f"{s} {k}")
    # each window spans its keyframes' timestamp gap
    for prev, cur in zip(tt.kf_chain[:-1], tt.kf_chain[1:]):
        if cur in tt.kf_preint:
            gap = tt.kf_timestamps[cur] - tt.kf_timestamps[prev]
            assert abs(float(tt.kf_preint[cur].dT) - gap) < 1e-3


def test_imu_monocular_steps_with_reference():
    """Two-view init, the IMU initialization with its world re-base and the
    chain-wide VI BA, the VI lane with keyframes every 0.25 s and their VI
    local BA, two black frames dead-reckoned after the init, and the first
    scale refinement: the first 40 frames of `test_imu_monocular_end_to_end`'s
    46."""
    n, blank = 40, (30, 31)
    sj, st, log = lockstep("imu-monocular", n, 46, blank)
    assert st.mapper._scale_refinements == sj.mapper._scale_refinements >= 1
    assert log["init_at"] is not None and log["init_at"] < n - 5, log["init_at"]
    assert log["worst_pre"] <= POSE_ATOL_PRE, log["diffs"]
    assert log["worst_post"] <= POSE_ATOL_POST, log["diffs"]
    for i in blank:
        assert i in log["poses"], f"no pose for black frame {i}"
    assert st.get_tracking_state() == "OK"
    assert_chains_agree(sj, st)
    tj, tt = sj.tracker, st.tracker
    # the gyro bias (true value 0) is weakly observed: its estimates part by
    # 1.2e-3 rad/s after the scale refinement while the poses hold 1e-2
    np.testing.assert_allclose(tt.bias_g, np.asarray(tj.bias_g), rtol=0, atol=3e-3)
    np.testing.assert_allclose(tt.vel_w, np.asarray(tj.vel_w), rtol=0, atol=2e-2)
    # the host state crosses between the packages with the inertial members
    d = convert.tracker_host_state_to_numpy(tj)
    convert.tracker_host_state_from_numpy(tt, d)
    back = convert.tracker_host_state_to_numpy(tt)
    assert back["kf_chain"] == d["kf_chain"] and back["imu_initialized"]
    for s in d["kf_preint"]:
        for k, v in d["kf_preint"][s].items():
            assert np.array_equal(back["kf_preint"][s][k], v)
    assert [c[0].shape for c in back["_imu_kf"]] == [c[0].shape for c in d["_imu_kf"]]


def test_port_vi_trajectory_matches_reference():
    """The port's `vi_trajectory` (the smoke's scene, without JAX) against
    the reference's: poses and velocities equal, IMU samples to f32
    rounding."""
    a = jsyn.vi_trajectory(9, fps=20.0, imu_rate=200.0, lateral=2.5, forward=0.8, z_amp=0.1)
    b = tsyn.vi_trajectory(9, fps=20.0, imu_rate=200.0, lateral=2.5, forward=0.8, z_amp=0.1)
    for x, y in zip(a[0], b[0]):
        np.testing.assert_allclose(y, x, rtol=0, atol=1e-6)
    np.testing.assert_allclose(b[2], a[2], rtol=0, atol=1e-6)
    for x, y in zip(a[1], b[1]):
        for k, tol in ((0, 1e-5), (1, 1e-5), (2, 0.0)):
            assert x[k].shape == y[k].shape
            np.testing.assert_allclose(y[k], x[k], rtol=0, atol=tol)


@pytest.mark.parametrize("sensor", ["imu-monocular", "imu-stereo", "imu-rgbd"])
def test_port_system_defaults_to_the_vi_lane(sensor):
    """The facade's IMU modes: the pipelined VI lane (async_depth 8, no
    autonomous lane), the calibration from the settings, the metric atlas
    scale; a stereo or RGB-D mode without a baseline raises as the
    reference's does."""
    s = convert.system_settings_from_dict(dataclasses.asdict(vi_settings(sensor)))
    st = tsys.System(s, sensor=sensor, device="cpu")
    t = st.tracker
    assert t.inertial and t.async_depth == 8 and not t.auto_mode
    assert t.imu_calib == s.imu.calib()
    assert t.config.sensor == {"imu-monocular": "monocular", "imu-stereo": "stereo",
                               "imu-rgbd": "rgbd"}[sensor]
    assert not st.is_imu_initialized()
    if sensor != "imu-monocular":
        s.camera.baseline = 0.0
        with pytest.raises(ValueError):
            tsys.System(s, sensor=sensor, device="cpu")
        with pytest.raises(ValueError):
            jsys.System(jcfg.SystemSettings(), sensor=sensor)
