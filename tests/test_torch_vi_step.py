"""The port's IMU-monocular VI lane held step by step against the JAX
package's (ROADMAP faults y and z).

The scene is `tests/test_torch_vi_system.py`'s (320x240, 600 features, IMU
100 Hz, 46-frame `vi_trajectory`), and frames WEAK_SPAN keep only a central
WEAK_BOX-pixel window, so after the IMU init they track with 15-59 inliers:
weak frames, the only ones the port's pose-inertial refinement serves
(`tracker.py::_track_pipelined_vi`), where the reference runs it on every
frame and selects its outputs on the device.

Until the two-view init both facades take each frame in turn (the port's
RANSAC replays the JAX draws). From the first tracked frame on, every step
starts the port from the JAX tracker's state: the map and its metadata, the
host state with its inertial members (`convert.tracker_host_state_*`) and
the mapper's counters; the device chain re-seeds from the mirrors in both.
Each package then tracks the frame and retires it in the same call
(`flush_pipeline`). Held per step, within STEP_ATOL (as `convert.
auto_state_*` holds the visual window): the pose returned; the record's
inlier count (identical), velocity and biases; after the retire the state,
keyframes, chain and IMU flag (identical), the last pose, velocity and
biases. The whole-run bounds of `tests/test_torch_vi_system.py` stay as
they are.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dvm_slam_tpu.io import synthetic as jsyn
from dvm_slam_tpu.models import system as jsys

from dvm_slam_tpu_torch import convert
from dvm_slam_tpu_torch.mapping import map_state as tms
from dvm_slam_tpu_torch.models import system as tsys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_system import reference_noise  # noqa: E402
from test_torch_vi_system import AGENT, FPS, vi_settings  # noqa: E402

torch.set_num_threads(2)

N_TRAJ, N = 46, 40
WEAK_SPAN = range(30, 36)   # after the IMU init (call 28 in both packages)
WEAK_BOX = 110              # the window of a weak frame kept, pixels
STEP_ATOL = 1e-3
MAPPER_COUNTERS = ("_kfs_at_init", "_scale_refinements", "_kf_count")


def _frame(world, pose, K, i):
    img = np.asarray(world.render(jnp.asarray(pose), K, 240, 320))
    if i in WEAK_SPAN:
        keep = np.zeros_like(img)
        keep[120 - WEAK_BOX // 2:120 + WEAK_BOX // 2, 160 - WEAK_BOX // 2:160 + WEAK_BOX // 2] = 1
        img = img * keep
    return img


def _start_from_reference(sj, st):
    """The JAX tracker's (retired) state into the port's, both device
    chains re-seeded from the mirrors."""
    jt, tt = sj.tracker, st.tracker
    tt.map = convert.map_state_from_numpy({k: np.asarray(v) for k, v in jt.map._asdict().items()})
    tt.meta = tms.MapMeta(**convert.map_meta_to_numpy(jt.meta))
    convert.tracker_host_state_from_numpy(tt, convert.tracker_host_state_to_numpy(jt))
    for k in MAPPER_COUNTERS:
        setattr(st.mapper, k, getattr(sj.mapper, k))
    tt._pipeline.clear()
    jt._vel_dev = tt._vel_dev = None


def _close(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


@pytest.fixture(scope="module")
def steps():
    s = vi_settings("imu-monocular")
    sj = jsys.System(s, sensor="imu-monocular", agent_id=AGENT)
    st = tsys.System(convert.system_settings_from_dict(dataclasses.asdict(s)),
                     sensor="imu-monocular", agent_id=AGENT, device="cpu")
    st.tracker._ransac_noise = reference_noise(AGENT)
    for t in (sj.tracker, st.tracker):
        t._record_ready = lambda rec: True
    world = jsyn.PlaneWorld(seed=3, tex_size=1024, plane_z=6.0, extent=30.0)
    poses, chunks, _ = jsyn.vi_trajectory(N_TRAJ, fps=FPS, imu_rate=100.0, lateral=2.0,
                                          forward=0.5, z_amp=0.3)
    K = jnp.asarray(s.camera.K())
    log = []
    for i in range(N):
        img, ts = _frame(world, poses[i], K, i), i / FPS
        jt, tt = sj.tracker, st.tracker
        stepped = jt.state == "OK"
        if stepped:
            _start_from_reference(sj, st)
        refines = tt.n_vi_refines
        pj = sj.track_monocular_inertial(img, ts, *chunks[i])
        pt = st.track_monocular_inertial(img, ts, *chunks[i])
        rec = {"i": i, "stepped": stepped, "state": (jt.state, tt.state),
               "pose": (pj is None, pt is None), "imu": jt.imu_initialized,
               "refined": tt.n_vi_refines - refines}
        if pj is not None and pt is not None:
            rec["d_pose"] = _close(pj, pt.cpu())
        if stepped and jt._pipeline and tt._pipeline:
            packed_j = np.asarray(jt._pipeline[-1][3])
            packed_t = tt._pipeline[-1][3].numpy()
            rec["inliers"] = (int(packed_j[0]), int(packed_t[0]))
            rec["d_chain"] = _close(packed_j[1:], packed_t[1:])
        if stepped:
            jt.flush_pipeline()
            tt.flush_pipeline()
            hj = convert.tracker_host_state_to_numpy(jt)
            ht = convert.tracker_host_state_to_numpy(tt)
            rec["host"] = tuple((hj[k], ht[k]) for k in ("state", "n_kf_host", "kf_chain",
                                                         "imu_initialized"))
            rec["d_host"] = max(_close(hj[k], ht[k]) for k in ("last_pose", "vel_w", "bias_g",
                                                             "bias_a"))
        log.append(rec)
    return log


def test_steps_start_from_the_reference(steps):
    """Fault y: every tracked step, started from the JAX tracker's state,
    gives the reference's pose, record and retired state within STEP_ATOL,
    before and after the IMU init."""
    stepped = [r for r in steps if r["stepped"]]
    assert len(stepped) >= 30 and any(r["imu"] for r in stepped)
    assert any(not r["imu"] for r in stepped), "no stepped frame before the IMU init"
    for r in steps:
        assert r["state"][0] == r["state"][1], r
        assert r["pose"][0] == r["pose"][1], r
    for r in stepped:
        assert r["d_pose"] <= STEP_ATOL, r
        assert r["inliers"][0] == r["inliers"][1], r
        assert r["d_chain"] <= STEP_ATOL, r
        for a, b in r["host"]:
            assert a == b, r
        assert r["d_host"] <= STEP_ATOL, r


def test_weak_frames_take_the_refinement(steps):
    """Fault z: the weak frames after the IMU init track with 15-59 inliers,
    the port runs the pose-inertial refinement on each (`n_vi_refines`) and
    its pose, velocity and biases are the ones the reference selects
    (within STEP_ATOL, held above); strong frames never refine."""
    weak = [r for r in steps if r["i"] in WEAK_SPAN]
    assert all(r["imu"] for r in weak), "the weak span must follow the IMU init"
    for r in weak:
        assert 15 <= r["inliers"][0] < 60, r
        assert r["refined"] == 1, r
    assert sum(r["refined"] for r in steps) == len(weak)
