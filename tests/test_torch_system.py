"""The port's `System` facade and settings against the JAX package.

The facade test runs `tests/test_io_system.py`'s scene (240x320, 600
features, 4 levels) through both packages' `System.track_monocular` from
frame 0: monocular two-view initialization, then the autonomous lane with
`auto_batch` 4. The port's RANSAC gets the reference's draws (the JAX key
schedule of `MonocularTracker._try_initialize` under the agent's seed).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvm_slam_tpu.io import config as jcfg
from dvm_slam_tpu.io import synthetic as jsyn
from dvm_slam_tpu.models import system as jsys

from dvm_slam_tpu_torch import convert
from dvm_slam_tpu_torch.eval import metrics as tmetrics
from dvm_slam_tpu_torch.io import config as tcfg
from dvm_slam_tpu_torch.io import trajectory as ttraj
from dvm_slam_tpu_torch.models import system as tsys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_twoview import reference_draws  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 16
AGENT = 3
N_BLACK = 9
POSE_ATOL = 5e-3     # exported poses, port against reference (f32 RANSAC solvers part)


def reference_noise(seed: int):
    """A stand-in for `MonocularTracker._ransac_noise` that replays the JAX
    tracker's draws: its key starts at PRNGKey(seed) and is split once per
    RANSAC call (`tracker.py:1270`)."""
    key = [jax.random.PRNGKey(seed)]

    def noise(n):
        key[0], sub = jax.random.split(key[0])
        nh, ne = reference_draws(sub, n)
        return torch.from_numpy(nh), torch.from_numpy(ne)

    return noise


def _settings():
    s = jcfg.SystemSettings()
    s.camera = jcfg.CameraSettings(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320,
                                   height=240, dist=(0.0, 0.0, 0.0, 0.0), fps=10.0)
    s.orb = jcfg.OrbSettings(n_features=600, n_levels=4)
    s.kf_capacity = 64
    s.pt_capacity = 4096
    return s


def _read(path, sep=None):
    return np.array([[float(v) for v in line.split(sep)] for line in open(path)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both facades over the same frames, their exported files, then
    N_BLACK black frames through the port's facade: two full batches, whose
    first ends lost, and one frame for the host path."""
    d = tmp_path_factory.mktemp("facade")
    settings = _settings()
    world = jsyn.PlaneWorld(seed=3, tex_size=1024, plane_z=6.0, extent=30.0)
    poses = jsyn.smooth_trajectory(30, lateral=2.0, forward=0.5, yaw=0.08)[:N_FRAMES]
    K = jnp.asarray(settings.camera.K())
    imgs = [np.asarray(world.render(jnp.asarray(T), K, 240, 320)) for T in poses]
    out = {"poses": poses}
    sj = jsys.System(settings, agent_id=AGENT)
    st = tsys.System(convert.system_settings_from_dict(dataclasses.asdict(settings)),
                     agent_id=AGENT, device="cpu")
    st.tracker._ransac_noise = reference_noise(AGENT)
    for name, s in (("jax", sj), ("port", st)):
        for i, img in enumerate(imgs):
            s.track_monocular(img, i * 0.1)
        files = {k: str(d / f"{name}_{k}.txt") for k in ("tum", "euroc", "kitti", "kf")}
        s.save_trajectory_tum(files["tum"])
        s.save_trajectory_euroc(files["euroc"])
        s.save_trajectory_kitti(files["kitti"])
        s.save_keyframe_trajectory_tum(files["kf"])
        out[name] = dict(files=files, state=s.get_tracking_state(), n_kf=int(s.map.n_kf),
                         n_kf_host=s.tracker.n_kf_host, kf_ts=dict(s.tracker.kf_timestamps),
                         autonomous=s.tracker.autonomous)
    t = st.tracker
    assert t.autonomous
    black = np.zeros((240, 320), np.float32)
    for j in range(N_BLACK):
        st.track_monocular(black, 10.0 + 0.1 * j)
    out["lost"] = dict(autonomous=t.autonomous, state=t.state, n_kf=int(t.map.n_kf),
                       n_kf_host=t.n_kf_host, kf_ts=dict(t.kf_timestamps),
                       uuids=t.meta.kf_uuid[:t.n_kf_host].copy(), n_frames=t.n_frames,
                       rows=len(t.trajectory))
    out["system"] = st
    return out


class TestSystemFacade:
    def test_tracks_and_exports(self, runs):
        """The same state, keyframes and rows as the reference; TUM, EuRoC
        and KITTI files with the same timestamps and poses within
        POSE_ATOL."""
        j, p = runs["jax"], runs["port"]
        assert p["state"] == j["state"] == "OK"
        assert runs["system"].get_agent_id() == AGENT
        assert p["n_kf"] == j["n_kf"] == p["n_kf_host"] >= 3
        assert p["kf_ts"] == j["kf_ts"]
        tum_j, tum_p = _read(j["files"]["tum"]), _read(p["files"]["tum"])
        assert len(tum_p) == len(tum_j) > 10
        np.testing.assert_array_equal(tum_p[:, 0], tum_j[:, 0])
        np.testing.assert_allclose(tum_p[:, 1:], tum_j[:, 1:], atol=POSE_ATOL)
        eu_j, eu_p = _read(j["files"]["euroc"], ","), _read(p["files"]["euroc"], ",")
        np.testing.assert_array_equal(eu_p[:, 0], eu_j[:, 0])
        np.testing.assert_allclose(eu_p[:, 1:], eu_j[:, 1:], atol=POSE_ATOL)
        ki_j, ki_p = _read(j["files"]["kitti"]), _read(p["files"]["kitti"])
        assert ki_p.shape == ki_j.shape == (len(tum_j), 12)
        np.testing.assert_allclose(ki_p, ki_j, atol=POSE_ATOL)
        kf_j, kf_p = _read(j["files"]["kf"]), _read(p["files"]["kf"])
        assert len(kf_p) == len(kf_j) == j["n_kf"]
        np.testing.assert_allclose(kf_p, kf_j, atol=POSE_ATOL)

    def test_exports_agree_with_each_other(self, runs):
        """The port's three files hold the same poses: TUM's (t, q) is
        EuRoC's with the quaternion reordered, KITTI's last column is t."""
        f = runs["port"]["files"]
        tum, eu, ki = _read(f["tum"]), _read(f["euroc"], ","), _read(f["kitti"])
        np.testing.assert_allclose(eu[:, 0] * 1e-9, tum[:, 0], atol=1e-6)
        np.testing.assert_allclose(tum[:, 1:4], eu[:, 1:4], atol=1e-7)
        np.testing.assert_allclose(tum[:, [7, 4, 5, 6]], eu[:, 4:8], atol=1e-7)
        np.testing.assert_allclose(ki[:, [3, 7, 11]], tum[:, 1:4], atol=1e-6)

    def test_accuracy_matches_reference(self, runs):
        """Sim3-aligned ATE of each package's TUM file against ground truth."""
        ates = {}
        for name in ("jax", "port"):
            rows = ttraj.load_tum(runs[name]["files"]["tum"])
            gt = np.stack([runs["poses"][int(round(ts * 10))] for ts, _ in rows])
            ates[name] = tmetrics.ate_rmse(np.stack([T for _, T in rows]), gt)[0]
        assert ates["port"] < 0.05
        assert abs(ates["port"] - ates["jax"]) < 0.01

    def test_black_frames_hand_back(self, runs):
        """A lost frame in the autonomous lane hands control back to the host
        state machine; the keyframe mirror stays equal to the map, every
        keyframe has a timestamp and a uuid."""
        lost = runs["lost"]
        assert not lost["autonomous"]
        assert lost["state"] in ("RECENTLY_LOST", "LOST")
        assert lost["n_kf_host"] == lost["n_kf"]
        assert set(lost["kf_ts"]) == set(range(lost["n_kf_host"]))
        assert (lost["uuids"].sum(axis=1) != 0).all()
        assert lost["n_frames"] == N_FRAMES + N_BLACK
        # lost frames leave no row, except the last: after the hand-back the
        # pipelined lane records the pose it dispatched, as the reference does
        assert lost["rows"] == len(_read(runs["port"]["files"]["tum"])) + 1

    def test_unported_paths_raise(self, runs, tmp_path, monkeypatch):
        """The viewer draws (headless: PNG frames under `viewer_frames/`
        every 10th frame, as the reference's); the inertial sensor modes
        construct and track (`tests/test_torch_vi_*.py` hold them to the
        reference); a
        stereo System without a baseline raises ValueError as the
        reference's does; map serialization and the checkpoint are ported
        (`tests/test_torch_multiagent.py`)."""
        st = runs["system"]
        from dvm_slam_tpu_torch.multiagent import codec as tcodec
        packet = tcodec.MapPacket.from_bytes(st.serialize_map())
        assert packet.n_kf == int(st.map.kf_valid.sum())
        settings = convert.system_settings_from_dict(dataclasses.asdict(_settings()))
        assert settings.camera.baseline == 0.0
        for sensor in ("stereo", "rgbd"):
            with pytest.raises(ValueError):
                jsys.System(_settings(), sensor=sensor)
            with pytest.raises(ValueError):
                tsys.System(settings, sensor=sensor, device="cpu")
        img = np.zeros((240, 320), np.float32)
        none = (np.zeros((0, 3), np.float32),) * 2 + (np.zeros(0, np.float32),)
        for sensor in ("imu-monocular", "imu-stereo", "imu-rgbd"):
            s = convert.system_settings_from_dict(dataclasses.asdict(_settings()))
            s.camera.baseline = 0.0 if sensor == "imu-monocular" else 0.1
            sysm = tsys.System(s, sensor=sensor, device="cpu")
            assert sysm.tracker.inertial and not sysm.is_imu_initialized()
            if sensor == "imu-monocular":
                out = sysm.track_monocular_inertial(img, 0.0, *none)
            elif sensor == "imu-stereo":
                out = sysm.track_stereo_inertial(img, img, 0.0, *none)
            else:
                out = sysm.track_rgbd_inertial(img, img, 0.0, *none)
            assert out is None and sysm.get_tracking_state() == "NOT_INITIALIZED"
        monkeypatch.chdir(tmp_path)
        monkeypatch.delenv("DISPLAY", raising=False)
        viewed = tsys.System(settings, device="cpu", use_viewer=True)
        assert viewed.viewer is not None and not viewed.viewer.interactive
        rng = np.random.RandomState(0)
        drawn = 0
        for i in range(10):
            viewed.track_monocular((rng.rand(240, 320) * 255).astype(np.float32), i * 0.1)
            drawn += viewed.tracker.n_frames % 10 == 0
        viewed.viewer.close()
        frames = sorted(os.listdir(tmp_path / "viewer_frames"))
        assert drawn >= 1 and frames == [f"viewer_{k:05d}.png" for k in range(drawn)]
        assert all(os.path.getsize(tmp_path / "viewer_frames" / f) > 1000 for f in frames)
        assert tuple(settings.imu.calib()) == tuple(float(np.asarray(v))
                                                   for v in jcfg.ImuSettings().calib())


class TestSettings:
    @pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(REPO, "configs"))))
    def test_load_settings_matches_reference(self, name):
        path = os.path.join(REPO, "configs", name)
        want = dataclasses.asdict(jcfg.load_settings(path))
        got = dataclasses.asdict(tcfg.load_settings(path))
        assert got == want
        js, ts = jcfg.load_settings(path), tcfg.load_settings(path)
        np.testing.assert_array_equal(ts.camera.K(), js.camera.K())
        assert ts.frontend_config().capacity == js.frontend_config().capacity
        assert (convert.tracker_config_to_dict(ts.tracker_config())
                == dataclasses.asdict(js.tracker_config()))

    def test_reference_style_keys(self, tmp_path):
        p = tmp_path / "ref.yaml"
        p.write_text(
            "%YAML:1.0\n"
            "Camera.type: \"PinHole\"\n"
            "Camera1.fx: 500.0\nCamera1.fy: 501.0\nCamera1.cx: 320.0\nCamera1.cy: 240.0\n"
            "Camera1.k1: -0.1\nCamera1.k2: 0.02\nCamera1.p1: 0.0\nCamera1.p2: 0.0\n"
            "Camera.width: 640\nCamera.height: 480\nCamera.fps: 30\nCamera.bf: 40.0\n"
            "ORBextractor.nFeatures: 900\nORBextractor.scaleFactor: 1.2\n"
            "ORBextractor.nLevels: 8\nORBextractor.iniThFAST: 20\n"
            "ORBextractor.minThFAST: 7\n"
            "System.SaveAtlasToFile: \"out.atlas\"\n"
            "IMU.T_b_c1: !!opencv-matrix\n  rows: 4\n  cols: 4\n  dt: f\n"
            "  data: [0.0, -1.0, 0.0, 0.1, 1.0, 0.0, 0.0, -0.2, 0.0, 0.0, 1.0, 0.05,"
            " 0.0, 0.0, 0.0, 1.0]\n"
        )
        want = dataclasses.asdict(jcfg.load_settings(str(p)))
        got = dataclasses.asdict(tcfg.load_settings(str(p)))
        T_cb_j, T_cb_t = want["imu"].pop("T_cb"), got["imu"].pop("T_cb")
        assert got == want
        np.testing.assert_allclose(T_cb_t, T_cb_j, atol=1e-6)
