"""The port's Kannala-Brandt-8 fisheye camera against the JAX package.

The model's projection and its Newton inverse (across the whole image of
`configs/tum_vi.yaml`'s camera, corners past the polynomial's range
included), the dispatch by model name, the rectified keypoints of
`make_frame(camera_model="kb8")`, and a monocular KB8 tracker stepped from
the JAX tracker's state on fisheye frames: pinhole renders of the dense
36-patch world warped into the fisheye (`chip_smoke.warp_to_fisheye`, the
smoke's phase 26 frames at 240x320).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dvm_slam_tpu.frontend import extractor as jex
from dvm_slam_tpu.geometry import cameras as jcam
from dvm_slam_tpu.io import synthetic as jsyn
from dvm_slam_tpu.mapping import local_mapping as jlm
from dvm_slam_tpu.tracking import tracker as jtrk

from dvm_slam_tpu_torch import convert
from dvm_slam_tpu_torch.frontend import extractor as tex
from dvm_slam_tpu_torch.geometry import cameras as tcam
from dvm_slam_tpu_torch.io import config as tcfg
from dvm_slam_tpu_torch.mapping import local_mapping as tlm
from dvm_slam_tpu_torch.models import system as tsys
from dvm_slam_tpu_torch.tracking import tracker as ttrk

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

TUM_VI = np.array([190.97847715128717, 190.9733070521226, 254.93170605935475,
                   256.8974428996504, 0.0034823894022493434, 0.0007150348452162257,
                   -0.0020532361418706202, 0.00020293673591811182], np.float32)
H, W = 240, 320
PARAMS = np.array([200.0, 200.0, 160.0, 120.0, 0.02, -0.005, 0.003, -0.001], np.float32)
N_FRAMES = 12
RAY_TOL = 1e-5
PX_TOL = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_dict(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items() if v is not None}


def _points(seed, n=400):
    """Camera-frame points from the optical axis out to 85 degrees, a few
    exactly on the axis, some behind the camera."""
    rng = np.random.RandomState(seed)
    theta = rng.uniform(0.0, np.deg2rad(85.0), n)
    phi = rng.uniform(-np.pi, np.pi, n)
    r = rng.uniform(0.5, 8.0, n)
    p = np.c_[r * np.sin(theta) * np.cos(phi), r * np.sin(theta) * np.sin(phi),
              r * np.cos(theta)]
    p[:5, :2] = 0.0
    p[5:15, 2] *= -1.0
    return p.astype(np.float32)


class TestModel:
    @pytest.mark.parametrize("params", [TUM_VI, PARAMS], ids=["tum_vi", "strong"])
    def test_project(self, params):
        """uv to 1e-3 px, the validity flags identical."""
        p = _points(0)
        uv_j, ok_j = jcam.kb8_project(jnp.asarray(params), jnp.asarray(p))
        uv_t, ok_t = tcam.kb8_project(_t(params), _t(p))
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), atol=PX_TOL)
        np.testing.assert_allclose(uv_t.numpy()[:5], np.broadcast_to(params[2:4], (5, 2)))

    @pytest.mark.parametrize("params", [TUM_VI, PARAMS], ids=["tum_vi", "strong"])
    def test_unproject(self, params):
        """Every 4th pixel of a 512x512 image, the centre pixel and the
        corners: rays to 1e-5 (relative past 1) out to 88 degrees from the
        axis. Past that (TUM-VI's corners lie past the clamp of theta_d at
        pi/2) the ray's length is tan(theta) near pi/2, where one f32 ulp of
        theta moves it by ~1e-3 relative: there the direction is held to
        1e-5 and the length to 1e-2 relative."""
        v, u = np.meshgrid(np.arange(0, 512, 4), np.arange(0, 512, 4), indexing="ij")
        uv = np.c_[u.ravel(), v.ravel()].astype(np.float32)
        uv = np.r_[uv, params[None, 2:4], [[0, 0], [511, 511]]].astype(np.float32)
        r_j = np.asarray(jcam.kb8_unproject(jnp.asarray(params), jnp.asarray(uv)))
        r_t = tcam.kb8_unproject(_t(params), _t(uv)).numpy()
        assert np.isfinite(r_t).all()
        steep = np.hypot(r_j[:, 0], r_j[:, 1]) > np.tan(np.deg2rad(88.0))
        assert steep.any() != (params is PARAMS)     # TUM-VI's corners reach the clamp
        np.testing.assert_allclose(r_t[~steep], r_j[~steep], rtol=RAY_TOL, atol=RAY_TOL)
        n_t = np.linalg.norm(r_t[steep], axis=1)
        n_j = np.linalg.norm(r_j[steep], axis=1)
        np.testing.assert_allclose(r_t[steep] / n_t[:, None], r_j[steep] / n_j[:, None],
                                   atol=RAY_TOL)
        np.testing.assert_allclose(n_t, n_j, rtol=1e-2)
        # the Newton inverse undoes the projection inside the model's range
        p = _points(1)
        p = p[(p[:, 2] > 0) & (np.arctan2(np.hypot(p[:, 0], p[:, 1]), p[:, 2]) < 1.2)]
        uv_p, _ = tcam.kb8_project(_t(params), _t(p))
        ray = tcam.kb8_unproject(_t(params), uv_p).numpy()
        np.testing.assert_allclose(ray, p / p[:, 2:], atol=1e-4)

    def test_dispatch_and_intrinsics(self):
        p = _points(2)[20:40]
        for model in ("pinhole", "kb8"):
            uv_j, _ = jcam.project(model, jnp.asarray(PARAMS), jnp.asarray(p))
            uv_t, _ = tcam.project(model, _t(PARAMS), _t(p))
            np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), atol=PX_TOL)
            r_j = jcam.unproject(model, jnp.asarray(PARAMS), jnp.asarray(uv_j))
            r_t = tcam.unproject(model, _t(PARAMS), uv_t)
            np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=RAY_TOL, atol=RAY_TOL)
        with pytest.raises(ValueError):
            tcam.project("ds", _t(PARAMS), _t(p))
        np.testing.assert_array_equal(tcam.intrinsic_matrix(_t(PARAMS)).numpy(),
                                      np.asarray(jcam.intrinsic_matrix(jnp.asarray(PARAMS))))


@pytest.fixture(scope="module")
def fisheye_scene():
    """Fisheye frames of the dense world along a sideways arc."""
    world = jsyn.PlaneWorld(seed=3, tex_size=1024, plane_z=6.0, extent=30.0,
                            **chip_smoke.DENSE_WORLD)
    poses = jsyn.smooth_trajectory(30, lateral=2.0, forward=0.5, yaw=0.08)[:N_FRAMES]
    Ks, S = chip_smoke.fisheye_source(PARAMS)
    field = chip_smoke.fisheye_field(PARAMS, H, W)
    imgs = [chip_smoke.warp_to_fisheye(world.render(jnp.asarray(p), jnp.asarray(Ks), S, S),
                                       field) for p in poses]
    return poses, imgs


def test_warp_covers_the_image_circle(fisheye_scene):
    """The warped frames are black exactly outside the image circle (60
    degrees from the axis): none of this 240x320 frame, TUM-VI's corners."""
    _, imgs = fisheye_scene
    _, _, inside = chip_smoke.fisheye_field(PARAMS, H, W)
    assert inside.all() and imgs[0].mean() > 20
    _, _, inside = chip_smoke.fisheye_field(TUM_VI, 512, 512)
    assert inside[256, 256] and not inside[0, 0] and not inside[256, 0]
    x, y, _ = chip_smoke.fisheye_field(TUM_VI, 512, 512)
    _, S = chip_smoke.fisheye_source(TUM_VI)
    assert 0 <= x[inside].min() and x[inside].max() <= S - 1
    assert 0 <= y[inside].min() and y[inside].max() <= S - 1
    img = chip_smoke.warp_to_fisheye(np.full((S, S), 7.0, np.float32), (x, y, inside))
    assert (img[~inside] == 0).all() and (img[inside] == 7.0).all()


def test_make_frame_kb8(fisheye_scene):
    """Rectified keypoints: raw keypoints identical, the rectified ones
    within 1e-3 px of the reference's and equal to the pinhole projection of
    the model's rays. Descriptors: under 1e-4 of the bits differ (the
    orientation's moments are summed in another order, and a steered test
    whose rotated offset rounds the other way flips a bit)."""
    _, imgs = fisheye_scene
    fc = jex.FrontendConfig(height=H, width=W, n_features=600, n_levels=4)
    fj = jex.make_frame(jnp.asarray(imgs[0]), jnp.asarray(PARAMS[:4]), jnp.asarray(PARAMS[4:]),
                        fc, camera_model="kb8")
    tfc = tex.FrontendConfig(height=H, width=W, n_features=600, n_levels=4)
    ft = tex.make_frame(_t(imgs[0]), _t(PARAMS[:4]), _t(PARAMS[4:]), tfc, camera_model="kb8")
    for k in ("xy_raw", "level", "valid"):
        np.testing.assert_array_equal(getattr(ft, k).numpy(), np.asarray(getattr(fj, k)))
    assert (ft.desc.numpy() != np.asarray(fj.desc)).mean() < 1e-4
    np.testing.assert_allclose(ft.xy.numpy(), np.asarray(fj.xy), atol=PX_TOL)
    v = ft.valid.numpy()
    assert v.sum() > 200
    ray = tcam.kb8_unproject(_t(PARAMS), ft.xy_raw[ft.valid])
    want, _ = tcam.pinhole_project(_t(PARAMS[:4]), ray)
    np.testing.assert_allclose(ft.xy.numpy()[v], want.numpy(), atol=PX_TOL)
    moved = np.abs(ft.xy.numpy()[v] - ft.xy_raw.numpy()[v]).max()
    assert moved > 1.0     # the fisheye really bends the keypoints


def _config():
    return jtrk.TrackerConfig(frontend=jex.FrontendConfig(height=H, width=W, n_features=600,
                                                          n_levels=4),
                              kf_cap=64, pt_cap=4096, fps=10.0, camera_model="kb8")


def _mapper(mod):
    return mod.LocalMapper(n_neighbors=4, ba_local=8, ba_fixed=4, ba_pts=2048, ba_iters=4)


@pytest.fixture(scope="module")
def stepped_kb8(fisheye_scene):
    """The JAX KB8 tracker through `process_image` from frame 0 (two-view
    init on rectified keypoints); after its init, before each of its steps,
    a port tracker takes the same step from its map and host state: the
    port's own KB8 front end, tracking, keyframe and mapper chain."""
    _, imgs = fisheye_scene
    cfg = _config()
    tcfg_ = convert.tracker_config_from_dict(dataclasses.asdict(cfg))
    tj = jtrk.MonocularTracker(cfg, PARAMS[:4], PARAMS[4:], local_mapper=_mapper(jlm))
    steps = []
    for i, img in enumerate(imgs):
        port = None
        if tj.state == jtrk.OK:
            tt = ttrk.MonocularTracker(tcfg_, PARAMS[:4], PARAMS[4:], local_mapper=_mapper(tlm),
                                       device="cpu")
            tt.map = convert.map_state_from_numpy(_np_dict(tj.map))
            convert.tracker_host_state_from_numpy(tt, convert.tracker_host_state_to_numpy(tj))
            tt.local_mapper._kf_count = tj.local_mapper._kf_count
            tt.n_frames = tj.n_frames
            pose = tt.process_image(img, i * 0.1)
            port = dict(pose=None if pose is None else pose.numpy(), n_kf=tt.n_kf_host,
                        state=tt.state)
        pose = tj.process_image(img, i * 0.1)
        steps.append(dict(port=port, pose=None if pose is None else np.asarray(pose),
                          n_kf=tj.n_kf_host, state=tj.state))
    return steps


def test_kb8_tracker_steps(stepped_kb8):
    """The JAX tracker initializes on these frames; every later step of the
    port from its state makes the same keyframe decision and state, the
    pose to 1e-3."""
    done = [s for s in stepped_kb8 if s["port"] is not None]
    assert len(done) >= 6
    for s in done:
        assert s["port"]["state"] == s["state"] == "OK"
        assert s["port"]["n_kf"] == s["n_kf"]
        np.testing.assert_allclose(s["port"]["pose"], s["pose"], atol=1e-3)
    assert done[-1]["n_kf"] > 2


def test_system_takes_the_camera_model():
    """`camera.model: kb8` reaches the tracker through the settings."""
    s = chip_smoke.settings9(26, tcfg)
    system = tsys.System(s, device="cpu")
    assert system.tracker.config.camera_model == "kb8"
    np.testing.assert_allclose(system.tracker.dist.numpy(), np.asarray(s.camera.dist, np.float32))
