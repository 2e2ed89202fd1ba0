"""The port's stereo and RGB-D sensor modes against the JAX package.

The stereo correspondence (`ops/stereo.py`) on the JAX front end's own
pyramids and the stereo frame field by field; pose optimization, windowed
and full-map BA with the disparity row; `local_ba` / `global_ba` with `bf`
and the depth map's one-anchor gauge; a 20-frame stereo and RGB-D
`MonocularTracker` run stepped from the JAX tracker's state; and both
`System` facades against the JAX facade.

The scene: 120x160 frames, 300 features on 4 levels, K = 130 px, a
0.25 m baseline, world seed 3 with its background plane at 3 m (stereo
matches on about 70 of the ~100 valid keypoints). At this size a frame has
fewer keypoints with depth than `min_init_stereo_points` (200) asks for, so
the runs lower it to 50 in both packages.

The SAD stage sums 121 f32 differences in another order in each package,
so a SAD tie or the median gate can flip a row: on the same pyramids the
coarse match indices are identical, `ur` agrees to 1e-3 px where both are
valid, and validity differs on at most 1% of the matched rows.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dvm_slam_tpu.frontend import extractor as jex
from dvm_slam_tpu.geometry import lie as jlie
from dvm_slam_tpu.io import config as jcfg
from dvm_slam_tpu.io import synthetic as jsyn
from dvm_slam_tpu.mapping import ba as jba
from dvm_slam_tpu.mapping import local_mapping as jlm
from dvm_slam_tpu.models import system as jsys
from dvm_slam_tpu.ops import matching as jm
from dvm_slam_tpu.ops import stereo as jst
from dvm_slam_tpu.tracking import pose_opt as jpo
from dvm_slam_tpu.tracking import tracker as jtrk

from dvm_slam_tpu_torch import convert
from dvm_slam_tpu_torch.frontend import extractor as tex
from dvm_slam_tpu_torch.mapping import ba as tba
from dvm_slam_tpu_torch.mapping import local_mapping as tlm
from dvm_slam_tpu_torch.models import system as tsys
from dvm_slam_tpu_torch.ops import stereo as tst
from dvm_slam_tpu_torch.tracking import pose_opt as tpo
from dvm_slam_tpu_torch.tracking import tracker as ttrk

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
import test_torch_mapping as tmap  # noqa: E402
from test_torch_slice import pipelined_head_repair  # noqa: E402

torch.set_num_threads(2)

H, W = 120, 160
K = np.array([130.0, 130.0, 80.0, 60.0], np.float32)
BASELINE = 0.25
BF = float(np.float32(K[0] * BASELINE))
BF_MAP = float(tmap.K[0]) * BASELINE     # test_torch_mapping's map and camera
N_FRAMES = 20
MIN_INIT = 50
UR_ATOL = 1e-3          # px, where both packages find a stereo match
VALID_FLIPS = 0.01      # of the matched rows


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_dict(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items() if v is not None}


@pytest.fixture(scope="module")
def scene():
    world = jsyn.PlaneWorld(seed=3, tex_size=1024, plane_z=3.0, extent=12.0)
    poses = jsyn.smooth_trajectory(N_FRAMES, lateral=0.8, forward=0.3, yaw=0.06)
    Kj = jnp.asarray(K)
    pairs, rgbd = [], []
    for p in poses:
        T = jnp.asarray(p)
        il, ir = world.render_stereo(T, Kj, H, W, BASELINE)
        pairs.append((np.asarray(il), np.asarray(ir)))
        rgbd.append((np.asarray(il), np.asarray(world.render_depth(T, Kj, H, W))))
    fc = jex.FrontendConfig(height=H, width=W, n_features=300, n_levels=4)
    return poses, pairs, rgbd, fc


def _ur_close(ur_t, ur_j, n_matched):
    both = (ur_t >= 0) & (ur_j >= 0)
    assert both.sum() > 40
    np.testing.assert_allclose(ur_t[both], ur_j[both], atol=UR_ATOL)
    assert ((ur_t >= 0) != (ur_j >= 0)).sum() <= VALID_FLIPS * n_matched


class TestStereoMatches:
    @pytest.mark.parametrize("i", [0, 9, 19])
    def test_on_jax_pyramids(self, scene, i):
        """`compute_stereo_matches` on the JAX extraction's keypoints and
        pyramids: coarse indices identical, ur to 1e-3 px, depth to 1e-4
        relative, at most 1% of the matched rows of another validity."""
        _, pairs, _, fc = scene
        fl, pyr_l = jex._extract_impl(jnp.asarray(pairs[i][0]), fc)
        fr, pyr_r = jex._extract_impl(jnp.asarray(pairs[i][1]), fc)
        args_j = (fl.xy_raw, fl.level, fl.desc, fl.valid, fr.xy_raw, fr.level, fr.desc,
                  fr.valid)
        ur_j, d_j = jst.compute_stereo_matches(*args_j, pyr_l, pyr_r, jnp.float32(K[0]),
                                               jnp.float32(BASELINE), n_levels=fc.n_levels)
        args_t = [_t(a) for a in args_j]
        ur_t, d_t = tst.compute_stereo_matches(*args_t, [_t(a) for a in pyr_l],
                                               [_t(a) for a in pyr_r], _t(K)[0], BASELINE,
                                               n_levels=fc.n_levels)
        # the coarse stage, as the reference computes it
        scales = jnp.asarray([1.2 ** k for k in range(fc.n_levels)], jnp.float32)
        s_r = scales[fr.level]
        dist = jm.hamming_matrix(fl.desc, fr.desc)
        disp = fl.xy_raw[:, 0:1] - fr.xy_raw[None, :, 0]
        mask = ((jnp.abs(fl.xy_raw[:, 1:2] - fr.xy_raw[None, :, 1]) <= 2.0 * s_r[None, :])
                & (disp > 0.0) & (disp <= K[0])
                & (jnp.abs(fl.level[:, None] - fr.level[None, :]) <= 1)
                & fl.valid[:, None] & fr.valid[None, :])
        ridx_j, _, ok_j = jm.masked_best_match(dist, mask, jst.TH_ORB)
        ridx_t, ok_t = tst.coarse_matches(*args_t, _t(K)[0], _t(np.asarray(s_r)))
        np.testing.assert_array_equal(ridx_t.numpy(), np.asarray(ridx_j))
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        ur_t, ur_j, d_t, d_j = ur_t.numpy(), np.asarray(ur_j), d_t.numpy(), np.asarray(d_j)
        _ur_close(ur_t, ur_j, int(np.asarray(ok_j).sum()))
        both = (ur_t >= 0) & (ur_j >= 0)
        np.testing.assert_allclose(d_t[both], d_j[both], rtol=1e-4)
        np.testing.assert_array_equal(d_t < 0, ur_t < 0)

    def test_make_frame_stereo_fields(self, scene):
        """The stereo frame field by field: one K1 call (here its plain
        version) describes both views, so keypoints, levels and descriptors
        are the JAX frame's; ur and depth as in the test above."""
        _, pairs, _, fc = scene
        il, ir = pairs[5]
        fj = jex.make_frame_stereo(jnp.asarray(il), jnp.asarray(ir), jnp.asarray(K),
                                   jnp.zeros(4), fc, jnp.float32(BASELINE))
        tfc = tex.FrontendConfig(height=H, width=W, n_features=300, n_levels=4)
        calls = []
        real = tex._orient_and_describe

        def counting(*a):
            calls.append(len(a[0]))
            return real(*a)

        tex._orient_and_describe = counting
        try:
            ft = tex.make_frame_stereo(_t(il), _t(ir), _t(K), torch.zeros(4), tfc, BASELINE)
        finally:
            tex._orient_and_describe = real
        assert calls == [2 * tfc.n_levels]
        for k in ("xy_raw", "level", "desc", "valid"):
            np.testing.assert_array_equal(getattr(ft, k).numpy(), np.asarray(getattr(fj, k)))
        for k in ("xy", "angle", "response"):
            np.testing.assert_allclose(getattr(ft, k).numpy(), np.asarray(getattr(fj, k)),
                                       rtol=1e-4, atol=1e-4)
        _ur_close(ft.ur.numpy(), np.asarray(fj.ur), int((np.asarray(fj.ur) >= 0).sum()))

    def test_rgbd_frame(self, scene):
        """`make_frame_rgbd`: the depth lookup and virtual right u."""
        _, _, rgbd, fc = scene
        img, depth = rgbd[3]
        fj = jex.make_frame_rgbd(jnp.asarray(img), jnp.asarray(depth), jnp.asarray(K),
                                 jnp.zeros(4), fc, jnp.float32(BF))
        tfc = tex.FrontendConfig(height=H, width=W, n_features=300, n_levels=4)
        ft = tex.make_frame_rgbd(_t(img), _t(depth), _t(K), torch.zeros(4), tfc, BF)
        np.testing.assert_array_equal(ft.desc.numpy(), np.asarray(fj.desc))
        np.testing.assert_array_equal(ft.ur.numpy() >= 0, np.asarray(fj.ur) >= 0)
        np.testing.assert_allclose(ft.ur.numpy(), np.asarray(fj.ur), atol=1e-4)
        np.testing.assert_allclose(ft.depth.numpy(), np.asarray(fj.depth), rtol=1e-6)


def _pose_problem(seed, n=160):
    """A pose 4-7 m from its points, 2/3 of them stereo rows, 10% gross
    outliers in u and 5% in ur, invalid rows."""
    rng = np.random.RandomState(seed)
    T = np.asarray(jlie.se3_exp(jnp.asarray(rng.randn(6).astype(np.float32) * 0.1)))
    pc = np.c_[rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 7, n)]
    pts = np.asarray(jlie.se3_apply(jlie.se3_inv(jnp.asarray(T))[None],
                                    jnp.asarray(pc.astype(np.float32))))
    uv = (K[:2] * pc[:, :2] / pc[:, 2:] + K[2:] + rng.randn(n, 2) * 0.7).astype(np.float32)
    ur = (uv[:, 0] - BF / pc[:, 2] + rng.randn(n) * 0.7).astype(np.float32)
    uv[rng.rand(n) < 0.1] += 40.0
    ur[rng.rand(n) < 0.05] -= 15.0
    ur[rng.rand(n) < 1 / 3] = -1.0
    sigma2 = np.asarray([1.0, 1.44, 2.0736], np.float32)[rng.randint(0, 3, n)]
    valid = rng.rand(n) > 0.05
    T0 = np.asarray(jlie.se3_retract(jnp.asarray(T), jnp.asarray(
        rng.randn(6).astype(np.float32) * 0.02)))
    return T0, pts, uv, sigma2, valid, ur


class TestStereoRows:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_pose_optimization(self, seed):
        """Poses to 1e-5, inliers identical, chi2 to 1e-4 (relative)."""
        T0, pts, uv, sig, valid, ur = _pose_problem(seed)
        Tj, inl_j, chi_j = jpo.pose_optimization(*[jnp.asarray(a) for a in
                                                   (T0, pts, uv, sig, valid)],
                                                 jnp.asarray(K), ur=jnp.asarray(ur), bf=BF)
        Tt, inl_t, chi_t = tpo.pose_optimization(*[_t(a) for a in (T0, pts, uv, sig, valid)],
                                                 _t(K), ur=_t(ur), bf=BF)
        np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-5)
        np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
        np.testing.assert_allclose(chi_t.numpy(), np.asarray(chi_j), rtol=1e-4, atol=1e-4)
        # the 3-dof gate: a stereo row is an inlier up to 7.815
        st = (ur >= 0) & np.asarray(inl_j)
        assert st.any() and np.asarray(chi_j)[st].max() <= jpo.CHI2_STEREO

    @staticmethod
    def _ba_problem(seed, L=5, n_pts=120, F=128, out=0.03):
        """Cameras on an arc around points 4-6 m ahead, keyframe 0 alone
        fixed (the disparity rows fix the scale), noisy poses and points,
        3% gross outliers in u and in ur, a right u on 70% of the
        observations."""
        rng = np.random.RandomState(seed)
        X = np.c_[rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                  rng.uniform(4, 6, n_pts)].astype(np.float32)
        poses, noisy = [], []
        for k in range(L):
            T = jlie.se3_exp(jnp.asarray([-0.3 * k, 0.02 * k, 0.0, 0.0, 0.03 * k, 0.0],
                                         jnp.float32))
            poses.append(np.asarray(T))
            dn = np.zeros(6, np.float32) if k == 0 else (rng.randn(6) * 0.01).astype(np.float32)
            noisy.append(np.asarray(jlie.se3_retract(T, jnp.asarray(dn))))
        obs = -np.ones((L, F), np.int32)
        xy = np.zeros((L, F, 2), np.float32)
        kf_ur = -np.ones((L, F), np.float32)
        for k in range(L):
            ids = rng.permutation(n_pts)[:int(n_pts * 0.9)]
            n = len(ids)
            pc = np.asarray(jlie.se3_apply(jnp.asarray(poses[k])[None], jnp.asarray(X[ids])))
            obs[k, :n] = ids
            xy[k, :n] = K[:2] * pc[:, :2] / pc[:, 2:] + K[2:] + rng.randn(n, 2) * 0.5
            bad = rng.rand(n) < out
            xy[k, :n][bad] += rng.randn(int(bad.sum()), 2).astype(np.float32) * 25
            ur = xy[k, :n, 0] - BF / pc[:, 2] + rng.randn(n) * 0.5
            ur[rng.rand(n) < out] -= 20.0
            kf_ur[k, :n] = np.where(rng.rand(n) < 0.7, ur, -1.0)
        sig = np.asarray([1.0, 1.44, 2.0736], np.float32)[rng.randint(0, 3, (L, F))]
        pts = X + rng.randn(n_pts, 3).astype(np.float32) * 0.05
        fixed = np.array([True] + [False] * (L - 1))
        pt_opt = rng.rand(n_pts) > 0.05
        return (np.stack(noisy), fixed, xy, sig, obs, pts, pt_opt), kf_ur

    @pytest.mark.parametrize("seed", [0, 1])
    def test_bundle_adjust(self, seed):
        """Through the stage boundary (4 + 2 LM steps): poses to 1e-4,
        points to 1e-3, inliers identical, chi2 to 1e-4 relative; the stereo
        rows change the solution."""
        args, kf_ur = self._ba_problem(seed)
        kw = dict(iters=4, stage2_iters=2, bf=BF)
        pj, xj, cj, ij = jba.bundle_adjust(*[jnp.asarray(a) for a in args], jnp.asarray(K),
                                           kf_ur=jnp.asarray(kf_ur), **kw)
        pt, xt, ct, it = tba.bundle_adjust(*[_t(a) for a in args], _t(K), kf_ur=_t(kf_ur), **kw)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-3, atol=1e-3)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(float(ct), float(cj), rtol=1e-4)
        mono = jba.bundle_adjust(*[jnp.asarray(a) for a in args], jnp.asarray(K), iters=4,
                                 stage2_iters=2)
        assert np.abs(np.asarray(mono[0]) - np.asarray(pj)).max() > 1e-4   # the rows count

    def test_bundle_adjust_converged(self):
        """The full 4 + 5 steps: at convergence an f32 cost comparison can
        accept a step in one package and reject it in the other, so the
        returned states sit one step apart: chi2 to 1e-5 relative, inliers
        identical, poses to 1e-3."""
        args, kf_ur = self._ba_problem(4)
        kw = dict(iters=4, bf=BF)
        pj, _, cj, ij = jba.bundle_adjust(*[jnp.asarray(a) for a in args], jnp.asarray(K),
                                          kf_ur=jnp.asarray(kf_ur), **kw)
        pt, _, ct, it = tba.bundle_adjust(*[_t(a) for a in args], _t(K), kf_ur=_t(kf_ur), **kw)
        np.testing.assert_allclose(float(ct), float(cj), rtol=1e-5)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-3)

    @pytest.mark.parametrize("dense", [True, False])
    def test_bundle_adjust_pcg(self, dense):
        """Both Schur strategies against the reference's: poses to 1e-4,
        points to 1e-3, inliers identical."""
        args, kf_ur = self._ba_problem(2)
        pj, xj, _, ij = jba.bundle_adjust_pcg(*[jnp.asarray(a) for a in args], jnp.asarray(K),
                                              kf_ur=jnp.asarray(kf_ur), bf=BF, lm_iters=6)
        pt, xt, _, it = tba.bundle_adjust_pcg(*[_t(a) for a in args], _t(K), kf_ur=_t(kf_ur),
                                              bf=BF, lm_iters=6, dense=dense)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-3, atol=1e-3)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def _depth_map(detach_kf0: bool):
    """`test_torch_mapping`'s six-keyframe map with a right-u channel on
    every observation of a valid point (from the true depth); with
    `detach_kf0` keyframe 0 observes nothing, so a window around keyframe 5
    holds keyframes 1-5 and no anchor of its own."""
    m = tmap._build_map(1)
    kf_obs = np.asarray(m.kf_obs).copy()
    if detach_kf0:
        kf_obs[0] = -1
    pose = np.asarray(m.kf_pose)
    pts = np.asarray(m.pt_pos)
    kf_ur = -np.ones(kf_obs.shape, np.float32)
    for k in range(tmap.N_KF):
        f = np.flatnonzero(kf_obs[k] >= 0)
        pc = np.asarray(jlie.se3_apply(jnp.asarray(pose[k])[None], jnp.asarray(pts[kf_obs[k, f]])))
        kf_ur[k, f] = np.asarray(m.kf_xy)[k, f, 0] - BF_MAP / pc[:, 2]
    return m._replace(kf_obs=jnp.asarray(kf_obs), kf_ur=jnp.asarray(kf_ur))


class TestDepthMapBA:
    @pytest.mark.parametrize("detach_kf0", [False, True])
    def test_local_ba(self, detach_kf0):
        """`local_ba(bf=)`: poses to 1e-4, points to 1e-3, observations
        identical. Without keyframe 0 the window pins only its oldest
        keyframe (a monocular window pins two)."""
        m = _depth_map(detach_kf0)
        bf = BF_MAP
        kw = dict(n_local=8, n_fixed=tmap.BA_FIXED, n_pts=tmap.BA_PTS, iters=tmap.BA_ITERS,
                  n_levels=tmap.N_LEVELS, scale_factor=tmap.SF)
        want, chi2_j = jlm.local_ba(m, jnp.int32(tmap.CENTER), jnp.asarray(tmap.K), bf=bf, **kw)
        got, chi2_t = tlm.local_ba(tmap._to_port(m), torch.tensor(tmap.CENTER, dtype=torch.int32),
                                   _t(tmap.K), bf=bf, **kw)
        np.testing.assert_allclose(got.kf_pose.numpy(), np.asarray(want.kf_pose), atol=1e-4)
        np.testing.assert_allclose(got.pt_pos.numpy(), np.asarray(want.pt_pos), rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_array_equal(got.kf_obs.numpy(), np.asarray(want.kf_obs))
        np.testing.assert_allclose(float(chi2_t), float(chi2_j), rtol=1e-3)
        moved = np.abs(got.kf_pose.numpy() - np.asarray(m.kf_pose)).max(1)
        if detach_kf0:
            assert moved[1] == 0.0 and moved[2] > 1e-5
        else:
            assert moved[0] == 0.0 and moved[1:tmap.N_KF].max() > 1e-5

    def test_global_ba(self):
        """`global_ba(bf=)`: keyframe 0 alone is fixed (the disparity rows
        hold the scale), poses to 1e-4, points to 1e-3."""
        m = _depth_map(False)
        bf = BF_MAP
        kw = dict(iters=6, n_levels=tmap.N_LEVELS, scale_factor=tmap.SF)
        want, _ = jlm.global_ba(m, jnp.asarray(tmap.K), bf=bf, **kw)
        got, _ = tlm.global_ba(tmap._to_port(m), _t(tmap.K), bf=bf, **kw)
        np.testing.assert_allclose(got.kf_pose.numpy(), np.asarray(want.kf_pose), atol=1e-4)
        np.testing.assert_allclose(got.pt_pos.numpy(), np.asarray(want.pt_pos), rtol=1e-3,
                                   atol=1e-3)
        moved = np.abs(got.kf_pose.numpy() - np.asarray(m.kf_pose)).max(1)
        assert moved[0] == 0.0 and moved[1] > 1e-5

    def test_batched_ba_stays_monocular(self):
        m = tmap._to_port(_depth_map(False))
        from dvm_slam_tpu_torch.mapping import map_state as tms
        with pytest.raises(NotImplementedError):
            tlm.local_ba_batched(tms.stack_maps([m, m]), torch.tensor([5, 5]), _t(tmap.K), bf=1.0)


def _configs(mode):
    cfg = jtrk.TrackerConfig(frontend=jex.FrontendConfig(height=H, width=W, n_features=300,
                                                         n_levels=4),
                             kf_cap=32, pt_cap=2048, fps=10.0, sensor=mode, baseline=BASELINE,
                             min_init_stereo_points=MIN_INIT)
    return cfg, convert.tracker_config_from_dict(dataclasses.asdict(cfg))


def _mapper(mod):
    return mod.LocalMapper(n_neighbors=4, ba_local=8, ba_fixed=4, ba_pts=1024, ba_iters=4)


@pytest.fixture(scope="module", params=["stereo", "rgbd"])
def stepped_run(request, scene):
    """The JAX tracker from frame 0 (the depth initialization) to the end;
    before each of its steps a port tracker takes the same step from the
    JAX tracker's map and host state, on the JAX front end's frame."""
    mode = request.param
    _, pairs, rgbd, _ = scene
    cfg, tcfg = _configs(mode)
    tj = jtrk.MonocularTracker(cfg, K, np.zeros(4, np.float32), local_mapper=_mapper(jlm))
    Kj = jnp.asarray(K)
    steps = []
    for i in range(N_FRAMES):
        if mode == "stereo":
            f = jex.make_frame_stereo(jnp.asarray(pairs[i][0]), jnp.asarray(pairs[i][1]), Kj,
                                      jnp.zeros(4), cfg.frontend, jnp.float32(BASELINE))
        else:
            f = jex.make_frame_rgbd(jnp.asarray(rgbd[i][0]), jnp.asarray(rgbd[i][1]), Kj,
                                    jnp.zeros(4), cfg.frontend, jnp.float32(BF))
        tt = ttrk.MonocularTracker(tcfg, K, np.zeros(4, np.float32), local_mapper=_mapper(tlm),
                                   device="cpu")
        if i > 0:
            tt.map = convert.map_state_from_numpy(_np_dict(tj.map))
            convert.tracker_host_state_from_numpy(tt, convert.tracker_host_state_to_numpy(tj))
            tt.local_mapper._kf_count = tj.local_mapper._kf_count
            tt.n_frames = tj.n_frames
        pose_t = tt.process_frame(convert.frame_from_numpy(_np_dict(f)), i * 0.1)
        pose_j = tj.process_frame(f, i * 0.1)
        steps.append(dict(pose_j=None if pose_j is None else np.asarray(pose_j),
                          pose_t=None if pose_t is None else pose_t.numpy(),
                          kf_j=tj.n_kf_host, kf_t=tt.n_kf_host, state_j=tj.state,
                          state_t=tt.state, map_t=tt.map, map_j=tj.map))
    return mode, steps, tj


class TestTrackerRun:
    def test_steps_match(self, stepped_run):
        """Every step: the same state and keyframe decision, the pose to
        1e-3; the depth initialization on frame 0 identical."""
        mode, steps, tj = stepped_run
        assert all(s["state_j"] == s["state_t"] == "OK" for s in steps)
        assert [s["kf_t"] for s in steps] == [s["kf_j"] for s in steps]
        assert steps[-1]["kf_j"] >= 2
        for s in steps:
            np.testing.assert_allclose(s["pose_t"], s["pose_j"], atol=1e-3)
        m_t, m_j = steps[0]["map_t"], steps[0]["map_j"]
        np.testing.assert_array_equal(m_t.kf_obs.numpy(), np.asarray(m_j.kf_obs))
        np.testing.assert_allclose(m_t.pt_pos.numpy(), np.asarray(m_j.pt_pos), atol=1e-5)
        np.testing.assert_allclose(m_t.kf_ur.numpy(), np.asarray(m_j.kf_ur), atol=1e-4)

    def test_keyframes_keep_ur_and_close_points(self, stepped_run):
        """A keyframe step stores the frame's right-u channel and creates
        the close points the reference creates."""
        mode, steps, _ = stepped_run
        kf_steps = [i for i in range(1, N_FRAMES) if steps[i]["kf_j"] > steps[i - 1]["kf_j"]]
        assert kf_steps
        for i in kf_steps:
            m_t, m_j = steps[i]["map_t"], steps[i]["map_j"]
            s = steps[i]["kf_j"] - 1
            np.testing.assert_allclose(m_t.kf_ur[s].numpy(), np.asarray(m_j.kf_ur[s]), atol=1e-4)
            assert (m_t.kf_ur[s].numpy() >= 0).sum() > 20
            assert int(m_t.n_pt) == int(m_j.n_pt)
            ur, obs = m_t.kf_ur[: s + 1].numpy(), m_t.kf_obs[: s + 1].numpy()
            assert ((ur >= 0) & (obs >= 0)).sum() > 100


def test_autonomous_step_depth_branch(scene):
    """`autonomous_step` with a depth sensor (the 0.75 keyframe ratio, the
    chain's BA with the disparity rows of the depth-seeded keyframe): each
    port step from the JAX step's map and state, on frames 1-8; the same
    keyframe flags, inliers within 1, the pose and keyframe poses to 1e-3."""
    from test_torch_slice import _jax_bootstrap

    _, _, rgbd, _ = scene
    cfg, tcfg = _configs("rgbd")
    mapper_cfg = (3, 4, 1.2, 4, 2, 256, 3, 1)
    Kj, Kt = jnp.asarray(K), _t(K)
    m, n = _jax_bootstrap(cfg, K, rgbd[0][0], rgbd[0][1])
    st = jtrk.AutoState(T_cw=jlie.se3_identity(), velocity=jlie.se3_identity(),
                        frames_since_kf=jnp.int32(0), ref_tracked=jnp.int32(n),
                        kf_count=jnp.int32(0))
    assert (np.asarray(m.kf_ur[0]) >= 0).sum() > 40
    flags = []
    for img, _ in rgbd[1:9]:
        mt = convert.map_state_from_numpy(_np_dict(m))
        stt = convert.auto_state_from_numpy(_np_dict(st))
        mt, stt, flt = ttrk.autonomous_step(_t(img), mt, stt, Kt, torch.zeros(4), tcfg,
                                            mapper_cfg)
        m, st, fl = jtrk.autonomous_step(jnp.asarray(img), m, st, Kj, jnp.zeros(4), cfg,
                                         mapper_cfg)
        flags.append(bool(fl.made_kf))
        assert bool(flt.made_kf) == flags[-1]
        assert abs(int(flt.n_inliers) - int(fl.n_inliers)) <= 1
        np.testing.assert_allclose(stt.T_cw.numpy(), np.asarray(st.T_cw), atol=1e-3)
        np.testing.assert_allclose(mt.kf_pose.numpy(), np.asarray(m.kf_pose), atol=1e-3)
    assert sum(flags) >= 1


@pytest.fixture(scope="module", params=["stereo", "rgbd"])
def facades(request, scene):
    """Both `System` facades (stereo or RGB-D, the pipelined lane with
    async_depth 8) over the same 20 frames; the JAX one with the port's
    repair of the pipelined retire (fault v). The RGB-D depth goes in as
    uint16 TUM units with `depth_map_factor` 1/5000."""
    mode = request.param
    poses, pairs, rgbd, _ = scene
    s = jcfg.SystemSettings()
    s.camera = jcfg.CameraSettings(fx=float(K[0]), fy=float(K[1]), cx=float(K[2]),
                                   cy=float(K[3]), width=W, height=H, dist=(0.0, 0.0, 0.0, 0.0),
                                   fps=10.0, baseline=BASELINE,
                                   depth_map_factor=1.0 / chip_smoke.TUM_DEPTH_FACTOR)
    s.orb = jcfg.OrbSettings(n_features=300, n_levels=4)
    s.kf_capacity, s.pt_capacity = 32, 2048
    st = convert.system_settings_from_dict(dataclasses.asdict(s))
    out = {}
    with pipelined_head_repair():
        for name, system in (("jax", jsys.System(s, sensor=mode)),
                             ("port", tsys.System(st, sensor=mode, device="cpu"))):
            t = system.tracker
            t.config = dataclasses.replace(t.config, min_init_stereo_points=MIN_INIT)
            est, gt = [], []
            for i, p in enumerate(poses):
                if mode == "stereo":
                    pose = system.track_stereo(pairs[i][0], pairs[i][1], i * 0.1)
                else:
                    pose = system.track_rgbd(rgbd[i][0], chip_smoke.depth_to_sensor(rgbd[i][1]),
                                             i * 0.1)
                if pose is not None:
                    est.append(np.asarray(pose.cpu() if isinstance(pose, torch.Tensor)
                                          else pose))
                    gt.append(p)
            t.flush_pipeline()
            out[name] = dict(state=t.state, n=len(est), n_kf=t.n_kf_host,
                             ate=chip_smoke.metric_ate(est, gt), sensor=t.config.sensor)
    return mode, out


class TestSystemFacade:
    def test_tracks_every_frame_metric(self, facades):
        """Both facades give every frame a pose from frame 0 on, in OK; the
        port's metric ATE within 1.5x of the JAX facade's; keyframes +-1."""
        mode, out = facades
        j, p = out["jax"], out["port"]
        assert p["sensor"] == j["sensor"] == mode
        assert j["state"] == p["state"] == "OK"
        assert j["n"] == p["n"] == N_FRAMES
        assert abs(p["n_kf"] - j["n_kf"]) <= 1
        assert p["ate"] < 1.5 * j["ate"] + 1e-3, (p["ate"], j["ate"])
        assert j["ate"] < 0.1


class TestConvert:
    def test_frame_and_config_round_trip(self, scene):
        """`convert` carries a stereo frame's ur/depth and the sensor fields
        of `TrackerConfig` both ways."""
        _, pairs, _, fc = scene
        cfg, tcfg = _configs("stereo")
        cfg = dataclasses.replace(cfg, camera_model="kb8", th_depth_ratio=35.0)
        tcfg = convert.tracker_config_from_dict(dataclasses.asdict(cfg))
        assert (tcfg.sensor, tcfg.baseline, tcfg.th_depth_ratio, tcfg.camera_model) == \
            ("stereo", BASELINE, 35.0, "kb8")
        assert tcfg.th_depth == cfg.th_depth and tcfg.depth_sensor
        assert convert.tracker_config_to_dict(tcfg) == dataclasses.asdict(cfg)
        fj = jex.make_frame_stereo(jnp.asarray(pairs[0][0]), jnp.asarray(pairs[0][1]),
                                   jnp.asarray(K), jnp.zeros(4), fc, jnp.float32(BASELINE))
        ft = convert.frame_from_numpy(_np_dict(fj))
        back = convert.frame_to_numpy(ft)
        for k, v in _np_dict(fj).items():
            np.testing.assert_array_equal(back[k], v)
        assert ft.ur is not None and ft.depth is not None
