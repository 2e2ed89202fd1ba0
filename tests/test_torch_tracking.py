"""Parity of the port's matching, map state, pose optimization and tracker
ops with the JAX package on numpy-seeded inputs. Integer, bool and bit
outputs must be identical; float tolerances are stated per test."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dvm_slam_tpu.frontend import extractor as jex
from dvm_slam_tpu.geometry import lie as jlie
from dvm_slam_tpu.mapping import map_state as jms
from dvm_slam_tpu.ops import matching as jm
from dvm_slam_tpu.tracking import pose_opt as jpo
from dvm_slam_tpu.tracking import tracker as jtrk

from dvm_slam_tpu_torch import convert
from dvm_slam_tpu_torch.mapping import map_state as tms
from dvm_slam_tpu_torch.ops import matching as tm
from dvm_slam_tpu_torch.tracking import pose_opt as tpo
from dvm_slam_tpu_torch.tracking import tracker as ttrk

torch.set_num_threads(2)

K = np.array([100.0, 100.0, 64.0, 48.0], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(m):
    return {k: None if v is None else np.asarray(v) for k, v in m._asdict().items()}


def _assert_map_equal(got, want, atol=1e-5):
    """Field by field: integer/bool/uint8 fields identical, floats to atol."""
    for name, w in _np(want).items():
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


# --------------------------------------------------------------------------
# matching
# --------------------------------------------------------------------------

def _descs(rng, n):
    return (rng.rand(n, 256) > 0.5).astype(np.uint8)


class TestMatching:
    def test_hamming_exact(self):
        rng = np.random.RandomState(0)
        a, b = _descs(rng, 50), _descs(rng, 70)
        want = np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
        got = tm.hamming_matrix(_t(a), _t(b)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, (a[:, None, :] != b[None, :, :]).sum(-1))

    @pytest.mark.parametrize("ratio,tie_ok", [(None, False), (0.9, False), (0.8, True)])
    def test_masked_best_match_exact(self, ratio, tie_ok):
        rng = np.random.RandomState(1)
        dist = rng.randint(0, 120, (40, 60)).astype(np.int32)
        dist[3, 5] = dist[3, 9] = 2  # exact tie: first index wins
        dist[3, :5] = 200
        mask = rng.rand(40, 60) > 0.3
        mask[3, 5] = mask[3, 9] = True
        want = jm.masked_best_match(jnp.asarray(dist), jnp.asarray(mask), 100, ratio=ratio,
                                    tie_ok=tie_ok)
        got = tm.masked_best_match(_t(dist), _t(mask), 100, ratio=ratio, tie_ok=tie_ok)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_search_by_projection_exact(self):
        rng = np.random.RandomState(2)
        P, F = 80, 60
        f_xy = (rng.rand(F, 2) * [128, 96]).astype(np.float32)
        proj_xy = (f_xy[rng.randint(0, F, P)] + rng.randn(P, 2) * 3).astype(np.float32)
        f_desc = _descs(rng, F)
        proj_desc = f_desc[rng.randint(0, F, P)].copy()
        proj_desc[:, :20] = _descs(rng, P)[:, :20]
        args = (proj_xy, rng.rand(P) > 0.1, proj_desc, rng.randint(0, 4, P).astype(np.int32),
                f_xy, f_desc, rng.randint(0, 4, F).astype(np.int32), rng.rand(F) > 0.1,
                (rng.rand(P) * 10 + 2).astype(np.float32))
        for ratio in (None, 0.9):
            want = jm.search_by_projection(*[jnp.asarray(a) for a in args], ratio=ratio)
            got = tm.search_by_projection(*[_t(a) for a in args], ratio=ratio)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_dedupe_exact(self):
        rng = np.random.RandomState(3)
        idx = rng.randint(0, 20, 100).astype(np.int32)
        ok = rng.rand(100) > 0.3
        want = np.asarray(jm.dedupe_matches(jnp.asarray(idx), jnp.asarray(ok), 20))
        got = tm.dedupe_matches(_t(idx), _t(ok), 20).numpy()
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# pose optimization
# --------------------------------------------------------------------------

def _pose_problem(seed, n=120, outliers=15):
    rng = np.random.RandomState(seed)
    T_true = np.asarray(jlie.se3_exp(jnp.asarray(rng.randn(6).astype(np.float32) * 0.1)))
    pc = np.stack([rng.randn(n) * 1.5, rng.randn(n), rng.rand(n) * 4 + 3], -1).astype(np.float32)
    pts = np.asarray(jlie.se3_apply(jlie.se3_inv(jnp.asarray(T_true)), jnp.asarray(pc)))
    uv = (K[:2] * pc[:, :2] / pc[:, 2:] + K[2:]).astype(np.float32)
    uv += rng.randn(n, 2).astype(np.float32) * 0.5
    uv[:outliers] += rng.randn(outliers, 2).astype(np.float32) * 30
    sigma2 = np.asarray([1.0, 1.44, 2.0736], np.float32)[rng.randint(0, 3, n)]
    valid = rng.rand(n) > 0.05
    T0 = np.asarray(jlie.se3_retract(jnp.asarray(T_true),
                                     jnp.asarray(rng.randn(6).astype(np.float32) * 0.03)))
    return T0, pts, uv, sigma2, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pose_optimization_matches_jax(seed):
    """Same inliers, pose to 1e-4 (f32 normal equations summed in another
    order), chi2 to 1e-3 relative."""
    T0, pts, uv, sigma2, valid = _pose_problem(seed)
    Tj, inl_j, chi_j = jpo.pose_optimization(*[jnp.asarray(a) for a in (T0, pts, uv, sigma2, valid, K)])
    Tt, inl_t, chi_t = tpo.pose_optimization(*[_t(a) for a in (T0, pts, uv, sigma2, valid, K)])
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    np.testing.assert_allclose(chi_t.numpy(), np.asarray(chi_j), rtol=1e-3, atol=1e-3)


# --------------------------------------------------------------------------
# map state
# --------------------------------------------------------------------------

KF, PT, FEAT = 4, 64, 40


def _frame_arrays(rng, n=FEAT):
    return dict(
        xy=(rng.rand(n, 2) * [128, 96]).astype(np.float32),
        level=rng.randint(0, 4, n).astype(np.int32),
        angle=rng.randn(n).astype(np.float32),
        desc=_descs(rng, n),
        valid=rng.rand(n) > 0.2,
    )


def _populated(seed=0):
    """A JAX map with 2 keyframes and 30 points (some observed twice)."""
    rng = np.random.RandomState(seed)
    m = jms.create(KF, PT, FEAT)
    pose0 = np.asarray(jlie.se3_identity())
    pose1 = np.asarray(jlie.se3_exp(jnp.asarray([0.2, 0, 0.05, 0, 0.05, 0], jnp.float32)))
    fr = _frame_arrays(rng)
    obs = np.full(FEAT, -1, np.int32)
    obs[:25] = np.arange(25)
    m, _ = jms.add_keyframe(m, jnp.asarray(pose0), *[jnp.asarray(fr[k]) for k in
                            ("xy", "level", "angle", "desc", "valid")], jnp.asarray(obs))
    fr1 = _frame_arrays(rng)
    obs1 = np.full(FEAT, -1, np.int32)
    obs1[5:30] = np.arange(5, 30)
    m, _ = jms.add_keyframe(m, jnp.asarray(pose1), *[jnp.asarray(fr1[k]) for k in
                            ("xy", "level", "angle", "desc", "valid")], jnp.asarray(obs1),
                            ur=jnp.asarray(rng.rand(FEAT).astype(np.float32) * 100))
    n = 30
    pos = np.stack([rng.randn(n), rng.randn(n), rng.rand(n) * 3 + 3], -1).astype(np.float32)
    m, _ = jms.add_points(m, jnp.asarray(pos), jnp.asarray(_descs(rng, n)),
                          jnp.zeros((n, 3)), jnp.zeros(n), jnp.full((n,), 50.0),
                          jnp.int32(0), jnp.ones(n, bool))
    return m


class TestMapState:
    def test_create_identical(self):
        _assert_map_equal(tms.create(KF, PT, FEAT), jms.create(KF, PT, FEAT))

    def test_add_keyframe_and_points_field_by_field(self):
        rng = np.random.RandomState(4)
        mj = _populated()
        mt = convert.map_state_from_numpy(_np(mj))
        fr = _frame_arrays(rng)
        obs = rng.randint(-1, 30, FEAT).astype(np.int32)
        mj2, sj = jms.add_keyframe(mj, jlie.se3_identity(), *[jnp.asarray(fr[k]) for k in
                                   ("xy", "level", "angle", "desc", "valid")], jnp.asarray(obs))
        mt2, st = tms.add_keyframe(mt, torch.tensor([1.0, 0, 0, 0, 0, 0, 0]),
                                   *[_t(fr[k]) for k in ("xy", "level", "angle", "desc", "valid")],
                                   _t(obs))
        assert int(st) == int(sj)
        _assert_map_equal(mt2, mj2)
        # points: invalid rows skipped, slots contiguous, overflow dropped
        n = 45
        pos = rng.randn(n, 3).astype(np.float32)
        args = (pos, _descs(rng, n), rng.randn(n, 3).astype(np.float32),
                rng.rand(n).astype(np.float32), rng.rand(n).astype(np.float32) + 1)
        valid = rng.rand(n) > 0.3
        mj3, slot_j = jms.add_points(mj2, *[jnp.asarray(a) for a in args], jnp.int32(2),
                                     jnp.asarray(valid))
        mt3, slot_t = tms.add_points(mt2, *[_t(a) for a in args], 2, _t(valid))
        np.testing.assert_array_equal(slot_t.numpy(), np.asarray(slot_j))
        _assert_map_equal(mt3, mj3)

    def test_incidence_identical(self):
        mj = _populated()
        got = tms.incidence(convert.map_state_from_numpy(_np(mj))).numpy()
        np.testing.assert_array_equal(got, np.asarray(jms.incidence(mj)))

    @pytest.mark.parametrize("with_desc", [True, False])
    def test_update_point_stats_field_by_field(self, with_desc):
        """Descriptor votes exact; normals and distance ranges to 1e-5."""
        mj = _populated()
        want = jms.update_point_stats(mj, 4, 1.2, with_desc=with_desc)
        got = tms.update_point_stats(convert.map_state_from_numpy(_np(mj)), 4, 1.2,
                                     with_desc=with_desc)
        _assert_map_equal(got, want, atol=1e-5)

    def test_predict_scale_identical(self):
        rng = np.random.RandomState(6)
        dist = (rng.rand(200) * 10 + 0.1).astype(np.float32)
        max_dist = (rng.rand(200) * 20).astype(np.float32)
        want = np.asarray(jms.predict_scale(jnp.asarray(dist), jnp.asarray(max_dist), 8, 1.2))
        np.testing.assert_array_equal(tms.predict_scale(_t(dist), _t(max_dist), 8, 1.2).numpy(), want)

    def test_frame_numpy_round_trip(self):
        f = jex.extract(jnp.asarray(np.random.RandomState(3).rand(96, 128).astype(np.float32) * 255),
                        jex.FrontendConfig(height=96, width=128, n_features=FEAT, n_levels=4))
        arrays = _np(f)
        back = convert.frame_to_numpy(convert.frame_from_numpy(arrays))
        assert back["ur"] is None and back["depth"] is None
        for k, v in arrays.items():
            if v is not None:
                np.testing.assert_array_equal(back[k], v)
                assert back[k].dtype == v.dtype

    def test_numpy_round_trip(self):
        mj = _populated()
        arrays = _np(mj)
        back = convert.map_state_to_numpy(convert.map_state_from_numpy(arrays))
        for k, v in arrays.items():
            np.testing.assert_array_equal(back[k], v)
            assert back[k].dtype == v.dtype


# --------------------------------------------------------------------------
# tracker ops
# --------------------------------------------------------------------------

def _cfg():
    fc = jex.FrontendConfig(height=96, width=128, n_features=FEAT, n_levels=4)
    return jtrk.TrackerConfig(frontend=fc, kf_cap=KF, pt_cap=PT, fps=10.0)


class TestTrackerOps:
    def test_project_points_field_by_field(self):
        mj = jms.update_point_stats(_populated(), 4, 1.2)
        cfg = _cfg()
        tcfg = convert.tracker_config_from_dict(__import__("dataclasses").asdict(cfg))
        T = np.asarray(jlie.se3_exp(jnp.asarray([0.05, -0.02, 0.1, 0.01, 0.02, 0.0], jnp.float32)))
        want = jtrk.project_points(mj, jnp.asarray(T), jnp.asarray(K), cfg)
        got = ttrk.project_points(convert.map_state_from_numpy(_np(mj)), _t(T), _t(K), tcfg)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-3)  # px
        for i in (1, 2):
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=1e-5)

    def test_create_points_from_depth_field_by_field(self):
        rng = np.random.RandomState(8)
        mj = _populated()
        fr = _frame_arrays(rng)
        depth = np.where(rng.rand(FEAT) > 0.2, rng.rand(FEAT) * 5 + 1, -1.0).astype(np.float32)
        frame = jex.Frame(xy=jnp.asarray(fr["xy"]), xy_raw=jnp.asarray(fr["xy"]),
                          level=jnp.asarray(fr["level"]), angle=jnp.asarray(fr["angle"]),
                          response=jnp.ones(FEAT), desc=jnp.asarray(fr["desc"]),
                          valid=jnp.asarray(fr["valid"]), ur=jnp.full((FEAT,), -1.0),
                          depth=jnp.asarray(depth))
        want, n_j = jtrk.create_points_from_depth(mj, jnp.int32(1), frame, jnp.asarray(K),
                                                  jnp.float32(4.0), 4, 1.2)
        got, n_t = ttrk.create_points_from_depth(
            convert.map_state_from_numpy(_np(mj)), 1, convert.frame_from_numpy(_np(frame)),
            _t(K), 4.0, 4, 1.2)
        assert int(n_t) == int(n_j) > 0
        _assert_map_equal(got, want, atol=1e-5)

    def test_update_visibility_identical(self):
        rng = np.random.RandomState(9)
        mj = _populated()
        vis, found = rng.rand(PT) > 0.5, rng.rand(PT) > 0.7
        want = jtrk.update_visibility(mj, jnp.asarray(vis), jnp.asarray(found))
        got = ttrk.update_visibility(convert.map_state_from_numpy(_np(mj)), _t(vis), _t(found))
        _assert_map_equal(got, want)

    def test_motion_model_step(self):
        """The pose chain of `autonomous_step`: velocity on a good track,
        hold + identity velocity on a bad one."""
        tcfg = convert.tracker_config_from_dict(__import__("dataclasses").asdict(_cfg()))
        T_last = _t(np.asarray(jlie.se3_exp(jnp.asarray([0.1, 0, 0, 0, 0.02, 0], jnp.float32))))
        T_new = _t(np.asarray(jlie.se3_exp(jnp.asarray([0.2, 0, 0, 0, 0.04, 0], jnp.float32))))
        res = ttrk.TrackResult(T_cw=T_new, obs=None, n_inliers=torch.tensor(40, dtype=torch.int32),
                               n_stage1=None, visible=None, found=None)
        T2, vel = ttrk.motion_model_step(T_last, res, tcfg)
        want_vel = np.asarray(jlie.se3_mul(jnp.asarray(T_new.numpy()),
                                           jlie.se3_inv(jnp.asarray(T_last.numpy()))))
        np.testing.assert_allclose(vel.numpy(), want_vel, atol=1e-6)
        np.testing.assert_array_equal(T2.numpy(), T_new.numpy())
        T3, vel3 = ttrk.motion_model_step(T_last, res._replace(n_inliers=torch.tensor(3)), tcfg)
        np.testing.assert_array_equal(T3.numpy(), T_last.numpy())
        np.testing.assert_array_equal(vel3.numpy(), np.asarray(jlie.se3_identity()))
