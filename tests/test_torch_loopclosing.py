"""Loop closing of the port against the JAX package: the Sim3 tangent space,
`ransac_umeyama`, the Sim3 and 4-DoF essential graphs, global BA
(`bundle_adjust_pcg` with both Schur strategies, `global_ba`,
`apply_gba_correction`) and loop detection (`detect_verdict_batch`,
`LoopDetector.{on_keyframe,fold,correct_loop}`).

Inputs come from numpy seeds. Where the reference draws (the RANSACs), the
port gets the reference's own draws: a key split into one subkey per
hypothesis, `gumbel(k, (n,))` each (`test_torch_placerec.gumbel_rows`).
The BA cases run on `test_torch_mapping._build_map`'s map (6 keyframes at
F = 160, 1024 point slots), where the reference takes its dense Schur
branch. Tolerances are stated per test.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvm_slam_tpu.geometry import alignment as jal
from dvm_slam_tpu.geometry import lie as jlie
from dvm_slam_tpu.loopclosing import loop_detector as jld
from dvm_slam_tpu.loopclosing import merge as jmerge
from dvm_slam_tpu.loopclosing import pose_graph as jpg
from dvm_slam_tpu.mapping import ba as jba
from dvm_slam_tpu.mapping import local_mapping as jlm
from dvm_slam_tpu.mapping import map_state as jms
from dvm_slam_tpu.placerec import database as jdb
from dvm_slam_tpu.placerec import vocabulary as jvoc

from dvm_slam_tpu_torch import convert
from dvm_slam_tpu_torch.geometry import alignment as tal
from dvm_slam_tpu_torch.geometry import lie as tlie
from dvm_slam_tpu_torch.loopclosing import loop_detector as tld
from dvm_slam_tpu_torch.loopclosing import pose_graph as tpg
from dvm_slam_tpu_torch.mapping import ba as tba
from dvm_slam_tpu_torch.mapping import local_mapping as tlm
from dvm_slam_tpu_torch.mapping import map_state as tms
from dvm_slam_tpu_torch.placerec import database as tdb

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_mapping import F, K, N_KF, N_LEVELS, SF, _build_map  # noqa: E402
from test_torch_placerec import gumbel_rows  # noqa: E402

torch.set_num_threads(2)

LIE_ATOL = 1e-5
JAC_ATOL = 1e-4
POSE_ATOL, PT_ATOL = 1e-4, 1e-3     # one BA / pose-graph call on identical inputs
S_ATOL = 1e-3                       # S_ab of a Sim3 verification


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.array(x)


def _rand_sim3(rng, n=(), s_sigma=0.3):
    q = np.asarray(jlie.so3_exp(jnp.asarray(rng.randn(*n, 3).astype(np.float32))))
    t = rng.randn(*n, 3).astype(np.float32)
    s = np.exp(rng.randn(*n) * s_sigma).astype(np.float32)
    return np.concatenate([q, t, s[..., None]], -1)


# --------------------------------------------------------------------------
# the Sim3 tangent space
# --------------------------------------------------------------------------

# (|omega| scale, |sigma| scale) of the four regimes of `_sim3_W`
REGIMES = {"theta0_sigma0": (1e-6, 1e-6), "theta0_sigma": (1e-6, 0.4),
           "theta_sigma0": (0.6, 1e-6), "general": (0.6, 0.4)}


class TestSim3Tangent:
    @pytest.mark.parametrize("regime", sorted(REGIMES))
    def test_exp_log_retract(self, regime):
        om, sg = REGIMES[regime]
        rng = np.random.RandomState(sorted(REGIMES).index(regime))
        xi = np.concatenate([rng.randn(16, 3), rng.randn(16, 3) * om, rng.randn(16, 1) * sg],
                            1).astype(np.float32)
        S = _rand_sim3(rng, (16,))
        for got, want in (
                (tlie.sim3_exp(_t(xi)), jlie.sim3_exp(jnp.asarray(xi))),
                (tlie.sim3_retract(_t(S), _t(xi)), jlie.sim3_retract(jnp.asarray(S), jnp.asarray(xi))),
                (tlie._sim3_W(_t(xi[:, 3:6]), _t(xi[:, 6])),
                 jlie._sim3_W(jnp.asarray(xi[:, 3:6]), jnp.asarray(xi[:, 6])))):
            np.testing.assert_allclose(got.numpy(), _np(want), atol=LIE_ATOL)
        E = np.asarray(jlie.sim3_exp(jnp.asarray(xi)))
        np.testing.assert_allclose(tlie.sim3_log(_t(E)).numpy(), _np(jlie.sim3_log(jnp.asarray(E))),
                                   atol=LIE_ATOL)

    @pytest.mark.parametrize("at_identity", [True, False])
    def test_edge_jacobian_at_zero(self, at_identity):
        """The pose graph's per-edge Jacobians (forward mode through the
        retraction at zero) against `jax.jacfwd`; at identity poses every
        `_sim3_W` call sits in regime 1's truncated series."""
        rng = np.random.RandomState(3)
        n = 6
        if at_identity:
            Si = Sj = M = np.tile(np.array([1, 0, 0, 0, 0, 0, 0, 1], np.float32), (n, 1))
        else:
            Si, Sj = _rand_sim3(rng, (n,)), _rand_sim3(rng, (n,))
            M = np.stack([np.asarray(jlie.sim3_mul(jnp.asarray(Si[e]), jlie.sim3_inv(jnp.asarray(Sj[e]))))
                          for e in range(n)])
            M = np.asarray(jlie.sim3_mul(jnp.asarray(_rand_sim3(rng, (n,), 0.05) * [1, 1, 1, 1, .1, .1, .1, 1]),
                                         jnp.asarray(M)))
        z = jnp.zeros(7)

        def f(xi, xj, a, b, m):
            return jpg.edge_residual(jlie.sim3_retract(a, xi), jlie.sim3_retract(b, xj), m)

        want = jax.vmap(jax.jacfwd(f, argnums=(0, 1)), in_axes=(None, None, 0, 0, 0))(
            z, z, jnp.asarray(Si), jnp.asarray(Sj), jnp.asarray(M))
        r_want = jax.vmap(f, in_axes=(None, None, 0, 0, 0))(z, z, jnp.asarray(Si), jnp.asarray(Sj),
                                                            jnp.asarray(M))
        p = _t(np.concatenate([Si, Sj]))
        r, Ji, Jj = tpg._edge_linearization(tpg.edge_residual, tlie.sim3_retract, 7, p,
                                            torch.arange(n), torch.arange(n, 2 * n), _t(M))
        assert np.isfinite(Ji.numpy()).all() and np.isfinite(Jj.numpy()).all()
        np.testing.assert_allclose(r.numpy(), _np(r_want), atol=LIE_ATOL)
        np.testing.assert_allclose(Ji.numpy(), _np(want[0]), atol=JAC_ATOL)
        np.testing.assert_allclose(Jj.numpy(), _np(want[1]), atol=JAC_ATOL)


# --------------------------------------------------------------------------
# RANSAC Umeyama
# --------------------------------------------------------------------------

class TestRansacUmeyama:
    @pytest.mark.parametrize("with_scale", [True, False])
    def test_matches_reference(self, with_scale):
        """The scale re-alignment's solver: 500 hypotheses on 600 points, a
        third of them corrupted, two masked out; the reference's draws."""
        rng = np.random.RandomState(11 + with_scale)
        n = 600
        S = _rand_sim3(rng)
        if not with_scale:
            S[7] = 1.0
        src = rng.randn(n, 3).astype(np.float32) * 2.0
        dst = np.array(jlie.sim3_apply(jnp.asarray(S), jnp.asarray(src)))
        dst += rng.randn(n, 3).astype(np.float32) * 1e-3
        bad = rng.rand(n) < 0.33
        dst[bad] += rng.randn(int(bad.sum()), 3).astype(np.float32)
        mask = np.ones(n, bool)
        mask[[5, 17]] = False
        key = jax.random.PRNGKey(21)
        Sj, inl_j, cnt_j = jal.ransac_umeyama(key, jnp.asarray(src), jnp.asarray(dst),
                                              jnp.asarray(mask), with_scale=with_scale)
        St, inl_t, cnt_t = tal.ransac_umeyama(gumbel_rows(key, 500, n), _t(src), _t(dst),
                                              _t(mask), with_scale=with_scale)
        np.testing.assert_array_equal(inl_t.numpy(), _np(inl_j))
        assert int(cnt_t) == int(cnt_j)
        sign = np.sign(np.dot(St.numpy()[:4], _np(Sj)[:4]))
        np.testing.assert_allclose(St.numpy()[:4] * sign, _np(Sj)[:4], atol=1e-4)
        np.testing.assert_allclose(St.numpy()[4:], _np(Sj)[4:], atol=1e-4)


# --------------------------------------------------------------------------
# the essential graph
# --------------------------------------------------------------------------

def _chain_sim3(n):
    """Ground-truth chain of Sim3 poses along x with mild rotation
    (`tests/test_loopclosing.py::TestPoseGraph._chain`)."""
    poses = []
    for i in range(n):
        T_wc = jlie.se3(jlie.so3_exp(jnp.array([0.0, 0.05 * i, 0.0])), jnp.array([0.5 * i, 0.0, 0.0]))
        poses.append(jlie.sim3_from_se3(jlie.se3_inv(T_wc)))
    return jnp.stack(poses)


def _chain_se3(n):
    poses = []
    for i in range(n):
        T_wc = jlie.se3(jlie.so3_exp(jnp.array([0.0, 0.0, 0.06 * i])), jnp.array([0.5 * i, 0.1 * i, 0.0]))
        poses.append(jlie.se3_inv(T_wc))
    return jnp.stack(poses)


def _drift_loop_case(seed, n=12):
    """`test_loopclosing.py::test_loop_closure_distributes_drift`'s graph:
    odometry from ground truth, drifted estimates, one exact loop edge."""
    rng = np.random.RandomState(seed)
    gt = _chain_sim3(n)
    ei, ej = np.arange(n - 1, dtype=np.int32), np.arange(1, n, dtype=np.int32)
    meas = jax.vmap(lambda i, j: jlie.sim3_mul(gt[i], jlie.sim3_inv(gt[j])))(jnp.asarray(ei),
                                                                            jnp.asarray(ej))
    drift = [np.asarray(gt[0])]
    for i in range(n - 1):
        noise = jlie.sim3_exp(jnp.asarray(np.concatenate(
            [rng.randn(3) * 0.03, rng.randn(3) * 0.01, rng.randn(1) * 0.02]).astype(np.float32)))
        step = jlie.sim3_mul(noise, jlie.sim3_mul(gt[i], jlie.sim3_inv(gt[i + 1])))
        drift.append(np.asarray(jlie.sim3_mul(jlie.sim3_inv(step), jnp.asarray(drift[-1]))))
    est = np.stack(drift)
    ei_all = np.concatenate([ei, [n - 1]]).astype(np.int32)
    ej_all = np.concatenate([ej, [0]]).astype(np.int32)
    meas_all = np.concatenate([_np(meas), _np(jlie.sim3_mul(gt[n - 1], jlie.sim3_inv(gt[0])))[None]])
    fixed = np.asarray([True] + [False] * (n - 1))
    return gt, est, fixed, ei_all, ej_all, meas_all


class TestPoseGraph:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_drift_loop_matches_reference(self, seed):
        gt, est, fixed, ei, ej, meas = _drift_loop_case(seed)
        emask = np.ones(len(ei), bool)
        want, cost_j = jpg.optimize_pose_graph(jnp.asarray(est), jnp.asarray(fixed), jnp.asarray(ei),
                                               jnp.asarray(ej), jnp.asarray(meas), jnp.asarray(emask),
                                               iters=25)
        got, cost_t = tpg.optimize_pose_graph(_t(est), _t(fixed), _t(ei), _t(ej), _t(meas),
                                              _t(emask), iters=25)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=POSE_ATOL)
        np.testing.assert_allclose(float(cost_t), float(cost_j), atol=1e-6)
        # and the reference test's own criteria
        r0 = tpg.edge_residual(_t(est)[_t(ei).long()], _t(est)[_t(ej).long()], _t(meas))
        assert float(cost_t) < float((r0 * r0).sum()) * 0.05
        assert np.abs(tlie.sim3_t(got).numpy() - _np(jlie.sim3_t(gt))).max() < 0.15

    def test_4dof_matches_reference(self):
        """`test_loopclosing.py::TestPoseGraph4DoF`: yaw + translation drift."""
        rng = np.random.RandomState(5)
        n = 10
        gt = _chain_se3(n)
        ei, ej = np.arange(n - 1, dtype=np.int32), np.arange(1, n, dtype=np.int32)
        meas = jax.vmap(lambda i, j: jlie.se3_mul(gt[i], jlie.se3_inv(gt[j])))(jnp.asarray(ei),
                                                                              jnp.asarray(ej))
        drift = [np.asarray(gt[0])]
        for i in range(n - 1):
            tang = np.zeros(6, np.float32)
            tang[:3] = rng.randn(3) * 0.04
            tang[5] = rng.randn() * 0.02
            step = jlie.se3_mul(jlie.se3_exp(jnp.asarray(tang)),
                                jlie.se3_mul(gt[i], jlie.se3_inv(gt[i + 1])))
            drift.append(np.asarray(jlie.se3_mul(jlie.se3_inv(step), jnp.asarray(drift[-1]))))
        est = np.stack(drift)
        ei_all = np.concatenate([ei, [n - 1]]).astype(np.int32)
        ej_all = np.concatenate([ej, [0]]).astype(np.int32)
        meas_all = np.concatenate([_np(meas), _np(jlie.se3_mul(gt[n - 1], jlie.se3_inv(gt[0])))[None]])
        fixed = np.asarray([True] + [False] * (n - 1))
        emask = np.ones(n, bool)
        want, cost_j = jpg.optimize_pose_graph_4dof(
            jnp.asarray(est), jnp.asarray(fixed), jnp.asarray(ei_all), jnp.asarray(ej_all),
            jnp.asarray(meas_all), jnp.asarray(emask), iters=25)
        got, cost_t = tpg.optimize_pose_graph_4dof(_t(est), _t(fixed), _t(ei_all), _t(ej_all),
                                                   _t(meas_all), _t(emask), iters=25)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=POSE_ATOL)
        assert float(cost_t) < 1e-3 and abs(float(cost_t) - float(cost_j)) < 1e-6
        assert np.abs(tlie.se3_t(got).numpy() - _np(jlie.se3_t(gt))).max() < 0.15

    def test_spanning_tree_and_edges(self):
        """On the covisibility of `_build_map`'s map and on the reference
        test's hand-made graph: identical parents and edge lists."""
        jm = _build_map()
        covis = _np(jms.covisibility(jm))
        tcov = tms.covisibility(convert.map_state_from_numpy({k: _np(v) for k, v in jm._asdict().items()}))
        np.testing.assert_array_equal(tcov.numpy(), covis)
        valid = _np(jm.kf_valid)
        for mw in (30, 50, 100):
            pj = jpg.compute_spanning_tree(covis, valid)
            pt = tpg.compute_spanning_tree(tcov, _t(valid))
            np.testing.assert_array_equal(pt, pj)
            ej_ = jpg.build_essential_edges(covis, valid, min_weight=mw, spanning_parent=pj,
                                            extra_edges=[(0, 5)])
            et_ = tpg.build_essential_edges(tcov, _t(valid), min_weight=mw, spanning_parent=pt,
                                            extra_edges=[(0, 5)])
            for a, b in zip(et_, ej_):
                np.testing.assert_array_equal(a, b)
        c = np.zeros((5, 5), np.int32)
        c[0, 1] = c[1, 0] = 150
        c[1, 2] = c[2, 1] = 50
        args = dict(spanning_parent=[-1, 0, 1, 2, 3], extra_edges=[(0, 4)])
        for a, b in zip(tpg.build_essential_edges(c, np.ones(5, bool), **args),
                        jpg.build_essential_edges(c, np.ones(5, bool), **args)):
            np.testing.assert_array_equal(a, b)

    def test_correct_points_and_fold(self):
        rng = np.random.RandomState(7)
        old = _rand_sim3(rng, (4,))
        new = _rand_sim3(rng, (4,))
        pts = rng.randn(20, 3).astype(np.float32)
        ref = rng.randint(-1, 4, 20).astype(np.int32)
        valid = rng.rand(20) > 0.2
        want = jpg.correct_points(jnp.asarray(pts), jnp.asarray(ref), jnp.asarray(valid),
                                  jnp.asarray(old), jnp.asarray(new))
        got = tpg.correct_points(_t(pts), _t(ref), _t(valid), _t(old), _t(new))
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4)
        np.testing.assert_allclose(tpg.se3_from_sim3_poses(_t(new)).numpy(),
                                   _np(jpg.se3_from_sim3_poses(jnp.asarray(new))), atol=LIE_ATOL)


# --------------------------------------------------------------------------
# global BA
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jmap():
    return _build_map()


def _port(jm):
    return convert.map_state_from_numpy({k: _np(v) for k, v in jm._asdict().items()})


def _pcg_inputs(jm, seed=0):
    """`global_ba`'s full-table inputs for `_build_map`'s map, with the
    points pushed off by 2 cm so the solve has work to do."""
    rng = np.random.RandomState(seed)
    kf_valid = _np(jm.kf_valid)
    L = kf_valid.shape[0]
    rows = np.arange(L)
    fixed = (rows == 0) | ~kf_valid | (rows == np.min(np.where(kf_valid & (rows != 0), rows, 2 ** 30)))
    obs = _np(jm.kf_obs)
    pt_valid = _np(jm.pt_valid)
    obs_pt = np.where(kf_valid[:, None] & (obs >= 0) & pt_valid[np.clip(obs, 0, None)], obs, -1)
    sig = (np.asarray([SF ** i for i in range(N_LEVELS)], np.float32) ** 2)[_np(jm.kf_level)]
    pts = _np(jm.pt_pos) + rng.randn(*_np(jm.pt_pos).shape).astype(np.float32) * 0.02
    return (_np(jm.kf_pose), fixed, _np(jm.kf_xy), sig.astype(np.float32),
            obs_pt.astype(np.int32), pts.astype(np.float32), pt_valid, K)


def _well_posed(kf_pose, kf_valid, kf_xy, kf_level, obs_pt, pts):
    """Points with at least 2 inlier observations (chi2 <= 5.991, in front)
    under the given poses: a point seen once is free along its ray, and its
    position after BA is rounding noise in either package."""
    obs_pt = np.asarray(obs_pt)
    ok = (obs_pt >= 0) & np.asarray(kf_valid)[:, None]
    l, f = np.nonzero(ok)
    p = obs_pt[l, f]
    Tj = jnp.asarray(np.asarray(kf_pose)[l])
    pc = np.asarray(jlie.se3_apply(Tj, jnp.asarray(np.asarray(pts)[p])))
    uv = K[:2] * pc[:, :2] / np.where(np.abs(pc[:, 2:]) < 1e-9, 1e-9, pc[:, 2:]) + K[2:]
    sig = (SF ** np.asarray(kf_level)[l, f]) ** 2
    chi2 = np.sum((np.asarray(kf_xy)[l, f] - uv) ** 2, -1) / sig
    inl = (chi2 <= tba.CHI2_MONO) & (pc[:, 2] > 0)
    return np.bincount(p[inl], minlength=np.asarray(pts).shape[0]) >= 2


def _assert_ba_close(got_pose, got_pts, want_pose, want_pts, obs_args):
    """Poses to POSE_ATOL; well-posed points to PT_ATOL; every point finite."""
    np.testing.assert_allclose(got_pose, want_pose, atol=POSE_ATOL)
    wp = _well_posed(want_pose, *obs_args, want_pts)
    assert wp.sum() > 100
    np.testing.assert_allclose(got_pts[wp], want_pts[wp], atol=PT_ATOL)
    assert np.isfinite(got_pts).all()


class TestGlobalBA:
    def test_pcg_dense_matches_reference(self, jmap):
        """The reference takes its dense branch at this size."""
        args = _pcg_inputs(jmap, seed=2)
        want = jba.bundle_adjust_pcg(*[jnp.asarray(a) for a in args], lm_iters=8)
        got = tba.bundle_adjust_pcg(*[_t(a) for a in args], lm_iters=8, dense=True)
        obs_args = (np.ones(len(args[0]), bool), args[2], _np(jmap.kf_level), args[4])
        _assert_ba_close(got[0].numpy(), got[1].numpy(), _np(want[0]), _np(want[1]), obs_args)
        agree = np.mean(got[3].numpy() == _np(want[3]))
        assert agree > 0.999, agree
        np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-2)

    def test_pcg_matrix_free_matches_dense(self, jmap):
        """The two Schur strategies the port keeps, on the same inputs."""
        args = _pcg_inputs(jmap, seed=2)
        dense = tba.bundle_adjust_pcg(*[_t(a) for a in args], lm_iters=8, dense=True)
        free = tba.bundle_adjust_pcg(*[_t(a) for a in args], lm_iters=8, dense=False)
        obs_args = (np.ones(len(args[0]), bool), args[2], _np(jmap.kf_level), args[4])
        _assert_ba_close(free[0].numpy(), free[1].numpy(), dense[0].numpy(), dense[1].numpy(),
                         obs_args)

    @pytest.mark.parametrize("n_pts", [None, 200])
    def test_global_ba_matches_reference(self, jmap, n_pts):
        """`global_ba` on the whole table and on its `n_pts` top-k branch."""
        rng = np.random.RandomState(2)
        pt = _np(jmap.pt_pos) + rng.randn(*_np(jmap.pt_pos).shape).astype(np.float32) * 0.02
        jm = jmap._replace(pt_pos=jnp.asarray(pt))
        want, chi_j = jlm.global_ba(jm, jnp.asarray(K), n_pts=n_pts, iters=6, n_levels=N_LEVELS,
                                    scale_factor=SF)
        got, chi_t = tlm.global_ba(_port(jm), _t(K), n_pts=n_pts, iters=6, n_levels=N_LEVELS,
                                   scale_factor=SF)
        obs_args = (_np(jm.kf_valid), _np(jm.kf_xy), _np(jm.kf_level), _np(jm.kf_obs))
        _assert_ba_close(got.kf_pose.numpy(), got.pt_pos.numpy(), _np(want.kf_pose),
                         _np(want.pt_pos), obs_args)
        np.testing.assert_allclose(float(chi_t), float(chi_j), rtol=1e-2)

    def test_apply_gba_correction(self, jmap):
        """A snapshot of 4 keyframes and 150 points folded into the grown
        map: optimized slots take the result, newer ones follow the anchor."""
        rng = np.random.RandomState(4)
        dT = jlie.se3(jlie.so3_exp(jnp.asarray([0.0, 0.03, 0.01])), jnp.asarray([0.1, 0.0, -0.05]))
        res_pose = np.asarray(jax.vmap(lambda T: jlie.se3_mul(T, dT))(jmap.kf_pose))
        res_pt = _np(jmap.pt_pos) + rng.randn(*_np(jmap.pt_pos).shape).astype(np.float32) * 0.05
        want = jlm.apply_gba_correction(jmap, jnp.asarray(res_pose), jnp.asarray(res_pt),
                                        jnp.int32(4), jnp.int32(150), jnp.int32(2))
        got = tlm.apply_gba_correction(_port(jmap), _t(res_pose), _t(res_pt), 4, 150, 2)
        np.testing.assert_allclose(got.kf_pose.numpy(), _np(want.kf_pose), atol=1e-5)
        np.testing.assert_allclose(got.pt_pos.numpy(), _np(want.pt_pos), atol=1e-4)


# --------------------------------------------------------------------------
# loop detection
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loop_case(jmap):
    """`_build_map`'s map with a second, Sim3-drifted epoch of its keyframes
    and points (disjoint points, so no covisibility across the epochs), as
    `tests/test_reloc_loop.py::TestLoopDetector` builds it; a vocabulary
    trained on its descriptors, every keyframe's BoW and a database of the
    first epoch's BoWs."""
    m, n_kf, n_pt = jmap, N_KF, int(jmap.n_pt)
    drift = jnp.concatenate([jlie.so3_exp(jnp.asarray([0.0, 0.03, 0.0])),
                             jnp.asarray([0.15, -0.05, 0.1, 1.06])])
    sl, sp = slice(n_kf, 2 * n_kf), slice(n_pt, 2 * n_pt)
    m2 = m._replace(
        kf_pose=m.kf_pose.at[sl].set(jmerge.transform_map(m, drift).kf_pose[:n_kf]),
        kf_valid=m.kf_valid.at[sl].set(m.kf_valid[:n_kf]),
        kf_xy=m.kf_xy.at[sl].set(m.kf_xy[:n_kf]),
        kf_level=m.kf_level.at[sl].set(m.kf_level[:n_kf]),
        kf_angle=m.kf_angle.at[sl].set(m.kf_angle[:n_kf]),
        kf_desc=m.kf_desc.at[sl].set(m.kf_desc[:n_kf]),
        kf_feat_valid=m.kf_feat_valid.at[sl].set(m.kf_feat_valid[:n_kf]),
        kf_obs=m.kf_obs.at[sl].set(jnp.where(m.kf_obs[:n_kf] >= 0, m.kf_obs[:n_kf] + n_pt, -1)),
        pt_pos=m.pt_pos.at[sp].set(jlie.sim3_apply(drift[None], m.pt_pos[:n_pt])),
        pt_valid=m.pt_valid.at[sp].set(m.pt_valid[:n_pt]),
        pt_desc=m.pt_desc.at[sp].set(m.pt_desc[:n_pt]),
        pt_ref_kf=m.pt_ref_kf.at[sp].set(jnp.where(m.pt_ref_kf[:n_pt] >= 0,
                                                   m.pt_ref_kf[:n_pt] + n_kf, -1)),
        n_kf=jnp.int32(2 * n_kf), n_pt=jnp.int32(2 * n_pt))
    valid = _np(m2.kf_feat_valid)
    voc = jvoc.train(_np(m2.kf_desc)[valid][:3000], branch=6, depth=2, seed=0)
    levels, idf = voc.device_arrays()
    bows = np.stack([_np(jvoc.bow_vector(levels, idf, m2.kf_desc[s], m2.kf_feat_valid[s],
                                         voc.branch, voc.n_words)) for s in range(2 * n_kf)])
    db = jdb.add_many(jdb.create(m2.kf_capacity, voc.n_words), jnp.arange(n_kf, dtype=jnp.int32),
                      jnp.asarray(bows[:n_kf]))
    return m2, bows, db, voc


class TestLoopDetection:
    def test_detect_verdict_batch_matches_reference(self, loop_case):
        """Every second-epoch keyframe queried against the first epoch, one
        key (one [300, F] Gumbel block) per row: the integer fields
        identical, S_ab to S_ATOL; the drifted revisit is found."""
        m2, bows, db, _ = loop_case
        slots = np.arange(N_KF, 2 * N_KF, dtype=np.int32)
        keys = jax.random.split(jax.random.PRNGKey(5), len(slots))
        covis = jms.covisibility(m2)
        want = _np(jld.detect_verdict_batch(keys, m2, db, covis, jnp.asarray(bows[slots]),
                                            jnp.asarray(slots), jnp.asarray(K)))
        tm2 = _port(m2)
        tdb_ = convert.bow_database_from_numpy(convert.bow_database_to_numpy(db))
        noises = torch.stack([gumbel_rows(k, 300, F) for k in keys])
        got = tld.detect_verdict_batch(noises, tm2, tdb_, tms.covisibility(tm2), _t(bows[slots]),
                                       _t(slots), _t(K)).numpy()
        assert got.shape == want.shape == (len(slots), 12)
        np.testing.assert_array_equal(got[:, :4], want[:, :4])
        ok = want[:, 2] > 0.5
        assert ok.sum() >= 3, want[:, :4]
        np.testing.assert_allclose(got[ok, 4:], want[ok, 4:], atol=S_ATOL)

    def test_on_keyframe_matches_reference(self, loop_case):
        """`LoopDetector.on_keyframe` over the second epoch, each keyframe's
        BoW registered first (`tests/test_reloc_loop.py::TestLoopDetector`),
        the port replaying the detector's PRNGKey(77) chain: the same
        keyframes fire with the same matches and triggers, S to S_ATOL."""
        m2, bows, db, voc = loop_case
        meta = jms.MapMeta.create(m2.kf_capacity, 8, agent_id=1)
        meta.kf_uuid[:] = meta.new_uuids(m2.kf_capacity)
        dj = jld.LoopDetector(voc, K)
        dt = tld.LoopDetector(convert.vocabulary_from_numpy(convert.vocabulary_to_numpy(voc)), K,
                              device="cpu")
        key = [jax.random.PRNGKey(77)]

        def replay(n):
            key[0], sub = jax.random.split(key[0])
            return gumbel_rows(sub, 300, n)

        dt._sim3_noise = replay
        tm2 = _port(m2)
        dbj, dbt = db, convert.bow_database_from_numpy(convert.bow_database_to_numpy(db))
        fired = []
        for slot in range(N_KF, 2 * N_KF):
            dbj = jdb.add_many(dbj, jnp.asarray([slot], jnp.int32), jnp.asarray(bows[slot:slot + 1]))
            dbt = tdb.add_many(dbt, [slot], _t(bows[slot:slot + 1]))
            fj, ij = dj.on_keyframe(m2, meta, dbj, slot)
            ft, it = dt.on_keyframe(tm2, meta, dbt, slot)
            assert fj == ft, slot
            if fj:
                fired.append(slot)
                assert (it["kf"], it["match"]) == (ij["kf"], ij["match"])
                np.testing.assert_allclose(it["S"], ij["S"], atol=S_ATOL)
        assert fired and dt.triggers == dj.triggers

    def test_correct_loop_matches_reference(self, loop_case):
        """The opt-in correction (`SlamAgent(loop_correction=True)`): the
        drifted revisit keyframe N_KF + 2 tied to keyframe 2 by the inverse
        drift, the first epoch fixed; poses to POSE_ATOL, points to
        PT_ATOL."""
        m2, _, _, _ = loop_case
        kf, match = N_KF + 2, 2
        S = _np(jlie.sim3_inv(jnp.concatenate([jlie.so3_exp(jnp.asarray([0.0, 0.03, 0.0])),
                                               jnp.asarray([0.15, -0.05, 0.1, 1.06])])))
        want = jld.LoopDetector(None, K).correct_loop(m2, kf, match, S, iters=10)
        got = tld.LoopDetector(None, K, device="cpu").correct_loop(_port(m2), kf, match, S,
                                                                   iters=10)
        assert np.abs(_np(want.kf_pose) - _np(m2.kf_pose)).max() > 1e-2   # the loop moved
        np.testing.assert_allclose(got.kf_pose.numpy(), _np(want.kf_pose), atol=POSE_ATOL)
        np.testing.assert_allclose(got.pt_pos.numpy(), _np(want.pt_pos), atol=PT_ATOL)

    def test_fold_sequences_give_identical_triggers(self):
        """Random verdict sequences (hits in and out of a region, misses)
        through both packages' consistency state: identical triggers."""
        rng = np.random.RandomState(9)
        meta = jms.MapMeta.create(64, 8, agent_id=1)
        meta.kf_uuid[:] = meta.new_uuids(64)
        for trial in range(4):
            dj = jld.LoopDetector(None, K)
            dt = tld.LoopDetector(None, K, device="cpu")
            for s in range(64):
                row = np.zeros(12, np.float32)
                row[0] = float(rng.rand() < 0.8)
                row[1] = float(rng.choice([3, 5, 9, 30]) + rng.randint(0, 4))
                row[2] = float(rng.rand() < 0.7)
                row[4:] = rng.randn(8)
                fj, ij = dj.fold(row, meta, s)
                ft, it = dt.fold(row, meta, s)
                assert fj == ft
                if fj:
                    assert ij["match"] == it["match"] and ij["kf"] == it["kf"]
                    np.testing.assert_array_equal(it["S"], ij["S"])
            assert dj.triggers == dt.triggers
            assert (dj._streak, dj._streak_target, dj._misses) == (dt._streak, dt._streak_target,
                                                                   dt._misses)
