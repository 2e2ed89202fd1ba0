"""The port's IMU preintegration, inertial factors and pose-inertial
optimization against the JAX package, on the CPU.

Inputs come from seeded numpy (`tests/test_inertial.py`'s simulated flight
and random IMU windows) and go through both packages. Tolerances: the
preintegrated deltas, the five bias Jacobians and the covariance to 1e-5
relative (f32 scans of up to 400 samples, summed in the same order);
residuals to 1e-5 absolute; the inertial optimization's states to 1e-4;
the per-frame pose-inertial optimization's state to 1e-4 with identical
inliers.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvm_slam_tpu.geometry import imu as jimu
from dvm_slam_tpu.geometry import lie as jlie
from dvm_slam_tpu.mapping import inertial as jinertial
from dvm_slam_tpu.tracking import pose_opt as jpose_opt

from dvm_slam_tpu_torch import convert
from dvm_slam_tpu_torch.geometry import imu as timu
from dvm_slam_tpu_torch.mapping import inertial as tinertial
from dvm_slam_tpu_torch.tracking import pose_opt as tpose_opt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_inertial import make_vi_problem  # noqa: E402

torch.set_num_threads(2)

RTOL = 1e-5


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def tpre(p):
    return convert.preintegrated_from_numpy(convert.preintegrated_to_numpy(p))


def assert_pre_close(pj, pt, rtol=RTOL):
    for k in jimu.Preintegrated._fields:
        a, b = np.asarray(getattr(pj, k)), getattr(pt, k).numpy()
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, rtol=0, atol=rtol * scale, err_msg=k)


def random_window(seed, n):
    rng = np.random.RandomState(seed)
    acc = (rng.randn(n, 3) * 2 + [0, 0, 9.81]).astype(np.float32)
    gyro = (rng.randn(n, 3) * 0.5).astype(np.float32)
    dts = rng.uniform(0.004, 0.006, n).astype(np.float32)
    bg = (rng.randn(3) * 0.01).astype(np.float32)
    ba = (rng.randn(3) * 0.1).astype(np.float32)
    return acc, gyro, dts, bg, ba


class TestPreintegration:
    @pytest.mark.parametrize("n,with_bias", [(50, False), (50, True), (137, True),
                                             (400, False), (400, True)])
    def test_window_matches_reference(self, n, with_bias):
        """The JAX `preintegrate_padded` (the tracker's call) against the
        port's `preintegrate`: dR, dV, dP, the five Jacobians, C, dT."""
        acc, gyro, dts, bg, ba = random_window(n + int(with_bias), n)
        kw_j = dict(bias_g=jnp.asarray(bg), bias_a=jnp.asarray(ba)) if with_bias else {}
        kw_t = dict(bias_g=t(bg), bias_a=t(ba)) if with_bias else {}
        calib_j = jimu.ImuCalib.create(freq=200.0)
        calib_t = timu.ImuCalib.create(freq=200.0)
        pj = jimu.preintegrate_padded(calib_j, acc, gyro, dts, **kw_j)
        pt = timu.preintegrate(calib_t, t(acc), t(gyro), t(dts), **kw_t)
        assert_pre_close(pj, pt)

    def test_calib_matches_reference(self):
        for freq in (100.0, 200.0):
            cj = jimu.ImuCalib.create(freq=freq)
            ct = timu.ImuCalib.create(freq=freq)
            for k in cj._fields:
                assert np.float32(getattr(ct, k)) == np.asarray(getattr(cj, k)), k
            back = convert.imu_calib_from_numpy(convert.imu_calib_to_numpy(cj))
            assert back == ct

    def test_single_measurement_and_getters(self):
        """`integrate_measurement` on a non-trivial state, the bias-corrected
        getters and `predict_state` under a changed bias."""
        acc, gyro, dts, bg, ba = random_window(5, 60)
        calib_j, calib_t = jimu.ImuCalib.create(), timu.ImuCalib.create()
        pj = jimu.preintegrate(calib_j, acc, gyro, dts, bias_g=bg, bias_a=ba)
        pt = tpre(pj)
        pj2 = jimu.integrate_measurement(pj, calib_j, jnp.asarray(acc[0]),
                                         jnp.asarray(gyro[1]), jnp.float32(0.007))
        pt2 = timu.integrate_measurement(pt, calib_t, t(acc[0]), t(gyro[1]),
                                         torch.tensor(0.007))
        assert_pre_close(pj2, pt2)
        nbg, nba = bg + 0.003, ba - 0.02
        for fj, ft, args in ((jimu.delta_rotation, timu.delta_rotation, (nbg,)),
                             (jimu.delta_velocity, timu.delta_velocity, (nbg, nba)),
                             (jimu.delta_position, timu.delta_position, (nbg, nba))):
            a = np.asarray(fj(pj, *[jnp.asarray(x) for x in args]))
            b = ft(pt, *[t(x) for x in args]).numpy()
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
        R = np.asarray(jlie.quat_to_matrix(jlie.so3_exp(jnp.asarray([0.1, -0.2, 0.3]))))
        v, p = np.array([0.3, 0.1, -0.2], np.float32), np.array([1.0, 2.0, 0.5], np.float32)
        outj = jimu.predict_state(pj, jnp.asarray(R), jnp.asarray(v), jnp.asarray(p),
                                  bias_g=jnp.asarray(nbg), bias_a=jnp.asarray(nba),
                                  gravity=jnp.asarray(jimu.GRAVITY))
        outt = timu.predict_state(pt, t(R), t(v), t(p), bias_g=t(nbg), bias_a=t(nba))
        for a, b in zip(outj, outt):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-5)

    def test_stack_round_trip(self):
        acc, gyro, dts, bg, ba = random_window(9, 20)
        pres = [jimu.preintegrate(jimu.ImuCalib.create(), acc[i:i + 10], gyro[i:i + 10],
                                  dts[i:i + 10]) for i in (0, 10)]
        pj = jax.tree.map(lambda *x: jnp.stack(x), *pres)
        pt = tpre(pj)
        assert pt.C.shape == (2, 15, 15)
        assert_pre_close(jax.tree.map(lambda x: x[1], pj), timu.index(pt, 1), rtol=0)
        st = timu.stack([timu.index(pt, 0), timu.index(pt, 1)])
        for a, b in zip(pt, st):
            assert torch.equal(a, b)


def _problem(seed, **kw):
    qs, ps, vs, pres = make_vi_problem(np.random.RandomState(seed), **kw)
    return qs, ps, vs, pres, tpre(pres)


class TestInertialResidual:
    @pytest.mark.parametrize("bias", [(0.0, 0.0), (0.05, -0.1)])
    def test_matches_reference(self, bias):
        qs, ps, vs, pres_j, pres_t = _problem(11)
        bg = np.full(3, bias[0], np.float32)
        ba = np.full(3, bias[1], np.float32)
        for k in range(qs.shape[0] - 1):
            rj = jinertial.inertial_residual(
                jnp.asarray(qs[k]), jnp.asarray(ps[k]), jnp.asarray(vs[k]), jnp.asarray(bg),
                jnp.asarray(ba), jnp.asarray(qs[k + 1]), jnp.asarray(ps[k + 1]),
                jnp.asarray(vs[k + 1]), jax.tree.map(lambda x: x[k], pres_j))
            rt = tinertial.inertial_residual(t(qs[k]), t(ps[k]), t(vs[k]), t(bg), t(ba),
                                             t(qs[k + 1]), t(ps[k + 1]), t(vs[k + 1]),
                                             timu.index(pres_t, k))
            np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-5)
        # batched over the edges at once
        rb = tinertial.inertial_residual(t(qs[:-1]), t(ps[:-1]), t(vs[:-1]),
                                         t(np.tile(bg, (len(qs) - 1, 1))),
                                         t(np.tile(ba, (len(qs) - 1, 1))), t(qs[1:]),
                                         t(ps[1:]), t(vs[1:]), pres_t)
        np.testing.assert_allclose(rb[-1].numpy(), rt.numpy(), rtol=0, atol=1e-6)


class TestInertialOptimization:
    def test_matches_reference(self):
        """`tests/test_inertial.py`'s bias-recovery setup (8 keyframes,
        measurements biased, preintegration at zero bias, velocities
        unknown), 25 iterations in both packages."""
        true_bg = np.array([0.01, -0.005, 0.008], np.float32)
        true_ba = np.array([0.05, 0.02, -0.03], np.float32)
        zero = np.zeros(3, np.float32)
        qs, ps, vs, pres_j, pres_t = _problem(0, n_kf=8, bias_g=true_bg, bias_a=true_ba,
                                              assumed_bg=zero, assumed_ba=zero)
        n = qs.shape[0]
        fixed = np.zeros(n, bool)
        fixed[0] = True
        z3 = np.zeros((n, 3), np.float32)
        sj = jinertial.ImuState(q=jnp.asarray(qs), p=jnp.asarray(ps), v=jnp.asarray(z3),
                                bg=jnp.asarray(z3), ba=jnp.asarray(z3))
        outj, costj = jinertial.inertial_optimization(sj, pres_j, jnp.asarray(qs),
                                                      jnp.asarray(ps), jnp.asarray(fixed),
                                                      iters=25)
        st = convert.imu_state_from_numpy(convert.imu_state_to_numpy(sj))
        outt, costt = tinertial.inertial_optimization(st, pres_t, t(qs), t(ps),
                                                      torch.from_numpy(fixed), iters=25)
        for k in jinertial.ImuState._fields:
            np.testing.assert_allclose(getattr(outt, k).numpy(), np.asarray(getattr(outj, k)),
                                       rtol=0, atol=1e-4, err_msg=k)
        assert abs(float(costt) - float(costj)) <= 1e-4 * max(1.0, float(costj))
        assert np.abs(outt.bg[1:].numpy() - true_bg).max() < 5e-3

    def test_marginalize_matches_reference(self):
        rng = np.random.RandomState(4)
        A = rng.randn(40, 30).astype(np.float32)
        H = A.T @ A
        H[12:18, 12:18] += np.diag([0, 0, 0, 1, 2, 3]).astype(np.float32)
        b = rng.randn(30).astype(np.float32)
        Hj, bj = jinertial.marginalize(jnp.asarray(H), jnp.asarray(b), 12, 18)
        Ht, bt = tinertial.marginalize(t(H), t(b), 12, 18)
        np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=0,
                                   atol=1e-4 * np.abs(H).max())
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=0,
                                   atol=1e-4 * np.abs(b).max())
        assert np.all(Ht.numpy()[12:18] == 0) and np.all(bt.numpy()[12:18] == 0)


def _pose_inertial_setup(seed, T_cb):
    """`tests/test_inertial.py::TestPoseInertialOptimization`'s setup: 50
    IMU samples over 0.25 s, 24 points of which 6 are usable, a perturbed
    pose and velocity; the points seen through the extrinsic T_cb."""
    rng = np.random.RandomState(seed)
    dt_total, n_imu = 0.25, 50
    dts = np.full(n_imu, dt_total / n_imu, np.float32)
    v0 = np.array([0.3, -0.1, 0.2], np.float32)
    a_w = np.array([0.5, 0.2, -0.3], np.float32)
    g = np.asarray(jimu.GRAVITY)
    acc = np.tile(a_w - g, (n_imu, 1)).astype(np.float32)
    gyro = np.zeros((n_imu, 3), np.float32)
    pre = jimu.preintegrate(jimu.ImuCalib.create(), jnp.asarray(acc), jnp.asarray(gyro),
                            jnp.asarray(dts))
    p1 = v0 * dt_total + 0.5 * a_w * dt_total ** 2
    v1 = v0 + a_w * dt_total
    T_true = jlie.se3(jlie.quat_identity(), jnp.asarray(-p1))
    N = 24
    pts = rng.randn(N, 3).astype(np.float32) * 2 + [0, 0, 6]
    pc = np.asarray(jax.vmap(lambda X: jlie.se3_apply(jlie.se3_mul(T_cb, T_true), X))(
        jnp.asarray(pts, jnp.float32)))
    uv = np.stack([260 * pc[:, 0] / pc[:, 2] + 160,
                   260 * pc[:, 1] / pc[:, 2] + 120], -1).astype(np.float32)
    uv += rng.randn(N, 2).astype(np.float32) * 0.3
    valid = np.zeros(N, bool)
    valid[:6] = True
    T0 = np.asarray(jlie.se3_retract(T_true, jnp.asarray([0.05, -0.04, 0.06, 0.01, -0.02, 0.015])))
    v_init = (v1 + rng.randn(3).astype(np.float32) * 0.1).astype(np.float32)
    return dict(T0=T0, v_init=v_init, v0=v0, pre=pre, pts=pts.astype(np.float32), uv=uv,
                sigma2=np.ones(N, np.float32), valid=valid,
                K=np.array([260.0, 260.0, 160.0, 120.0], np.float32), g=g)


class TestPoseInertialOptimization:
    @pytest.mark.parametrize("T_cb", [(1.0, 0, 0, 0, 0, 0, 0),
                                      (0.9998, 0.0, 0.02, 0.0, 0.05, -0.01, 0.02)])
    def test_matches_reference(self, T_cb):
        """Identity and a non-identity camera-from-body extrinsic (its
        quaternion normalized), non-zero anchor biases."""
        T_cb = np.asarray(jlie.se3(jlie.quat_normalize(jnp.asarray(T_cb[:4], jnp.float32)),
                                   jnp.asarray(T_cb[4:], jnp.float32)))
        s = _pose_inertial_setup(0, jnp.asarray(T_cb))
        bg_a = np.array([0.002, -0.001, 0.003], np.float32)
        ba_a = np.array([0.01, 0.02, -0.01], np.float32)
        T_a = np.asarray(jlie.se3_identity())
        outj = jpose_opt.pose_inertial_optimization(
            jnp.asarray(s["T0"]), jnp.asarray(s["v_init"]), jnp.asarray(bg_a), jnp.asarray(ba_a),
            jnp.asarray(T_a), jnp.asarray(s["v0"]), jnp.asarray(bg_a), jnp.asarray(ba_a),
            s["pre"], jnp.asarray(s["pts"]), jnp.asarray(s["uv"]), jnp.asarray(s["sigma2"]),
            jnp.asarray(s["valid"]), jnp.asarray(s["K"]), jnp.asarray(T_cb),
            jnp.asarray(s["g"]))
        outt = tpose_opt.pose_inertial_optimization(
            t(s["T0"]), t(s["v_init"]), t(bg_a), t(ba_a), t(T_a), t(s["v0"]), t(bg_a),
            t(ba_a), tpre(s["pre"]), t(s["pts"]), t(s["uv"]), t(s["sigma2"]),
            torch.from_numpy(s["valid"]), t(s["K"]), t(T_cb), t(s["g"]))
        for a, b, name in zip(outj[:4], outt[:4], ("T_bw", "v", "bg", "ba")):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-4, err_msg=name)
        assert np.array_equal(outt[4].numpy(), np.asarray(outj[4]))
        assert int(outt[4].sum()) == 6
        np.testing.assert_allclose(outt[5].numpy(), np.asarray(outj[5]), rtol=1e-3, atol=1e-3)


def test_jacfwd_columns_match_finite_differences():
    """`inertial.jacfwd`'s batched JVP against central differences in f64."""
    W = torch.randn(5, 4, dtype=torch.float64, generator=torch.Generator().manual_seed(0))

    def f(dx):
        return torch.sin(dx @ W.T) + (dx ** 2).sum(-1, keepdim=True)

    r, J = tinertial.jacfwd(lambda dx: f(dx + 0.3), 4, torch.float64, None)
    eps = 1e-6
    Jn = torch.stack([(f(torch.full((4,), 0.3, dtype=torch.float64) + eps * e)
                       - f(torch.full((4,), 0.3, dtype=torch.float64) - eps * e)) / (2 * eps)
                      for e in torch.eye(4, dtype=torch.float64)], -1)
    assert torch.allclose(J, Jn, atol=1e-8)
    assert torch.allclose(r, f(torch.full((4,), 0.3, dtype=torch.float64)))
