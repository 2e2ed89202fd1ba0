"""The port's joint visual-inertial BA and IMU-initialization estimators
against the JAX package, on the CPU.

`tests/test_vi_pipeline.py::_circular_rig` gives exact preintegrations
between keyframes on an analytic trajectory; observations of random points
are projected through a camera-from-body extrinsic. Tolerances:
`vi_bundle_adjust` poses and velocities 1e-4, points 1e-3 (f32 solves of an
equilibrated [15L,15L] system whose LAPACK paths differ), the visual chi2
1e-4 relative; the gyro bias 1e-6, the gravity/scale system 1e-4 relative
(an ill-conditioned least squares: the port's SVD runs in f32 on the CPU
as the reference's does), the alignment rotation 1e-6.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvm_slam_tpu.geometry import lie as jlie
from dvm_slam_tpu.mapping import vi_ba as jvi

from dvm_slam_tpu_torch import convert
from dvm_slam_tpu_torch.mapping import vi_ba as tvi

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_vi_pipeline import _circular_rig  # noqa: E402

torch.set_num_threads(2)


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def tpre(p):
    return convert.preintegrated_from_numpy(convert.preintegrated_to_numpy(p))


T_CB = np.asarray(jlie.se3(jlie.quat_normalize(jnp.asarray([0.999, 0.02, -0.03, 0.01])),
                           jnp.asarray([0.04, -0.02, 0.03])))


def vi_problem(seed, L=8, F=96, P=300, T_cb=T_CB):
    """The rig's poses perturbed (the first kept), points observed through
    T_cb and perturbed, velocities perturbed."""
    rng = np.random.RandomState(seed)
    T_bw, vels, pres = _circular_rig(L)
    X = (rng.randn(P, 3) * 3 + [0, 8, 0]).astype(np.float32)
    uv = np.zeros((L, F, 2), np.float32)
    obs = np.full((L, F), -1, np.int32)
    for k in range(L):
        T_cw = jlie.se3_mul(jnp.asarray(T_cb), T_bw[k])
        pc = np.asarray(jax.vmap(lambda x: jlie.se3_apply(T_cw, x))(jnp.asarray(X)))
        sel = np.nonzero(pc[:, 2] > 1.0)[0][:F]
        obs[k, :len(sel)] = sel
        uv[k, :len(sel), 0] = 300 * pc[sel, 0] / pc[sel, 2] + 160
        uv[k, :len(sel), 1] = 300 * pc[sel, 1] / pc[sel, 2] + 120
    uv += rng.randn(L, F, 2).astype(np.float32) * 0.5
    obs[2, 5] = obs[2, 6]          # a point observed twice by one keyframe (fault m)
    pert = rng.randn(L, 6).astype(np.float32) * 0.01
    pert[0] = 0
    T0 = np.asarray(jax.vmap(jlie.se3_retract)(T_bw, jnp.asarray(pert)))
    X0 = (X + rng.randn(P, 3).astype(np.float32) * 0.05).astype(np.float32)
    v0 = (np.asarray(vels) + rng.randn(L, 3).astype(np.float32) * 0.1).astype(np.float32)
    sigma2 = rng.choice([1.0, 1.44, 2.0736], size=(L, F)).astype(np.float32)
    return dict(T0=T0, v0=v0, X0=X0, uv=uv, obs=obs, sigma2=sigma2, pres=pres,
                T_bw=np.asarray(T_bw), vels=np.asarray(vels))


def run_both(s, fixed, pre_valid, pt_opt, iters, T_cb=T_CB):
    L = s["T0"].shape[0]
    K = np.array([300.0, 300.0, 160.0, 120.0], np.float32)
    bg = np.tile(np.array([0.001, -0.002, 0.0005], np.float32), (L, 1))
    ba = np.tile(np.array([0.01, 0.0, -0.02], np.float32), (L, 1))
    wj = jvi.ViWindow(T_bw=jnp.asarray(s["T0"]), v=jnp.asarray(s["v0"]), bg=jnp.asarray(bg),
                      ba=jnp.asarray(ba))
    outj = jvi.vi_bundle_adjust(wj, jnp.asarray(fixed), jnp.asarray(s["uv"]),
                                jnp.asarray(s["sigma2"]), jnp.asarray(s["obs"]),
                                jnp.asarray(s["X0"]), jnp.asarray(pt_opt), jnp.asarray(K),
                                jnp.asarray(T_cb), s["pres"], jnp.asarray(pre_valid),
                                iters=iters)
    wt = convert.vi_window_from_numpy(convert.vi_window_to_numpy(wj))
    outt = tvi.vi_bundle_adjust(wt, torch.from_numpy(fixed), t(s["uv"]), t(s["sigma2"]),
                                torch.from_numpy(s["obs"]), t(s["X0"]),
                                torch.from_numpy(pt_opt), t(K), t(T_cb), tpre(s["pres"]),
                                torch.from_numpy(pre_valid), iters=iters)
    return outj, outt


def assert_ba_close(outj, outt):
    (wj, pj, cj), (wt, pt, ct) = outj, outt
    for k in ("T_bw", "v", "bg", "ba"):
        np.testing.assert_allclose(getattr(wt, k).numpy(), np.asarray(getattr(wj, k)), rtol=0,
                                   atol=1e-4, err_msg=k)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-3)
    assert abs(float(ct) - float(cj)) <= 1e-4 * max(1.0, float(cj))


class TestViBundleAdjust:
    @pytest.mark.parametrize("case", ["gauge", "fixed_and_gap", "identity_extrinsic"])
    def test_matches_reference(self, case):
        """One gauge keyframe; two fixed poses with an invalid edge and
        frozen points; the identity extrinsic."""
        T_cb = np.asarray(jlie.se3_identity()) if case == "identity_extrinsic" else T_CB
        s = vi_problem(1, T_cb=T_cb)
        L, P = s["T0"].shape[0], s["X0"].shape[0]
        fixed = np.zeros(L, bool)
        fixed[0] = True
        pre_valid = np.ones(L - 1, bool)
        pt_opt = np.ones(P, bool)
        if case == "fixed_and_gap":
            fixed[4] = True
            pre_valid[2] = False
            pt_opt[::7] = False
        outj, outt = run_both(s, fixed, pre_valid, pt_opt, iters=8, T_cb=T_cb)
        assert_ba_close(outj, outt)
        if case != "fixed_and_gap":   # without the gap's edge the velocities converge
            assert np.abs(outt[0].v.numpy() - s["vels"]).max() < 0.05

    def test_all_poses_fixed_estimates_velocity(self):
        """Every pose pinned: poses stay put, velocities still move
        (`tests/test_vi_pipeline.py::test_fixed_pose_velocity_still_estimated`)."""
        s = vi_problem(2, L=4, F=8, P=20)
        s["v0"] = s["vels"] + 0.5
        s["T0"] = s["T_bw"]
        fixed = np.ones(4, bool)
        outj, outt = run_both(s, fixed, np.ones(3, bool), np.zeros(20, bool), iters=8)
        assert_ba_close(outj, outt)
        np.testing.assert_allclose(outt[0].T_bw.numpy(), s["T_bw"], atol=1e-6)


class TestImuInit:
    @pytest.mark.parametrize("L,scale", [(4, 1.0), (8, 1.0), (8, 1.0 / 3.0)])
    def test_estimators_match_reference(self, L, scale):
        """The gyro bias, then gravity, scale and velocities from visual
        poses at `scale` of the metric ones."""
        T_bw, vels, pres = _circular_rig(L=L)
        T = np.asarray(T_bw).copy()
        T[:, 4:7] *= scale
        pt = tpre(pres)
        bgj = jvi.estimate_gyro_bias(jnp.asarray(T), pres)
        bgt = tvi.estimate_gyro_bias(t(T), pt)
        np.testing.assert_allclose(bgt.numpy(), np.asarray(bgj), rtol=0, atol=1e-6)
        sj, gj, vj = jvi.estimate_gravity_scale(jnp.asarray(T), None, pres, bias_g=bgj)
        st, gt, vt = tvi.estimate_gravity_scale(t(T), None, pt, bias_g=bgt)
        assert abs(float(st) - float(sj)) <= 1e-4 * abs(float(sj))
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=1e-3)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(np.asarray(vj)).max()))
        if L == 8:
            assert abs(float(st) - 1.0 / scale) < 0.05 / scale

    @pytest.mark.parametrize("g", [(2.0, 1.0, -9.3), (0.0, 0.0, -9.81), (0.1, 9.7, 0.5)])
    def test_gravity_alignment_matches_reference(self, g):
        gj = jnp.asarray(g) / jnp.linalg.norm(jnp.asarray(g)) * 9.81
        qj = np.asarray(jvi.gravity_alignment_rotation(gj))
        qt = tvi.gravity_alignment_rotation(t(np.asarray(gj))).numpy()
        np.testing.assert_allclose(qt, qj, rtol=0, atol=1e-6)
