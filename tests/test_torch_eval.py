"""Trajectory evaluation and trajectory files: the port's `eval/metrics.py`
(`camera_centers`, `ate_rmse`, `rpe`), `geometry/alignment.py::umeyama` and
`io/trajectory.py` against the JAX package on the same numpy poses."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dvm_slam_tpu.eval import metrics as jmetrics
from dvm_slam_tpu.geometry import alignment as jalign
from dvm_slam_tpu.geometry import lie as jlie
from dvm_slam_tpu.io import trajectory as jtraj

from dvm_slam_tpu_torch.eval import metrics as tmetrics
from dvm_slam_tpu_torch.geometry import alignment as talign
from dvm_slam_tpu_torch.geometry import lie as tlie
from dvm_slam_tpu_torch.io import trajectory as ttraj

torch.set_num_threads(2)


def _read(path, sep=None):
    return np.array([[float(v) for v in line.split(sep)] for line in open(path)])


class TestMetricsAndTrajectories:
    def _poses(self, rng, n=40):
        q = jlie.so3_exp(jnp.asarray(rng.randn(n, 3).astype(np.float32) * 0.2))
        return np.asarray(jlie.se3(q, jnp.asarray(rng.randn(n, 3).astype(np.float32))))

    def test_ate_and_rpe(self, rng):
        gt = self._poses(rng)
        noise = np.asarray(jlie.se3_exp(jnp.asarray(rng.randn(40, 6).astype(np.float32) * 0.02)))
        est = np.asarray(jlie.se3_mul(jnp.asarray(noise), jnp.asarray(gt)))
        for scale in (True, False):
            rj, aj, Sj = jmetrics.ate_rmse(est, gt, correct_scale=scale)
            rt, at, St = tmetrics.ate_rmse(torch.from_numpy(est), gt, correct_scale=scale)
            assert abs(rt - rj) <= 1e-5 * (1 + rj)
            np.testing.assert_allclose(at, aj, atol=1e-4)
            np.testing.assert_allclose(St, Sj, atol=1e-4)
        for delta in (1, 5, 39, 40):
            assert abs(tmetrics.rpe(est, gt, delta) - jmetrics.rpe(est, gt, delta)) <= 1e-5
        np.testing.assert_allclose(tmetrics.camera_centers(gt), jmetrics.camera_centers(gt),
                                   atol=1e-5)
        np.testing.assert_allclose(tmetrics.camera_centers(gt[0]),
                                   jmetrics.camera_centers(gt[0]), atol=1e-5)

    @pytest.mark.parametrize("with_scale", [True, False])
    def test_umeyama(self, rng, with_scale):
        src = rng.randn(60, 3).astype(np.float32)
        S_true = jnp.concatenate([jlie.so3_exp(jnp.array([0.2, -0.1, 0.4])),
                                  jnp.array([1.0, -2.0, 0.5, 1.7 if with_scale else 1.0])])
        dst = np.array(jlie.sim3_apply(S_true[None], jnp.asarray(src)))
        dst += rng.randn(60, 3).astype(np.float32) * 0.01
        dst[50:] += 100.0
        mask = np.arange(60) < 50
        for m in (None, mask):
            Sj = jalign.umeyama(jnp.asarray(src), jnp.asarray(dst),
                                mask=None if m is None else jnp.asarray(m), with_scale=with_scale)
            St = talign.umeyama(torch.from_numpy(src), torch.from_numpy(dst),
                                mask=None if m is None else torch.from_numpy(m),
                                with_scale=with_scale)
            np.testing.assert_allclose(St.numpy(), np.asarray(Sj), atol=1e-4, rtol=1e-4)
            np.testing.assert_allclose(tlie.sim3_apply(St[None], torch.from_numpy(src)).numpy(),
                                       np.asarray(jlie.sim3_apply(Sj[None], jnp.asarray(src))),
                                       atol=1e-3, rtol=1e-4)

    def test_save_load_round_trip(self, rng, tmp_path):
        poses = self._poses(rng, 7)
        traj = [(i * 0.05, torch.from_numpy(T) if i % 2 else T, "OK")
                for i, T in enumerate(poses)]
        p = str(tmp_path / "t.txt")
        ttraj.save_tum(p, traj)
        back = ttraj.load_tum(p)
        assert [round(ts, 6) for ts, _ in back] == [round(ts, 6) for ts, _, _ in traj]
        ones = torch.ones(3)
        for (_, T0, _), (_, T1) in zip(traj, back):
            np.testing.assert_allclose(
                tlie.se3_apply(torch.as_tensor(T0), ones).numpy(),
                tlie.se3_apply(torch.from_numpy(T1), ones).numpy(), atol=1e-4)
        # the reference reads the port's file into the same poses
        for (_, T1), (_, T2) in zip(back, jtraj.load_tum(p)):
            np.testing.assert_allclose(T1, T2, atol=1e-6)
        for fn_t, fn_j in ((ttraj.save_euroc, jtraj.save_euroc),
                           (ttraj.save_kitti, jtraj.save_kitti)):
            fn_t(str(tmp_path / "a.txt"), traj)
            fn_j(str(tmp_path / "b.txt"), [(ts, np.asarray(T), s) for ts, T, s in traj])
            sep = "," if fn_t is ttraj.save_euroc else None
            np.testing.assert_allclose(_read(tmp_path / "a.txt", sep), _read(tmp_path / "b.txt", sep),
                                       atol=2e-7, rtol=1e-6)
