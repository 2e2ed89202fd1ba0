"""Monocular initialization parity: the port's `search_for_initialization`
(with `mutual_filter` and `rotation_consistency`) and two-view
reconstruction against the JAX package on the same numpy inputs.

The RANSAC draws are the reference's own: the test rebuilds the Gumbel noise
from the JAX key schedule of `two_view.reconstruct_two_views` (one split
into the homography and the essential key, `iters` subkeys each) and hands
it to the port, which takes its draws as inputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvm_slam_tpu.frontend import extractor as jex
from dvm_slam_tpu.geometry import lie as jlie
from dvm_slam_tpu.geometry import two_view as jtv
from dvm_slam_tpu.io import synthetic as jsyn
from dvm_slam_tpu.ops import matching as jmatch

from dvm_slam_tpu_torch import convert
from dvm_slam_tpu_torch.geometry import two_view as ttv
from dvm_slam_tpu_torch.ops import matching as tmatch

torch.set_num_threads(2)

ITERS = 200
T_ATOL = 2e-3        # T21 (unit quaternion and unit-norm translation)
PT_RTOL = 2e-3       # points: |dX| <= PT_RTOL * (1 + |X|)
GOOD_AGREE = 0.99    # fraction of matches with the same `good` verdict


@jax.jit
def _gumbel_rows(key, n_like):
    keys = jax.random.split(key, ITERS)
    return jax.vmap(lambda k: jax.random.gumbel(k, n_like.shape))(keys)


def reference_draws(key, n):
    """The Gumbel noise [ITERS, n] of the reference's homography and
    essential samplers under `key`: `two_view.py:236` splits the key in two,
    `_ransac_best` splits each into ITERS subkeys and draws `gumbel(k, (n,))`
    per subkey."""
    k_h, k_e = jax.random.split(key)
    like = jnp.zeros((n,), jnp.float32)
    return np.asarray(_gumbel_rows(k_h, like)), np.asarray(_gumbel_rows(k_e, like))


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene(rng, n=300, planar=False):
    """`tests/test_matching_twoview.py`'s scene: bearings in two views."""
    if planar:
        X = np.stack([rng.rand(n) * 4 - 2, rng.rand(n) * 4 - 2, np.full(n, 5.0)],
                     -1).astype(np.float32)
    else:
        X = rng.randn(n, 3).astype(np.float32)
        X[:, 2] = X[:, 2] * 1.5 + 6.0
    T21 = jlie.se3(jlie.so3_exp(jnp.array([0.02, -0.08, 0.01])), jnp.array([0.8, 0.1, 0.05]))
    x1 = X[:, :2] / X[:, 2:3]
    Xc2 = np.asarray(jlie.se3_apply(T21[None], jnp.asarray(X)))
    x2 = Xc2[:, :2] / Xc2[:, 2:3]
    mk3 = lambda p: np.concatenate([p, np.ones_like(p[:, :1])], -1).astype(np.float32)  # noqa: E731
    return mk3(x1), mk3(x2), np.asarray(T21), X


def _both(key, x1, x2, mask, focal=450.0):
    res_j = jtv.reconstruct_two_views(key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask),
                                      focal=focal)
    nh, ne = reference_draws(key, x1.shape[0])
    res_t = ttv.reconstruct_two_views(_t(nh), _t(ne), _t(x1), _t(x2), _t(mask),
                                      focal=torch.tensor(focal, dtype=torch.float32))
    return res_j, res_t


def _same_result(res_j, res_t):
    assert bool(res_t.ok) == bool(res_j.ok)
    assert bool(res_t.used_homography) == bool(res_j.used_homography)
    if not bool(res_j.ok):
        return
    np.testing.assert_allclose(res_t.T21.numpy(), np.asarray(res_j.T21), atol=T_ATOL)
    gj, gt = np.asarray(res_j.good), res_t.good.numpy()
    assert np.mean(gj == gt) >= GOOD_AGREE
    both = gj & gt
    Xj, Xt = np.asarray(res_j.points)[both], res_t.points.numpy()[both]
    err = np.abs(Xt - Xj).max(1) / (1.0 + np.linalg.norm(Xj, axis=1))
    assert err.max() <= PT_RTOL


class TestTwoView:
    def test_general_scene_uses_essential(self, rng):
        x1, x2, _, _ = _scene(rng)
        res_j, res_t = _both(jax.random.PRNGKey(1), x1, x2, np.ones(len(x1), bool))
        assert bool(res_j.ok) and not bool(res_j.used_homography)
        _same_result(res_j, res_t)
        assert int(res_t.good.sum()) > 250

    def test_planar_scene_uses_homography(self, rng):
        x1, x2, _, _ = _scene(rng, planar=True)
        res_j, res_t = _both(jax.random.PRNGKey(2), x1, x2, np.ones(len(x1), bool))
        assert bool(res_j.ok) and bool(res_j.used_homography)
        _same_result(res_j, res_t)

    def test_outliers_rejected(self, rng):
        x1, x2, _, _ = _scene(rng)
        x2[:60, :2] += (rng.randn(60, 2) * 0.3).astype(np.float32)
        mask = np.ones(len(x1), bool)
        mask[-20:] = False      # masked matches never enter a sample
        res_j, res_t = _both(jax.random.PRNGKey(3), x1, x2, mask)
        assert bool(res_j.ok)
        _same_result(res_j, res_t)
        assert res_t.good.numpy()[:60].sum() < 8
        assert not res_t.good.numpy()[-20:].any()

    def test_no_parallax_fails(self, rng):
        n = 200
        X = rng.randn(n, 3).astype(np.float32)
        X[:, 2] = X[:, 2] * 1.5 + 6.0
        T21 = jlie.se3(jlie.so3_exp(jnp.array([0.0, 0.1, 0.0])), jnp.zeros(3))  # pure rotation
        Xc2 = np.asarray(jlie.se3_apply(T21[None], jnp.asarray(X)))
        mk3 = lambda p: np.concatenate([p, np.ones_like(p[:, :1])], -1).astype(np.float32)  # noqa: E731
        res_j, res_t = _both(jax.random.PRNGKey(4), mk3(X[:, :2] / X[:, 2:3]),
                             mk3(Xc2[:, :2] / Xc2[:, 2:3]), np.ones(n, bool))
        assert not bool(res_j.ok) and not bool(res_t.ok)
        assert not res_t.good.numpy().any()

    def test_samples_match_reference_top_k(self):
        """The minimal sets: the port's stable sort of noise + mask picks the
        indices `jax.lax.top_k` picks, masked entries (all -1e9) included."""
        n = 40
        nh, _ = reference_draws(jax.random.PRNGKey(5), n)
        mask = np.zeros(n, bool)
        mask[::7] = True        # 6 valid entries: every sample takes 2 masked ones
        g = jnp.asarray(nh) + jnp.where(jnp.asarray(mask), 0.0, -1e9)
        want = np.asarray(jax.vmap(lambda r: jax.lax.top_k(r, 8)[1])(g))
        got = ttv.sample_indices(_t(nh), _t(mask)).numpy()
        np.testing.assert_array_equal(got, want)


def _candidate_sets_equal(Rt_a, Rt_b, atol=1e-4):
    (Ra, ta), (Rb, tb) = Rt_a, Rt_b
    A = np.concatenate([np.asarray(Ra).reshape(len(Ra), 9), np.asarray(ta)], 1)
    B = np.concatenate([np.asarray(Rb).reshape(len(Rb), 9), np.asarray(tb)], 1)
    d = np.abs(A[:, None, :] - B[None, :, :]).max(-1)
    return bool((d.min(1) <= atol).all() and (d.min(0) <= atol).all())


class TestDecompositions:
    def _models(self, rng):
        x1, x2, _, _ = _scene(rng, planar=True)
        H = np.asarray(jtv._dlt_h(jnp.asarray(x1[:40, :2]), jnp.asarray(x2[:40, :2])))
        x1, x2, _, _ = _scene(rng)
        E = np.asarray(jtv._eight_point_e(jnp.asarray(x1[:8, :2]), jnp.asarray(x2[:8, :2])))
        return H, E

    def test_decompose_h_candidate_set(self, rng):
        H, _ = self._models(rng)
        ref = jtv._decompose_h(jnp.asarray(H))
        assert _candidate_sets_equal(ttv._decompose_h(_t(H)), ref)
        # a flipped sign of H permutes the candidates and keeps the set
        assert _candidate_sets_equal(ttv._decompose_h(_t(-H)), ref)

    def test_decompose_e_candidate_set(self, rng):
        _, E = self._models(rng)
        ref = jtv._decompose_e(jnp.asarray(E))
        assert _candidate_sets_equal(ttv._decompose_e(_t(E)), ref)
        assert _candidate_sets_equal(ttv._decompose_e(_t(-E)), ref)

    def test_dlt_h_up_to_sign(self, rng):
        """The DLT homographies of the same minimal sets of a planar scene
        agree up to the free sign of the null vector."""
        x1, x2, _, _ = _scene(rng, planar=True)
        idx = rng.randint(0, len(x1), (16, 8))
        want = np.stack([np.asarray(jtv._dlt_h(jnp.asarray(x1[i, :2]), jnp.asarray(x2[i, :2])))
                         for i in idx])
        got = ttv._dlt_h(_t(x1[idx, :2]), _t(x2[idx, :2])).numpy()
        sign = np.sign(np.sum(got * want, axis=(1, 2)))[:, None, None]
        np.testing.assert_allclose(got * sign, want, atol=2e-4)

    def test_eight_point_e_on_manifold(self, rng):
        """Eight-point hypotheses lie on the essential manifold (singular
        values 1, 1, 0) and nearly satisfy their own sample's epipolar
        constraints. They are not compared with the reference's entry by
        entry: the f32 normal equations A^T A square A's condition number,
        and for one sample LAPACK builds return E's that differ by up to ~1
        (max abs), so E is held to the reference at RANSAC's output
        (`TestTwoView`)."""
        x1, x2, _, _ = _scene(rng)
        idx = rng.randint(0, len(x1), (16, 8))
        E = ttv._eight_point_e(_t(x1[idx, :2]), _t(x2[idx, :2])).numpy()
        np.testing.assert_allclose(np.linalg.svd(E)[1], np.tile([1.0, 1.0, 0.0], (16, 1)),
                                   atol=1e-5)
        r = np.einsum("snk,skl,snl->sn", x2[idx], E, x1[idx])
        assert np.abs(r).max() < 0.2


class TestSearchForInitialization:
    def test_mutual_filter(self):
        idx, ok = tmatch.mutual_filter(torch.tensor([1, 0, 2, -1]), torch.tensor([1, 0, 0]))
        idx_j, ok_j = jmatch.mutual_filter(jnp.array([1, 0, 2, -1]), jnp.array([1, 0, 0]))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_rotation_consistency(self, seed):
        """Random angles with a dominant rotation, wrapped differences of
        both signs, ties between bins: identical masks."""
        r = np.random.RandomState(seed)
        n = 400
        a = (r.rand(n) * 2 * np.pi).astype(np.float32)
        rot = np.where(r.rand(n) < 0.7, 0.4, r.rand(n) * 6.0 - 3.0)
        b = (a - rot).astype(np.float32)
        b[:5] = a[:5]                               # zero difference
        b[5:10] = a[5:10] + np.float32(2 * np.pi)   # wraps onto 2 pi
        idx = r.randint(-1, n, n)
        ok = (idx >= 0) & (r.rand(n) < 0.9)
        idx = np.where(ok, np.arange(n), idx)
        got = tmatch.rotation_consistency(_t(a), _t(b), _t(idx), _t(ok)).numpy()
        want = np.asarray(jmatch.rotation_consistency(jnp.asarray(a), jnp.asarray(b),
                                                      jnp.asarray(idx), jnp.asarray(ok)))
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < ok.sum()

    def test_shifted_features(self, rng):
        """`tests/test_matching_twoview.py::TestSearchInit`'s permuted,
        shifted, noisy descriptors, with random orientations."""
        n = 300
        desc = (rng.rand(n, 256) > 0.5).astype(np.uint8)
        xy1 = (rng.rand(n, 2) * 400).astype(np.float32)
        perm = rng.permutation(n)
        xy2 = (xy1 + np.array([8.0, -5.0], np.float32))[perm]
        desc2 = desc[perm] ^ (rng.rand(n, 256) < 0.05).astype(np.uint8)
        ang1 = (rng.rand(n) * 6.28).astype(np.float32)
        ang2 = (ang1[perm] - np.where(rng.rand(n) < 0.8, 0.1, rng.rand(n) * 3)).astype(np.float32)
        valid = rng.rand(n) < 0.95
        args = (xy1, desc, ang1, valid, xy2, desc2, ang2, valid[perm])
        idx_j, ok_j = jmatch.search_for_initialization(*map(jnp.asarray, args))
        idx_t, ok_t = tmatch.search_for_initialization(*map(_t, args))
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
        assert ok_t.sum() > 150

    def test_rendered_frames(self):
        """Two rendered frames of `tests/test_tracking.py`'s world at 240x320
        through the JAX front end, matched by both packages: identical idx
        and ok."""
        world = jsyn.PlaneWorld(seed=3, tex_size=1024, plane_z=6.0, extent=30.0)
        K = jnp.asarray([260.0, 260.0, 160.0, 120.0])
        fc = jex.FrontendConfig(height=240, width=320, n_features=600, n_levels=4)
        poses = jsyn.smooth_trajectory(10, lateral=2.0, forward=0.5, yaw=0.08)
        frames = [jex.make_frame(world.render(jnp.asarray(p), K, 240, 320), K, jnp.zeros(4), fc)
                  for p in (poses[0], poses[1])]
        f1, f2 = ({k: np.asarray(v) for k, v in f._asdict().items() if v is not None}
                  for f in frames)
        keys = ("xy", "desc", "angle", "valid")
        idx_j, ok_j = jmatch.search_for_initialization(*(jnp.asarray(f[k]) for f in (f1, f2)
                                                         for k in keys))
        t1, t2 = (convert.frame_from_numpy(f) for f in (f1, f2))
        idx_t, ok_t = tmatch.search_for_initialization(*(getattr(f, k) for f in (t1, t2)
                                                         for k in keys))
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
        assert ok_t.sum() > 50
