"""Parity of the port's mapping slice (map-state derivations, triangulation,
the epipolar mask, culling, new points, fusion, windowed BA) with the JAX
package, on one map built from numpy seeds: six keyframes around a field of
3D points, with noisy poses and points, free features that triangulate,
duplicate map points that fuse, and rows that hold one point twice.

Integer, bool and observation outputs must be identical; float tolerances are
stated per test. Also the repair of `update_point_stats` for rows that hold a
point at two features (XLA's in-order scatter keeps the last feature)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dvm_slam_tpu.geometry import lie as jlie
from dvm_slam_tpu.geometry import triangulation as jtri
from dvm_slam_tpu.mapping import ba as jba
from dvm_slam_tpu.mapping import local_mapping as jlm
from dvm_slam_tpu.mapping import map_state as jms
from dvm_slam_tpu.ops import matching as jm

from dvm_slam_tpu_torch import convert
from dvm_slam_tpu_torch.geometry import triangulation as ttri
from dvm_slam_tpu_torch.mapping import ba as tba
from dvm_slam_tpu_torch.mapping import local_mapping as tlm
from dvm_slam_tpu_torch.mapping import map_state as tms
from dvm_slam_tpu_torch.ops import matching as tm

torch.set_num_threads(2)

K = np.array([100.0, 100.0, 64.0, 48.0], np.float32)
W, H = 128, 96
N_LEVELS, SF = 4, 1.2
KF_CAP, PT_CAP, F, N_KF = 16, 1024, 160, 6
CENTER = N_KF - 1
# small mapper: n_neighbors 3, ba_local 4, ba_fixed 2, ba_pts 256, ba_iters 3
NN, BA_LOCAL, BA_FIXED, BA_PTS, BA_ITERS = 3, 4, 2, 256, 3


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(m):
    return {k: None if v is None else np.asarray(v) for k, v in m._asdict().items()}


def _to_port(m_j):
    return convert.map_state_from_numpy(_np(m_j))


def _build_map(seed=0):
    """A JAX MapState of N_KF keyframes observing a field of points (see the
    module docstring); descriptors and point statistics come from the JAX
    package's `update_point_stats`."""
    rng = np.random.RandomState(seed)
    n_world = 420
    Xw = np.stack([rng.uniform(-3.0, 4.5, n_world), rng.uniform(-2.2, 2.2, n_world),
                   rng.uniform(4.0, 6.0, n_world)], -1).astype(np.float32)
    base = (rng.rand(n_world, 256) > 0.5).astype(np.uint8)
    T_true, T_noisy = [], []
    for k in range(N_KF):
        c = np.array([0.25 * k, 0.03 * np.sin(k), 0.05 * k], np.float32)
        T_wc = jlie.se3(jlie.so3_exp(jnp.asarray([0.0, -0.02 * k, 0.01 * k], jnp.float32)),
                        jnp.asarray(c))
        T = jlie.se3_inv(T_wc)
        T_true.append(np.asarray(T))
        noise = np.zeros(6, np.float32) if k == 0 else (rng.randn(6) * 0.004).astype(np.float32)
        T_noisy.append(np.asarray(jlie.se3_retract(T, jnp.asarray(noise))))

    mapped = rng.rand(n_world) < 0.65
    slot_of = -np.ones(n_world, np.int64)
    slot_of[mapped] = rng.permutation(int(mapped.sum()))
    n_pt = int(mapped.sum())
    # duplicates: a second slot for some mapped points, seen from the later KFs
    dup_w = np.flatnonzero(mapped)[:25]
    dup_slot = {int(w): n_pt + i for i, w in enumerate(dup_w)}
    n_pt += len(dup_w)

    kf_xy = rng.uniform(0, [W, H], (KF_CAP, F, 2)).astype(np.float32)
    kf_level = np.zeros((KF_CAP, F), np.int32)
    kf_desc = (rng.rand(KF_CAP, F, 256) > 0.5).astype(np.uint8)
    kf_fv = np.zeros((KF_CAP, F), bool)
    kf_obs = -np.ones((KF_CAP, F), np.int32)
    first_obs = -np.ones(n_pt, np.int64)
    for k in range(N_KF):
        pc = np.asarray(jlie.se3_apply(jnp.asarray(T_true[k])[None], jnp.asarray(Xw)))
        uv = K[:2] * pc[:, :2] / pc[:, 2:] + K[2:]
        vis = np.flatnonzero((pc[:, 2] > 0.5) & (uv[:, 0] > 2) & (uv[:, 0] < W - 2)
                             & (uv[:, 1] > 2) & (uv[:, 1] < H - 2))
        vis = rng.permutation(vis)[:F - 12]
        nf = len(vis)
        kf_fv[k, :nf] = True
        kf_level[k, :nf] = rng.randint(0, N_LEVELS, nf)
        kf_xy[k, :nf] = uv[vis] + rng.randn(nf, 2).astype(np.float32) * 0.3
        for f, w in enumerate(vis):
            d = base[w].copy()
            d[rng.randint(0, 256, 6)] ^= 1
            kf_desc[k, f] = d
            if mapped[w] and rng.rand() < 0.9:
                s = dup_slot[w] if (w in dup_slot and k >= 3) else slot_of[w]
                kf_obs[k, f] = s
                if first_obs[s] < 0:
                    first_obs[s] = k
    # one row holds a point at two features (as fusion leaves it)
    kf_obs[2, 150] = kf_obs[2, np.flatnonzero(kf_obs[2] >= 0)[3]]
    kf_fv[2, 150] = True

    world_of = np.zeros(n_pt, np.int64)
    world_of[slot_of[mapped]] = np.flatnonzero(mapped)
    for w, s in dup_slot.items():
        world_of[s] = w
    pt_pos = np.zeros((PT_CAP, 3), np.float32)
    pt_pos[:n_pt] = Xw[world_of] + rng.randn(n_pt, 3).astype(np.float32) * 0.03
    pt_valid = np.zeros(PT_CAP, bool)
    pt_valid[:n_pt] = first_obs >= 0
    ref = np.full(PT_CAP, -1, np.int32)
    ref[:n_pt] = np.maximum(first_obs, 0)
    vis_c = np.zeros(PT_CAP, np.int32)
    vis_c[:n_pt] = rng.randint(1, 12, n_pt)
    found = np.zeros(PT_CAP, np.int32)
    found[:n_pt] = (vis_c[:n_pt] * rng.uniform(0.1, 1.0, n_pt)).astype(np.int32)

    m = jms.create(KF_CAP, PT_CAP, F)
    kf_pose = np.asarray(m.kf_pose).copy()
    kf_pose[:N_KF] = np.stack(T_noisy)
    kf_valid = np.zeros(KF_CAP, bool)
    kf_valid[:N_KF] = True
    m = m._replace(
        kf_pose=jnp.asarray(kf_pose), kf_valid=jnp.asarray(kf_valid),
        kf_xy=jnp.asarray(kf_xy), kf_level=jnp.asarray(kf_level),
        kf_desc=jnp.asarray(kf_desc), kf_feat_valid=jnp.asarray(kf_fv),
        kf_obs=jnp.asarray(kf_obs), pt_pos=jnp.asarray(pt_pos),
        pt_valid=jnp.asarray(pt_valid), pt_ref_kf=jnp.asarray(ref),
        pt_first_kf=jnp.asarray(ref), pt_visible=jnp.asarray(vis_c),
        pt_found=jnp.asarray(found), n_kf=jnp.int32(N_KF), n_pt=jnp.int32(n_pt),
    )
    return jms.update_point_stats(m, N_LEVELS, SF)


@pytest.fixture(scope="module")
def jmap():
    return _build_map()


def _assert_map_equal(got, want, atol=1e-5, rtol=0.0, fields=None):
    """Field by field: integer/bool/uint8 fields identical, floats to tolerance."""
    for name, w in _np(want).items():
        if fields is not None and name not in fields:
            continue
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


# --------------------------------------------------------------------------
# the fault repair: XLA's in-order scatter-set
# --------------------------------------------------------------------------

def _scatter_cases():
    rng = np.random.RandomState(11)
    P, F = 40, 24
    do = rng.rand(30) < 0.5
    loser = rng.randint(0, P, 30)
    winner = rng.randint(0, P, 30)
    feat = rng.permutation(F)[:20]
    add = rng.rand(20) < 0.5
    return {
        "random_repeats": (np.arange(50, dtype=np.int32), rng.randint(0, 12, 60),
                           rng.randint(-9, 9, 60).astype(np.int32)),
        # fuse_duplicates' remap: the dummy target P-1 is a real slot
        "remap_dummy_last": (np.arange(P, dtype=np.int32), np.where(do, loser, P - 1),
                             np.where(do, winner, P - 1).astype(np.int32)),
        # the kill mask: dummy target 0 written False after a real True
        "kill_mask_slot0": (np.zeros(P, bool), np.where(do, np.r_[0, loser[1:]], 0), do),
        # kf_obs row: the dummy feature F-1 is a real slot
        "kf_obs_dummy_last": (rng.randint(-1, P, F).astype(np.int32),
                              np.where(add, feat, F - 1),
                              np.where(add, rng.randint(0, P, 20), 7).astype(np.int32)),
    }


@pytest.mark.parametrize("case", sorted(_scatter_cases()))
def test_scatter_set_last_matches_xla(case):
    dst, idx, vals = _scatter_cases()[case]
    assert len(np.unique(idx)) < len(idx)  # the case really repeats indices
    want = np.asarray(jnp.asarray(dst).at[jnp.asarray(idx)].set(jnp.asarray(vals)))
    got = tms.scatter_set_last(_t(dst), _t(idx), _t(vals)).numpy()
    np.testing.assert_array_equal(got, want)


def _dup_row_map():
    """Three keyframes; point 0 is held by keyframe 1 at features 3 and 7,
    which carry different descriptors and levels."""
    rng = np.random.RandomState(5)
    m = jms.create(4, 32, 12)
    kf_obs = np.full((4, 12), -1, np.int32)
    kf_obs[0, 5] = 0
    kf_obs[1, 3] = kf_obs[1, 7] = 0
    kf_obs[1, 9] = kf_obs[2, 2] = 1
    kf_obs[2, 4] = kf_obs[2, 6] = 1
    kf_level = rng.randint(0, 4, (4, 12)).astype(np.int32)
    kf_level[1, 3], kf_level[1, 7] = 1, 3
    pose = np.asarray(m.kf_pose).copy()
    pose[1, 4:] = [0.3, 0.0, 0.0]
    pose[2, 4:] = [0.0, 0.2, 0.1]
    valid = np.zeros(32, bool)
    valid[:2] = True
    pos = np.zeros((32, 3), np.float32)
    pos[:2] = [[0.1, 0.2, 4.0], [-0.3, 0.1, 5.0]]
    return m._replace(
        kf_pose=jnp.asarray(pose), kf_valid=jnp.asarray([True, True, True, False]),
        kf_obs=jnp.asarray(kf_obs), kf_level=jnp.asarray(kf_level),
        kf_desc=jnp.asarray((rng.rand(4, 12, 256) > 0.5).astype(np.uint8)),
        pt_pos=jnp.asarray(pos), pt_valid=jnp.asarray(valid),
        pt_ref_kf=jnp.asarray(np.r_[1, 2, -np.ones(30)].astype(np.int32)),
        n_kf=jnp.int32(3), n_pt=jnp.int32(2))


class TestPointStatsFault:
    def test_duplicate_feature_row_matches_jax(self):
        """Keyframe 1 holds point 0 twice: the vote takes its LAST feature's
        descriptor, as the JAX package does. pt_desc, pt_max_dist and
        pt_min_dist identical."""
        mj = _dup_row_map()
        want = jms.update_point_stats(mj, 4, 1.2)
        got = tms.update_point_stats(_to_port(mj), 4, 1.2)
        for name in ("pt_desc", "pt_max_dist", "pt_min_dist"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)), err_msg=name)
        # the two features' descriptors differ, so the choice is visible
        d = np.asarray(mj.kf_desc)
        assert (d[1, 3] != d[1, 7]).any()

    @pytest.mark.cuda
    def test_duplicate_feature_row_on_card(self):
        """The same map through `update_point_stats` on the card gives the CPU
        result: integer fields identical, floats to 1e-5."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        mt = _to_port(_dup_row_map())
        cpu = tms.update_point_stats(mt, 4, 1.2)
        dev = tms.MapState(*[t.to("cuda") for t in mt])
        gpu = tms.update_point_stats(dev, 4, 1.2)
        for name, a in cpu._asdict().items():
            b = getattr(gpu, name).cpu()
            if a.dtype.is_floating_point:
                np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5, err_msg=name)
            else:
                assert torch.equal(a, b), name


# --------------------------------------------------------------------------
# derived structures
# --------------------------------------------------------------------------

class TestDerived:
    def test_covis_row_every_center(self, jmap):
        mt = _to_port(jmap)
        full_j = np.asarray(jms.covisibility(jmap))
        np.testing.assert_array_equal(tms.covisibility(mt).numpy(), full_j)
        for c in range(N_KF + 1):
            want = np.asarray(jms.covis_row(jmap, jnp.int32(c)))
            got = tms.covis_row(mt, torch.tensor(c, dtype=torch.int32)).numpy()
            np.testing.assert_array_equal(got, want)
            if c < N_KF:
                np.testing.assert_array_equal(got, full_j[c])

    def test_point_observers_and_first_occurrence(self, jmap):
        mt = _to_port(jmap)
        np.testing.assert_array_equal(tms.point_observers(mt).numpy(),
                                      np.asarray(jms.point_observers(jmap)))
        np.testing.assert_array_equal(tms._first_occurrence(mt.kf_obs).numpy(),
                                      np.asarray(jms._first_occurrence(jmap.kf_obs)))

    def test_check_invariants(self, jmap):
        assert tms.check_invariants(_to_port(jmap)) == jms.check_invariants(jmap) == []
        bad = jmap._replace(pt_valid=jmap.pt_valid.at[3].set(False),
                            kf_valid=jmap.kf_valid.at[N_KF + 2].set(True))
        assert tms.check_invariants(_to_port(bad)) == jms.check_invariants(bad)
        assert len(jms.check_invariants(bad)) == 2


# --------------------------------------------------------------------------
# geometry
# --------------------------------------------------------------------------

class TestGeometry:
    def test_epipolar_mask_exact(self):
        rng = np.random.RandomState(3)
        x1 = np.c_[rng.randn(90, 2) * 0.4, np.ones(90)].astype(np.float32)
        x2 = np.c_[rng.randn(70, 2) * 0.4, np.ones(70)].astype(np.float32)
        E = rng.randn(3, 3).astype(np.float32)
        sig = (rng.rand(70) * 1e-3).astype(np.float32)
        want = np.asarray(jm.epipolar_mask(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(E),
                                           jnp.asarray(sig)))
        got = tm.epipolar_mask(_t(x1), _t(x2), _t(E), _t(sig)).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < want.sum() < want.size

    def test_triangulate(self):
        """X to 1e-4 relative (f32 eigh in two LAPACK builds; the
        eigenvector's sign cancels); ok, depth and parallax agree."""
        rng = np.random.RandomState(4)
        n = 200
        X = np.c_[rng.uniform(-2, 2, n), rng.uniform(-1, 1, n), rng.uniform(3, 7, n)]
        T1 = np.tile(np.asarray(jlie.se3_identity()), (n, 1))
        T2 = np.tile(np.asarray(jlie.se3_exp(jnp.asarray([-0.4, 0.05, 0.02, 0.01, 0.05, 0.0],
                                                         jnp.float32))), (n, 1))
        p2 = np.asarray(jlie.se3_apply(jnp.asarray(T2), jnp.asarray(X, jnp.float32)))
        x1 = (X[:, :2] / X[:, 2:] + rng.randn(n, 2) * 1e-3).astype(np.float32)
        x2 = (p2[:, :2] / p2[:, 2:] + rng.randn(n, 2) * 1e-3).astype(np.float32)
        Xj, okj = jtri.triangulate(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(T1),
                                   jnp.asarray(T2))
        Xt, okt = ttri.triangulate(_t(x1), _t(x2), _t(T1), _t(T2))
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
        np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(ttri.parallax_cos(_t(T1), _t(T2), Xt).numpy(),
                                   np.asarray(jtri.parallax_cos(jnp.asarray(T1), jnp.asarray(T2),
                                                                Xj)), atol=1e-6)
        np.testing.assert_allclose(ttri.depth_in_camera(_t(T2), Xt).numpy(),
                                   np.asarray(jtri.depth_in_camera(jnp.asarray(T2), Xj)),
                                   rtol=1e-4)

    def test_nanmedian_is_jax_definition(self):
        for vals in ([1.0, 2.0, 3.0, 4.0, np.nan], [5.0, np.nan, 1.0], [np.nan, np.nan],
                     [2.5, 2.5, -1.0, 7.0]):
            x = np.asarray(vals, np.float32)
            want = np.asarray(jnp.nanmedian(jnp.asarray(x)))
            np.testing.assert_array_equal(tlm._nanmedian(_t(x)).numpy(), want)


# --------------------------------------------------------------------------
# the mapper chain's stages
# --------------------------------------------------------------------------

class TestMapperStages:
    def test_cull_points_exact(self, jmap):
        want = jlm.cull_points(jmap, jnp.int32(CENTER))
        got = tlm.cull_points(_to_port(jmap), torch.tensor(CENTER, dtype=torch.int32))
        _assert_map_equal(got, want)
        assert int(np.asarray(want.pt_valid).sum()) < int(np.asarray(jmap.pt_valid).sum())

    def test_create_new_points(self, jmap):
        """n_added, kf_obs and every other field identical; new points to 1e-4
        of their norm for >= 95% of them and all within 1e-3. The tail is the
        f32 `eigh` of two LAPACK builds on low-parallax points (depth ~8 m
        over a 0.25 m baseline here): bounded, not hidden."""
        want, n_j = jlm.create_new_points(jmap, jnp.int32(CENTER), jnp.asarray(K),
                                          n_neighbors=NN, n_levels=N_LEVELS, scale_factor=SF)
        got, n_t = tlm.create_new_points(_to_port(jmap), torch.tensor(CENTER, dtype=torch.int32),
                                         _t(K), n_neighbors=NN, n_levels=N_LEVELS,
                                         scale_factor=SF)
        assert int(n_t) == int(n_j) > 10
        _assert_map_equal(got, want, fields=set(want._fields) - {"pt_pos"})
        old, new = int(jmap.n_pt), int(want.n_pt)
        a, b = got.pt_pos.numpy(), np.asarray(want.pt_pos)
        np.testing.assert_array_equal(np.r_[a[:old], a[new:]], np.r_[b[:old], b[new:]])
        rel = np.abs(a[old:new] - b[old:new]).max(1) / np.linalg.norm(b[old:new], axis=1)
        assert np.mean(rel <= 1e-4) >= 0.95 and rel.max() <= 1e-3, np.sort(rel)[-5:]

    def test_fuse_duplicates_exact(self, jmap):
        want = jlm.fuse_duplicates(jmap, jnp.int32(CENTER), jnp.asarray(K),
                                   n_neighbors=NN, n_levels=N_LEVELS, scale_factor=SF)
        got = tlm.fuse_duplicates(_to_port(jmap), torch.tensor(CENTER, dtype=torch.int32),
                                  _t(K), n_neighbors=NN, n_levels=N_LEVELS, scale_factor=SF)
        _assert_map_equal(got, want)
        # duplicates really merged, observations really added
        assert int(np.asarray(want.pt_valid).sum()) < int(np.asarray(jmap.pt_valid).sum())
        assert (np.asarray(want.kf_obs) != np.asarray(jmap.kf_obs)).sum() > 0

    def test_local_ba(self, jmap):
        """Poses to 1e-4, points to 1e-3 (absolute and relative), post-BA
        kf_obs identical, chi2 to 1e-3 relative (f32 LM in another summation
        order)."""
        kw = dict(n_local=BA_LOCAL, n_fixed=BA_FIXED, n_pts=BA_PTS, iters=BA_ITERS,
                  n_levels=N_LEVELS, scale_factor=SF)
        want, chi2_j = jlm.local_ba(jmap, jnp.int32(CENTER), jnp.asarray(K), **kw)
        got, chi2_t = tlm.local_ba(_to_port(jmap), torch.tensor(CENTER, dtype=torch.int32),
                                   _t(K), **kw)
        np.testing.assert_allclose(got.kf_pose.numpy(), np.asarray(want.kf_pose), atol=1e-4)
        np.testing.assert_allclose(got.pt_pos.numpy(), np.asarray(want.pt_pos), rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_array_equal(got.kf_obs.numpy(), np.asarray(want.kf_obs))
        np.testing.assert_allclose(float(chi2_t), float(chi2_j), rtol=1e-3)
        # the solve really moved the window
        assert np.abs(np.asarray(want.kf_pose) - np.asarray(jmap.kf_pose)).max() > 1e-4


def _ba_problem(seed, L=5, n_pts=90, F=100):
    """Cameras on an arc around points 4-6 m ahead, each point seen by most
    cameras (a well-posed window), noisy poses and points, 10% gross
    outliers."""
    rng = np.random.RandomState(seed)
    X = np.c_[rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
              rng.uniform(4, 6, n_pts)].astype(np.float32)
    poses, noisy = [], []
    for k in range(L):
        T = jlie.se3_exp(jnp.asarray([-0.3 * k, 0.02 * k, 0.0, 0.0, 0.03 * k, 0.0], jnp.float32))
        poses.append(np.asarray(T))
        dn = np.zeros(6, np.float32) if k < 2 else (rng.randn(6) * 0.01).astype(np.float32)
        noisy.append(np.asarray(jlie.se3_retract(T, jnp.asarray(dn))))
    obs = -np.ones((L, F), np.int32)
    xy = np.zeros((L, F, 2), np.float32)
    for k in range(L):
        ids = rng.permutation(n_pts)[:int(n_pts * 0.9)]
        n = len(ids)
        pc = np.asarray(jlie.se3_apply(jnp.asarray(poses[k])[None], jnp.asarray(X[ids])))
        obs[k, :n] = ids
        xy[k, :n] = K[:2] * pc[:, :2] / pc[:, 2:] + K[2:] + rng.randn(n, 2) * 0.5
        out = rng.rand(n) < 0.1
        xy[k, :n][out] += rng.randn(int(out.sum()), 2).astype(np.float32) * 25
    sig = np.asarray([1.0, 1.44, 2.0736], np.float32)[rng.randint(0, 3, (L, F))]
    pts = X + rng.randn(n_pts, 3).astype(np.float32) * 0.05
    fixed = np.array([True, True] + [False] * (L - 2))
    pt_opt = rng.rand(n_pts) > 0.05
    return (np.stack(noisy), fixed, xy, sig, obs, pts, pt_opt)


def test_bundle_adjust_matches_jax():
    """Poses to 1e-4, points to 1e-3 (absolute, and relative to the
    coordinate for points the outliers pushed far along their rays), inlier
    mask identical, chi2 to 1e-3 relative."""
    args = _ba_problem(8)
    pj, xj, cj, ij = jba.bundle_adjust(*[jnp.asarray(a) for a in args], jnp.asarray(K), iters=4)
    pt, xt, ct, it = tba.bundle_adjust(*[_t(a) for a in args], _t(K), iters=4)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-3)
    assert 0 < int(np.asarray(ij).sum()) < int((args[4] >= 0).sum())  # outliers dropped


def test_bundle_adjust_counts_kernel_calls(monkeypatch):
    """One gather and one adjoint per LM step, plus the final gather: 12 and
    13 at iters=6 (the calls the smoke counts on the card)."""
    from dvm_slam_tpu_torch.ops import scatter

    calls = {"adjoint": 0, "gather": 0}
    real_a, real_g = scatter.onehot_adjoint, scatter.onehot_gather

    def adj(*a, **k):
        calls["adjoint"] += 1
        return real_a(*a, **k)

    def gat(*a, **k):
        calls["gather"] += 1
        return real_g(*a, **k)

    monkeypatch.setattr(scatter, "onehot_adjoint", adj)
    monkeypatch.setattr(scatter, "onehot_gather", gat)
    args = _ba_problem(9, L=3, n_pts=30, F=30)
    tba.bundle_adjust(*[_t(a) for a in args], _t(K), iters=6)
    assert calls == {"adjoint": 12, "gather": 13}


def test_bundle_adjust_rejects_a_non_finite_step(monkeypatch):
    """A step through an indefinite Schur system (a PCG blow-up) is rejected
    and reverted, so BA returns the last finite accepted state; the
    reference's `cost > best` test would accept the NaN state."""
    args = _ba_problem(10, L=3, n_pts=30, F=30)
    # two steps: the state proposed by step 0 is evaluated and kept
    want = tba.bundle_adjust(*[_t(a) for a in args], _t(K), iters=1, stage2_iters=0)
    real, calls = tba._block_jacobi_pcg, []

    def blow_up(*a):
        calls.append(1)
        x = real(*a)
        return x * 1e30 if len(calls) == 2 else x

    monkeypatch.setattr(tba, "_block_jacobi_pcg", blow_up)
    # three steps: step 1's proposal blows up, step 2 rejects it
    got = tba.bundle_adjust(*[_t(a) for a in args], _t(K), iters=2, stage2_iters=0)
    assert bool(torch.isfinite(got[0]).all()) and bool(torch.isfinite(got[1]).all())
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
