"""Place recognition and PnP of the port against the JAX package: the
vocabulary (training, files, the tree transform, BoW vectors), the keyframe
database queries and RANSAC PnP. Inputs come from numpy seeds; the RANSAC
draws are the JAX package's own (its key schedule, replayed as noise)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvm_slam_tpu.geometry import lie as jlie
from dvm_slam_tpu.geometry import pnp as jpnp
from dvm_slam_tpu.placerec import database as jdb
from dvm_slam_tpu.placerec import vocabulary as jvoc

from dvm_slam_tpu_torch import convert
from dvm_slam_tpu_torch.frontend import extractor as tex
from dvm_slam_tpu_torch.geometry import pnp as tpnp
from dvm_slam_tpu_torch.io import synthetic as tsyn
from dvm_slam_tpu_torch.placerec import database as tdb
from dvm_slam_tpu_torch.placerec import vocabulary as tvoc

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOW_ATOL = 1e-7      # bow_vector: one f32 normalisation, summed in another order
SCORE_ATOL = 1e-6    # L1 scores: 10^4-term f32 sums in another order
MARGIN = 1e-5        # candidate sets are compared where score margins exceed this


def gumbel_rows(key, rows: int, n: int):
    """The reference's draws of a hypothesize-and-verify RANSAC: `key` split
    into `rows` subkeys, `gumbel(k, (n,))` per subkey."""
    keys = jax.random.split(key, rows)
    return torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.gumbel(k, (n,)))(keys)))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def rendered_desc():
    """Valid ORB descriptors of three rendered frames of the synthetic world
    (the port's extractor, whose descriptors equal the JAX package's)."""
    world = tsyn.PlaneWorld(seed=3, tex_size=512, plane_z=6.0, extent=30.0)
    poses = tsyn.smooth_trajectory(20, lateral=2.0, forward=0.5)
    K = (130.0, 130.0, 80.0, 60.0)
    fc = tex.FrontendConfig(height=120, width=160, n_features=300, n_levels=4)
    out = []
    for i in (0, 8, 16):
        f = tex.make_frame(world.render(poses[i], K, 120, 160), torch.tensor(K), torch.zeros(4), fc)
        out.append((f.desc.numpy(), f.valid.numpy()))
    return out


@pytest.fixture(scope="module")
def vocs(rendered_desc):
    """(the shipped 10^4-word vocabulary, a branch-8 depth-2 tree trained on
    the rendered descriptors) in both packages."""
    train_set = np.concatenate([d[v] for d, v in rendered_desc])
    j_small = jvoc.train(train_set, branch=8, depth=2, seed=0)
    path = os.path.join(REPO, "data", "voc_default.npz")
    return {"default": (jvoc.load(path), tvoc.load_default()),
            "trained": (j_small,
                        convert.vocabulary_from_numpy(convert.vocabulary_to_numpy(j_small)))}


class TestVocabulary:
    def test_train_equal(self):
        descs = (np.random.RandomState(0).rand(1500, 256) > 0.5).astype(np.uint8)
        j, t = jvoc.train(descs, branch=6, depth=2, seed=3), tvoc.train(descs, branch=6, depth=2,
                                                                          seed=3)
        assert (t.branch, t.depth, t.n_words) == (j.branch, j.depth, j.n_words) == (6, 2, 36)
        for a, b in zip(t.levels, j.levels):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t.idf, j.idf)

    def test_files_cross(self, tmp_path):
        descs = (np.random.RandomState(1).rand(800, 256) > 0.5).astype(np.uint8)
        voc = tvoc.train(descs, branch=4, depth=2, seed=0)
        tvoc.save(voc, str(tmp_path / "t.npz"))
        jvoc.save(jvoc.train(descs, branch=4, depth=2, seed=0), str(tmp_path / "j.npz"))
        for a, b in ((jvoc.load(str(tmp_path / "t.npz")), tvoc.load(str(tmp_path / "j.npz"))),
                     (tvoc.load(str(tmp_path / "t.npz")), voc)):
            assert (a.branch, a.depth) == (b.branch, b.depth)
            for x, y in zip(a.levels, b.levels):
                np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(a.idf, b.idf)

    def test_default_shape(self):
        voc = tvoc.load_default()
        assert voc.n_words == 10 ** 4
        assert [lv.shape for lv in voc.levels] == [(10, 256), (100, 256), (1000, 256),
                                                   (10000, 256)]
        assert voc.idf.shape == (10000,) and voc.idf.dtype == np.float32
        levels, idf = voc.device_arrays("cpu")
        assert voc.device_arrays(torch.device("cpu"))[1] is idf   # cached per device

    @pytest.mark.parametrize("which", ["default", "trained"])
    @pytest.mark.parametrize("source", ["random", "rendered"])
    def test_words_and_bow(self, vocs, rendered_desc, which, source):
        """Word ids identical, invalid slots -1; BoW vectors within BOW_ATOL."""
        jv, tv = vocs[which]
        if source == "random":
            rng = np.random.RandomState(5)
            sets = [((rng.rand(300, 256) > 0.5).astype(np.uint8), rng.rand(300) > 0.2)]
        else:
            sets = rendered_desc
        jl, jidf = jv.device_arrays()
        tl, tidf = tv.device_arrays("cpu")
        for desc, valid in sets:
            wj = np.asarray(jvoc.transform_words(jl, jnp.asarray(desc), jnp.asarray(valid),
                                                 jv.branch))
            wt = tvoc.transform_words(tl, _t(desc), _t(valid), tv.branch).numpy()
            np.testing.assert_array_equal(wt, wj)
            assert (wt[~valid] == -1).all() and (wt[valid] >= 0).all()
            bj = np.asarray(jvoc.bow_vector(jl, jidf, jnp.asarray(desc), jnp.asarray(valid),
                                            jv.branch, jv.n_words))
            bt = tvoc.bow_vector(tl, tidf, _t(desc), _t(valid), tv.branch, tv.n_words).numpy()
            np.testing.assert_allclose(bt, bj, atol=BOW_ATOL, rtol=0)

    def test_l1_score(self):
        """Against the reference within SCORE_ATOL; an empty query or row
        scores 0."""
        rng = np.random.RandomState(2)
        bows = rng.rand(4, 16).astype(np.float32)
        bows[1] = 0.0
        bows /= np.maximum(bows.sum(1, keepdims=True), 1e-12)
        q = rng.rand(16).astype(np.float32)
        q /= q.sum()
        s = tvoc.l1_score(_t(q), _t(bows)).numpy()
        np.testing.assert_allclose(s, np.asarray(jvoc.l1_score(jnp.asarray(q), jnp.asarray(bows))),
                                   atol=SCORE_ATOL)
        assert s[1] == 0 and (s[[0, 2, 3]] > 0).all()
        assert (tvoc.l1_score(torch.zeros(16), _t(bows)) == 0).all()


def _db_case(seed: int, K: int = 24, W: int = 64):
    """A database of K keyframe BoWs over W words that share words in
    overlapping groups (some slots invalid), a query close to one group,
    and a covisibility matrix with many ties."""
    rng = np.random.RandomState(seed)
    base = rng.rand(K // 4, W) * (rng.rand(K // 4, W) > 0.6)
    bows = np.repeat(base, 4, axis=0) * (rng.rand(K, W) > 0.3) + rng.rand(K, W) * (
        rng.rand(K, W) > 0.9)
    bows[5] = 0.0                              # an empty BoW
    bows = (bows / np.maximum(bows.sum(1, keepdims=True), 1e-12)).astype(np.float32)
    valid = rng.rand(K) > 0.15
    q = base[2] * (rng.rand(W) > 0.2) + rng.rand(W) * (rng.rand(W) > 0.95)
    q = (q / q.sum()).astype(np.float32)
    c = rng.randint(0, 4, (K, K)) * (rng.rand(K, K) > 0.4)
    covis = np.triu(c, 1)
    covis = (covis + covis.T).astype(np.int32)
    exclude = rng.rand(K) > 0.85
    return bows, valid, q, covis, exclude


def _both_dbs(bows, valid):
    dj = jdb.BowDatabase(bow=jnp.asarray(bows), valid=jnp.asarray(valid))
    dt = convert.bow_database_from_numpy({"bow": bows, "valid": valid})
    return dj, dt


def _same_where_separated(got, want, scores):
    """Candidate indices agree wherever the scores that ranked them are
    separated by more than MARGIN from every other score."""
    s = np.sort(np.asarray(scores))
    for g, w, v in zip(got, want, np.asarray(scores)[: len(got)]):
        near = np.abs(s - v) <= MARGIN
        if near.sum() <= 1:
            assert g == w


class TestDatabase:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_accumulated_scores(self, seed):
        bows, valid, q, covis, exclude = _db_case(seed)
        dj, dt = _both_dbs(bows, valid)
        cw_j = np.asarray(jdb._common_words(jnp.asarray(q), jnp.asarray(bows)))
        cw_t = tdb._common_words(_t(q), _t(bows)).numpy()
        np.testing.assert_array_equal(cw_t, cw_j)
        aj, sj, ej = (np.asarray(x) for x in jdb.accumulated_scores(
            dj, jnp.asarray(q), jnp.asarray(exclude), jnp.asarray(covis)))
        at, st, et = (x.numpy() for x in tdb.accumulated_scores(dt, _t(q), _t(exclude), _t(covis)))
        np.testing.assert_array_equal(et, ej)
        assert ej.any()
        np.testing.assert_allclose(st, sj, atol=SCORE_ATOL, rtol=0)
        np.testing.assert_allclose(at, aj, atol=SCORE_ATOL, rtol=0)

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_queries(self, seed):
        bows, valid, q, covis, exclude = _db_case(seed)
        dj, dt = _both_dbs(bows, valid)
        Qj, Qt, Cj, Ct = jnp.asarray(q), _t(q), jnp.asarray(covis), _t(covis)
        acc = np.asarray(jdb.accumulated_scores(dj, Qj, jnp.asarray(exclude), Cj)[0])
        sj, bj = jdb.best_group_match(dj, Qj, jnp.asarray(exclude), Cj)
        st, bt = tdb.best_group_match(dt, Qt, _t(exclude), Ct)
        assert abs(float(st) - float(sj)) <= SCORE_ATOL
        if np.sort(acc)[-1] - np.sort(acc)[-2] > MARGIN:
            assert int(bt) == int(bj)
        pj = jdb.detect_merge_possibility(dj, Qj, Cj)
        pt = tdb.detect_merge_possibility(dt, Qt, Ct)
        assert bool(pt[0]) == bool(pj[0])
        assert int(pt[1]) == int(pj[1])
        np.testing.assert_allclose([float(pt[2]), float(pt[3])], [float(pj[2]), float(pj[3])],
                                   atol=SCORE_ATOL)
        ij, oj = jdb.detect_candidates(dj, Qj, jnp.asarray(exclude), Cj, n=3)
        it, ot = tdb.detect_candidates(dt, Qt, _t(exclude), Ct, n=3)
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        _same_where_separated(it.tolist(), np.asarray(ij).tolist(), -np.sort(-acc))

    def test_create_add_add_many(self):
        dt = tdb.create(6, 8)
        dj = jdb.create(6, 8)
        rng = np.random.RandomState(0)
        b = rng.rand(8).astype(np.float32)
        dt, dj = tdb.add(dt, 2, _t(b)), jdb.add(dj, jnp.int32(2), jnp.asarray(b))
        slots = np.array([1, 4, 1, 3, 4], np.int32)        # duplicates: the last write wins
        bows = rng.rand(5, 8).astype(np.float32)
        dt = tdb.add_many(dt, _t(slots), _t(bows))
        dj = jdb.add_many(dj, jnp.asarray(slots), jnp.asarray(bows))
        got = convert.bow_database_to_numpy(dt)
        np.testing.assert_array_equal(got["bow"], np.asarray(dj.bow))
        np.testing.assert_array_equal(got["valid"], np.asarray(dj.valid))
        np.testing.assert_array_equal(got["bow"][1], bows[2])
        np.testing.assert_array_equal(got["bow"][4], bows[4])


def _pnp_scene(seed: int, n: int = 80, outliers: float = 0.3):
    """Non-coplanar world points in front of a known camera, their pixels
    (rounded to 0.1 px), a share replaced by outliers."""
    rng = np.random.RandomState(seed)
    K = np.array([260.0, 260.0, 160.0, 120.0], np.float32)
    T = np.asarray(jlie.se3_exp(jnp.asarray(rng.randn(6).astype(np.float32) * 0.2)))
    pc = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)], -1)
    X = np.asarray(jlie.se3_apply(jlie.se3_inv(jnp.asarray(T))[None], jnp.asarray(pc, jnp.float32)))
    uv = np.stack([K[0] * pc[:, 0] / pc[:, 2] + K[2], K[1] * pc[:, 1] / pc[:, 2] + K[3]], -1)
    uv = np.round(uv, 1).astype(np.float32)
    bad = rng.rand(n) < outliers
    uv[bad] += rng.uniform(-60, 60, (int(bad.sum()), 2)).astype(np.float32)
    mask = rng.rand(n) > 0.1
    return X.astype(np.float32), uv, mask, K, T


def _pose_close(a, b, atol):
    """Poses equal to atol, the quaternion up to its sign."""
    s = np.sign(np.dot(a[:4], b[:4]))
    return max(np.abs(a[:4] * s - b[:4]).max(), np.abs(a[4:] - b[4:]).max()) <= atol


class TestPnP:
    @pytest.mark.parametrize("k", [12, 20])
    def test_dlt_pose(self, k):
        """Noiseless non-coplanar sets, batched. The port recovers the true
        pose (1e-3) in every set; wherever the reference recovers it too, the
        two agree to 1e-4. The reference misses where the cheirality counts
        of the two signs tie and its eigensolver returned the mirrored sign
        (ROADMAP fault q)."""
        rng = np.random.RandomState(k)
        Xs, xns, Ts = [], [], []
        for _ in range(16):
            T = np.asarray(jlie.se3_exp(jnp.asarray(rng.randn(6).astype(np.float32) * 0.2)))
            pc = np.stack([rng.uniform(-3, 3, k), rng.uniform(-3, 3, k), rng.uniform(2, 8, k)], -1)
            X = np.asarray(jlie.se3_apply(jlie.se3_inv(jnp.asarray(T))[None],
                                          jnp.asarray(pc, jnp.float32)))
            Xs.append(X)
            xns.append((pc[:, :2] / pc[:, 2:]).astype(np.float32))
            Ts.append(T)
        Xs, xns = np.stack(Xs).astype(np.float32), np.stack(xns)
        got = tpnp._dlt_pose(_t(Xs), _t(xns)).numpy()
        n_ref_ok = 0
        for i in range(16):
            assert _pose_close(got[i], Ts[i], 1e-3)
            want = np.asarray(jpnp._dlt_pose(jnp.asarray(Xs[i]), jnp.asarray(xns[i])))
            if _pose_close(want, Ts[i], 1e-3):
                n_ref_ok += 1
                assert _pose_close(got[i], want, 1e-4)
        assert n_ref_ok >= 4

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_ransac_pnp(self, seed):
        """The reference's draws. The port's best hypothesis has at least the
        reference's support (its tie rule only turns mirrored hypotheses
        into true ones); after the pose-only refinement that relocalization
        runs, inliers within 2 and the pose within 1e-3 of the reference's."""
        from dvm_slam_tpu.tracking import pose_opt as jpo
        from dvm_slam_tpu_torch.tracking import pose_opt as tpo

        X, uv, mask, K, T_true = _pnp_scene(seed)
        key = jax.random.PRNGKey(seed)
        Tj, inl_j, n_j = jpnp.ransac_pnp(key, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(mask),
                                         jnp.asarray(K), num_hypotheses=64)
        noise = gumbel_rows(key, 64, X.shape[0])
        Tt, inl_t, n_t = tpnp.ransac_pnp(noise, _t(X), _t(uv), _t(mask), _t(K))
        assert int(n_t) >= int(n_j) > 30
        sig = np.ones(X.shape[0], np.float32)
        Rj, rinl_j, _ = jpo.pose_optimization(Tj, jnp.asarray(X), jnp.asarray(uv),
                                              jnp.asarray(sig), inl_j, jnp.asarray(K))
        Rt, rinl_t, _ = tpo.pose_optimization(Tt, _t(X), _t(uv), _t(sig), inl_t, _t(K))
        assert abs(int(rinl_t.sum()) - int(np.asarray(rinl_j).sum())) <= 2
        assert _pose_close(Rt.numpy(), np.asarray(Rj), 1e-3)
        assert _pose_close(Rt.numpy(), T_true, 1e-2)
