"""Relocalization of the port against the JAX package.

The whole-run test is `tests/test_reloc_loop.py::TestRelocalization`
(240x320, 600 features on 4 levels, kf_cap 64, fps 5, a branch-8 depth-2
vocabulary trained on the world; the dense 36-patch world, see DENSE)
through both packages' `MonocularTracker`: 30 frames, 3 black
frames, then a revisit of frame 15 that must relocalize. Both start from
the same initial map: the port replays the reference's two-view results
(the init is near-degenerate for f32 solvers, ROADMAP fault o; the init
itself is held by `test_torch_tracker_host.py`). The port draws the
reference's relocalization noise (`reloc_noise_replay`: `PRNGKey(4242)`
split once per call and once per candidate tried, 128 Gumbel rows per
candidate). The unit
tests run `_match_and_pnp`, `relocalize` and the service's database on the
map the JAX run built.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dvm_slam_tpu.frontend.extractor import FrontendConfig, make_frame
from dvm_slam_tpu.geometry import lie as jlie
from dvm_slam_tpu.geometry import two_view as jtv
from dvm_slam_tpu.io import synthetic as jsyn
from dvm_slam_tpu.mapping import local_mapping as jlm
from dvm_slam_tpu.mapping import map_state as jms
from dvm_slam_tpu.placerec import database as jdb
from dvm_slam_tpu.placerec import vocabulary as jvoc
from dvm_slam_tpu.tracking import relocalization as jrel
from dvm_slam_tpu.tracking import tracker as jtrk

from dvm_slam_tpu_torch import convert
from dvm_slam_tpu_torch.geometry import lie as tlie
from dvm_slam_tpu_torch.geometry import two_view as ttv
from dvm_slam_tpu_torch.mapping import local_mapping as tlm
from dvm_slam_tpu_torch.mapping import map_state as tms
from dvm_slam_tpu_torch.tracking import relocalization as trel
from dvm_slam_tpu_torch.tracking import tracker as ttrk

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_placerec import gumbel_rows  # noqa: E402

torch.set_num_threads(2)

H, W = 240, 320
K = np.array([260.0, 260.0, 160.0, 120.0], np.float32)
N_BLACK = 3
REVISIT = 15
POSE_ATOL = 1e-3     # relocalized / refined poses, port against reference
ERR_BOUND = 0.1      # the reference test's bound on the relocalized camera center
# the dense 36-patch world: on the default 8-patch layout the two-view init
# is near-degenerate and two LAPACK builds initialize at different frames
# (ROADMAP fault o)
DENSE = dict(n_patches=36, depth_range=(0.30, 0.92), patch_half=(0.03, 0.09))


def reloc_noise_replay(svc):
    """Make `svc` (the port's `RelocalizationService`) draw the reference's
    PnP noise: its key starts at PRNGKey(4242), splits once per call, then
    once per candidate tried, each subkey split into 128 Gumbel rows."""
    key = [jax.random.PRNGKey(trel.SEED)]

    def source():
        key[0], sub = jax.random.split(key[0])
        k = [sub]

        def draw(n):
            k[0], s = jax.random.split(k[0])
            return gumbel_rows(s, trel.PNP_HYPOTHESES, n)
        return draw

    svc._noise_source = source


def _center(T):
    T = np.asarray(T, np.float32)
    return np.asarray(jlie.se3_t(jlie.se3_inv(jnp.asarray(T))))


def _np_map(m):
    return {k: np.asarray(v) for k, v in m._asdict().items()}


def _frame_np(f):
    return {k: None if v is None else np.asarray(v) for k, v in f._asdict().items()}


@pytest.fixture(scope="module")
def scene():
    world = jsyn.PlaneWorld(seed=3, tex_size=1024, plane_z=6.0, extent=30.0, **DENSE)
    cfg = jtrk.TrackerConfig(frontend=FrontendConfig(height=H, width=W, n_features=600, n_levels=4),
                             kf_cap=64, pt_cap=4096, fps=5.0)
    Kj = jnp.asarray(K)
    traj = jsyn.smooth_trajectory(20, lateral=2.0, forward=0.5)
    descs = []
    for i in range(0, 20, 4):
        im = world.render(jnp.asarray(traj[i]), Kj, H, W)
        f = make_frame(jnp.asarray(np.asarray(im)), Kj, jnp.zeros(4), cfg.frontend)
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    voc = jvoc.train(np.concatenate(descs)[:5000], branch=8, depth=2, seed=0)
    traj = jsyn.smooth_trajectory(40, lateral=2.0, forward=0.5, yaw=0.08)
    imgs = [np.asarray(world.render(jnp.asarray(traj[i]), Kj, H, W)) for i in range(30)]
    return dict(cfg=cfg, voc=voc, imgs=imgs,
                tcfg=convert.tracker_config_from_dict(dataclasses.asdict(cfg)),
                tvoc=convert.vocabulary_from_numpy(convert.vocabulary_to_numpy(voc)))


def _mapper(mod):
    return mod.LocalMapper(n_neighbors=4, ba_local=8, ba_fixed=8, ba_pts=2048, ba_iters=6)


def _drive(t, imgs, after_map=None):
    """The reference test's sequence. Returns (poses by frame, states after
    the blackout, the revisit's pose and state)."""
    est = {}
    for i, img in enumerate(imgs):
        p = t.process_image(img, i * 0.1)
        if p is not None:
            est[i] = np.asarray(p.cpu() if hasattr(p, "cpu") else p, np.float32)
    if after_map is not None:
        after_map(t)
    black = np.zeros((H, W), np.float32)
    states = []
    for j in range(N_BLACK):
        t.process_image(black, 10.0 + j * 0.1)
        states.append(t.state)
    pose = t.process_image(imgs[REVISIT], 20.0)
    pose = None if pose is None else np.asarray(pose.cpu() if hasattr(pose, "cpu") else pose,
                                                np.float32)
    return est, states, pose, t.state


@pytest.fixture(scope="module")
def runs(scene):
    cfg, voc = scene["cfg"], scene["voc"]
    jr = jrel.RelocalizationService(voc, K, cfg.frontend.sigma2, kf_cap=cfg.kf_cap)
    tj = jtrk.MonocularTracker(cfg, K, np.zeros(4, np.float32), local_mapper=_mapper(jlm),
                               relocalizer=jr)
    snap = {}

    def keep(t):
        snap["map"] = _np_map(t.map)
        snap["n_kf"] = int(t.map.n_kf)

    with pytest.MonkeyPatch.context() as mp:
        inits = []
        original = jtv.reconstruct_two_views
        mp.setattr(jtv, "reconstruct_two_views",
                   lambda *a, **k: inits.append(original(*a, **k)) or inits[-1])
        out = {"jax": _drive(tj, scene["imgs"], keep), "jax_map": snap}
        mp.undo()
        replay = [ttv.TwoViewResult(*(torch.from_numpy(np.array(x)) for x in res))
                  for res in inits]
        mp.setattr(ttv, "reconstruct_two_views", lambda *a, **k: replay.pop(0))
        tr = trel.RelocalizationService(scene["tvoc"], K, scene["tcfg"].frontend.sigma2,
                                        kf_cap=cfg.kf_cap, device="cpu")
        reloc_noise_replay(tr)
        tt = ttrk.MonocularTracker(scene["tcfg"], K, np.zeros(4, np.float32),
                                   local_mapper=_mapper(tlm), relocalizer=tr, device="cpu")
        out["port"] = _drive(tt, scene["imgs"])
    out["jax_db"] = convert.bow_database_to_numpy(jr.db)
    f = make_frame(jnp.asarray(scene["imgs"][REVISIT]), jnp.asarray(K), jnp.zeros(4),
                   cfg.frontend)
    out["frame"] = f
    return out


class TestWholeRun:
    def test_recovers_like_reference(self, runs):
        """Both lose track in the blackout and relocalize at the revisit;
        the port's relocalized camera center within the reference test's
        0.1 of its own pre-blackout estimate and of the reference's."""
        (est_j, st_j, pose_j, state_j), (est_t, st_t, pose_t, state_t) = runs["jax"], runs["port"]
        assert st_t == st_j
        assert st_t[-1] in ("RECENTLY_LOST", "LOST")
        assert state_j == state_t == "OK"
        assert pose_t is not None and pose_j is not None
        assert sorted(est_t) == sorted(est_j)
        err = np.linalg.norm(_center(pose_t) - _center(est_t[REVISIT]))
        assert err < ERR_BOUND
        assert np.linalg.norm(_center(pose_t) - _center(pose_j)) < ERR_BOUND

    def test_database_matches_reference(self, runs, scene):
        """On the reference's map the service registers the keyframes the
        reference's service registered, with the same BoWs."""
        svc = trel.RelocalizationService(scene["tvoc"], K, scene["tcfg"].frontend.sigma2,
                                         kf_cap=scene["cfg"].kf_cap, device="cpu")
        svc._refresh(convert.map_state_from_numpy(runs["jax_map"]["map"]))
        db = convert.bow_database_to_numpy(svc.db)
        np.testing.assert_array_equal(db["valid"], runs["jax_db"]["valid"])
        np.testing.assert_allclose(db["bow"], runs["jax_db"]["bow"], atol=1e-7, rtol=0)
        assert svc._slots == set(range(runs["jax_map"]["n_kf"]))


class TestOnReferenceMap:
    """`_match_and_pnp` and `relocalize` on the map the JAX run built before
    the blackout, with the revisit frame the JAX front end extracted."""

    def _inputs(self, runs, scene):
        mj = jms.MapState(**{k: jnp.asarray(v) for k, v in runs["jax_map"]["map"].items()})
        mt = convert.map_state_from_numpy(runs["jax_map"]["map"])
        fj = runs["frame"]
        ft = convert.frame_from_numpy(_frame_np(fj))
        return mj, mt, fj, ft

    def test_match_and_pnp(self, runs, scene):
        """Every keyframe as the candidate: the same acceptance at
        MIN_RELOC_INLIERS, inliers within 2, the refined pose within
        POSE_ATOL where accepted."""
        mj, mt, fj, ft = self._inputs(runs, scene)
        sig = tuple(scene["cfg"].frontend.sigma2)
        n_ok = 0
        for slot in range(runs["jax_map"]["n_kf"]):
            key = jax.random.PRNGKey(100 + slot)
            Tj, nj = jrel._match_and_pnp(key, mj, jnp.int32(slot), fj.xy, fj.desc, fj.level,
                                         fj.valid, jnp.asarray(K), sig)
            noise = gumbel_rows(key, trel.PNP_HYPOTHESES, ft.capacity)
            Tt, nt = trel._match_and_pnp(noise, mt, slot, ft.xy, ft.desc, ft.level, ft.valid,
                                         torch.from_numpy(K), torch.tensor(sig))
            nj, nt = int(nj), int(nt)
            assert (nt >= trel.MIN_RELOC_INLIERS) == (nj >= jrel.MIN_RELOC_INLIERS)
            assert abs(nt - nj) <= 2
            if nj >= jrel.MIN_RELOC_INLIERS:
                n_ok += 1
                np.testing.assert_allclose(_center(Tt.numpy()), _center(Tj), atol=POSE_ATOL)
        assert n_ok >= 2

    def test_relocalize(self, runs, scene):
        """The same outcome through the BoW candidates: ok, inliers within
        2, the pose within POSE_ATOL."""
        mj, mt, fj, ft = self._inputs(runs, scene)
        voc, tv = scene["voc"], scene["tvoc"]
        levels, idf = voc.device_arrays()
        db = jdb.create(mj.kf_capacity, voc.n_words)
        for slot in range(runs["jax_map"]["n_kf"]):
            db = jdb.add(db, jnp.int32(slot), jvoc.bow_vector(
                levels, idf, mj.kf_desc[slot], mj.kf_feat_valid[slot], voc.branch, voc.n_words))
        sig = scene["cfg"].frontend.sigma2
        key = jax.random.PRNGKey(7)
        okj, Tj, nj = jrel.relocalize(key, mj, db, jms.covisibility(mj), voc, fj, jnp.asarray(K),
                                      sig)
        k = [key]

        def draw(n):
            k[0], s = jax.random.split(k[0])
            return gumbel_rows(s, trel.PNP_HYPOTHESES, n)

        dbt = convert.bow_database_from_numpy(convert.bow_database_to_numpy(db))
        okt, Tt, nt = trel.relocalize(draw, mt, dbt, tms.covisibility(mt), tv, ft,
                                      torch.from_numpy(K), sig)
        assert bool(okj) and okt
        assert abs(nt - int(nj)) <= 2
        np.testing.assert_allclose(_center(Tt.numpy()), _center(Tj), atol=POSE_ATOL)

    def test_black_frame_finds_no_candidate(self, runs, scene):
        mj, mt, fj, ft = self._inputs(runs, scene)
        svc = trel.RelocalizationService(scene["tvoc"], K, scene["tcfg"].frontend.sigma2,
                                         kf_cap=mt.kf_capacity, device="cpu")
        black = ft._replace(valid=torch.zeros_like(ft.valid))
        ok, T, n = svc(mt, black)
        assert (ok, T, n) == (False, None, 0)
        assert int(svc.db.valid.sum()) == runs["jax_map"]["n_kf"]
        svc.reset(mt.kf_capacity)
        assert not bool(svc.db.valid.any()) and not svc._slots


class _StubRelocalizer:
    """Accepts every call with a fixed pose."""

    def __init__(self, T):
        self.T, self.calls = T, 0

    def __call__(self, m, frame):
        self.calls += 1
        return True, self.T, 99


class TestCallSites:
    """ROADMAP fault p: the lost path extracts the frame once, relocalizes
    on it, and every call site returns the relocalized pose. The map is
    empty, so the refinement after the relocalizer finds nothing and the
    relocalizer's pose is returned as it is."""

    def _tracker(self, monkeypatch, state, async_depth=0):
        fc = ttrk.FrontendConfig(height=96, width=128, n_features=96, n_levels=4)
        cfg = ttrk.TrackerConfig(frontend=fc, kf_cap=8, pt_cap=256, fps=10.0)
        T = tlie.se3_exp(torch.tensor([0.1, -0.2, 0.3, 0.01, 0.02, -0.03]))
        t = ttrk.MonocularTracker(cfg, [100.0, 100.0, 64.0, 48.0], np.zeros(4, np.float32),
                                  relocalizer=_StubRelocalizer(T), device="cpu")
        t.state, t.async_depth = state, async_depth
        calls = []
        real = ttrk.make_frame
        monkeypatch.setattr(ttrk, "make_frame", lambda *a, **k: calls.append(1) or real(*a, **k))
        img = np.random.RandomState(0).rand(96, 128).astype(np.float32) * 255
        return t, T, calls, img

    @pytest.mark.parametrize("async_depth", [0, 8])
    def test_process_image_lost(self, monkeypatch, async_depth):
        t, T, calls, img = self._tracker(monkeypatch, ttrk.LOST, async_depth)
        pose = t.process_image(img, 1.0)
        assert len(calls) == 1 and t.relocalizer.calls == 1
        assert torch.equal(pose, T) and t.state == ttrk.OK and t._lost_frames == 0
        assert t.trajectory[-1][0] == 1.0 and torch.equal(t.trajectory[-1][1], T)

    def test_process_image_lost_failure_tracks_same_frame(self, monkeypatch):
        t, T, calls, img = self._tracker(monkeypatch, ttrk.LOST)
        t.relocalizer = lambda m, f: (False, None, 0)
        assert t.process_image(img, 1.0) is None
        assert len(calls) == 1 and t.state == ttrk.LOST and t._lost_frames == 1

    def test_track(self, monkeypatch):
        t, T, calls, img = self._tracker(monkeypatch, ttrk.RECENTLY_LOST)
        frame = ttrk.make_frame(torch.from_numpy(img), t.K, t.dist, t.config.frontend)
        pose = t.process_frame(frame, 2.0)
        assert torch.equal(pose, T) and t.state == ttrk.OK
        assert torch.equal(t.trajectory[-1][1], T)

    def test_track_resolve(self, monkeypatch):
        t, T, calls, img = self._tracker(monkeypatch, ttrk.OK)
        frame = ttrk.make_frame(torch.from_numpy(img), t.K, t.dist, t.config.frontend)
        res = ttrk.track_frame(t.map, frame, t.last_pose, t.K, t.config)
        assert int(res.n_inliers) < t.config.min_track_inliers
        pose = t._track_resolve(frame, 3.0, t.last_pose, None, res)
        assert torch.equal(pose, T) and t.state == ttrk.OK and t.relocalizer.calls == 1
        assert torch.equal(t.last_pose, T)
