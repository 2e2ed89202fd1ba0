"""Sim(3) alignment, map merging and the atlas of the port against the JAX
package.

Unit tests hold the Sim3 group functions, `horn_sim3`, `ransac_sim3`,
`transform_map`, the slot maps, `splice_map` and `merge_maps` to the
reference on inputs from numpy seeds. The whole-run test is
`tests/test_atlas.py` (240x320, 600 features on 4 levels, fps 2, a
branch-8 depth-2 vocabulary trained on the world; kf_cap 64 and pt_cap
4096 against the reference test's 96 and 8192, to keep the file near 100 s
on the CPU; the dense 36-patch world, see `test_torch_reloc.DENSE`) through
both packages' `MonocularTracker` with an atlas: 30 frames, 8 black frames (the map is
stashed), then a revisit of frames 8.. that initializes a second map and
merges it back. The port replays the reference's two-view results (fault o)
and draws its Sim3 noise (`sim3_noise_replay`: `PRNGKey(31337)` split once
per verification, 300 Gumbel rows). `compute_sim3_between`, `stash_active`
and `try_merge_back` are then run on the maps the JAX run built.
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
from dvm_slam_tpu.geometry import alignment as jal
from dvm_slam_tpu.geometry import lie as jlie
from dvm_slam_tpu.geometry import two_view as jtv
from dvm_slam_tpu.io import synthetic as jsyn
from dvm_slam_tpu.loopclosing import merge as jmerge
from dvm_slam_tpu.loopclosing import sim3_solver as jsim3
from dvm_slam_tpu.mapping import atlas as jatlas
from dvm_slam_tpu.mapping import local_mapping as jlm
from dvm_slam_tpu.mapping import map_state as jms
from dvm_slam_tpu.placerec import database as jdb
from dvm_slam_tpu.placerec import vocabulary as jvoc
from dvm_slam_tpu.tracking import tracker as jtrk

from dvm_slam_tpu_torch import convert
from dvm_slam_tpu_torch.geometry import alignment as tal
from dvm_slam_tpu_torch.geometry import lie as tlie
from dvm_slam_tpu_torch.geometry import two_view as ttv
from dvm_slam_tpu_torch.loopclosing import merge as tmerge
from dvm_slam_tpu_torch.loopclosing import sim3_solver as tsim3
from dvm_slam_tpu_torch.mapping import atlas as tatlas
from dvm_slam_tpu_torch.mapping import local_mapping as tlm
from dvm_slam_tpu_torch.mapping import map_state as tms
from dvm_slam_tpu_torch.tracking import tracker as ttrk

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_placerec import gumbel_rows  # noqa: E402
from test_torch_reloc import DENSE  # noqa: E402

torch.set_num_threads(2)

H, W = 240, 320
K = np.array([260.0, 260.0, 160.0, 120.0], np.float32)
LIE_ATOL = 1e-5
S_ATOL = 1e-3        # S_ab, port against reference
N_FRAMES, N_BLACK, REVISIT0 = 30, 8, 8
MERGE_FRAMES = 4     # the whole runs' merge frames, port against reference


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_map(m):
    return {k: np.array(v) for k, v in m._asdict().items()}


def _jmap(d):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


def sim3_noise_replay(atlas, key=None):
    """Make the port's `atlas` draw the reference's Sim3 noise: a key from
    PRNGKey(31337) (or `key`), split once per verification, the subkey split
    into 300 Gumbel rows."""
    state = [jax.random.PRNGKey(tatlas.SEED) if key is None else key]

    def draw(n):
        state[0], sub = jax.random.split(state[0])
        return gumbel_rows(sub, tsim3.ITERS, n)

    atlas._sim3_noise = draw


def _rand_sim3(rng, n=()):
    q = np.asarray(jlie.so3_exp(jnp.asarray(rng.randn(*n, 3).astype(np.float32))))
    t = rng.randn(*n, 3).astype(np.float32)
    s = np.exp(rng.randn(*n) * 0.3).astype(np.float32)
    return np.concatenate([q, t, s[..., None]], -1)


class TestSim3Lie:
    def test_group_functions(self):
        rng = np.random.RandomState(0)
        a, b = _rand_sim3(rng, (16,)), _rand_sim3(rng, (16,))
        T = np.asarray(jlie.se3_exp(jnp.asarray(rng.randn(16, 6).astype(np.float32))))
        p = rng.randn(16, 3).astype(np.float32)
        A, B, Tj = jnp.asarray(a), jnp.asarray(b), jnp.asarray(T)
        cases = [
            (tlie.sim3_mul(_t(a), _t(b)), jlie.sim3_mul(A, B)),
            (tlie.sim3_inv(_t(a)), jlie.sim3_inv(A)),
            (tlie.sim3_apply(_t(a), _t(p)), jlie.sim3_apply(A, jnp.asarray(p))),
            (tlie.sim3_from_se3(_t(T)), jlie.sim3_from_se3(Tj)),
            (tlie.sim3_from_se3(_t(T), _t(a[:, 7])), jlie.sim3_from_se3(Tj, A[:, 7])),
            (tlie.sim3_to_se3(_t(a)), jlie.sim3_to_se3(A)),
            (tlie.sim3(_t(a[:, :4]), _t(a[:, 4:7]), _t(a[:, 7])),
             jlie.sim3(A[:, :4], A[:, 4:7], A[:, 7])),
        ]
        for got, want in cases:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LIE_ATOL)
        # the scale fold the reference writes out inline
        Sc = jlie.sim3_mul(jlie.sim3_from_se3(Tj), jlie.sim3_inv(A))
        want = jlie.se3(jlie.sim3_q(Sc),
                        jlie.sim3_t(Sc) / jnp.maximum(jlie.sim3_s(Sc), 1e-12)[:, None])
        got = tlie.sim3_fold(tlie.sim3_mul(tlie.sim3_from_se3(_t(T)), tlie.sim3_inv(_t(a))))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LIE_ATOL)

    @pytest.mark.parametrize("with_scale", [True, False])
    def test_horn_and_residuals(self, with_scale):
        """Batched minimal sets against the reference's per-set solve."""
        rng = np.random.RandomState(1)
        S = _rand_sim3(rng, (8,))
        src = rng.randn(8, 3, 3).astype(np.float32)
        dst = np.stack([np.asarray(jlie.sim3_apply(jnp.asarray(S[i]), jnp.asarray(src[i])))
                        for i in range(8)]) + rng.randn(8, 3, 3).astype(np.float32) * 0.01
        got = tal.horn_sim3(_t(src), _t(dst), with_scale=with_scale).numpy()
        for i in range(8):
            want = np.asarray(jal.horn_sim3(jnp.asarray(src[i]), jnp.asarray(dst[i]),
                                            with_scale=with_scale))
            sign = np.sign(np.dot(got[i, :4], want[:4]))
            np.testing.assert_allclose(got[i, :4] * sign, want[:4], atol=1e-4)
            np.testing.assert_allclose(got[i, 4:], want[4:], atol=1e-4)
            r_t = tal.alignment_residuals(_t(got[i]), _t(src[i]), _t(dst[i])).numpy()
            r_j = np.asarray(jal.alignment_residuals(jnp.asarray(want), jnp.asarray(src[i]),
                                                     jnp.asarray(dst[i])))
            np.testing.assert_allclose(r_t, r_j, atol=1e-4)


def _sim3_scene(seed, with_scale, n=120):
    """Matched map points in two camera frames related by a Sim3 (scale 1
    without `with_scale`), their keypoints at 0.1 px, a third of the
    matches corrupted."""
    rng = np.random.RandomState(seed)
    S12 = _rand_sim3(rng)
    if not with_scale:
        S12[7] = 1.0
    S12[:4] = np.asarray(jlie.so3_exp(jnp.asarray(rng.randn(3).astype(np.float32) * 0.1)))
    S12[4:7] *= 0.3
    pc2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)],
                   -1).astype(np.float32)
    pc1 = np.array(jlie.sim3_apply(jnp.asarray(S12), jnp.asarray(pc2)))
    bad = rng.rand(n) < 0.33
    pc1[bad] += rng.randn(int(bad.sum()), 3).astype(np.float32)

    def proj(p):
        return np.stack([K[0] * p[:, 0] / p[:, 2] + K[2], K[1] * p[:, 1] / p[:, 2] + K[3]],
                        -1).round(1).astype(np.float32)

    sig1 = (1.2 ** rng.randint(0, 4, n)).astype(np.float32) ** 2
    sig2 = (1.2 ** rng.randint(0, 4, n)).astype(np.float32) ** 2
    mask = rng.rand(n) > 0.1
    return pc1, pc2, proj(pc1), proj(pc2), sig1, sig2, mask


class TestRansacSim3:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("with_scale", [True, False])
    def test_matches_reference(self, seed, with_scale):
        """The reference's draws: identical inliers and count, S12 to 1e-4."""
        args = _sim3_scene(seed, with_scale)
        key = jax.random.PRNGKey(seed)
        Sj, inl_j, nj = jsim3.ransac_sim3(key, *(jnp.asarray(a) for a in args), jnp.asarray(K),
                                          with_scale=with_scale)
        St, inl_t, nt = tsim3.ransac_sim3(gumbel_rows(key, tsim3.ITERS, args[0].shape[0]),
                                          *(_t(a) for a in args), _t(K), with_scale=with_scale)
        assert int(nt) == int(nj) >= 20
        np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
        Sj, St = np.asarray(Sj), St.numpy()
        sign = np.sign(np.dot(St[:4], Sj[:4]))
        np.testing.assert_allclose(St[:4] * sign, Sj[:4], atol=1e-4)
        np.testing.assert_allclose(St[4:], Sj[4:], atol=1e-4)


def _small_map(rng, mod, kf_cap=6, pt_cap=40, F=16, n_kf=3, n_pt=25):
    """A map of n_kf keyframes and n_pt points from `rng`, as numpy."""
    m = jms.create(kf_cap, pt_cap, F)
    d = _np_map(m)
    d["kf_pose"][:n_kf] = np.asarray(jlie.se3_exp(jnp.asarray(rng.randn(n_kf, 6).astype(np.float32)
                                                              * 0.2)))
    d["kf_valid"][:n_kf] = True
    d["kf_xy"][:n_kf] = rng.rand(n_kf, F, 2) * 100
    d["kf_level"][:n_kf] = rng.randint(0, 4, (n_kf, F))
    d["kf_desc"][:n_kf] = rng.rand(n_kf, F, 256) > 0.5
    d["kf_feat_valid"][:n_kf] = rng.rand(n_kf, F) > 0.1
    d["kf_obs"][:n_kf] = np.where(rng.rand(n_kf, F) > 0.3, rng.randint(0, n_pt, (n_kf, F)), -1)
    d["pt_pos"][:n_pt] = rng.randn(n_pt, 3) + [0, 0, 5]
    d["pt_valid"][:n_pt] = rng.rand(n_pt) > 0.1
    d["pt_desc"][:n_pt] = rng.rand(n_pt, 256) > 0.5
    nrm = rng.randn(n_pt, 3)
    d["pt_normal"][:n_pt] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    d["pt_min_dist"][:n_pt] = rng.rand(n_pt)
    d["pt_max_dist"][:n_pt] = 2 + rng.rand(n_pt)
    d["pt_ref_kf"][:n_pt] = rng.randint(-1, n_kf, n_pt)
    d["pt_first_kf"][:n_pt] = rng.randint(-1, n_kf, n_pt)
    d["pt_visible"][:n_pt] = rng.randint(0, 9, n_pt)
    d["pt_found"][:n_pt] = rng.randint(0, 5, n_pt)
    d["n_kf"], d["n_pt"] = np.int32(n_kf), np.int32(n_pt)
    meta = jms.MapMeta.create(kf_cap, pt_cap, agent_id=1)
    meta.kf_uuid[:n_kf] = meta.new_uuids(n_kf)
    meta.pt_uuid[:n_pt] = meta.new_uuids(n_pt)
    meta.kf_creator[:n_kf] = 1
    meta.pt_creator[:n_pt] = 1
    return d, meta


class TestMergeMaps:
    def test_transform_map_rotates_normals(self):
        """`tests/test_merge_units.py`'s case: normals rotate, positions take
        the full Sim3."""
        m = tms.create(4, 8, 4)
        m, _ = tms.add_points(m, torch.tensor([[0.0, 0.0, 5.0], [1.0, 0.0, 5.0]]),
                              torch.zeros((2, 256), dtype=torch.uint8),
                              torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]]),
                              torch.zeros(2), torch.ones(2), 0, torch.ones(2, dtype=torch.bool))
        S = tlie.sim3(tlie.so3_exp(torch.tensor([np.pi / 2, 0.0, 0.0])),
                      torch.tensor([3.0, 0.0, 0.0]), torch.tensor(2.0))
        out = tmerge.transform_map(m, S)
        n = out.pt_normal[:2].numpy()
        np.testing.assert_allclose(n, [[0.0, 1.0, 0.0]] * 2, atol=1e-6)
        np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-6)
        np.testing.assert_allclose(out.pt_pos[0].numpy(), tlie.sim3_apply(S, m.pt_pos[0]).numpy(),
                                   atol=1e-5)

    def test_transform_map_matches_reference(self):
        rng = np.random.RandomState(3)
        d, _ = _small_map(rng, jms)
        S = _rand_sim3(rng)
        want = _np_map(jmerge.transform_map(_jmap(d), jnp.asarray(S)))
        got = convert.map_state_to_numpy(tmerge.transform_map(convert.map_state_from_numpy(d), S))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)

    def test_slot_maps_splice_and_meta(self):
        """Two maps sharing some uuids: identical slot maps and spliced map;
        `merge_maps` leaves the meta it was given unchanged."""
        rng = np.random.RandomState(4)
        dA, metaA = _small_map(rng, jms, n_kf=3, n_pt=20)
        dB, metaB = _small_map(rng, jms, n_kf=3, n_pt=25)
        metaB.kf_uuid[1] = metaA.kf_uuid[0]          # a keyframe both maps hold
        metaB.pt_uuid[[2, 5, 7]] = metaA.pt_uuid[[1, 4, 9]]
        S = _rand_sim3(rng)
        snap = convert.map_meta_to_numpy(metaA)
        mj, meta_j, kf_j, pt_j = jmerge.merge_maps(_jmap(dA), metaA, _jmap(dB), metaB,
                                                   jnp.asarray(S))
        tA, tB = convert.map_state_from_numpy(dA), convert.map_state_from_numpy(dB)
        metaA_t = convert.map_meta_from_numpy(convert.map_meta_to_numpy(metaA))
        metaB_t = convert.map_meta_from_numpy(convert.map_meta_to_numpy(metaB))
        slots_t = tmerge.build_slot_maps(metaA_t, dA["kf_valid"], dA["pt_valid"], 3, 20, metaB_t,
                                         dB["kf_valid"], dB["pt_valid"])
        slots_j = jmerge.build_slot_maps(metaA, dA["kf_valid"], dA["pt_valid"], 3, 20, metaB,
                                         dB["kf_valid"], dB["pt_valid"])
        for a, b in zip(slots_t, slots_j):
            np.testing.assert_array_equal(a, b)
        mt, meta_t, kf_t, pt_t = tmerge.merge_maps(tA, metaA_t, tB, metaB_t, S)
        np.testing.assert_array_equal(kf_t, kf_j)
        np.testing.assert_array_equal(pt_t, pt_j)
        got, want = convert.map_state_to_numpy(mt), _np_map(mj)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
        for k, v in convert.map_meta_to_numpy(meta_t).items():
            np.testing.assert_array_equal(v, convert.map_meta_to_numpy(meta_j)[k])
            np.testing.assert_array_equal(convert.map_meta_to_numpy(metaA_t)[k], snap[k])
        assert meta_t.kf_uuid is not metaA_t.kf_uuid

    def test_splice_identity(self):
        """splice_map on the host slot maps, without the transform."""
        rng = np.random.RandomState(5)
        dA, metaA = _small_map(rng, jms)
        dB, metaB = _small_map(rng, jms)
        slots = jmerge.build_slot_maps(metaA, dA["kf_valid"], dA["pt_valid"], int(dA["n_kf"]),
                                       int(dA["n_pt"]), metaB, dB["kf_valid"], dB["pt_valid"])
        want = _np_map(jmerge.splice_map(_jmap(dA), _jmap(dB), *(jnp.asarray(s) for s in slots)))
        got = convert.map_state_to_numpy(tmerge.splice_map(
            convert.map_state_from_numpy(dA), convert.map_state_from_numpy(dB), *slots))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --------------------------------------------------------------------------
# the stash-then-merge-back run of tests/test_atlas.py, both packages
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    world = jsyn.PlaneWorld(seed=3, tex_size=1024, plane_z=6.0, extent=30.0, **DENSE)
    cfg = jtrk.TrackerConfig(frontend=FrontendConfig(height=H, width=W, n_features=600,
                                                     n_levels=4),
                             kf_cap=64, pt_cap=4096, fps=2.0)
    Kj = jnp.asarray(K)
    traj = jsyn.smooth_trajectory(40, lateral=2.0, forward=0.5, yaw=0.08)
    imgs = [np.asarray(world.render(jnp.asarray(traj[i]), Kj, H, W)) for i in range(N_FRAMES)]
    descs = []
    for i in range(0, 40, 8):
        im = imgs[i] if i < N_FRAMES else np.asarray(world.render(jnp.asarray(traj[i]), Kj, H, W))
        f = make_frame(jnp.asarray(im), Kj, jnp.zeros(4), cfg.frontend)
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    voc = jvoc.train(np.concatenate(descs)[:5000], branch=8, depth=2, seed=0)
    return dict(cfg=cfg, voc=voc, imgs=imgs,
                tcfg=convert.tracker_config_from_dict(dataclasses.asdict(cfg)),
                tvoc=convert.vocabulary_from_numpy(convert.vocabulary_to_numpy(voc)))


def _mapper(mod):
    return mod.LocalMapper(n_neighbors=4, ba_local=8, ba_fixed=8, ba_pts=2048, ba_iters=6)


def _drive(t, imgs):
    """Frames 0..29, the blackout, then the revisit until the merge. Returns
    per-call (frame, state, n_kf, stored maps)."""
    log = []
    for i in range(N_FRAMES):
        t.process_image(imgs[i], i * 0.1)
    log.append(("mapped", t.state, int(t.map.n_kf), len(t.atlas.inactive)))
    black = np.zeros((H, W), np.float32)
    for j in range(N_BLACK):
        t.process_image(black, 10.0 + j * 0.1)
        log.append((f"black {j}", t.state, int(t.map.n_kf), len(t.atlas.inactive)))
    for j, i in enumerate(range(REVISIT0, N_FRAMES)):
        t.process_image(imgs[i], 20.0 + j * 0.1)
        log.append((f"revisit {i}", t.state, int(t.map.n_kf), len(t.atlas.inactive)))
        if not t.atlas.inactive:
            break
    return log


@pytest.fixture(scope="module")
def atlas_runs(scene):
    cfg = scene["cfg"]
    tj = jtrk.MonocularTracker(cfg, K, np.zeros(4, np.float32), local_mapper=_mapper(jlm))
    tj.atlas = jatlas.Atlas(scene["voc"], K, cfg.frontend)
    calls = []
    real_merge = tj.atlas.try_merge_back
    real_stash = tj.atlas.stash_active

    def merge_rec(m_active, meta_active, q):
        rec = dict(m=_np_map(m_active), meta=convert.map_meta_to_numpy(meta_active), q=q,
                   key=np.array(tj.atlas.key),
                   stored=convert.stored_map_to_numpy(tj.atlas.inactive[0]))
        out = real_merge(m_active, meta_active, q)
        rec["out"] = None if out is None else (int(out[0].n_kf), np.array(out[2]), out[3])
        calls.append(rec)
        return out

    stash = {}

    def stash_rec(m, meta, ts):
        stash.update(m=_np_map(m), meta=convert.map_meta_to_numpy(meta), ts=dict(ts))
        return real_stash(m, meta, ts)

    tj.atlas.try_merge_back, tj.atlas.stash_active = merge_rec, stash_rec
    with pytest.MonkeyPatch.context() as mp:
        inits = []
        original = jtv.reconstruct_two_views
        mp.setattr(jtv, "reconstruct_two_views",
                   lambda *a, **k: inits.append(original(*a, **k)) or inits[-1])
        log_j = _drive(tj, scene["imgs"])
        mp.undo()
        replay = [ttv.TwoViewResult(*(torch.from_numpy(np.array(x)) for x in res))
                  for res in inits]
        mp.setattr(ttv, "reconstruct_two_views", lambda *a, **k: replay.pop(0))
        tt = ttrk.MonocularTracker(scene["tcfg"], K, np.zeros(4, np.float32),
                                   local_mapper=_mapper(tlm), device="cpu")
        tt.atlas = tatlas.Atlas(scene["tvoc"], K, scene["tcfg"].frontend, device="cpu")
        sim3_noise_replay(tt.atlas)
        epochs = [tt.map_epoch]
        log_t = _drive(tt, scene["imgs"])
        epochs.append(tt.map_epoch)

    return dict(log_j=log_j, log_t=log_t, calls=calls, stash=stash, jax=tj, port=tt,
                epochs=epochs)


class TestAtlasRun:
    def test_stash_and_merge_like_reference(self, atlas_runs):
        """The same per-frame states and stored-map counts as the reference
        through the stash (on the 5th lost frame) and the second map's
        init; keyframe counts within 1; the merge-back into a map holding
        both epochs within MERGE_FRAMES of the reference's frame. (Each
        merge-back attempt on identical inputs is held exactly by
        `test_merge_back_on_reference_maps`; here the second maps part by
        f32 rounding, so the attempt that passes the gates may move.)"""
        log_j, log_t = atlas_runs["log_j"], atlas_runs["log_t"]
        n = min(len(log_j), len(log_t)) - 1
        assert [e[:2] for e in log_t[:n]] == [e[:2] for e in log_j[:n]]
        assert [e[3] for e in log_t[:n]] == [e[3] for e in log_j[:n]]
        for (_, _, nt, _), (_, _, nj, _) in zip(log_t[:n], log_j[:n]):
            assert abs(nt - nj) <= 1
        kf_phase1 = log_j[0][2]
        assert kf_phase1 >= 10
        assert any(e[1] == "NOT_INITIALIZED" and e[3] == 1 for e in log_t)   # stashed
        for log in (log_t, log_j):
            assert log[-1][3] == 0 and log[-1][2] > kf_phase1              # merged back
            assert log[-1][1] == "OK"
        assert abs(len(log_t) - len(log_j)) <= MERGE_FRAMES
        assert atlas_runs["epochs"] == [0, 2]
        t = atlas_runs["port"]
        assert t.n_kf_host == int(t.map.n_kf)
        assert set(t.kf_timestamps) == set(range(t.n_kf_host))
        assert (t.meta.kf_uuid[:t.n_kf_host].sum(axis=1) != 0).all()

    def test_stash_active_on_reference_map(self, atlas_runs, scene):
        """The port's atlas stashes the reference's map with the reference's
        database and covisibility."""
        stash = atlas_runs["stash"]
        a = tatlas.Atlas(scene["tvoc"], K, scene["tcfg"].frontend, device="cpu")
        a.stash_active(convert.map_state_from_numpy(stash["m"]),
                       convert.map_meta_from_numpy(stash["meta"]), stash["ts"])
        got = convert.stored_map_to_numpy(a.inactive[0])
        want = convert.stored_map_to_numpy(atlas_runs["jax"].atlas.inactive[0]) \
            if atlas_runs["jax"].atlas.inactive else atlas_runs["calls"][0]["stored"]
        np.testing.assert_array_equal(got["db"]["valid"], want["db"]["valid"])
        np.testing.assert_allclose(got["db"]["bow"], want["db"]["bow"], atol=1e-7, rtol=0)
        np.testing.assert_array_equal(got["covis"], want["covis"])
        assert got["kf_timestamps"] == want["kf_timestamps"]

    def test_merge_back_on_reference_maps(self, atlas_runs, scene):
        """Every merge-back attempt of the JAX run, replayed on its inputs
        (the stored map and the active map the JAX run held, the atlas key
        of the call): the same outcome; on the merge the same merged n_kf
        and kf_map, S_ab to S_ATOL."""
        merged = 0
        for call in atlas_runs["calls"]:
            a = tatlas.Atlas(scene["tvoc"], K, scene["tcfg"].frontend, device="cpu")
            a.inactive.append(convert.stored_map_from_numpy(call["stored"]))
            sim3_noise_replay(a, jnp.asarray(call["key"]))
            out = a.try_merge_back(convert.map_state_from_numpy(call["m"]),
                                   convert.map_meta_from_numpy(call["meta"]), call["q"])
            assert (out is None) == (call["out"] is None)
            if out is None:
                assert len(a.inactive) == 1
                continue
            merged += 1
            n_kf, kf_map, S_ab = call["out"]
            assert int(out[0].n_kf) == n_kf and not a.inactive
            np.testing.assert_array_equal(out[2], kf_map)
            np.testing.assert_allclose(out[3], S_ab, atol=S_ATOL)
            assert out[4] == call["stored"]["kf_timestamps"]
        assert merged == 1

    def test_compute_sim3_on_reference_maps(self, atlas_runs, scene):
        """The verification of the JAX run's merging pair: the same ok,
        n_inliers within 1, n_proj within 2, S_ab to S_ATOL."""
        call = atlas_runs["calls"][-1]
        stored = call["stored"]
        mA_j, mB_j = _jmap(stored["m"]), _jmap(call["m"])
        voc = scene["voc"]
        levels, idf = voc.device_arrays()
        q = jvoc.bow_vector(levels, idf, mB_j.kf_desc[call["q"]], mB_j.kf_feat_valid[call["q"]],
                            voc.branch, voc.n_words)
        db = jdb.BowDatabase(bow=jnp.asarray(stored["db"]["bow"]),
                             valid=jnp.asarray(stored["db"]["valid"]))
        ok, best, _, _ = jdb.detect_merge_possibility(db, q, jnp.asarray(stored["covis"]))
        assert bool(ok)
        _, sub = jax.random.split(jnp.asarray(call["key"]))
        rj = convert.sim3_result_to_numpy(jmerge.compute_sim3_between(
            sub, mA_j, jnp.int32(int(best)), mB_j, jnp.int32(call["q"]), jnp.asarray(K)))
        rt = convert.sim3_result_to_numpy(tmerge.compute_sim3_between(
            gumbel_rows(sub, tsim3.ITERS, mA_j.feat_capacity),
            convert.map_state_from_numpy(stored["m"]), int(best),
            convert.map_state_from_numpy(call["m"]), call["q"], _t(K)))
        assert rt["ok"] == rj["ok"] is True
        assert abs(rt["n_inliers"] - rj["n_inliers"]) <= 1
        assert abs(rt["n_proj"] - rj["n_proj"]) <= 2
        assert rj["S_ab"][7] > 0
        np.testing.assert_allclose(rt["S_ab"], rj["S_ab"], atol=S_ATOL)


# --------------------------------------------------------------------------
# the tracker's atlas hooks, both packages, with a stub atlas
# --------------------------------------------------------------------------

class _StubAtlas:
    """Records stashes; `try_merge_back` returns `result` once."""

    def __init__(self, result=None):
        self.inactive, self.stashed, self.result, self.queries = [], [], result, []

    def stash_active(self, m, meta, ts):
        self.stashed.append((int(m.n_kf), dict(ts)))
        self.inactive.append(object())

    def try_merge_back(self, m, meta, q):
        self.queries.append(q)
        out, self.result = self.result, None
        if out is not None:
            self.inactive.pop()
        return out


class _StubReloc:
    def __init__(self):
        self.resets = 0

    def __call__(self, m, frame):
        return False, None, 0

    def reset(self, kf_cap):
        self.resets += 1


def _hook_trackers():
    fc = FrontendConfig(height=96, width=128, n_features=96, n_levels=4)
    cfg = jtrk.TrackerConfig(frontend=fc, kf_cap=16, pt_cap=64, fps=10.0)
    tcfg = convert.tracker_config_from_dict(dataclasses.asdict(cfg))
    Kh = np.array([100.0, 100.0, 64.0, 48.0], np.float32)
    tj = jtrk.MonocularTracker(cfg, Kh, np.zeros(4, np.float32), relocalizer=_StubReloc())
    tt = ttrk.MonocularTracker(tcfg, Kh, np.zeros(4, np.float32), relocalizer=_StubReloc(),
                               device="cpu")
    return tj, tt


class TestTrackerAtlasHooks:
    def test_merge_back_rebases_like_reference(self):
        """`_atlas_merge_back` on the same stub result: the pose re-based by
        S_ab, the keyframe timestamps renumbered through kf_map onto the
        stored ones, the slot mirrors, the epoch, the relocalizer reset and
        (in the autonomous lane) the device continuation re-seeded."""
        rng = np.random.RandomState(6)
        S_ab = _rand_sim3(rng)
        T = np.asarray(jlie.se3_exp(jnp.asarray(rng.randn(6).astype(np.float32) * 0.3)))
        kf_map = np.array([12, 13, -1, 14] + [-1] * 12)
        merged = {}
        for name, t in zip(("jax", "port"), _hook_trackers()):
            m = jms.create(16, 64, 96) if name == "jax" else tms.create(16, 64, 96)
            m = m._replace(n_kf=(jnp.int32(15) if name == "jax" else torch.tensor(15)))
            t.atlas = _StubAtlas((m, t.meta, kf_map, S_ab, {0: 0.0, 5: 0.5}))
            t.atlas.inactive.append(object())
            t.last_pose = jnp.asarray(T) if name == "jax" else _t(T)
            t.kf_timestamps = {0: 9.0, 1: 9.5, 2: 9.8, 3: 10.2}
            t.last_kf_slot = 3
            if name == "port":
                t.autonomous = True
                t._auto_state = ttrk.AutoState(_t(T), tlie.se3_identity(), torch.tensor(0),
                                               torch.tensor(1), torch.tensor(0))
            t._atlas_merge_back()
            merged[name] = t
        j, p = merged["jax"], merged["port"]
        np.testing.assert_allclose(p.last_pose.numpy(), np.asarray(j.last_pose), atol=1e-5)
        assert p.kf_timestamps == j.kf_timestamps == {0: 0.0, 5: 0.5, 12: 9.0, 13: 9.5, 14: 10.2}
        assert p.last_kf_slot == j.last_kf_slot == 14
        assert p.n_kf_host == j.n_kf_host == 15
        assert p.map_epoch == j.map_epoch == 1
        assert p.relocalizer.resets == j.relocalizer.resets == 1
        assert torch.equal(p._auto_state.T_cw, p.last_pose)
        assert torch.equal(p._auto_state.velocity, tlie.se3_identity())

    def test_new_map_like_reference(self):
        """`_new_map_in_atlas`: the map, its meta and timestamps go to the
        atlas; the tracker restarts on an empty map of the same capacities."""
        out = {}
        for name, t in zip(("jax", "port"), _hook_trackers()):
            t.atlas = _StubAtlas()
            t.kf_timestamps = {0: 1.0, 1: 2.0}
            t.n_kf_host, t.last_kf_slot, t.state, t._lost_frames = 2, 1, "LOST", 6
            t._new_map_in_atlas()
            out[name] = (t.atlas.stashed, t.state, t.n_kf_host, t.last_kf_slot, t._lost_frames,
                         t.kf_timestamps, t.map_epoch, t.relocalizer.resets, int(t.map.n_kf),
                         tuple(t.map.kf_pose.shape), t.init_frame)
        assert out["port"] == out["jax"]
        assert out["port"][1] == "NOT_INITIALIZED"

    def test_pipelined_retire_stashes_on_persistent_lost(self):
        """The port's repair: a lost frame retired from the pipelined lane
        on persistent LOST with a mature map starts a new map, as
        `_track_resolve` does."""
        _, t = _hook_trackers()
        t.atlas = _StubAtlas()
        t.map = t.map._replace(n_kf=torch.tensor(10, dtype=torch.int32))
        t.state, t._lost_frames, t.async_depth = "LOST", 4, 8
        n0 = torch.tensor(3, dtype=torch.int32)
        res = ttrk.TrackResult(tlie.se3_identity(), None, n0, n0, None, None)
        t._pipeline = [(1.0, None, res, ttrk._HostCopy(n0))]
        t._retire_pipelined()
        assert t.atlas.stashed and t.atlas.stashed[0][0] == 10
        assert t.state == "NOT_INITIALIZED" and t.map_epoch == 1 and int(t.map.n_kf) == 0
        assert t.relocalizer.resets == 1 and not t._pipeline
        # not yet persistent: RECENTLY_LOST after OK stashes nothing
        _, t = _hook_trackers()
        t.atlas = _StubAtlas()
        t.map = t.map._replace(n_kf=torch.tensor(10, dtype=torch.int32))
        t.state, t._lost_frames = "OK", 9
        t._pipeline = [(1.0, None, res, ttrk._HostCopy(n0))]
        t._retire_pipelined()
        assert not t.atlas.stashed and t.state == "RECENTLY_LOST"

    def test_autonomous_keyframe_schedules_merge_back(self):
        """A keyframe retired from the autonomous lane while the atlas holds
        a stored map sets the check; the next autonomous call drains the
        lane and tries the merge-back with the newest keyframe."""
        _, t = _hook_trackers()
        t.atlas = _StubAtlas()
        rows = np.zeros((2, 10), np.float32)
        rows[:, 0] = 1.0
        rows[:, 8] = 1.0
        rows[1, 7] = 1.0                      # the second frame made a keyframe
        rows[:, 9] = 50
        t._auto_flags = [([1.0, 1.1], ttrk._HostCopy(torch.from_numpy(rows)), 2, [1, 2])]
        t._retire_auto_record()
        assert not t._atlas_check_pending      # no stored map: nothing to merge into
        t.atlas.inactive.append(object())
        t._auto_flags = [([1.2, 1.3], ttrk._HostCopy(torch.from_numpy(rows)), 2, [3, 4])]
        t._retire_auto_record()
        assert t._atlas_check_pending and t.last_kf_slot == 1
        t.autonomous, t.auto_batch = True, 4
        t._auto_state = ttrk.AutoState(tlie.se3_identity(), tlie.se3_identity(),
                                       torch.tensor(0), torch.tensor(1), torch.tensor(0))
        drained = []
        t.drain_auto = lambda: drained.append(1)
        t._process_autonomous(torch.zeros((96, 128)), 1.4)   # buffered, nothing dispatched
        assert drained == [1] and t.atlas.queries == [1] and not t._atlas_check_pending
