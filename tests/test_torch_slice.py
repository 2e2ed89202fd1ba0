"""Slice parity: the port's per-frame step (`make_frame` + `track_frame`)
and its full autonomous step (keyframe decision, mapper chain, local BA)
against the JAX package, on `__graft_entry__`'s flagship setup and on a
rendered synthetic sequence, plus the port's import and dispatch contracts.

Run as a script, this file performs the JAX package's CPU reference runs at
EuRoC geometry (480x752, 1250 features, 8 levels, pt_cap 8192; the frames
`chip_smoke.py` runs on the card) and prints per-frame inliers and
translation errors as JSON: tracking only on frames 0..29, or with
`--slice2` the autonomous step with the mapper chain on frames 0..59:

    JAX_PLATFORMS=cpu python tests/test_torch_slice.py [--slice2]
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dvm_slam_tpu.frontend import extractor as jex
from dvm_slam_tpu.geometry import lie as jlie
from dvm_slam_tpu.io import synthetic as jsyn
from dvm_slam_tpu.mapping import map_state as jms
from dvm_slam_tpu.tracking import tracker as jtrk

from dvm_slam_tpu_torch import convert
from dvm_slam_tpu_torch.frontend import extractor as tex
from dvm_slam_tpu_torch.geometry import lie as tlie
from dvm_slam_tpu_torch.io import synthetic as tsyn
from dvm_slam_tpu_torch.mapping import map_state as tms
from dvm_slam_tpu_torch.tracking import tracker as ttrk

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EUROC_K = np.array([458.654, 457.296, 367.215, 248.375], np.float32)
# autonomous_step's mapper_cfg: (n_neighbors, n_levels, scale_factor,
# ba_local, ba_fixed, ba_pts, ba_iters, run_ba_every)
MAPPER_FULL = (5, 8, 1.2, 12, 8, 4096, 6, 1)   # bench.py's LocalMapper


def _scene(h, w, tex_size, n_frames, **world_kw):
    """The benchmark scene at (h, w): EuRoC intrinsics scaled to the width,
    the JAX world's renders of the first n_frames poses and frame 0's
    depth. `world_kw`: the world's layout (e.g. DENSE_WORLD)."""
    K = EUROC_K * np.float32(w / 752)
    world = jsyn.PlaneWorld(seed=7, tex_size=tex_size, plane_z=6.0, extent=36.0, **world_kw)
    poses = jsyn.smooth_trajectory(60, lateral=2.5, forward=0.8, yaw=0.1)[:n_frames]
    Kj = jnp.asarray(K)
    imgs = [np.array(world.render(jnp.asarray(p), Kj, h, w)) for p in poses]
    depth0 = np.array(world.render_depth(jnp.asarray(poses[0]), Kj, h, w))
    return K, poses, imgs, depth0


def _np_dict(nt):
    return {k: None if v is None else np.asarray(v) for k, v in nt._asdict().items()}


def _center_err(T_cw, T_gt):
    c = np.asarray(jlie.se3_t(jlie.se3_inv(jnp.asarray(T_cw))))
    g = np.asarray(jlie.se3_t(jlie.se3_inv(jnp.asarray(T_gt))))
    return float(np.linalg.norm(c - g))


def _jax_bootstrap(cfg, K, img0, depth0):
    """The JAX package's map seeding from frame 0's depth: keyframe 0 at
    identity plus one point per keypoint with depth. Returns (map, n)."""
    fc = cfg.frontend
    Kj, dist = jnp.asarray(K), jnp.zeros(4)
    f0 = jex.make_frame_rgbd(jnp.asarray(img0), jnp.asarray(depth0), Kj, dist, fc,
                             jnp.float32(K[0] * cfg.baseline))
    m = jms.create(cfg.kf_cap, cfg.pt_cap, fc.capacity)
    m, _ = jms.add_keyframe(m, jlie.se3_identity(), f0.xy, f0.level, f0.angle, f0.desc,
                            f0.valid, jnp.full((fc.capacity,), -1, jnp.int32), ur=f0.ur)
    return jtrk.create_points_from_depth(m, jnp.int32(0), f0, Kj, jnp.float32(1e9),
                                         fc.n_levels, fc.scale_factor)


def jax_run(cfg, K, poses, imgs, depth0):
    """Depth bootstrap from frame 0, then motion-model tracking of frames
    1.. with `make_and_track`. Returns (n_created, [(n_inliers, T_cw,
    translation error)])."""
    Kj, dist = jnp.asarray(K), jnp.zeros(4)
    m, n = _jax_bootstrap(cfg, K, imgs[0], depth0)
    T, vel, out = jlie.se3_identity(), jlie.se3_identity(), []
    for img, gt in zip(imgs[1:], poses[1:]):
        _, res, pv, pf = jtrk.make_and_track(jnp.asarray(img), m, jlie.se3_mul(vel, T),
                                             Kj, dist, cfg)
        m = m._replace(pt_visible=pv, pt_found=pf)
        good = res.n_inliers >= cfg.min_track_inliers
        vel = jnp.where(good, jlie.se3_mul(res.T_cw, jlie.se3_inv(T)), jlie.se3_identity())
        T = jnp.where(good, res.T_cw, T)
        out.append((int(res.n_inliers), np.asarray(T), _center_err(T, gt)))
    return int(n), out


def jax_auto_run(cfg, mapper_cfg, K, poses, imgs, depth0):
    """Depth bootstrap from frame 0, then the JAX package's
    `autonomous_step` (track, keyframe decision, mapper chain with local BA)
    on frames 1.. Returns (n_created, [(n_inliers, made_kf, T_cw,
    translation error, valid points)], final map)."""
    Kj, dist = jnp.asarray(K), jnp.zeros(4)
    m, n = _jax_bootstrap(cfg, K, imgs[0], depth0)
    st = jtrk.AutoState(T_cw=jlie.se3_identity(), velocity=jlie.se3_identity(),
                        frames_since_kf=jnp.int32(0), ref_tracked=jnp.int32(n),
                        kf_count=jnp.int32(0))
    out = []
    for img, gt in zip(imgs[1:], poses[1:]):
        m, st, fl = jtrk.autonomous_step(jnp.asarray(img), m, st, Kj, dist, cfg, mapper_cfg)
        out.append((int(fl.n_inliers), bool(fl.made_kf), np.asarray(st.T_cw),
                    _center_err(st.T_cw, gt), int(np.asarray(m.pt_valid).sum())))
    return int(n), out, m


def port_run(tcfg, K, imgs, depth0, device="cpu"):
    """The same run through the port."""
    Kt = torch.from_numpy(K).to(device)
    dist = torch.zeros(4, device=device)
    f0 = tex.make_frame_rgbd(torch.from_numpy(imgs[0]).to(device),
                             torch.from_numpy(depth0).to(device), Kt, dist,
                             tcfg.frontend, float(K[0]) * tcfg.baseline)
    m = tms.create(tcfg.kf_cap, tcfg.pt_cap, tcfg.frontend.capacity, device=device)
    m, n = ttrk.bootstrap_from_depth(m, f0, Kt, tcfg)
    T, vel, out = tlie.se3_identity(device=device), tlie.se3_identity(device=device), []
    for img in imgs[1:]:
        _, res, pv, pf = ttrk.make_and_track(torch.from_numpy(img).to(device), m,
                                             tlie.se3_mul(vel, T), Kt, dist, tcfg)
        m = m._replace(pt_visible=pv, pt_found=pf)
        T, vel = ttrk.motion_model_step(T, res, tcfg)
        out.append((int(res.n_inliers), T.cpu().numpy()))
    return int(n), out


def port_auto_run(tcfg, mapper_cfg, K, imgs, depth0, device="cpu"):
    """The same run as `jax_auto_run` through the port."""
    Kt = torch.from_numpy(K).to(device)
    dist = torch.zeros(4, device=device)
    f0 = tex.make_frame_rgbd(torch.from_numpy(imgs[0]).to(device),
                             torch.from_numpy(depth0).to(device), Kt, dist,
                             tcfg.frontend, float(K[0]) * tcfg.baseline)
    m = tms.create(tcfg.kf_cap, tcfg.pt_cap, tcfg.frontend.capacity, device=device)
    m, n = ttrk.bootstrap_from_depth(m, f0, Kt, tcfg)
    i32 = dict(dtype=torch.int32, device=device)
    st = ttrk.AutoState(T_cw=tlie.se3_identity(device=device),
                        velocity=tlie.se3_identity(device=device),
                        frames_since_kf=torch.zeros((), **i32), ref_tracked=n.to(torch.int32),
                        kf_count=torch.zeros((), **i32))
    out = []
    for img in imgs[1:]:
        m, st, fl = ttrk.autonomous_step(torch.from_numpy(img).to(device), m, st, Kt, dist, tcfg,
                                         mapper_cfg)
        out.append((int(fl.n_inliers), bool(fl.made_kf), st.T_cw.cpu().numpy()))
    return int(n), out, m


class TestAutonomousRun:
    def test_ten_frames_match_jax(self):
        """`autonomous_step` with the mapper chain and local BA on 10 tracked
        frames at 120x160 (300 features, 4 levels, kf_cap 16, pt_cap 1024,
        mapper (3 neighbors, ba_local 4, ba_fixed 2, ba_pts 256, ba_iters 3)).

        Free run: identical made_kf flags and n_kf, inliers within 1. Step by
        step, each port step starting from the JAX package's map and state
        (`convert`): identical flags and kf_obs, inliers within 1, the pose
        and the keyframe poses to 1e-3, points to 5e-3 (1 + |X|). At this
        size the scene pins the pose weakly (0.03-0.5 m error in both
        packages), so a free run lets f32 differences of the BA compound;
        the step-by-step check bounds what one step adds."""
        K, poses, imgs, depth0 = _scene(120, 160, 512, 11)
        fc = jex.FrontendConfig(height=120, width=160, n_features=300, n_levels=4)
        cfg = jtrk.TrackerConfig(frontend=fc, kf_cap=16, pt_cap=1024, fps=20.0)
        tcfg = convert.tracker_config_from_dict(dataclasses.asdict(cfg))
        mapper_cfg = (3, 4, 1.2, 4, 2, 256, 3, 1)
        Kj, Kt = jnp.asarray(K), torch.from_numpy(K)
        m, n = _jax_bootstrap(cfg, K, imgs[0], depth0)
        st = jtrk.AutoState(T_cw=jlie.se3_identity(), velocity=jlie.se3_identity(),
                            frames_since_kf=jnp.int32(0), ref_tracked=jnp.int32(n),
                            kf_count=jnp.int32(0))
        flags_j, inl_j = [], []
        for img in imgs[1:]:
            mt = convert.map_state_from_numpy(_np_dict(m))
            stt = convert.auto_state_from_numpy(_np_dict(st))
            mt, stt, flt = ttrk.autonomous_step(torch.from_numpy(img), mt, stt, Kt,
                                                torch.zeros(4), tcfg, mapper_cfg)
            m, st, fl = jtrk.autonomous_step(jnp.asarray(img), m, st, Kj, jnp.zeros(4), cfg,
                                             mapper_cfg)
            flags_j.append(bool(fl.made_kf))
            inl_j.append(int(fl.n_inliers))
            assert bool(flt.made_kf) == flags_j[-1]
            assert abs(int(flt.n_inliers) - inl_j[-1]) <= 1
            np.testing.assert_allclose(stt.T_cw.numpy(), np.asarray(st.T_cw), atol=1e-3)
            np.testing.assert_array_equal(mt.kf_obs.numpy(), np.asarray(m.kf_obs))
            np.testing.assert_allclose(mt.kf_pose.numpy(), np.asarray(m.kf_pose), atol=1e-3)
            X = np.asarray(m.pt_pos)
            err = np.abs(mt.pt_pos.numpy() - X).max(1) / (1.0 + np.linalg.norm(X, axis=1))
            assert err.max() <= 5e-3
        assert sum(flags_j) >= 2   # the chain really ran

        n_t, out_t, m_t = port_auto_run(tcfg, mapper_cfg, K, imgs, depth0)
        assert n_t == int(n)
        assert [o[1] for o in out_t] == flags_j
        assert int(m_t.n_kf) == int(m.n_kf)
        assert all(abs(o[0] - i) <= 1 for o, i in zip(out_t, inl_j))

        # the batch entry is the same steps in a loop: identical outcome rows
        m0, n0 = ttrk.bootstrap_from_depth(
            tms.create(16, 1024, tcfg.frontend.capacity),
            tex.make_frame_rgbd(torch.from_numpy(imgs[0]), torch.from_numpy(depth0), Kt,
                                torch.zeros(4), tcfg.frontend, 0.0), Kt, tcfg)
        zero = torch.zeros((), dtype=torch.int32)
        st0 = ttrk.AutoState(tlie.se3_identity(), tlie.se3_identity(), zero,
                             n0.to(torch.int32), zero)
        m_b, _, rows = ttrk.autonomous_step_batch(torch.from_numpy(np.stack(imgs[1:4])), m0,
                                                  st0, Kt, torch.zeros(4), tcfg, mapper_cfg)
        want = np.array([np.r_[T, kf, True, inl] for inl, kf, T in out_t[:3]], np.float32)
        np.testing.assert_array_equal(rows.numpy(), want)


class TestSyntheticRun:
    def test_six_frames_match_jax(self):
        """120x160, tex_size 256, 300 features on 4 levels: the same points
        created, the same inlier count every frame (exact) and the same poses
        (atol 1e-3: f32 Gauss-Newton sums in another order)."""
        K, poses, imgs, depth0 = _scene(120, 160, 256, 6)
        fc = jex.FrontendConfig(height=120, width=160, n_features=300, n_levels=4)
        cfg = jtrk.TrackerConfig(frontend=fc, kf_cap=8, pt_cap=1024, fps=20.0)
        tcfg = convert.tracker_config_from_dict(dataclasses.asdict(cfg))
        n_j, out_j = jax_run(cfg, K, poses, imgs, depth0)
        n_t, out_t = port_run(tcfg, K, imgs, depth0)
        assert n_t == n_j > 0
        assert [o[0] for o in out_t] == [o[0] for o in out_j]
        assert max(o[0] for o in out_j) >= 15  # the run really tracks
        for (_, Tj, _), (_, Tt) in zip(out_j, out_t):
            np.testing.assert_allclose(Tt, Tj, atol=1e-3)

    def test_world_matches_jax(self):
        """Texture and plane layout come from the same numpy draws: the
        texture is identical. Renders agree to 0.05 grey levels (f32 ray
        arithmetic in another fusion order), depth to 1e-4 m, trajectory
        poses to 1e-6."""
        K, poses, imgs, depth0 = _scene(60, 80, 256, 3)
        tw = tsyn.PlaneWorld(seed=7, tex_size=256, plane_z=6.0, extent=36.0)
        jw = jsyn.PlaneWorld(seed=7, tex_size=256, plane_z=6.0, extent=36.0)
        np.testing.assert_array_equal(tw.texture.numpy(), np.asarray(jw.texture))
        np.testing.assert_array_equal(tw.planes, jw.planes)
        tposes = tsyn.smooth_trajectory(60, lateral=2.5, forward=0.8, yaw=0.1)[:3]
        for tp, p in zip(tposes, poses):
            np.testing.assert_allclose(tp, p, atol=1e-6)
        for p, img in zip(poses, imgs):
            np.testing.assert_allclose(tw.render(np.array(p), K, 60, 80).numpy(), img, atol=0.05)
        np.testing.assert_allclose(tw.render_depth(np.array(poses[0]), K, 60, 80).numpy(), depth0,
                                   atol=1e-4)


class TestFlagshipStep:
    def test_track_frame_matches_entry(self):
        """`__graft_entry__.entry()`'s setup: identical n_inliers, n_stage1
        and obs, T_cw to 1e-4."""
        sys.path.insert(0, REPO)
        import __graft_entry__ as ge

        cfg, m, img, T, K = ge._small_setup()
        fn, args = ge.entry()
        T_j, n_j = fn(*args)
        fj = jex.make_frame(img, K, jnp.zeros(4), cfg.frontend)
        rj = jtrk.track_frame(m, fj, T, K, cfg)

        tcfg = convert.tracker_config_from_dict(dataclasses.asdict(cfg))
        mt = convert.map_state_from_numpy({k: np.asarray(v) for k, v in m._asdict().items()})
        Kt = torch.from_numpy(np.array(K))
        ft = tex.make_frame(torch.from_numpy(np.array(img)), Kt, torch.zeros(4), tcfg.frontend)
        rt = ttrk.track_frame(mt, ft, torch.from_numpy(np.array(T)), Kt, tcfg)
        assert int(rt.n_inliers) == int(n_j) == int(rj.n_inliers)
        assert int(rt.n_stage1) == int(rj.n_stage1)
        np.testing.assert_array_equal(rt.obs.numpy(), np.asarray(rj.obs))
        np.testing.assert_array_equal(rt.visible.numpy(), np.asarray(rj.visible))
        np.testing.assert_array_equal(rt.found.numpy(), np.asarray(rj.found))
        np.testing.assert_allclose(rt.T_cw.numpy(), np.asarray(T_j), atol=1e-4)


class TestPortContracts:
    def test_import_leaves_jax_out(self):
        code = ("import sys; import dvm_slam_tpu_torch.tracking.tracker, "
                "dvm_slam_tpu_torch.io.synthetic, dvm_slam_tpu_torch.convert, "
                "dvm_slam_tpu_torch.ops.orb_kernel, dvm_slam_tpu_torch.ops.scatter, "
                "dvm_slam_tpu_torch.ops.scatter_kernel, dvm_slam_tpu_torch.mapping.ba, "
                "dvm_slam_tpu_torch.mapping.local_mapping, "
                "dvm_slam_tpu_torch.geometry.triangulation, "
                "dvm_slam_tpu_torch.geometry.two_view, dvm_slam_tpu_torch.geometry.alignment, "
                "dvm_slam_tpu_torch.io.config, dvm_slam_tpu_torch.io.trajectory, "
                "dvm_slam_tpu_torch.eval.metrics, dvm_slam_tpu_torch.models.system, "
                "dvm_slam_tpu_torch.placerec.vocabulary, dvm_slam_tpu_torch.placerec.database, "
                "dvm_slam_tpu_torch.geometry.pnp, dvm_slam_tpu_torch.tracking.relocalization, "
                "dvm_slam_tpu_torch.loopclosing.sim3_solver, "
                "dvm_slam_tpu_torch.loopclosing.merge, dvm_slam_tpu_torch.mapping.atlas, "
                "dvm_slam_tpu_torch.loopclosing.pose_graph, "
                "dvm_slam_tpu_torch.loopclosing.loop_detector, "
                "dvm_slam_tpu_torch.multiagent.messages, dvm_slam_tpu_torch.multiagent.wirecodec, "
                "dvm_slam_tpu_torch.multiagent.transport, "
                "dvm_slam_tpu_torch.multiagent.socket_transport, "
                "dvm_slam_tpu_torch.multiagent.peer, dvm_slam_tpu_torch.multiagent.codec, "
                "dvm_slam_tpu_torch.multiagent.reference_frames, "
                "dvm_slam_tpu_torch.multiagent.agent, dvm_slam_tpu_torch.parallel.multi_agent, "
                "dvm_slam_tpu_torch.multiagent.native_codec, "
                "dvm_slam_tpu_torch.geometry.imu, dvm_slam_tpu_torch.mapping.vi_ba, "
                "dvm_slam_tpu_torch.mapping.inertial; "
                "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
                "or m.startswith('dvm_slam_tpu.') or m == 'dvm_slam_tpu' "
                "or m == 'yaml' or m.startswith('yaml.')]; "
                "print(bad); sys.exit(1 if bad else 0)")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr

    def test_chip_smoke_leaves_jax_out(self):
        """`chip_smoke.py` without a card exits non-zero before any result
        line, and neither it nor the port modules its phases import pull in
        JAX, the JAX package or yaml."""
        code = ("import sys; sys.argv = ['chip_smoke.py']; import chip_smoke; "
                "rc = chip_smoke.main(); "
                "import dvm_slam_tpu_torch.multiagent.agent, dvm_slam_tpu_torch.models.system; "
                "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
                "or m.startswith('dvm_slam_tpu.') or m == 'dvm_slam_tpu' "
                "or m == 'yaml' or m.startswith('yaml.')]; "
                "print(rc, bad); sys.exit(0 if rc != 0 and not bad else 1)")
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert '"ok"' not in proc.stdout

    def test_import_sets_precision_policy(self):
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False

    def test_use_kernel_true_on_cpu_raises(self):
        fc = tex.FrontendConfig(height=96, width=128, n_features=96, n_levels=4, use_kernel=True)
        img = torch.from_numpy(np.random.RandomState(0).rand(96, 128).astype(np.float32) * 255)
        with pytest.raises(ValueError, match="CUDA"):
            tex.extract(img, fc)

    def test_config_round_trip(self):
        fc = jex.FrontendConfig(height=96, width=128, n_features=96, n_levels=4)
        cfg = jtrk.TrackerConfig(frontend=fc, kf_cap=8, pt_cap=256, fps=10.0)
        d = dataclasses.asdict(cfg)
        tcfg = convert.tracker_config_from_dict(d)
        assert tcfg.frontend.capacity == fc.capacity
        assert tcfg.frontend.level_budgets == fc.level_budgets
        assert convert.tracker_config_to_dict(tcfg) == d


def _reference_main():
    """The JAX package's CPU reference run of the smoke's frames."""
    n_frames = 30
    K, poses, imgs, depth0 = _scene(480, 752, 2048, n_frames)
    fc = jex.FrontendConfig(height=480, width=752, n_features=1250)
    cfg = jtrk.TrackerConfig(frontend=fc, kf_cap=128, pt_cap=8192, fps=20.0)
    n, out = jax_run(cfg, K, poses, imgs, depth0)
    print(json.dumps({
        "n_created": n,
        "n_inliers": [o[0] for o in out],
        "trans_err_m": [round(o[2], 6) for o in out],
        "max_trans_err_m": round(max(o[2] for o in out), 6),
    }))


def _reference_slice2_main():
    """The JAX package's CPU reference of the smoke's slice-2 run: depth
    bootstrap, then `autonomous_step` with the mapper chain on frames 1..59
    at EuRoC geometry, `LocalMapper(5, ba_local=12, ba_fixed=8, ba_pts=4096,
    ba_iters=6)`."""
    n_frames = 60
    K, poses, imgs, depth0 = _scene(480, 752, 2048, n_frames)
    fc = jex.FrontendConfig(height=480, width=752, n_features=1250)
    cfg = jtrk.TrackerConfig(frontend=fc, kf_cap=128, pt_cap=8192, fps=20.0)
    n, out, m = jax_auto_run(cfg, MAPPER_FULL, K, poses, imgs, depth0)
    print(json.dumps({
        "n_created": n,
        "n_inliers": [o[0] for o in out],
        "made_kf": [int(o[1]) for o in out],
        "trans_err_m": [round(o[3], 6) for o in out],
        "max_trans_err_m": round(max(o[3] for o in out), 6),
        "valid_points": [o[4] for o in out],
        "n_kf": int(m.n_kf),
        "n_valid_points": int(np.asarray(m.pt_valid).sum()),
        "invariants": jms.check_invariants(m),
    }))


def euroc_settings_dict():
    """`configs/euroc.yaml` as the JAX package loads it, with no lens
    distortion (the synthetic renderer draws none), as a plain dict."""
    from dvm_slam_tpu.io import config as jcfg

    s = jcfg.load_settings(os.path.join(REPO, "configs", "euroc.yaml"))
    s.camera = dataclasses.replace(s.camera, dist=(0.0, 0.0, 0.0, 0.0))
    return dataclasses.asdict(s)


def jax_settings(d):
    """The JAX package's `SystemSettings` from its `dataclasses.asdict`."""
    from dvm_slam_tpu.io import config as jcfg

    return jcfg.SystemSettings(**{**d, "camera": jcfg.CameraSettings(**d["camera"]),
                                  "orb": jcfg.OrbSettings(**d["orb"]),
                                  "imu": jcfg.ImuSettings(**d["imu"])})


def jax_system_run(settings, imgs, poses, out_dir):
    """Every frame through the JAX package's `System.track_monocular(img,
    i/20)` from frame 0 (monocular two-view init, then autonomous tracking),
    then `save_trajectory_tum` and a Sim3-aligned ATE against ground truth
    by timestamp. Returns a dict of the run's outcomes."""
    from dvm_slam_tpu.eval import metrics as jmetrics
    from dvm_slam_tpu.geometry import two_view as jtv
    from dvm_slam_tpu.io import trajectory as jtraj
    from dvm_slam_tpu.models import system as jsys

    inits = []
    original = jtv.reconstruct_two_views

    def recording(*args, **kwargs):
        res = original(*args, **kwargs)
        inits.append(res)
        return res

    jtv.reconstruct_two_views = recording
    try:
        sysj = jsys.System(settings)
        t = sysj.tracker
        init_pair, n_init_points, states = None, None, []
        for i, img in enumerate(imgs):
            was = t.state
            sysj.track_monocular(img, i / 20.0)
            states.append(t.state)
            if was == jtrk.NOT_INITIALIZED and t.state == jtrk.OK:
                init_pair = (int(round(t._init_ts * 20)), i)
                n_init_points = int(t.map.n_pt)
        path = os.path.join(out_dir, "traj_tum.txt")
        sysj.save_trajectory_tum(path)
    finally:
        jtv.reconstruct_two_views = original
    rows = jtraj.load_tum(path)
    idx = [int(round(ts * 20)) for ts, _ in rows]
    est = np.stack([T for _, T in rows])
    gt = np.stack([np.asarray(poses[i]) for i in idx])
    ate, _, _ = jmetrics.ate_rmse(est, gt)
    res = inits[-1]
    return {
        "init_pair": init_pair,
        "used_homography": bool(res.used_homography),
        "n_init_good": int(np.asarray(res.good).sum()),
        "n_init_points": n_init_points,
        "n_ransac_calls": len(inits),
        "final_state": t.state,
        "states": states,
        "tracked_frames": idx,
        "kf_frames": sorted(int(round(v * 20)) for v in t.kf_timestamps.values()),
        "n_kf": int(t.map.n_kf),
        "n_kf_host": t.n_kf_host,
        "n_valid_points": int(np.asarray(t.map.pt_valid).sum()),
        "ate_rmse_m": ate,
    }


def jax_init_outcome(settings, imgs, agent_id):
    """The JAX `System`'s two-view initialization on `imgs` under the RANSAC
    draws of agent `agent_id`: (init frame pair, homography, good points),
    or None when it does not initialize on these frames."""
    from dvm_slam_tpu.geometry import two_view as jtv
    from dvm_slam_tpu.models import system as jsys

    inits = []
    original = jtv.reconstruct_two_views

    def recording(*args, **kwargs):
        res = original(*args, **kwargs)
        inits.append(res)
        return res

    jtv.reconstruct_two_views = recording
    try:
        sysj = jsys.System(settings, agent_id=agent_id)
        for i, img in enumerate(imgs):
            sysj.track_monocular(img, i / 20.0)
            if sysj.tracker.state == jtrk.OK:
                res = inits[-1]
                return ((int(round(sysj.tracker._init_ts * 20)), i),
                        bool(res.used_homography), int(np.asarray(res.good).sum()))
    finally:
        jtv.reconstruct_two_views = original
    return None


def _reference_slice3_main():
    """The JAX package's CPU reference of the smoke's slice-3 run: the
    benchmark scene at 480x752, every frame through `System.track_monocular`
    with `configs/euroc.yaml` (resized to 600x350, no distortion), agent 0;
    then the two-view initialization alone under the draws of agents 1-5,
    whose spread the smoke holds the card's initialization to."""
    import tempfile

    _, poses, imgs, _ = _scene(480, 752, 2048, 60)
    settings = jax_settings(euroc_settings_dict())
    with tempfile.TemporaryDirectory() as d:
        out = jax_system_run(settings, imgs, poses, d)
    out["init_by_seed"] = {0: (out["init_pair"], out["used_homography"], out["n_init_good"])}
    for seed in range(1, 6):
        out["init_by_seed"][seed] = jax_init_outcome(settings, imgs[:16], seed)
    print(json.dumps(out))


# Slice 6: the System with the shipped vocabulary. Sequences are lists of
# (ground-truth frame or None for a black frame, timestamp).
N_BLACK6, REVISIT6 = 4, (30, 42)          # phase 16: blackout, revisited frames
N_BLACK6A, REVISIT6A = 20, (10, 60)       # phase 17
FPS6A = 5.0                               # phase 17's camera.fps
# phase 17's world: the dense 36-patch layout. On the default 8-patch world
# at camera.fps 5 the reference's first map loses track at frame 41, before
# the blackout.
DENSE_WORLD = dict(n_patches=36, depth_range=(0.30, 0.92), patch_half=(0.03, 0.09))


def slice6_sequences():
    """(phase 16, phase 17) sequences: frames 0..59, a blackout, then a
    revisit, frame index i stamped i / 20 throughout."""
    def seq(n_black, revisit):
        frames = list(range(60)) + [None] * n_black + list(range(*revisit))
        return [(f, i / 20.0) for i, f in enumerate(frames)]
    return seq(N_BLACK6, REVISIT6), seq(N_BLACK6A, REVISIT6A)


def jax_vocab_run(settings, imgs, poses, seq, drain_after=None):
    """`seq` through the JAX package's `System(settings, vocabulary_file=
    data/voc_default.npz)` as agent 0, recording per call the state, the
    pose, relocalization attempts (with the relocalizer's inliers), stashes,
    merge-back attempts and two-view inits. Two changes to the tracker make
    the run the one the port makes: records of the autonomous lane retire
    as soon as the next one is dispatched (`_record_ready` true, so the
    hand-back lands on the same call in every run), and the pipelined
    retire stashes the map on persistent LOST as `_track_resolve` does (the
    port's repair; without it the System never starts a new map). After
    call `drain_after` the lane is drained, as the smoke's saving of the
    trajectory there does (it restarts the batches of 4)."""
    from dvm_slam_tpu.geometry import two_view as jtv
    from dvm_slam_tpu.models import system as jsys

    sysj = jsys.System(settings, vocabulary_file=os.path.join(REPO, "data", "voc_default.npz"))
    t = sysj.tracker
    log = dict(calls=[], reloc=[], stash=[], merge=[], inits=[])
    cur = [0]
    t._record_ready = lambda rec: True
    retire = t._retire_pipelined

    def retire_and_stash():
        before = t._lost_frames
        retire()
        if (t._lost_frames > before and t.atlas is not None and t.state == jtrk.LOST
                and t._lost_frames >= 5 and int(t.map.n_kf) >= 10):
            t._new_map_in_atlas()

    t._retire_pipelined = retire_and_stash
    from dvm_slam_tpu.tracking import relocalization as jrel

    relocalize, last_n = jrel.relocalize, [0]

    def counting(*args, **kwargs):
        ok, T, n = relocalize(*args, **kwargs)
        last_n[0] = int(n)
        return ok, T, n

    try_reloc = t._try_relocalize

    def logged_reloc(frame, ts):
        pose = try_reloc(frame, ts)
        log["reloc"].append((cur[0], pose is not None, last_n[0],
                             None if pose is None else np.asarray(pose).tolist()))
        return pose

    t._try_relocalize = logged_reloc
    stash = t._new_map_in_atlas

    def logged_stash():
        log["stash"].append((cur[0], int(t.map.n_kf)))
        stash()

    t._new_map_in_atlas = logged_stash
    merge = t.atlas.try_merge_back

    def logged_merge(m, meta, q):
        out = merge(m, meta, q)
        log["merge"].append((cur[0], int(q), out is not None,
                             None if out is None else np.asarray(out[3]).tolist(),
                             None if out is None else int(out[0].n_kf), len(t.trajectory)))
        return out

    t.atlas.try_merge_back = logged_merge
    original = jtv.reconstruct_two_views

    def recording(*args, **kwargs):
        res = original(*args, **kwargs)
        if bool(res.ok):
            log["inits"].append((cur[0], int(np.asarray(res.good).sum()),
                                 bool(res.used_homography)))
        return res

    jtv.reconstruct_two_views, jrel.relocalize = recording, counting
    black = np.zeros_like(imgs[0])
    log["init_pairs"] = []
    try:
        for i, (f, ts) in enumerate(seq):
            cur[0] = i
            was = t.state
            pose = sysj.track_monocular(black if f is None else imgs[f], ts)
            if was == jtrk.NOT_INITIALIZED and t.state == jtrk.OK:
                log["init_pairs"].append((int(round(t._init_ts * 20)), i))
            if i == drain_after:
                t.drain_auto()
            log["calls"].append((i, t.state, pose is not None, int(t.map.n_kf),
                                 len(t.atlas.inactive), t.autonomous))
        t.drain_auto()
    finally:
        jtv.reconstruct_two_views, jrel.relocalize = original, relocalize
    rows = [(float(ts), np.asarray(T, np.float32)) for ts, T, _ in t.trajectory]
    log["rows"] = [(ts, T.tolist()) for ts, T in rows]
    log["n_kf"] = int(t.map.n_kf)
    return log


def slice6_summary(ref, poses):
    """The numbers `chip_smoke.py`'s JAX_REF6 holds, from the logs of the
    two runs (`jax_vocab_run`, as printed) and the ground truth: phase 16's
    first successful relocalization (call, relocalizer inliers, camera
    center distance from the pre-blackout estimate of the same view); phase
    17's stash (call, stored keyframes), inits, merge call, S_ab, the ATE
    over the rows in the stored map's frame (calls 0..59 before the stash,
    every row after the merge) and the spread of the second init over
    agents 0-5 (frame pairs)."""
    from dvm_slam_tpu.eval import metrics as jmetrics

    seq16, seq17 = slice6_sequences()
    r16, r17 = ref["phase16"], ref["phase17"]

    def center(T):
        return np.asarray(jlie.se3_t(jlie.se3_inv(jnp.asarray(np.asarray(T, np.float32)))))

    call, _, n_inl, T_rel = [r for r in r16["reloc"] if r[1]][0]
    view = seq16[call][0]
    pre = [T for ts, T in r16["rows"] if abs(ts - view / 20.0) < 1e-9][0]
    merge = [m for m in r17["merge"] if m[2]][0]
    rows, n_before = r17["rows"], merge[5]
    keep = [r for r in rows[:n_before] if int(round(r[0] * 20)) < 60] + rows[n_before:]
    keep = [r for r in keep if seq17[int(round(r[0] * 20))][0] is not None]
    est = np.stack([np.asarray(T, np.float32) for _, T in keep])
    gt = np.stack([np.asarray(poses[seq17[int(round(ts * 20))][0]]) for ts, _ in keep])
    spread = [(REVISIT6A[0] + p[0], REVISIT6A[0] + p[1])
              for p, _, _ in (v for v in r17["init_by_seed"].values() if v is not None)]
    return {
        "phase16": {"reloc_call": call, "reloc_inliers": n_inl,
                    "reloc_dist": float(np.linalg.norm(center(T_rel) - center(pre)))},
        "phase17": {"stash": tuple(r17["stash"][0]), "init_pairs": r17["init_pairs"],
                    "merge_call": merge[0], "S_ab": merge[3],
                    "ate": float(jmetrics.ate_rmse(est, gt)[0]), "init_spread": spread},
    }


def _reference_slice6_main():
    """The JAX package's CPU reference of the smoke's slice-6 runs (phase 16:
    slice 3's settings with the vocabulary, a blackout of N_BLACK6 frames,
    a revisit of REVISIT6; phase 17: the dense world, camera.fps FPS6A,
    N_BLACK6A black frames, a revisit of REVISIT6A), then the two-view init alone on the
    phase-17 revisit frames under the draws of agents 0-5 (the spread the
    smoke holds the second map's init to). Prints one JSON object."""
    _, poses, imgs, _ = _scene(480, 752, 2048, 60)
    d = euroc_settings_dict()
    seq16, seq17 = slice6_sequences()
    out = {"phase16": jax_vocab_run(jax_settings(d), imgs, poses, seq16, drain_after=59)}
    _, _, imgs, _ = _scene(480, 752, 2048, 60, **DENSE_WORLD)
    d17 = {**d, "camera": {**d["camera"], "fps": FPS6A}}
    out["phase17"] = jax_vocab_run(jax_settings(d17), imgs, poses, seq17)
    revisit = imgs[REVISIT6A[0]:REVISIT6A[0] + 16]
    out["phase17"]["init_by_seed"] = {
        seed: jax_init_outcome(jax_settings(d17), revisit, seed) for seed in range(6)}
    print(json.dumps(out))
    print(json.dumps(slice6_summary(json.loads(json.dumps(out)), poses)))


# Slice 7: two SlamAgents (chip_smoke.py phase 18). Agent 1 takes frames
# 0..51 and agent 2 frames 28..79 of one trajectory over the dense world,
# one frame each per step, stamped step / 10; then flush() and 6 protocol
# iterations, as tests/test_multiagent.py:139-161.
FPS7 = 4.0                                 # a keyframe at least every 4 frames
SEGMENTS7 = {1: (0, 52), 2: (28, 80)}
N_STEPS7, N_IDLE7 = 52, 6
CONSOLE_MAPPER = dict(n_neighbors=4, ba_local=8, ba_fixed=8, ba_pts=2048, ba_iters=6)


def slice7_world(synthetic):
    """(world, trajectory) of phase 18 from either package's `synthetic`."""
    world = synthetic.PlaneWorld(seed=7, tex_size=2048, plane_z=6.0, extent=36.0, **DENSE_WORLD)
    return world, synthetic.smooth_trajectory(80, lateral=2.2, forward=0.6, yaw=0.08)


def _host_np(a, dtype=None):
    return np.asarray(a.cpu() if hasattr(a, "cpu") else a, dtype)


def agent_keyframes(m, kf_timestamps, lo, traj):
    """(estimated, ground-truth) world->camera poses of a map's valid
    keyframe slots, matched by timestamp (frame lo + ts * 10)."""
    n = int(m.n_kf)
    valid = _host_np(m.kf_valid)
    est, gt = [], []
    for slot, ts in kf_timestamps.items():
        i = lo + int(round(ts * 10))
        if slot < n and valid[slot] and i < len(traj):
            est.append(_host_np(m.kf_pose[slot], np.float32))
            gt.append(np.asarray(traj[i]))
    return np.stack(est), np.stack(gt)


def agents_keyframe_ate(agent, traj, metrics):
    """Sim3-aligned keyframe ATE of agent 2's map against ground truth
    (`tests/test_multiagent.py:187-203`): keyframe slots by timestamp."""
    est, gt = agent_keyframes(agent.map, agent.tracker.kf_timestamps, SEGMENTS7[2][0], traj)
    return float(metrics.ate_rmse(est, gt)[0]), len(est)


def merge_scale_gt(maps, traj, metrics):
    """The scale of S_ab that ground truth implies at a merge: `maps` holds
    (map, kf_timestamps, first frame) of the merging agent a and of its peer
    b, each aligned to ground truth by a Sim3 over its keyframes (X_w = S_i
    X_i), so S_ab = S_a^-1 S_b and its scale is s_b / s_a."""
    s_a, s_b = (float(metrics.ate_rmse(*agent_keyframes(m, ts, lo, traj))[2][7])
                for m, ts, lo in maps)
    return s_b / s_a


def _reference_slice7_main(seed_offset: int = 0):
    """The JAX package's CPU reference of phase 18: two `SlamAgent`s at
    `configs/euroc.yaml`'s tracker settings with camera.fps FPS7, the
    console's mapper and the shipped vocabulary, on one loopback bus.
    Prints the merge step, S_ab and the scale ground truth implies for it,
    the log kinds, keyframe counts by creator, the frame tree and agent 2's
    keyframe ATE as one JSON object (`chip_smoke.py`'s JAX_REF7).
    Asynchronous results count as landed on
    the next call (autonomous records, protocol records, the global BA), as
    the smoke's synchronized calls see them on the card (fault s). The
    trackers draw their two-view RANSAC from PRNGKey(agent id +
    `seed_offset`): which frames initialize, and with them when each agent
    reaches 12 keyframes and which agent finds the merge candidates, depend
    on those draws (fault o), so the smoke holds the card to the spread over
    offsets 0, 10, 20 and 30 (`--seed-offset N`)."""
    from dvm_slam_tpu.eval import metrics as jmetrics
    from dvm_slam_tpu.mapping import local_mapping as jlm
    from dvm_slam_tpu.multiagent import agent as jagent
    from dvm_slam_tpu.multiagent import transport as jtransport
    from dvm_slam_tpu.placerec import vocabulary as jvoc

    d = euroc_settings_dict()
    d["camera"]["fps"] = FPS7
    settings = jax_settings(d)
    cfg, K = settings.tracker_config(), settings.camera.K()
    h, w = cfg.frontend.height, cfg.frontend.width
    world, traj = slice7_world(jsyn)
    voc = jvoc.load(os.path.join(REPO, "data", "voc_default.npz"))
    bus = jtransport.LoopbackTransport()
    agents = {aid: jagent.SlamAgent(aid, cfg, K, np.zeros(4, np.float32), voc, bus, [1, 2],
                                    mapper=jlm.LocalMapper(**CONSOLE_MAPPER),
                                    rng_seed=aid + seed_offset)
              for aid in (1, 2)}
    merges, cur, events, kf_steps = [], [None], [], {1: [], 2: []}
    publish = bus.publish

    def publishing(sender, target, channel, msg):
        events.append((cur[0], sender, channel))
        return publish(sender, target, channel, msg)

    bus.publish = publishing
    jagent._dev_ready = lambda arr: True
    for a in agents.values():
        a.tracker._record_ready = lambda rec: True
        a._gba_ready = lambda: True
        receive_bows = a._receive_new_key_frame_bows

        def bows_in(m, a=a, receive_bows=receive_bows):
            n_log = len(a.log)
            receive_bows(m)
            found = [e[2] for e in a.log[n_log:] if e[0] == "merge_candidates"]
            events.append((cur[0], a.agent_id, "bows in", len(a._own_kf_slots()), found))

        a._receive_new_key_frame_bows = bows_in
        do_merge = a._do_merge

        def recording(peer_id, mB, metaB, S_ab, weld_kf, a=a, do_merge=do_merge):
            sides = [(x.map, dict(x.tracker.kf_timestamps), SEGMENTS7[x.agent_id][0])
                     for x in (a, agents[peer_id])]
            merges.append({"agent": a.agent_id, "step": cur[0], "S_ab": np.asarray(S_ab).tolist(),
                           "scale_gt": merge_scale_gt(sides, traj, jmetrics)})
            return do_merge(peer_id, mB, metaB, S_ab, weld_kf)

        a._do_merge = recording
    Kj = jnp.asarray(K)
    for step in range(N_STEPS7 + N_IDLE7):
        cur[0] = step
        if step == N_STEPS7:
            for a in agents.values():
                a.flush()
        for aid, (lo, hi) in SEGMENTS7.items():
            if step < N_STEPS7:
                img = np.asarray(world.render(jnp.asarray(traj[lo + step]), Kj, h, w))
                agents[aid].process_image(img, step * 0.1)
                kf_steps[aid].append(agents[aid].tracker.n_kf_host)
            else:
                agents[aid].run_once(step * 0.1)
    out = {"merges": merges, "events": events, "kf_steps": kf_steps}
    for aid, a in agents.items():
        n = int(a.map.n_kf)
        valid = np.asarray(a.map.kf_valid)[:n]
        out[str(aid)] = {
            "merged": bool(a.peers[3 - aid].successfully_merged),
            "log_kinds": sorted({e[0] for e in a.log}), "log": [list(map(str, e)) for e in a.log],
            "n_kf": n, "by_creator": {str(c): int((a.meta.kf_creator[:n][valid] == c).sum())
                                      for c in (1, 2)},
            "parent": a.frames.parent_frame, "invariants": bool(a.check_invariants())}
    out["ate2"], out["ate2_n"] = agents_keyframe_ate(agents[2], traj, jmetrics)
    out["bandwidth"] = bus.bandwidth_report()
    print(json.dumps(out))


def _reference_slice8_protocol_main(perturb: float = 0.0):
    """The JAX package's CPU reference of phase 22: `build_protocol_step` on
    a 4-device CPU mesh, on `chip_smoke.protocol_maps` (four agents at
    EuRoC capacity), PROTO_ROUNDS rounds with window 4, refresh_every 2,
    fusion, the welding BA, the essential graph and the global BA on. The
    RANSAC draws are the port's (`multi_agent.protocol_noise` from a CPU
    generator seeded `multi_agent.SEED`, one [A,A,200,F] block a round):
    the block goes in as the step's `keys` and `jax.random`'s key functions
    pass it through while the step runs, so `ransac_umeyama` reads receiver
    me's row for peer a where it would draw. Prints one JSON line per
    round (`chip_smoke.py`'s JAX_REF8["rounds"]). With `--perturb X` every
    map point moves by X times a standard normal draw first: the rounds'
    own sensitivity to f32 rounding (the global BA on a merged map is
    chaotic, fault t), which bounds S_peer after a refresh."""
    import jax
    import chip_smoke as cs
    from dvm_slam_tpu.parallel import multi_agent as jma
    from dvm_slam_tpu.placerec import vocabulary as jvoc
    from dvm_slam_tpu_torch.parallel import multi_agent as tma

    settings = jax_settings(euroc_settings_dict())
    cfg = settings.tracker_config()
    voc = jvoc.load(os.path.join(REPO, "data", "voc_default.npz"))
    maps_np, K = cs.protocol_maps()
    A = cs.PROTO_AGENTS
    rng = np.random.RandomState(1)
    for m in maps_np:
        m["pt_pos"] = (m["pt_pos"] + perturb * rng.randn(*m["pt_pos"].shape)).astype(np.float32)
    maps = jma.stack_agents([jms.MapState(**{k: jnp.asarray(v) for k, v in m.items()})
                             for m in maps_np])
    states = jma.stack_agents([jma.create_protocol_state(
        cs.PROTO_CAPS[0], voc.n_words, A, refresh_base=cs.PROTO_REFRESH) for _ in range(A)])
    step = jma.build_protocol_step(jma.make_mesh(A, jax.devices()[:A]), cfg, voc,
                                   window=cs.PROTO_WINDOW, refresh_every=cs.PROTO_REFRESH)
    gen = torch.Generator()
    gen.manual_seed(tma.SEED)
    Kb = jnp.asarray(np.tile(K, (A, 1)))
    rnd = jax.random
    saved = {n: getattr(rnd, n) for n in ("wrap_key_data", "fold_in", "split", "gumbel")}
    rnd.wrap_key_data = lambda k: k
    rnd.fold_in = lambda k, a: k[a]
    rnd.split = lambda k, n=2: k
    rnd.gumbel = lambda k, shape=(), *args, **kw: k
    try:
        for r in range(cs.PROTO_ROUNDS):
            noise = tma.protocol_noise(gen, A, 200, cs.PROTO_CAPS[2], "cpu").numpy()
            win = jnp.asarray(cs.protocol_windows(r))
            t0 = time.perf_counter()
            maps, states, M = step(maps, states, Kb, win, win, jnp.asarray(noise))
            jax.block_until_ready(maps)
            print(json.dumps({
                "round": r, "seconds": time.perf_counter() - t0,
                "noise_sum": float(noise.astype(np.float64).sum()),
                "M": np.asarray(M).astype(int).tolist(),
                "S_ok": np.asarray(states.S_ok).astype(int).tolist(),
                "merged": np.asarray(states.merged).astype(int).tolist(),
                "last_seen": np.asarray(states.last_seen).tolist(),
                "dropped": np.asarray(states.dropped).tolist(),
                "refresh_interval": np.asarray(states.refresh_interval).tolist(),
                "next_refresh": np.asarray(states.next_refresh).tolist(),
                "n_kf": np.asarray(maps.n_kf).tolist(), "n_pt": np.asarray(maps.n_pt).tolist(),
                "S_peer": np.asarray(states.S_peer).tolist()}), flush=True)
    finally:
        for n, f in saved.items():
            setattr(rnd, n, f)


SEGMENTS8 = {1: (0, 46), 2: (28, 78), 3: (62, 110)}   # tests/test_three_agents.py
N_IDLE8 = 8
TRAJ8 = dict(lateral=2.6, forward=0.7, yaw=0.08)


def _reference_slice8_agents_main(seed_offset: int = 0):
    """The JAX package's CPU reference of phase 23: `tests/test_three_agents.py`'s
    layout (chained overlaps, agents 1-3 on SEGMENTS8 of
    `smooth_trajectory(110, **TRAJ8)`, interleaved per step, then flush()
    and N_IDLE8 protocol rounds) at `configs/euroc.yaml`'s tracker settings
    with camera.fps FPS7, the console's mapper and the shipped vocabulary,
    on the smoke's dense world (fault o). Asynchronous results land on the
    next call, as in `--slice7`; the trackers draw from PRNGKey(agent id +
    `seed_offset`). Prints one JSON line: per agent the merged peers, the
    log kinds, the parent frame, the creators in its map and its ATE over
    its tracked trajectory (`tests/test_three_agents.py:101-114`), and the
    merge steps."""
    from dvm_slam_tpu.eval import metrics as jmetrics
    from dvm_slam_tpu.mapping import local_mapping as jlm
    from dvm_slam_tpu.multiagent import agent as jagent
    from dvm_slam_tpu.multiagent import transport as jtransport
    from dvm_slam_tpu.placerec import vocabulary as jvoc

    d = euroc_settings_dict()
    d["camera"]["fps"] = FPS7
    settings = jax_settings(d)
    cfg, K = settings.tracker_config(), settings.camera.K()
    h, w = cfg.frontend.height, cfg.frontend.width
    world = jsyn.PlaneWorld(seed=7, tex_size=2048, plane_z=6.0, extent=36.0, **DENSE_WORLD)
    traj = jsyn.smooth_trajectory(110, **TRAJ8)
    voc = jvoc.load(os.path.join(REPO, "data", "voc_default.npz"))
    bus = jtransport.LoopbackTransport()
    agents = {aid: jagent.SlamAgent(aid, cfg, K, np.zeros(4, np.float32), voc, bus, [1, 2, 3],
                                    mapper=jlm.LocalMapper(**CONSOLE_MAPPER),
                                    rng_seed=aid + seed_offset)
              for aid in (1, 2, 3)}
    jagent._dev_ready = lambda arr: True
    for a in agents.values():
        a.tracker._record_ready = lambda rec: True
        a._gba_ready = lambda: True
    Kj = jnp.asarray(K)
    steps = max(hi - lo for lo, hi in SEGMENTS8.values())
    merge_steps = {}
    for step in range(steps + N_IDLE8):
        if step == steps:
            for a in agents.values():
                a.flush()
        for aid, (lo, hi) in SEGMENTS8.items():
            a = agents[aid]
            n_log = len(a.log)
            if step >= steps:
                a.run_once(step * 0.1)
            elif lo + step < hi:
                img = np.asarray(world.render(jnp.asarray(traj[lo + step]), Kj, h, w))
                a.process_image(img, step * 0.1)
            for e in a.log[n_log:]:
                if e[0] in ("merged", "implicit_merge"):
                    merge_steps.setdefault(str(aid), []).append([e[0], int(e[1]), step])
    out = {"offset": seed_offset, "merge_steps": merge_steps}
    for aid, a in agents.items():
        n = int(a.map.n_kf)
        valid = np.asarray(a.map.kf_valid)[:n]
        est, gt = [], []
        for ts, T, _ in a.tracker.trajectory:
            i = SEGMENTS8[aid][0] + int(round(ts / 0.1))
            if i < len(traj):
                est.append(np.asarray(T, np.float32))
                gt.append(np.asarray(traj[i]))
        out[str(aid)] = {
            "merged": {str(p.agent_id): bool(p.successfully_merged) for p in a.peers},
            "log_kinds": sorted({e[0] for e in a.log}), "parent": a.frames.parent_frame,
            "creators": sorted({int(c) for c in a.meta.kf_creator[:n][valid]}),
            "n_kf": n, "ate": float(jmetrics.ate_rmse(np.stack(est), np.stack(gt))[0]),
            "n_poses": len(est), "invariants": bool(a.check_invariants())}
    out["bandwidth"] = bus.bandwidth_report()
    print(json.dumps(out), flush=True)


# Slice 9: the depth sensors and the fisheye camera (chip_smoke.py phases
# 24-26): the JAX package's System on the smoke's frames. Scenes and
# settings are chip_smoke's (a module without JAX).

def slice9_frames(phase: int, n_frames: int):
    """Phase `phase`'s inputs rendered by the JAX world: per frame the
    stereo pair (24), the image and its uint16 depth (25) or the fisheye
    image (26), and the ground-truth poses."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    world = jsyn.PlaneWorld(seed=7, tex_size=cs.TEX_SIZE, **cs.WORLD9[phase])
    poses = jsyn.smooth_trajectory(n_frames, **cs.TRAJ9[phase])
    from dvm_slam_tpu.io import config as jcfg

    cam = cs.settings9(phase, jcfg).camera
    Kj = jnp.asarray(cam.K())
    h, w = cam.out_height, cam.out_width
    frames = []
    for p in poses:
        T = jnp.asarray(p)
        if phase == 24:
            il, ir = world.render_stereo(T, Kj, h, w, cam.baseline)
            frames.append((np.array(il), np.array(ir)))
        elif phase == 25:
            frames.append((np.array(world.render(T, Kj, h, w)),
                           cs.depth_to_sensor(world.render_depth(T, Kj, h, w))))
        else:
            Ks, S = cs.fisheye_source(cam.params())
            field = cs.fisheye_field(cam.params(), h, w)
            frames.append((cs.warp_to_fisheye(world.render(T, jnp.asarray(Ks), S, S), field),))
    return frames, poses


class pipelined_head_repair:
    """The port's repair of the reference's pipelined retire (ROADMAP fault
    v), patched into the JAX tracker while the context is open: a keyframe
    made in `_retire_pipelined` leaves `last_pose`, the head of the
    prediction chain, where it was, unless a merge re-based the map."""

    def __enter__(self):
        cls = jtrk.MonocularTracker
        self.saved = (cls._retire_pipelined, cls._create_keyframe)
        retire, create = self.saved

        def retiring(t):
            t._in_retire = True
            try:
                return retire(t)
            finally:
                t._in_retire = False

        def creating(t, frame, res):
            head, epoch = t.last_pose, t.map_epoch
            create(t, frame, res)
            if getattr(t, "_in_retire", False) and t.map_epoch == epoch:
                t.last_pose = head

        cls._retire_pipelined, cls._create_keyframe = retiring, creating
        return self

    def __exit__(self, *exc):
        jtrk.MonocularTracker._retire_pipelined, jtrk.MonocularTracker._create_keyframe = self.saved


def jax_sensor_run(phase: int, frames, poses, agent_id: int = 0, n_calls=None):
    """Phase `phase`'s frames through the JAX package's System (stereo,
    RGB-D or the KB8 monocular) from frame 0 as agent `agent_id`, stopping
    after `n_calls` calls or, with `n_calls` None, running every frame and
    saving the trajectory. The tracker carries the port's repair of fault
    v. Returns a dict of the run's outcomes."""
    import tempfile

    import chip_smoke as cs
    from dvm_slam_tpu.eval import metrics as jmetrics
    from dvm_slam_tpu.geometry import two_view as jtv
    from dvm_slam_tpu.io import config as jcfg
    from dvm_slam_tpu.io import trajectory as jtraj
    from dvm_slam_tpu.models import system as jsys

    settings = cs.settings9(phase, jcfg)
    if phase in cs.REF9_CAPS:
        settings.kf_capacity, settings.pt_capacity = cs.REF9_CAPS[phase]
    fps = settings.camera.fps
    sensor = {24: "stereo", 25: "rgbd", 26: "monocular"}[phase]
    log = {"stereo_matches": [], "close_points": [], "inits": []}
    originals = (jex.make_frame_stereo, jex.make_frame_rgbd, jtrk.create_points_from_depth,
                 jtv.reconstruct_two_views)

    def counted(fn):
        def wrapped(*args, **kwargs):
            f = fn(*args, **kwargs)
            log["stereo_matches"].append(int(np.asarray(f.ur >= 0).sum()))
            return f
        return wrapped

    def close_points(m, slot, *args, **kwargs):
        m2, n = originals[2](m, slot, *args, **kwargs)
        log["close_points"].append((int(slot), int(n)))
        return m2, n

    def recording(*args, **kwargs):
        res = originals[3](*args, **kwargs)
        log["inits"].append(res)
        return res

    jex.make_frame_stereo, jex.make_frame_rgbd = counted(originals[0]), counted(originals[1])
    jtrk.create_points_from_depth, jtv.reconstruct_two_views = close_points, recording
    repair = pipelined_head_repair().__enter__()
    try:
        sysj = jsys.System(settings, sensor=sensor, agent_id=agent_id)
        t = sysj.tracker
        first_pose, init_pair = None, None
        for i, fr in enumerate(frames[:n_calls]):
            was = t.state
            if phase == 24:
                pose = sysj.track_stereo(fr[0], fr[1], i / fps)
            elif phase == 25:
                pose = sysj.track_rgbd(fr[0], fr[1], i / fps)
            else:
                pose = sysj.track_monocular(fr[0], i / fps)
            if pose is not None and first_pose is None:
                first_pose = i
            if was == jtrk.NOT_INITIALIZED and t.state == jtrk.OK and init_pair is None:
                init_pair = (int(round(t._init_ts * fps)) if phase == 26 else i, i)
                if n_calls is not None:
                    break
        out = {"init_pair": init_pair, "first_pose": first_pose}
        if phase == 26 and log["inits"]:
            res = log["inits"][-1]
            out["used_homography"] = bool(res.used_homography)
            out["n_init_good"] = int(np.asarray(res.good).sum())
        if n_calls is not None:
            return out
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "traj_tum.txt")
            sysj.save_trajectory_tum(path)
            rows = jtraj.load_tum(path)
    finally:
        repair.__exit__()
        (jex.make_frame_stereo, jex.make_frame_rgbd, jtrk.create_points_from_depth,
         jtv.reconstruct_two_views) = originals
    idx = [int(round(ts * fps)) for ts, _ in rows]
    est = np.stack([T for _, T in rows])
    gt = np.stack([np.asarray(poses[i]) for i in idx])
    n_kf = int(t.map.n_kf)
    ur = np.asarray(t.map.kf_ur[:n_kf])
    obs = np.asarray(t.map.kf_obs[:n_kf])
    out.update({
        "final_state": t.state,
        "tracked_frames": idx,
        "kf_frames": sorted(int(round(v * fps)) for v in t.kf_timestamps.values()),
        "n_kf": n_kf,
        "n_valid_points": int(np.asarray(t.map.pt_valid).sum()),
        "n_pt": int(t.map.n_pt),
        "stereo_matches": log["stereo_matches"],
        "close_points": log["close_points"],
        "stereo_obs": int(((ur >= 0) & (obs >= 0)).sum()),
        "ate_metric_m": cs.metric_ate(est, gt),
        "ate_sim3_m": float(jmetrics.ate_rmse(est, gt)[0]),
    })
    return out


def _reference_slice9_main(modes):
    """The JAX package's CPU references of chip_smoke.py's phases 24-26: one
    JSON line per mode (stereo, rgbd, kb8); for kb8 also the two-view init
    under the draws of agents 1-5 (on the first 16 frames)."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    for mode in modes:
        phase = {"stereo": 24, "rgbd": 25, "kb8": 26}[mode]
        t0 = time.time()
        frames, poses = slice9_frames(phase, cs.N_FRAMES9)
        out = jax_sensor_run(phase, frames, poses)
        if phase == 26:
            out["init_by_seed"] = {0: (out["init_pair"], out.get("used_homography"),
                                       out.get("n_init_good"))}
            for seed in range(1, 6):
                r = jax_sensor_run(phase, frames, poses, agent_id=seed, n_calls=16)
                out["init_by_seed"][seed] = (r["init_pair"], r.get("used_homography"),
                                             r.get("n_init_good"))
        out["mode"] = mode
        out["seconds"] = time.time() - t0
        print(json.dumps(out), flush=True)


def slice10_frames(phase: int):
    """Phase `phase`'s inputs rendered by the JAX world at the camera's full
    size (phase 27's black span zeroed), the IMU chunks and the ground
    truth: (frames, chunks, poses, velocities)."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from dvm_slam_tpu.io import config as jcfg

    settings = cs.settings10(phase, jcfg)
    cam = settings.camera
    world = jsyn.PlaneWorld(tex_size=cs.TEX_SIZE, **cs.WORLD10[phase])
    poses, chunks, vels = jsyn.vi_trajectory(cs.N_FRAMES10[phase], fps=cam.fps,
                                             imu_rate=settings.imu.frequency, **cs.TRAJ10[phase])
    Kj = jnp.asarray([cam.fx, cam.fy, cam.cx, cam.cy])
    h, w = cam.height, cam.width
    lo, hi = cs.BLANK10.get(phase, (0, 0))
    frames = []
    for i, p in enumerate(poses):
        T = jnp.asarray(p)
        if phase == 27:
            img = np.array(world.render(T, Kj, h, w))
            frames.append((img * (0.0 if lo <= i < hi else 1.0),))
        elif phase == 28:
            il, ir = world.render_stereo(T, Kj, h, w, cam.baseline)
            frames.append((np.array(il), np.array(ir)))
        else:
            frames.append((np.array(world.render(T, Kj, h, w)),
                           cs.depth_to_sensor(world.render_depth(T, Kj, h, w))))
    return frames, chunks, poses, vels


def jax_vi_run(phase: int, frames, chunks, agent_id: int = 0, n_calls=None, first: int = 0):
    """Phase `phase`'s frames (from `first`) through the JAX System's
    `track_*_inertial` as agent `agent_id`, the pipelined VI lane retiring
    at the next dispatch (`_record_ready` true); with `n_calls` it stops
    after the two-view init. Returns (outcomes dict, System)."""
    import tempfile

    import chip_smoke as cs
    from dvm_slam_tpu.io import config as jcfg
    from dvm_slam_tpu.io import trajectory as jtraj
    from dvm_slam_tpu.models import system as jsys

    settings = cs.settings10(phase, jcfg)
    fps = settings.camera.fps
    sysj = jsys.System(settings, sensor=cs.MODE10[phase], agent_id=agent_id)
    t = sysj.tracker
    t._record_ready = lambda rec: True
    init_pair, imu_init, live = None, None, {}
    for i in range(first, len(frames)):
        fr = frames[i]
        ts = (i - first) / fps
        was, imu0 = t.state, t.imu_initialized
        if phase == 27:
            pose = sysj.track_monocular_inertial(fr[0], ts, *chunks[i])
        elif phase == 28:
            pose = sysj.track_stereo_inertial(fr[0], fr[1], ts, *chunks[i])
        else:
            pose = sysj.track_rgbd_inertial(fr[0], fr[1], ts, *chunks[i])
        if pose is not None:
            live[i] = np.asarray(pose)
        if was == jtrk.NOT_INITIALIZED and t.state == jtrk.OK and init_pair is None:
            init_pair = (int(round(t._init_ts * fps)) + first if phase == 27 else i, i)
            if n_calls is not None:
                return {"init_pair": init_pair}, sysj
        if t.imu_initialized and not imu0:
            imu_init = (i, len(t.kf_chain))
        if n_calls is not None and i + 1 - first >= n_calls:
            return {"init_pair": init_pair}, sysj
    t.flush_pipeline()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "traj_tum.txt")
        sysj.save_trajectory_tum(path)
        rows = jtraj.load_tum(path)
    out = {"init_pair": init_pair, "imu_init": imu_init, "final_state": t.state,
           "tracked_frames": [int(round(ts * fps)) + first for ts, _ in rows],
           "kf_frames": sorted(int(round(v * fps)) + first for v in t.kf_timestamps.values()),
           "n_kf": int(t.map.n_kf)}
    run = {"frames": out["tracked_frames"], "poses": np.stack([T for _, T in rows]),
           "live": live, "imu_init": imu_init}
    return out, sysj, run


def _reference_slice10_main(modes, seed=None):
    """The JAX package's CPU references of chip_smoke.py's phases 27-30: one
    JSON line per mode (imu-mono, imu-stereo, imu-rgbd, merge); for imu-mono
    also the two-view init under the draws of agents 1-5, and with `seed`
    the whole imu-mono run under agent `seed`'s draws instead (one line of
    `JAX_REF10["imu-monocular"]["by_seed"]`)."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from dvm_slam_tpu.multiagent import agent as jagent
    from dvm_slam_tpu.multiagent import codec as jcodec
    from dvm_slam_tpu.multiagent import transport as jtransport
    from dvm_slam_tpu.placerec import vocabulary as jvocab
    from dvm_slam_tpu.geometry import lie as jlie

    phases = {"imu-mono": 27, "imu-stereo": 28, "imu-rgbd": 29, "merge": 28}
    for mode in modes:
        phase = phases[mode]
        t0 = time.time()
        frames, chunks, poses, vels = slice10_frames(phase)
        if seed is not None:
            out, sysj, run = jax_vi_run(phase, frames, chunks, agent_id=seed)
            print(json.dumps({"seed": seed, "init_pair": out["init_pair"],
                              "imu_init": out["imu_init"], "n_kf": out["n_kf"],
                              "ratio": cs.vi_ratio(phase, run, poses),
                              "final_state": out["final_state"],
                              "seconds": time.time() - t0}), flush=True)
            continue
        out, sysj, run = jax_vi_run(phase, frames, chunks)
        if mode == "merge":
            s2, sys2, _ = jax_vi_run(28, frames, chunks, first=cs.SEGMENT30)
            t1 = sysj.tracker
            mask = np.asarray(sys2.map.kf_valid).copy()
            mask[int(sys2.map.n_kf):] = False
            blob = jcodec.extract_submap(sys2.map, sys2.tracker.meta, mask).to_bytes()
            cfg = t1.config
            a = jagent.SlamAgent(1, cfg, np.asarray(sysj.settings.camera.K()),
                                 np.zeros(4, np.float32),
                                 jvocab.load(os.path.join(REPO, cs.VOCAB)),
                                 jtransport.LoopbackTransport(), [1, 2], autonomous=False)
            a.tracker = t1
            t1.meta.agent_id = 1
            mB, metaB = jcodec.materialize(jcodec.MapPacket.from_bytes(blob),
                                           cfg.frontend.capacity)
            a._do_merge(2, mB, metaB, np.asarray(jlie.sim3_identity()), t1.kf_chain[-1])
            a.flush_gba()
            fps = cfg.fps
            errs = {}
            for s in t1.kf_chain[-6:]:
                i = int(round(t1.kf_timestamps[s] * fps))
                if 0 <= i < len(vels):
                    errs[i] = float(np.linalg.norm(np.asarray(t1.kf_vel[s]) - vels[i]))
            out = {"vel_err": errs, "bias_g": float(np.linalg.norm(t1.bias_g)),
                   "bias_a": float(np.linalg.norm(t1.bias_a)),
                   "merged": ("merged", 2) in a.log,
                   "gba_applied": any(e[0] == "gba_applied" for e in a.log),
                   "system2": s2}
        else:
            out["ratio"] = cs.vi_ratio(phase, run, poses)
            if phase == 27:
                out["init_by_seed"] = {0: (out["init_pair"],)}
                for seed in range(1, 6):
                    r, _ = jax_vi_run(phase, frames, chunks, agent_id=seed, n_calls=24)
                    out["init_by_seed"][seed] = (r["init_pair"],)
        out["mode"] = mode
        out["seconds"] = time.time() - t0
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    if "--slice8" in sys.argv:  # the protocol runs on a 4-device CPU mesh
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    if "--slice10" in sys.argv:
        _reference_slice10_main([m for m in ("imu-mono", "imu-stereo", "imu-rgbd", "merge")
                                 if m in sys.argv] or ["imu-mono", "imu-stereo", "imu-rgbd",
                                                       "merge"],
                                int(sys.argv[sys.argv.index("--seed") + 1])
                                if "--seed" in sys.argv else None)
    elif "--slice9" in sys.argv:
        modes = [m for m in ("stereo", "rgbd", "kb8") if m in sys.argv] or ["stereo", "rgbd", "kb8"]
        _reference_slice9_main(modes)
    elif "--slice2" in sys.argv:
        _reference_slice2_main()
    elif "--slice3" in sys.argv:
        _reference_slice3_main()
    elif "--slice6" in sys.argv:
        _reference_slice6_main()
    elif "--slice8" in sys.argv and "--protocol" in sys.argv:
        _reference_slice8_protocol_main(
            float(sys.argv[sys.argv.index("--perturb") + 1]) if "--perturb" in sys.argv else 0.0)
    elif "--slice8" in sys.argv:
        offset = int(sys.argv[sys.argv.index("--seed-offset") + 1]) if "--seed-offset" in sys.argv else 0
        _reference_slice8_agents_main(offset)
    elif "--slice7" in sys.argv:
        offset = int(sys.argv[sys.argv.index("--seed-offset") + 1]) if "--seed-offset" in sys.argv else 0
        _reference_slice7_main(offset)
    else:
        _reference_main()
