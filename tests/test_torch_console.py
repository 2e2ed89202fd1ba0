"""The port's operator console (`tools/console.py`) against the JAX
package's: the settings and vocabulary of smoke phase 31, a short
`run_dataset` (`tests/test_io_system.py::TestRunDataset`: 24 rendered frames
written as a EuRoC tree, one agent), `run_dataset_sensor` on a written
stereo tree (`tests/test_stereo.py::TestStereoConsoleReplay`'s scene), the
recorded files and `evaluate`, and the CLI. The full two-agent run on
`tests/fixtures/mini_euroc` is marked `slow`, as the reference's is.

Both packages run on the CPU; the port's two-view RANSAC replays the JAX
tracker's draws (`test_torch_system.reference_noise`), the short run the JAX
run's two-view results (fault o), and the JAX stereo
System carries the port's repair of fault v (`pipelined_head_repair`).
Bounds: the same paired frames, keyframes within 1, ATE under 3x the JAX
run's and under ATE_BOUND_M (`tests/test_io_system.py:214`); the vocabulary
node for node.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from PIL import Image

from dvm_slam_tpu.geometry import lie as jlie
from dvm_slam_tpu.geometry import two_view as jtv
from dvm_slam_tpu.io import config as jcfg
from dvm_slam_tpu.io import datasets as jds
from dvm_slam_tpu.io import synthetic as jsyn
from dvm_slam_tpu.tools import console as jcon

from dvm_slam_tpu_torch.geometry import two_view as ttv
from dvm_slam_tpu_torch.io import config as tcfg
from dvm_slam_tpu_torch.io import datasets as tds
from dvm_slam_tpu_torch.tools import console as tcon

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_slice import pipelined_head_repair  # noqa: E402
from test_torch_system import reference_noise  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "mini_euroc")
ATE_BOUND_M = 0.15
RUN_FILES = ("robot1_trajectory.txt", "robot1_state.json", "robot1_map.ply", "bandwidth.json",
             "gt.bin", "evaluation.json")


def _replaying(build):
    """`console.build_agents` with each port agent's RANSAC replaying the
    JAX tracker's draws (PRNGKey(agent id))."""
    def building(*args, **kw):
        agents = build(*args, **kw)
        for aid, a in agents.items():
            a.tracker._ransac_noise = reference_noise(aid)
        return agents
    return building


def _gt_row(ts_ns, T_cw):
    Twc = jlie.se3_inv(jnp.asarray(T_cw))
    q, t = np.asarray(Twc[:4]), np.asarray(Twc[4:])
    return f"{ts_ns * 1e-9:.6f} {t[0]} {t[1]} {t[2]} {q[1]} {q[2]} {q[3]} {q[0]}"


class TestSmokeInputs:
    def test_settings_dict_matches_fixture(self):
        """`chip_smoke.MINI_EUROC_SETTINGS` (the card has no YAML parser) is
        the fixture's settings.yaml: `settings_from_dict` of it equals both
        packages' `load_settings` of the file."""
        sys.path.insert(0, REPO)
        import chip_smoke

        path = os.path.join(FIXTURE, "settings.yaml")
        got = dataclasses.asdict(tcfg.settings_from_dict(dict(chip_smoke.MINI_EUROC_SETTINGS)))
        assert got == dataclasses.asdict(tcfg.load_settings(path))
        assert got == dataclasses.asdict(jcfg.load_settings(path))
        assert got == dataclasses.asdict(chip_smoke.mini_euroc_settings())

    def test_file_ate_matches_the_reference_metric(self, tmp_path):
        """`chip_smoke.file_ate31` (phase 31's own ATE from the written
        trajectories): on trajectory files holding mini_euroc's ground-truth
        centers under a Sim3 plus 1 cm noise, written with each agent's
        relative stamps, the same paired frames as the console's pairing
        and the JAX `ate_rmse` of those pairs within 1e-5 m."""
        sys.path.insert(0, REPO)
        import chip_smoke
        from dvm_slam_tpu.eval import metrics as jmetrics

        gt_stamps, gt_cw = jds.load_groundtruth_tum(os.path.join(FIXTURE, "gt_tum.txt"))
        gt_wc = np.asarray(jlie.se3_inv(jnp.asarray(gt_cw)))
        parts = jds.load_euroc(FIXTURE).split_for_agents(2, overlap=0.5)
        rng = np.random.default_rng(11)
        w = rng.normal(size=3)
        c, s_, sn = np.cos(np.linalg.norm(w)), np.sin(np.linalg.norm(w)), w / np.linalg.norm(w)
        Kx = np.array([[0, -sn[2], sn[1]], [sn[2], 0, -sn[0]], [-sn[1], sn[0], 0]])
        R = np.eye(3) * c + s_ * Kx + (1 - c) * np.outer(sn, sn)
        want = {}
        for ai, part in enumerate(parts):
            est_cw, ref_cw, lines = [], [], []
            for ts in part.stamps:
                i = int(np.argmin(np.abs(gt_stamps - ts)))
                center = 1.7 * R @ gt_wc[i, 4:] + (0.3, -0.2, 0.5) + rng.normal(0, 0.01, 3)
                row = np.concatenate([gt_wc[i, :4], center]).astype(np.float32)
                lines.append(f"{ts - part.stamps[0]:.6f} {row[4]:.7f} {row[5]:.7f} {row[6]:.7f} "
                             f"{row[1]:.7f} {row[2]:.7f} {row[3]:.7f} {row[0]:.7f}")
                if abs(gt_stamps[i] - ts) < 0.05:
                    est_cw.append(np.asarray(jlie.se3_inv(jnp.asarray(row))))
                    ref_cw.append(gt_cw[i])
            (tmp_path / f"robot{ai + 1}_trajectory.txt").write_text("\n".join(lines) + "\n")
            want[str(ai + 1)] = (len(est_cw), float(jmetrics.ate_rmse(
                np.stack(est_cw), np.stack(ref_cw))[0]))
        got = chip_smoke.file_ate31(str(tmp_path))
        assert set(got) == set(want)
        for aid, (n, ate) in want.items():
            assert got[aid][0] == n >= 30
            assert abs(got[aid][1] - ate) < 1e-5, (aid, got[aid], ate)

    def test_vocabulary_from_fixture_frames(self):
        """`train_vocabulary_from_frames` on `run_dataset`'s 8 sample frames
        of mini_euroc: the port's vocabulary is the JAX one node for node."""
        seq = tds.load_euroc(FIXTURE)
        sample = [img for _, img in seq[:: max(len(seq) // 10, 1)]][:8]
        s = tcfg.load_settings(os.path.join(FIXTURE, "settings.yaml"))
        js = jcfg.load_settings(os.path.join(FIXTURE, "settings.yaml"))
        tv = tcon.train_vocabulary_from_frames(sample, s.tracker_config(), s.camera.K(),
                                               device="cpu")
        jv = jcon.train_vocabulary_from_frames(sample, js.tracker_config(), js.camera.K())
        assert (tv.branch, tv.depth) == (jv.branch, jv.depth) == (8, 2)
        for a, b in zip(tv.levels, jv.levels):
            np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_allclose(tv.idf, np.asarray(jv.idf), atol=1e-6)

    def test_entry_points_default_to_the_card(self):
        """Every entry point takes `device`, "cuda" unless the caller asks
        for the CPU; on a host without a card the default raises instead of
        running on the CPU."""
        import inspect

        for fn in (tcon.build_agents, tcon.train_vocabulary_from_frames, tcon.run_synthetic,
                   tcon.run_dataset, tcon.run_dataset_sensor):
            assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
        s = tcfg.load_settings(os.path.join(FIXTURE, "settings.yaml"))
        if not torch.cuda.is_available():
            with pytest.raises((AssertionError, RuntimeError)):
                tcon.train_vocabulary_from_frames([np.zeros((180, 240), np.float32)],
                                                  s.tracker_config(), s.camera.K())


@pytest.fixture(scope="module")
def short_runs(tmp_path_factory):
    """`TestRunDataset`'s 24 frames at 180x240 (EuRoC tree, TUM ground
    truth, native settings) through both packages' `run_dataset` with one
    agent. The two-view init is near-degenerate on this world, and the two
    packages' f32 eight-point solvers part on it (ROADMAP fault o): the port
    replays the JAX run's two-view results, call by call."""
    root = tmp_path_factory.mktemp("euroc")
    world = jsyn.PlaneWorld(seed=3, tex_size=512, plane_z=6.0, extent=30.0)
    K = np.array([200.0, 200.0, 120.0, 90.0], np.float32)
    base = root / "mav0" / "cam0"
    (base / "data").mkdir(parents=True)
    rows, gt_rows = ["#ts,filename"], []
    for i, T in enumerate(jsyn.smooth_trajectory(24, lateral=1.5, forward=0.4)):
        img = np.asarray(world.render(jnp.asarray(T), jnp.asarray(K), 180, 240))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(base / "data" / f"{i}.png")
        ts_ns = 1000000000 + i * 100000000
        rows.append(f"{ts_ns},{i}.png")
        gt_rows.append(_gt_row(ts_ns, T))
    (base / "data.csv").write_text("\n".join(rows))
    gt_path = root / "gt.txt"
    gt_path.write_text("\n".join(gt_rows))
    settings = root / "settings.yaml"
    settings.write_text(
        "camera:\n  model: pinhole\n  fx: 200.0\n  fy: 200.0\n  cx: 120.0\n"
        "  cy: 90.0\n  dist: [0.0, 0.0, 0.0, 0.0]\n  width: 240\n  height: 180\n"
        "  fps: 5.0\norb:\n  n_features: 500\nkf_capacity: 32\npt_capacity: 2048\n")
    out, inits = {}, []
    original = jtv.reconstruct_two_views
    with pytest.MonkeyPatch.context() as mp:
        for name, con in (("jax", jcon), ("port", tcon)):
            run_dir = str(root / f"out_{name}")
            kw = {}
            if name == "jax":
                mp.setattr(jtv, "reconstruct_two_views",
                           lambda *a, **k: inits.append(original(*a, **k)) or inits[-1])
            else:
                mp.undo()
                replay = [ttv.TwoViewResult(*(torch.from_numpy(np.array(x)) for x in res))
                          for res in inits]
                mp.setattr(ttv, "reconstruct_two_views", lambda *a, **k: replay.pop(0))
                mp.setattr(tcon, "build_agents", _replaying(tcon.build_agents))
                kw = {"device": "cpu"}
            rep = con.run_dataset(str(root), fmt="euroc", settings_path=str(settings),
                                  n_agents=1, out_dir=run_dir, gt_path=str(gt_path), **kw)
            with open(os.path.join(run_dir, "robot1_state.json")) as f:
                out[name] = (rep, run_dir, json.load(f))
    return out


class TestRunDataset:
    def test_same_outcome_as_reference(self, short_runs):
        (jrep, _, jstate), (trep, _, tstate) = short_runs["jax"], short_runs["port"]
        ja, ta = jrep["agents"]["1"], trep["agents"]["1"]
        assert ta["frames"] == ja["frames"] > 5, (trep, jrep)
        assert abs(tstate["n_keyframes"] - jstate["n_keyframes"]) <= 1
        assert ta["ate_rmse_m"] < min(3.0 * ja["ate_rmse_m"], ATE_BOUND_M), (trep, jrep)

    def test_recorded_files_and_evaluate(self, short_runs):
        """Every file of the recording exists; `evaluate` of the port's run
        directory reproduces its report, and so does the JAX `evaluate` of
        the same directory (the formats cross)."""
        trep, run_dir, tstate = short_runs["port"]
        for name in RUN_FILES:
            assert os.path.exists(os.path.join(run_dir, name)), name
        assert tcon.evaluate(run_dir) == trep
        jrep = jcon.evaluate(run_dir)
        assert jrep["bandwidth"] == trep["bandwidth"]
        assert jrep["agents"]["1"]["frames"] == trep["agents"]["1"]["frames"]
        assert abs(jrep["agents"]["1"]["ate_rmse_m"] - trep["agents"]["1"]["ate_rmse_m"]) < 1e-6
        _, jdir, jstate = short_runs["jax"]
        assert set(tstate) == set(jstate)
        with open(os.path.join(run_dir, "robot1_map.ply")) as f:
            assert f.readline() == "ply\n"

    def test_cli_evaluate(self, short_runs, capsys):
        trep, run_dir, _ = short_runs["port"]
        tcon.main(["evaluate", "--run-dir", run_dir])
        assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(trep))


def _stereo_tree(root):
    """`tests/test_stereo.py::TestStereoConsoleReplay`'s tree: 12 rendered
    rectified pairs at 240x320 in the EuRoC layout, TUM ground truth and
    native settings with the baseline."""
    H, W, BASELINE = 240, 320, 0.12
    K = np.asarray([260.0, 260.0, 160.0, 120.0], np.float32)
    world = jsyn.PlaneWorld(seed=3, tex_size=1024, plane_z=6.0, extent=30.0)
    poses = jsyn.smooth_trajectory(12, lateral=1.4, forward=0.4, yaw=0.05)
    gt_rows = []
    for cam in ("cam0", "cam1"):
        d = root / "mav0" / cam / "data"
        d.mkdir(parents=True)
        rows = []
        for i, p in enumerate(poses):
            ts_ns = int(1e9 * (100 + i * 0.1))
            il, ir = world.render_stereo(jnp.asarray(p), jnp.asarray(K), H, W, BASELINE)
            name = f"{ts_ns}.png"
            Image.fromarray(np.asarray(il if cam == "cam0" else ir).astype(np.uint8)).save(d / name)
            rows.append(f"{ts_ns},{name}")
            if cam == "cam0":
                gt_rows.append(_gt_row(ts_ns, p))
        (root / "mav0" / cam / "data.csv").write_text("\n".join(rows) + "\n")
    (root / "gt_tum.txt").write_text("\n".join(gt_rows) + "\n")
    (root / "settings.yaml").write_text(
        f"camera:\n  fx: {K[0]}\n  fy: {K[1]}\n  cx: {K[2]}\n  cy: {K[3]}\n"
        f"  width: {W}\n  height: {H}\n  dist: [0.0, 0.0, 0.0, 0.0]\n  fps: 10.0\n"
        f"  baseline: {BASELINE}\norb:\n  n_features: 600\n  n_levels: 4\n"
        "kf_capacity: 16\npt_capacity: 4096\n")


class TestRunDatasetSensor:
    def test_stereo_replay_matches_reference(self, tmp_path):
        """`run_dataset_sensor(sensor="stereo")` in both packages: the same
        frames with a pose, keyframes within 1, metric (unscaled) ATE under
        3x the JAX run's and ATE_BOUND_M; the port's settings given as a
        `SystemSettings`."""
        root = tmp_path / "seq"
        _stereo_tree(root)
        with pipelined_head_repair():
            jrep = jcon.run_dataset_sensor(str(root), sensor="stereo",
                                           settings_path=str(root / "settings.yaml"),
                                           out_dir=str(tmp_path / "jax"),
                                           gt_path=str(root / "gt_tum.txt"))
        trep = tcon.run_dataset_sensor(str(root), sensor="stereo",
                                       settings_path=tcfg.load_settings(
                                           str(root / "settings.yaml")),
                                       out_dir=str(tmp_path / "port"),
                                       gt_path=str(root / "gt_tum.txt"), device="cpu")
        assert trep["frames"] == jrep["frames"] >= 10, (trep, jrep)
        assert abs(trep["n_keyframes"] - jrep["n_keyframes"]) <= 1
        assert trep["state"] == jrep["state"] == "OK"
        assert trep["ate_rmse_metric_m"] < min(3.0 * jrep["ate_rmse_metric_m"], ATE_BOUND_M), \
            (trep, jrep)
        with open(tmp_path / "port" / "evaluation.json") as f:
            assert json.load(f) == json.loads(json.dumps(trep))
        with pytest.raises(ValueError, match="unknown sensor"):
            tcon.run_dataset_sensor(str(root), sensor="monocular",
                                    settings_path=str(root / "settings.yaml"),
                                    out_dir=str(tmp_path / "x"), device="cpu")


@pytest.mark.slow
class TestMiniEurocFixture:
    def test_run_dataset_end_to_end(self, tmp_path):
        """`tests/test_dataset_integration.py::TestMiniEurocFixture` on the
        port (CPU): two agents split the out-and-back sequence, each with at
        least 30 paired frames and a Sim3-aligned ATE under 0.15 m, and a
        merge on real imagery."""
        out = str(tmp_path / "run")
        rep = tcon.run_dataset(FIXTURE, fmt="euroc",
                               settings_path=os.path.join(FIXTURE, "settings.yaml"),
                               n_agents=2, out_dir=out, overlap=0.5,
                               gt_path=os.path.join(FIXTURE, "gt_tum.txt"), device="cpu")
        assert "agents" in rep and rep["agents"], rep
        for a in rep["agents"].values():
            assert a["frames"] >= 30, rep
            assert a["ate_rmse_m"] < 0.15, rep
        for name in ("robot1_trajectory.txt", "bandwidth.json", "evaluation.json"):
            assert os.path.exists(os.path.join(out, name))
        merged = []
        for aid in (1, 2):
            with open(os.path.join(out, f"robot{aid}_state.json")) as f:
                merged.append(json.load(f).get("merged_with", []))
        assert merged[0] or merged[1], f"agents never merged on the fixture overlap: {merged}"

    def test_loader_parses_fixture(self):
        seq = tds.load_euroc(FIXTURE)
        assert len(seq) == 120
        ts, img = seq[0]
        assert img.shape == (180, 240) and img.dtype == np.float32
        assert img.std() > 10.0
        assert ts == jds.load_euroc(FIXTURE)[0][0]


@pytest.mark.slow
@pytest.mark.skipif(not os.environ.get("EUROC_ROOT"),
                    reason="set EUROC_ROOT=/path/to/EuRoC/MH_01 to run the full-sequence test")
class TestFullEuroc:
    def test_full_sequence_tracks(self, tmp_path):
        """`tests/test_dataset_integration.py::TestFullEuroc` on the port, on
        the card when there is one."""
        root = os.environ["EUROC_ROOT"]
        gt = os.environ.get("EUROC_GT")
        rep = tcon.run_dataset(root, fmt="euroc", n_agents=1, out_dir=str(tmp_path / "run"),
                               max_frames=int(os.environ.get("EUROC_MAX_FRAMES", "500")),
                               gt_path=gt, device="cuda" if torch.cuda.is_available() else "cpu")
        if gt:
            assert next(iter(rep["agents"].values()))["ate_rmse_m"] < 0.5
        else:
            assert rep.get("run_dir")
