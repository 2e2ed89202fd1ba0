"""The port's periphery against the JAX package: the PNG reader, the dataset
loaders, recording, verbose logging, `StageTimer`, the controllers, the
simulation harness, the viz exports and viewer, `plot_run`, `train_vocab`,
`circuit_trajectory` and `SlamAgent.send_loop_closure_triggers`.

Tolerances: images, stamps, paths, commands and robot states identical; the
PNG reader bit-identical to Pillow; ground-truth and synthetic poses within
1e-6 (f32 rounding of the two packages' Lie functions); renders within
RENDER_ATOL gray levels; exported floats within 1e-6.
"""

import dataclasses
import io
import json
import os
import struct
import types
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from PIL import Image

from dvm_slam_tpu.control import driver as jdrv
from dvm_slam_tpu.control.follow import FollowTheLeader as JFollow
from dvm_slam_tpu.control.nmpc import NmpcController as JNmpc
from dvm_slam_tpu.io import datasets as jds
from dvm_slam_tpu.io import recording as jrec
from dvm_slam_tpu.io import sim as jsim
from dvm_slam_tpu.io import synthetic as jsyn
from dvm_slam_tpu.io import viz as jviz
from dvm_slam_tpu.mapping import map_state as jms
from dvm_slam_tpu.utils import profiling as jprof
from dvm_slam_tpu.utils import verbose as jverbose

from dvm_slam_tpu_torch import convert
from dvm_slam_tpu_torch.control import driver as tdrv
from dvm_slam_tpu_torch.control.follow import FollowTheLeader as TFollow
from dvm_slam_tpu_torch.control.nmpc import NmpcController as TNmpc
from dvm_slam_tpu_torch.io import datasets as tds
from dvm_slam_tpu_torch.io import png
from dvm_slam_tpu_torch.io import recording as trec
from dvm_slam_tpu_torch.io import sim as tsim
from dvm_slam_tpu_torch.io import synthetic as tsyn
from dvm_slam_tpu_torch.io import viz as tviz
from dvm_slam_tpu_torch.utils import profiling as tprof
from dvm_slam_tpu_torch.utils import verbose as tverbose

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "mini_euroc")
POSE_ATOL = 1e-6
RENDER_ATOL = 1e-2   # gray levels of 255: f32 ray/plane rounding at texel edges
FLOAT_ATOL = 1e-6


# --------------------------------------------------------------------------
# the PNG reader
# --------------------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(arr, color: int, depth: int, filters, interlace: int = 0) -> bytes:
    """A PNG of `arr` ([H,W] or [H,W,C], big-endian samples of `depth` bits)
    whose row r uses filter `filters[r % len(filters)]` (Pillow's encoder
    picks its own filter per row, so the test writes the rows itself)."""
    arr = np.asarray(arr)
    h, w = arr.shape[:2]
    raw = arr.astype(">u2").view(np.uint8) if depth == 16 else arr.astype(np.uint8)
    raw = raw.reshape(h, -1).astype(np.int64)
    bpp = raw.shape[1] // w
    out, prior = [], np.zeros(raw.shape[1], np.int64)
    for r in range(h):
        x, ft = raw[r], filters[r % len(filters)]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        pred = [0, a, prior, (a + prior) // 2, _paeth(a, prior, c)][ft]
        out.append(bytes([ft]) + ((x - pred) % 256).astype(np.uint8).tobytes())
        prior = x

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


_FORMATS = {  # name -> (color type, bit depth, channels, dtype)
    "gray8": (0, 8, 1, np.uint8), "rgb8": (2, 8, 3, np.uint8),
    "rgba8": (6, 8, 4, np.uint8), "gray16": (0, 16, 1, np.uint16),
}


class TestPng:
    def test_fixture_frames_bit_identical(self):
        """All 120 mini_euroc frames: `read_gray` equals Pillow's
        `convert("L")` bit for bit (8-bit gray, mostly Paeth rows)."""
        names = sorted(os.listdir(os.path.join(FIXTURE, "mav0", "cam0", "data")))
        assert len(names) == 120
        for n in names:
            p = os.path.join(FIXTURE, "mav0", "cam0", "data", n)
            want = np.asarray(Image.open(p).convert("L"), np.float32)
            got = png.read_gray(p)
            assert got.dtype == np.float32 and got.shape == (180, 240)
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                             ids=["none", "sub", "up", "average", "paeth", "mixed"])
    @pytest.mark.parametrize("fmt", sorted(_FORMATS))
    def test_formats_and_filters_match_pillow(self, tmp_path, fmt, filters):
        """Files written with every filter type (and all five mixed row by
        row), read by Pillow and by the port: `read_gray` equals
        `convert("L")` (Pillow's integer luma for RGB and RGBA, saturation
        for 16-bit), `read_raw` of a grayscale file equals
        `np.asarray(Image.open(p), np.float32)` (16-bit depth kept raw)."""
        color, depth, ch, dtype = _FORMATS[fmt]
        rng = np.random.RandomState(7)
        shape = (23, 37) if ch == 1 else (23, 37, ch)
        arr = (rng.rand(*shape) * np.iinfo(dtype).max).astype(dtype)
        arr[:4] = arr[:4] // (300 if depth == 16 else 3)   # dark rows: 16-bit values < 255
        p = str(tmp_path / f"{fmt}.png")
        with open(p, "wb") as f:
            f.write(encode_png(arr, color, depth, filters))
        with Image.open(p) as im:
            want = np.asarray(im.convert("L"), np.float32)
            want_raw = np.asarray(im, np.float32)
        np.testing.assert_array_equal(png.read_gray(p), want)
        np.testing.assert_array_equal(png.read(p), arr)
        if ch == 1:
            np.testing.assert_array_equal(png.read_raw(p), want_raw)

    @pytest.mark.parametrize("kind", ["palette", "bilevel", "gray_alpha", "rgb16", "interlaced",
                                      "not_png", "corrupt"])
    def test_other_formats_raise(self, tmp_path, kind):
        rng = np.random.RandomState(1)
        img = (rng.rand(8, 9) * 255).astype(np.uint8)
        buf = io.BytesIO()
        if kind == "palette":
            Image.fromarray(img).convert("P").save(buf, format="PNG")
            data, match = buf.getvalue(), "palette"
        elif kind == "bilevel":
            Image.fromarray(img).convert("1").save(buf, format="PNG")
            data, match = buf.getvalue(), "1-bit grayscale"
        elif kind == "gray_alpha":
            Image.fromarray(img).convert("LA").save(buf, format="PNG")
            data, match = buf.getvalue(), "grayscale\\+alpha"
        elif kind == "rgb16":
            data = encode_png(np.stack([img.astype(np.uint16) * 200] * 3, -1), 2, 16, (0,))
            match = "16-bit RGB"
        elif kind == "interlaced":
            data, match = encode_png(img, 0, 8, (0,), interlace=1), "interlaced"
        elif kind == "not_png":
            data, match = b"GIF89a" + bytes(40), "not a PNG"
        else:
            data = bytearray(encode_png(img, 0, 8, (4,)))
            data[40] ^= 0xFF
            data, match = bytes(data), "CRC"
        p = str(tmp_path / "x.png")
        with open(p, "wb") as f:
            f.write(data)
        with pytest.raises(ValueError, match=match):
            png.read_gray(p)


# --------------------------------------------------------------------------
# dataset loaders
# --------------------------------------------------------------------------

def _write_png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _euroc_cam(root, cam, imgs, stamps_ns):
    base = os.path.join(root, "mav0", cam)
    rows = ["#timestamp [ns],filename"]
    for img, ts in zip(imgs, stamps_ns):
        _write_png(os.path.join(base, "data", f"{ts}.png"), img)
        rows.append(f"{ts},{ts}.png")
    with open(os.path.join(base, "data.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


def _tree(kind, root):
    """A small dataset tree of `kind`, written with Pillow; returns the
    (JAX, port) loader calls."""
    rng = np.random.RandomState(3)
    gray = [(rng.rand(30, 40) * 255).astype(np.uint8) for _ in range(5)]
    stamps = [1403636579763555584 + i * 50_000_000 for i in range(5)]
    if kind == "euroc_stereo":
        _euroc_cam(root, "cam0", gray, stamps)
        # cam1 misses the last pair and is off by 1 ms
        _euroc_cam(root, "cam1", gray[::-1][:4], [s + 1_000_000 for s in stamps[:4]])
        return jds.load_euroc_stereo, tds.load_euroc_stereo
    if kind in ("kitti_stereo", "kitti"):
        for cam in (0, 1):
            for i, g in enumerate(gray):
                _write_png(os.path.join(root, f"image_{cam}", f"{i:06d}.png"), g[:, ::1 - 2 * cam])
        with open(os.path.join(root, "times.txt"), "w") as f:
            f.write("".join(f"{i * 0.1:.6e}\n" for i in range(5)))
        return ((jds.load_kitti_stereo, tds.load_kitti_stereo) if kind == "kitti_stereo"
                else (jds.load_kitti, tds.load_kitti))
    # TUM: 8-bit RGB frames, 16-bit depth in sensor units (factor 5000)
    rgb = [(rng.rand(30, 40, 3) * 255).astype(np.uint8) for _ in range(5)]
    depth = [(rng.rand(30, 40) * 40000).astype(np.uint16) for _ in range(4)]
    rows_rgb, rows_d = ["# color images"], ["# depth maps"]
    for i, img in enumerate(rgb):
        t = 1305031102.175304 + i * 0.0333
        _write_png(os.path.join(root, "rgb", f"{t:.6f}.png"), img)
        rows_rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
    for i, d in enumerate(depth):
        t = 1305031102.175304 + i * 0.0333 + 0.004
        p = os.path.join(root, "depth", f"{t:.6f}.png")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        Image.fromarray(d).save(p)
        rows_d.append(f"{t:.6f} depth/{t:.6f}.png")
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("\n".join(rows_rgb) + "\n")
    with open(os.path.join(root, "depth.txt"), "w") as f:
        f.write("\n".join(rows_d) + "\n")
    return ((jds.load_tum_rgbd, tds.load_tum_rgbd) if kind == "tum_rgbd"
            else (jds.load_tum, tds.load_tum))


def _assert_items_equal(js, ts):
    assert len(ts) == len(js) > 0
    for a, b in zip(js, ts):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            assert y.dtype == np.float32
            np.testing.assert_array_equal(y, x)


class TestDatasets:
    def test_mini_euroc_matches_reference(self):
        """The committed fixture: identical stamps, paths and images, the
        same agents' split, ground-truth poses within POSE_ATOL."""
        js, ts = jds.load_euroc(FIXTURE), tds.load_euroc(FIXTURE)
        assert ts.stamps == js.stamps and len(ts) == 120
        assert [os.path.relpath(p, FIXTURE) for p in ts.paths] == \
            [os.path.relpath(p, FIXTURE) for p in js.paths]
        _assert_items_equal(js, ts)
        for n, ov in ((2, 0.5), (2, 0.25), (3, 0.25), (1, 0.0)):
            jp, tp = js.split_for_agents(n, overlap=ov), ts.split_for_agents(n, overlap=ov)
            assert [(p.stamps, p.paths) for p in tp] == [(p.stamps, p.paths) for p in jp]
        gt = os.path.join(FIXTURE, "gt_tum.txt")
        (js_t, jp), (ts_t, tp) = jds.load_groundtruth_tum(gt), tds.load_groundtruth_tum(gt)
        np.testing.assert_array_equal(ts_t, js_t)
        assert tp.dtype == np.float32 and tp.shape == jp.shape == (120, 7)
        np.testing.assert_allclose(tp, jp, atol=POSE_ATOL)

    @pytest.mark.parametrize("kind", ["euroc_stereo", "kitti_stereo", "kitti", "tum",
                                      "tum_rgbd"])
    def test_loaders_on_written_trees(self, tmp_path, kind):
        """Stereo, RGB-D and the other monocular layouts on small trees the
        test writes: the same pairs and stamps, identical images (RGB frames
        to Pillow's luma, 16-bit depth raw)."""
        jload, tload = _tree(kind, str(tmp_path))
        js, ts = jload(str(tmp_path)), tload(str(tmp_path))
        _assert_items_equal(js, ts)
        if kind == "euroc_stereo":
            assert len(ts) == 4
            assert ts.right_paths == js.right_paths
        if kind == "tum_rgbd":
            assert ts.depth_paths == js.depth_paths
            assert ts[0][2].max() > 255   # raw sensor units, not clipped


# --------------------------------------------------------------------------
# recording, verbose, StageTimer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(jrec, trec), (trec, jrec), (trec, trec)],
                         ids=["jax_to_port", "port_to_jax", "port_to_port"])
class TestRecording:
    def test_roundtrip_and_rate(self, tmp_path, rng, writer, reader):
        rec = writer.FrameRecorder()
        for i in range(5):
            rec.add(10.0 + i * 0.1, rng.rand(8, 10), gt_pose=np.arange(7) + i)
        p = str(tmp_path / "run.npz")
        rec.save(p)
        rep = reader.FrameReplay(p, rate=2.0)
        assert len(rep) == 5
        rows = list(rep)
        assert abs(rows[1][0] - rows[0][0] - 0.05) < 1e-9  # 2x rate
        np.testing.assert_allclose(rows[3][2], np.arange(7) + 3)
        rep2 = reader.FrameReplay(p, start=1, stop=3)
        assert len(rep2) == 2
        back = list(jrec.FrameReplay(p, rate=2.0))
        for a, b in zip(rows, back):
            assert a[0] == b[0]
            np.testing.assert_array_equal(a[1], b[1])

    def test_missing_gt(self, tmp_path, rng, writer, reader):
        rec = writer.FrameRecorder()
        rec.add(0.0, rng.rand(4, 4))
        p = str(tmp_path / "nogt.npz")
        rec.save(p)
        assert list(reader.FrameReplay(p))[0][2] is None


class TestVerbose:
    def test_levels(self, capsys):
        assert (tverbose.QUIET, tverbose.NORMAL, tverbose.VERBOSE, tverbose.VERY_VERBOSE,
                tverbose.DEBUG) == (jverbose.QUIET, jverbose.NORMAL, jverbose.VERBOSE,
                                    jverbose.VERY_VERBOSE, jverbose.DEBUG)
        tverbose.set_verbosity(tverbose.NORMAL)
        tverbose.print_mess("shown", tverbose.NORMAL)
        tverbose.print_mess("hidden", tverbose.DEBUG)
        out = capsys.readouterr().out
        assert "shown" in out and "hidden" not in out
        tverbose.set_verbosity(tverbose.DEBUG)
        assert tverbose.get_verbosity() == tverbose.DEBUG
        tverbose.print_mess("now shown", tverbose.DEBUG)
        assert "now shown" in capsys.readouterr().out
        tverbose.set_verbosity(tverbose.NORMAL)


class TestStageTimer:
    def test_stage_timer(self):
        slow = []
        t = tprof.StageTimer(slow_threshold_ms=0.0, on_slow=lambda n, ms: slow.append(n))
        with t.span("stage_a"):
            sum(range(1000))
        rep = t.report()
        assert "stage_a" in rep and rep["stage_a"]["n"] == 1
        assert slow == ["stage_a"]
        assert t.stop("never started") == 0.0
        j = jprof.StageTimer()
        with j.span("stage_a"):
            pass
        assert set(rep["stage_a"]) == set(j.report()["stage_a"])

    def test_dump(self, tmp_path):
        t = tprof.StageTimer()
        for _ in range(3):
            t.start("x")
            t.stop("x")
        p = str(tmp_path / "times.json")
        t.dump(p)
        with open(p) as f:
            assert json.load(f)["x"]["n"] == 3


# --------------------------------------------------------------------------
# control and sim
# --------------------------------------------------------------------------

def _nmpc_run(mod_nmpc, scenario):
    """The reference test's scenario through one package's controllers:
    every command and position."""
    out = []
    if scenario == "goal":
        c = mod_nmpc(robot_radius=0.5, vmax=1.0, seed=0)
        c.set_goal((3.0, 0.0))
        pos = np.array([0.0, 0.0])
        for t in range(120):
            v = c.step(pos, np.zeros((0, 2)), now=t * 0.1)
            pos = pos + np.asarray(v) * c.timestep
            out.append((v, pos.copy()))
    elif scenario == "head_on":
        cA = mod_nmpc(robot_radius=0.5, vmax=1.0, seed=1)
        cB = mod_nmpc(robot_radius=0.5, vmax=1.0, seed=2)
        cA.set_goal((4.0, 0.0))
        cB.set_goal((0.0, 0.0))
        pA, pB = np.array([0.0, 0.0]), np.array([4.0, 0.0])
        for t in range(200):
            vA = cA.step(pA, pB[None], now=t * 0.1)
            vB = cB.step(pB, pA[None], now=t * 0.1)
            pA = pA + np.asarray(vA) * cA.timestep
            pB = pB + np.asarray(vB) * cB.timestep
            out.append((vA, vB, pA.copy(), pB.copy()))
    else:
        c = mod_nmpc(robot_radius=0.4, vmax=1.0, seed=3)
        c.set_goal((3.0, 0.0))
        c.set_static_obstacles([(1.5, -2.0, 1.5, 2.0)])  # wall across the path
        pos = np.array([0.0, 0.0])
        for t in range(100):
            v = c.step(pos, np.zeros((0, 2)), now=t * 0.1)
            pos = pos + np.asarray(v) * c.timestep
            out.append((v, pos.copy(), float(c._segment_distances(pos[None])[0])))
    return out


class TestNmpc:
    @pytest.mark.parametrize("scenario", ["goal", "head_on", "static"])
    def test_same_commands_and_outcome(self, scenario):
        """`tests/test_control_sim_viz.py::TestNmpc`'s three scenarios:
        identical commands and states step by step, and the reference
        test's outcome bounds on the port's run."""
        ref, got = _nmpc_run(JNmpc, scenario), _nmpc_run(TNmpc, scenario)
        assert len(got) == len(ref)
        for a, b in zip(ref, got):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
        if scenario == "goal":
            assert np.linalg.norm(got[-1][1] - [3.0, 0.0]) < 0.3
        elif scenario == "head_on":
            min_d = min(float(np.linalg.norm(r[2] - r[3])) for r in got)
            assert min_d > 0.55
            assert np.linalg.norm(got[-1][2] - [4.0, 0.0]) < 0.6
            assert np.linalg.norm(got[-1][3] - [0.0, 0.0]) < 0.6
        else:
            assert min(r[2] for r in got) > 0.15


class TestFollowDriver:
    def test_follow_same_commands(self):
        ftl = [cls(position_offset=(0.0, -1.0), rotation_offset=0.0) for cls in (JFollow, TFollow)]
        states = [(np.array([3.0, 3.0]), 0.0), (np.array([3.0, 3.0]), 0.0)]
        for _ in range(100):
            for k, f in enumerate(ftl):
                my, yaw = states[k]
                v, w = f.step(my, yaw, leader_xy=(0.0, 0.0), leader_yaw=0.0)
                states[k] = (my + v * 0.1, yaw + w * 0.1)
            np.testing.assert_array_equal(states[1][0], states[0][0])
            assert states[1][1] == states[0][1]
        np.testing.assert_allclose(states[1][0], [0.0, -1.0], atol=0.05)

    @pytest.mark.parametrize("robot_type", ["robomaster", "sim", "sim_ground_truth"])
    def test_driver_same_twists(self, robot_type):
        sent = []
        jd = jdrv.Driver(robot_type=robot_type, max_linear_speed=1.0)
        td = tdrv.Driver(robot_type=robot_type, max_linear_speed=1.0, send_fn=sent.append)
        for v, w in (([0.5, 0.2], 0.3), ([3.0, 4.0], -2.0), ([0.0, 0.0], 0.0)):
            assert dataclasses.asdict(td.drive(v, w)) == dataclasses.asdict(jd.drive(v, w))
        assert len(sent) == 3 and sent[-1] == td.last_cmd
        cmd = tdrv.Driver(robot_type=robot_type).drive([3.0, 4.0])
        assert abs(np.hypot(cmd.linear_x, cmd.linear_y) - 1.0) < 1e-6
        if robot_type == tdrv.ROBOMASTER:
            cmd = td.drive([0.5, 0.2], 0.3)
            assert cmd.linear_x == 0.5 and cmd.linear_y == -0.2 and cmd.angular_z == -0.3


class TestSim:
    def test_robots_states_and_renders(self):
        """`SimulationServer` with two robots in both packages: identical
        states and times, ground truth within POSE_ATOL, renders within
        RENDER_ATOL; the reference test's motion checks on the port."""
        K = np.array([100.0, 100.0, 64.0, 48.0], np.float32)
        starts = [((0.0, 0.0), 0.0), ((1.0, 0.0), 0.3)]
        jw = jsyn.PlaneWorld(seed=1, tex_size=256, plane_z=6.0, extent=20.0)
        tw = tsyn.PlaneWorld(seed=1, tex_size=256, plane_z=6.0, extent=20.0, device="cpu")
        js = jsim.SimulationServer(jw, K, 96, 128, starts=starts, dt=0.1)
        ts = tsim.SimulationServer(tw, K, 96, 128, starts=starts, dt=0.1)
        for k in range(4):
            for s in (js, ts):
                s.set_cmd_vel(1, 1.0, 0.0)
                s.set_cmd_vel(2, -0.3, 0.2, 0.5)
            a, b = js.step_all(), ts.step_all()
            assert set(b) == {1, 2}
            for rid in (1, 2):
                assert b[rid][0] == a[rid][0]
                assert b[rid][1].shape == (96, 128) and b[rid][1].dtype == np.float32
                np.testing.assert_allclose(b[rid][2], a[rid][2], atol=POSE_ATOL)
                np.testing.assert_allclose(b[rid][1], a[rid][1], atol=RENDER_ATOL)
            assert ts.positions() == js.positions()
        r = ts.robots[1]
        assert abs(r.x - 0.4) < 1e-6 and ts.positions()[2][1] != 0.0


# --------------------------------------------------------------------------
# viz, the viewer, plot_run
# --------------------------------------------------------------------------

def _map_arrays():
    """A numpy map at capacity (8 keyframes, 256 points, 64 features): 5
    keyframe slots written (slot 3 invalid), overlapping observations so
    some pairs share 30 or more points, 200 valid points."""
    rng = np.random.RandomState(11)
    d = {k: np.asarray(v).copy() for k, v in jms.create(8, 256, 64)._asdict().items()}
    q = rng.randn(8, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    d["kf_pose"] = np.concatenate([q, rng.randn(8, 3).astype(np.float32)], 1)
    d["kf_valid"][:5] = True
    d["kf_valid"][3] = False
    for k in range(5):
        lo = 20 * k
        obs = np.full(64, -1, np.int32)
        obs[:60] = np.arange(lo, lo + 60)
        d["kf_obs"][k] = obs
    d["pt_pos"] = rng.randn(256, 3).astype(np.float32)
    d["pt_valid"][:200] = rng.rand(200) > 0.1
    d["n_kf"] = np.asarray(5, np.int32)
    d["n_pt"] = np.asarray(200, np.int32)
    return d


def _maps():
    d = _map_arrays()
    return (jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()}),
            convert.map_state_from_numpy(d))


def _agent(m, meta):
    frames = types.SimpleNamespace(tree=lambda: {"robot2/origin": {"parent": "robot1/origin",
                                                                   "S": [1.0] * 8}})
    peers = [types.SimpleNamespace(agent_id=1, successfully_merged=True),
             types.SimpleNamespace(agent_id=3, successfully_merged=False)]
    last = np.asarray([0.9, 0.1, -0.3, 0.2, 0.5, -1.0, 2.0], np.float32)
    last[:4] /= np.linalg.norm(last[:4])
    pose = torch.from_numpy(last) if isinstance(m.kf_pose, torch.Tensor) else jnp.asarray(last)
    return types.SimpleNamespace(
        agent_id=2, map=m, meta=meta, frames=frames, peers=peers,
        tracker=types.SimpleNamespace(last_pose=pose),
        log=[("loop_trigger", 3, 1), ("merged", 1), None, ("loop_trigger", 4, 0)])


def _assert_json_close(a, b):
    """Integer and string fields identical, floats within FLOAT_ATOL."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_json_close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_json_close(x, y)
    elif isinstance(a, float):
        assert isinstance(b, float) and abs(a - b) <= FLOAT_ATOL, (a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


class TestViz:
    def test_ply_bytes_identical(self, tmp_path):
        jm, tm = _maps()
        mask = np.random.RandomState(2).rand(256) > 0.5
        for name, kw in (("all", {}), ("tracked", {"tracked_mask": mask})):
            pj, pt = str(tmp_path / f"j_{name}.ply"), str(tmp_path / f"t_{name}.ply")
            jviz.export_pointcloud_ply(pj, jm, **({"tracked_mask": jnp.asarray(mask)} if kw
                                                  else {}))
            tviz.export_pointcloud_ply(pt, tm, **({"tracked_mask": torch.from_numpy(mask)} if kw
                                                  else {}))
            with open(pj, "rb") as a, open(pt, "rb") as b:
                assert b.read() == a.read()

    def test_markers_wireframe_and_state_json(self, tmp_path):
        """keyframe markers (with delta encoding), the wireframe, the frame
        tree and the state JSON: integer and string fields identical,
        floats within FLOAT_ATOL."""
        jm, tm = _maps()
        rng = np.random.RandomState(4)
        meta = types.SimpleNamespace(kf_uuid=rng.randint(0, 2**62, (8, 2)).astype(np.uint64),
                                     kf_creator=np.array([1, 1, 2, 2, 1, -1, -1, -1], np.int32))
        mk_t = tviz.keyframe_markers(tm, meta, min_covis=30)
        _assert_json_close(jviz.keyframe_markers(jm, meta, min_covis=30), mk_t)
        assert len(mk_t["keyframes"]) == 4 and mk_t["edges"]
        prev = {mk_t["keyframes"][0]["slot"]: mk_t["keyframes"][0]["T_cw"]}
        _assert_json_close(jviz.keyframe_markers(jm, None, changed_since=prev),
                           tviz.keyframe_markers(tm, None, changed_since=prev))
        T = np.asarray([1, 0, 0, 0, 0.1, 0.2, 0.3], np.float32)
        np.testing.assert_allclose(tviz.camera_wireframe(T, 0.3),
                                   np.asarray(jviz.camera_wireframe(T, 0.3)), atol=FLOAT_ATOL)
        ja, ta = _agent(jm, meta), _agent(tm, meta)
        assert tviz.frame_tree([ta]) == jviz.frame_tree([ja])
        dj = jviz.export_state_json(str(tmp_path / "j.json"), ja)
        dt = tviz.export_state_json(str(tmp_path / "t.json"), ta)
        _assert_json_close(dj, dt)
        with open(tmp_path / "j.json") as a, open(tmp_path / "t.json") as b:
            _assert_json_close(json.load(a), json.load(b))
        assert dt["loop_triggers"] == 2 and dt["merged_with"] == [1]

    def test_empty_map(self, tmp_path):
        """`TestVizProfiling::test_pointcloud_and_markers` on the port."""
        from dvm_slam_tpu_torch.mapping import map_state as tms

        m = tms.create(4, 32, 8)
        m, _ = tms.add_points(m, torch.from_numpy(np.random.RandomState(0).randn(5, 3)
                                                  .astype(np.float32)),
                              torch.zeros((5, 256), dtype=torch.uint8), torch.zeros((5, 3)),
                              torch.zeros(5), torch.ones(5), torch.tensor(0, dtype=torch.int32),
                              torch.ones(5, dtype=torch.bool))
        p = str(tmp_path / "cloud.ply")
        tviz.export_pointcloud_ply(p, m)
        lines = open(p).read().splitlines()
        assert lines[0] == "ply" and "element vertex 5" in lines[2]
        assert tviz.camera_wireframe(np.asarray([1, 0, 0, 0, 0, 0, 0], np.float32)).shape == (5, 3)
        mk = tviz.keyframe_markers(m)
        assert mk["keyframes"] == [] and mk["edges"] == []


class TestFrameDrawer:
    def test_draw_frame_overlay(self, rng):
        """The JAX front end's frame crossed through `convert`: the port's
        overlay equals the reference's; the port's own frame draws as the
        reference test asks."""
        from dvm_slam_tpu.frontend.extractor import FrontendConfig as JFC, extract as jextract
        from dvm_slam_tpu_torch.frontend.extractor import FrontendConfig as TFC, extract

        img = (rng.rand(96, 128) * 255).astype(np.float32)
        fj = jextract(jnp.asarray(img), JFC(height=96, width=128, n_features=100, n_levels=3))
        obs = np.full(fj.capacity, -1, np.int32)
        obs[:5] = 1  # pretend first 5 features track map points
        ft = convert.frame_from_numpy({k: np.asarray(v) for k, v in fj._asdict().items()
                                       if v is not None})
        want = jviz.draw_frame(img, fj, obs)
        got = tviz.draw_frame(torch.from_numpy(img), ft, torch.from_numpy(obs))
        np.testing.assert_array_equal(got, want)
        f = extract(torch.from_numpy(img), TFC(height=96, width=128, n_features=100, n_levels=3))
        rgb = tviz.draw_frame(img, f, obs[:f.capacity])
        assert rgb.shape == (96, 128, 3) and rgb.dtype == np.uint8
        assert (rgb[..., 1] == 220).any() or (rgb[..., 2] == 255).any()


class TestLiveViewer:
    def test_headless_png_frames(self, tmp_path):
        """`tests/test_io_system.py::TestLiveViewer` on the port's map."""
        from dvm_slam_tpu_torch.geometry import lie
        from dvm_slam_tpu_torch.mapping import map_state as tms

        m = tms.create(8, 256, 64)
        rng = np.random.RandomState(0)
        m = m._replace(pt_pos=torch.from_numpy(rng.randn(256, 3).astype(np.float32) + [0, 0, 5]),
                       pt_valid=torch.ones(256, dtype=torch.bool),
                       kf_valid=m.kf_valid.clone().index_fill_(0, torch.arange(3), True),
                       n_kf=torch.tensor(3, dtype=torch.int32))
        traj = [(i * 0.1, lie.se3_identity(), "OK") for i in range(5)]
        v = tviz.LiveViewer(out_dir=str(tmp_path), interactive=False)
        img = (rng.rand(120, 160) * 255).astype(np.float32)
        p1 = v.update(m, trajectory=traj, img=img, title="t")
        p2 = v.update(m)
        v.close()
        assert os.path.exists(p1) and os.path.getsize(p1) > 1000
        assert os.path.exists(p2)


def _figure_of(plot_run_fn, run_dir, tmp_path, tag):
    """The data the figure of `plot_run_fn(run_dir)` draws: each line's xy
    and each scatter's offsets, in drawing order."""
    import matplotlib.figure

    seen = []
    save = matplotlib.figure.Figure.savefig

    def capture(fig, *a, **k):
        ax = fig.axes[0]
        seen.append(([np.asarray(l.get_xydata()) for l in ax.get_lines()],
                     [np.asarray(c.get_offsets()) for c in ax.collections],
                     [t.get_text() for t in ax.get_legend().get_texts()]))
        return save(fig, *a, **k)

    matplotlib.figure.Figure.savefig = capture
    try:
        out = plot_run_fn(run_dir, str(tmp_path / f"{tag}.png"))
    finally:
        matplotlib.figure.Figure.savefig = save
    assert os.path.getsize(out) > 1000
    return seen[0]


class TestPlotRun:
    def test_same_figure_data(self, tmp_path):
        """A run directory with two robots (one without a map, trajectories,
        state JSON with keyframes and covisibility edges): the port's figure
        draws the reference's lines and points within FLOAT_ATOL."""
        from dvm_slam_tpu.tools import plot_run as jplot
        from dvm_slam_tpu_torch.io import trajectory as ttraj
        from dvm_slam_tpu_torch.tools import plot_run as tplot

        jm, tm = _maps()
        run = tmp_path / "run"
        run.mkdir()
        rng = np.random.RandomState(9)
        meta = types.SimpleNamespace(kf_uuid=np.zeros((8, 2), np.uint64),
                                     kf_creator=np.ones(8, np.int32))
        for aid in (1, 2):
            q = rng.randn(6, 4).astype(np.float32)
            q /= np.linalg.norm(q, axis=1, keepdims=True)
            rows = [(0.1 * i, np.concatenate([q[i], rng.randn(3).astype(np.float32)]), "OK")
                    for i in range(6)]
            ttraj.save_tum(str(run / f"robot{aid}_trajectory.txt"), rows)
            tviz.export_state_json(str(run / f"robot{aid}_state.json"), _agent(tm, meta))
        tviz.export_pointcloud_ply(str(run / "robot1_map.ply"), tm)
        fj = _figure_of(jplot.plot_run, str(run), tmp_path, "jax")
        ft = _figure_of(tplot.plot_run, str(run), tmp_path, "port")
        assert ft[2] == fj[2] == ["robot1 trajectory", "robot2 trajectory"]
        for a_list, b_list in zip(fj[:2], ft[:2]):
            assert len(a_list) == len(b_list) > 0
            for a, b in zip(a_list, b_list):
                np.testing.assert_allclose(b, a, atol=FLOAT_ATOL)
        np.testing.assert_allclose(tplot.load_ply(str(run / "robot1_map.ply")),
                                   jplot.load_ply(str(run / "robot1_map.ply")))


class TestTrainVocab:
    def test_main_trains_the_port_vocabulary(self, tmp_path, monkeypatch):
        """`train_vocab.main` on fixed descriptors: the saved vocabulary is
        `vocabulary.train`'s of them, node for node the JAX package's."""
        from dvm_slam_tpu.placerec import vocabulary as jvoc
        from dvm_slam_tpu_torch.placerec import vocabulary as tvoc
        from dvm_slam_tpu_torch.tools import train_vocab

        descs = (np.random.RandomState(5).rand(3000, 256) > 0.5).astype(np.uint8)
        seen = {}

        def collect(n, device="cuda"):
            seen["args"] = (n, device)
            return descs

        monkeypatch.setattr(train_vocab, "collect_descriptors", collect)
        out = str(tmp_path / "voc.npz")
        train_vocab.main([out, "--branch", "4", "--depth", "3", "--descs", "3000",
                          "--device", "cpu"])
        assert seen["args"] == (3000, "cpu")
        got, want = tvoc.load(out), jvoc.train(descs, branch=4, depth=3, seed=0)
        assert got.branch == 4 and got.depth == 3
        for a, b in zip(got.levels, want.levels):
            np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_allclose(got.idf, np.asarray(want.idf), atol=FLOAT_ATOL)


# --------------------------------------------------------------------------
# item 14f: circuit_trajectory and send_loop_closure_triggers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(n_frames=40, radius=1.5, forward=0.4, loops=1.5),
                                dict(n_frames=1)])
def test_circuit_trajectory(kw):
    kw = {"n_frames": 30, **kw}
    ref, got = jsyn.circuit_trajectory(**kw), tsyn.circuit_trajectory(**kw)
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        assert b.dtype == np.float32 and b.shape == (7,)
        np.testing.assert_allclose(b, np.asarray(a), atol=POSE_ATOL)


def test_send_loop_closure_triggers():
    """A JAX and a port `SlamAgent`, each on its own bus with a merged and
    an unmerged peer: the same messages to the same peers, each trigger
    sent once per peer."""
    from dvm_slam_tpu.frontend.extractor import FrontendConfig as JFC
    from dvm_slam_tpu.multiagent import agent as jagent, transport as jtr
    from dvm_slam_tpu.placerec import vocabulary as jvoc
    from dvm_slam_tpu.tracking import tracker as jtrk
    from dvm_slam_tpu_torch.frontend.extractor import FrontendConfig as TFC
    from dvm_slam_tpu_torch.multiagent import agent as tagent, transport as ttr
    from dvm_slam_tpu_torch.placerec import vocabulary as tvoc
    from dvm_slam_tpu_torch.tracking import tracker as ttrk

    voc_path = os.path.join(REPO, "data", "voc_default.npz")
    K = np.array([100.0, 100.0, 64.0, 48.0], np.float32)
    sent = {}
    for name, agent_mod, tr, trk, fc, voc, kw in (
            ("jax", jagent, jtr, jtrk, JFC, jvoc, {}),
            ("port", tagent, ttr, ttrk, TFC, tvoc, {"device": "cpu"})):
        cfg = trk.TrackerConfig(frontend=fc(height=96, width=128, n_features=100, n_levels=3),
                                kf_cap=8, pt_cap=256)
        bus = tr.LoopbackTransport()
        log = sent[name] = []
        publish = bus.publish

        def recording(sender, target, channel, msg, publish=publish, log=log):
            log.append((sender, target, channel, type(msg).__name__,
                        dataclasses.asdict(msg)))
            return publish(sender, target, channel, msg)

        bus.publish = recording
        a = agent_mod.SlamAgent(2, cfg, K, np.zeros(4, np.float32), voc.load(voc_path), bus,
                                [1, 2, 3], **kw)
        for p in a.peers:
            p.successfully_merged = p.agent_id == 1
        log.clear()
        a.send_loop_closure_triggers([(1, 2), (3, 4)])
        a.send_loop_closure_triggers([(3, 4), (5, 6)])
        a.send_loop_closure_triggers([(5, 6)])
    assert sent["port"] == sent["jax"]
    assert [m[4]["trigger_key_frame_uuids"] for m in sent["port"]] == [[(1, 2), (3, 4)],
                                                                      [(5, 6)]]
    assert {m[1] for m in sent["port"]} == {1}
