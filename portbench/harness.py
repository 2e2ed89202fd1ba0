"""One run of one cell: set-up, the measured window, the traced stretch, the
check against the plain reference, and the result line.

The window opens on a warm state (the sequence rendered, the entry driven
through the traffic's `warm_frames`, the device synchronised, the garbage
collected) and feeds frames in a closed loop with one caller, as a replay of
a recording does. Once `seconds` have passed it keeps feeding until the
next pose comes back, and ends there: `host_frames_per_s` is the poses
returned inside the window over the time from its start to that return,
after a synchronise. A pose comes back when it enters the agent's
trajectory (the autonomous lane retires four at a time, a frame or two
late; the pipelined lane at the frame's own call). A traced run profiles a
stretch of `trace_frames` after the window, so that both kinds of run time
the same window. `device_memory_gib` is the device memory the system holds
at its peak over set-up and window: the allocator's peak less what the
benchmark's own inputs (the rendered sequence, the world) hold on the card.
"""

from __future__ import annotations

import gc
import importlib.util
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import manifest, reference, tracing, world as world_mod

BANNED = ("jax", "jaxlib", "flax", "dvm_slam_tpu")
PROBE_LAUNCHES = 2000
PROBE_LOOP = 1_000_000   # iterations of the host's pure-Python probe
IN_FLIGHT_MARGIN = 64    # frames rendered beyond the window's share
BA_MIN_OBS = 3           # observations a point needs to be judged after local BA


class RunError(RuntimeError):
    """A run that cannot give a result: it prints none and exits non-zero."""


def banned_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in BANNED)


def load_metric(root: Path, name: str):
    """The reader module `portbench/metrics/<name>.py`, found by its name."""
    path = root / manifest.BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launch_probe(device) -> float:
    """µs per launch of PROBE_LAUNCHES tiny device ops ending in a
    synchronise: the host's launch speed, recorded beside each window."""
    x = torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    t = time.perf_counter()
    for _ in range(PROBE_LAUNCHES):
        x.add_(1.0)
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t) / PROBE_LAUNCHES * 1e6


def cpu_probe() -> float:
    """Milliseconds of PROBE_LOOP iterations of a pure-Python loop: the
    host's own speed for one thread, recorded beside each window."""
    t = time.perf_counter()
    acc = 0
    for i in range(PROBE_LOOP):
        acc += i & 7
    return (time.perf_counter() - t) * 1e3


def smi() -> dict:
    """The card's SM clock (MHz), power draw and limit (W) from nvidia-smi."""
    keys = ("clocks.sm", "power.draw", "power.limit")
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(keys)}",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30).stdout.splitlines()[0]
        return {k: float(v) for k, v in zip(keys, out.split(","))}
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return {}


class Cell:
    """The system under test and its inputs for one run."""

    def __init__(self, spec: dict, root: Path, seed: int, device, seconds: float,
                 control=None):
        from dvm_slam_tpu_torch.io import config as config_mod
        from dvm_slam_tpu_torch.models import system as system_mod

        cfg, traffic = spec["config"], spec["traffic"]
        self.device = torch.device(device)
        self.cfg = cfg
        settings = config_mod.settings_from_dict(cfg["settings"])
        for key in ("autonomous", "auto_batch", "async_depth"):
            if key in cfg["settings"]:
                setattr(settings, key, cfg["settings"][key])
        self.settings = settings
        cam = settings.camera
        self.fps = float(cam.fps)
        # the frames a window of `seconds` can use at the camera's own rate,
        # after the warm frames, with room for the traced stretch and the
        # dispatches in flight at the close; a program that feeds faster
        # than the camera runs out, and the run says so
        self.n_frames = min(int(traffic["frames"]),
                            int(traffic["warm_frames"]) + math.ceil(seconds * self.fps)
                            + int(traffic["trace_frames"]) + IN_FLIGHT_MARGIN)
        t = time.perf_counter()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        self.world = world_mod.World(traffic, gen, self.device)
        self.R_wc, self.centers = world_mod.camera_path(traffic["trajectory"], self.n_frames)
        K = (cam.fx, cam.fy, cam.cx, cam.cy)
        self.frames = world_mod.render_sequence(
            self.world, self.R_wc, self.centers, K, cam.height, cam.width,
            float(traffic["noise_sigma"]), gen, views=cfg["views"])
        self.sync()
        # the benchmark's own inputs on the card, left out of the system's memory
        self.input_bytes = (torch.cuda.memory_allocated(self.device)
                            if self.device.type == "cuda" else 0)
        self.setup_parts = {"render_s": time.perf_counter() - t}
        t = time.perf_counter()
        voc = cfg.get("vocabulary")
        self.agents = [system_mod.System(settings, sensor=cfg["sensor"], agent_id=a,
                                         vocabulary_file=None if voc is None else str(root / voc),
                                         device=self.device)
                       for a in range(int(cfg.get("agents", 1)))]
        self.starts = traffic.get("agent_start_frames", [0] * len(self.agents))
        self.setup_parts["system_s"] = time.perf_counter() - t
        if control == "tf32":
            # the control: the program's f32 matrix products in TF32
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        elif control is not None:
            raise RunError(f"unknown control {control!r}")
        self.fed = 0
        self.t_in = {}
        self._seen = [0] * len(self.agents)

    def feed(self):
        """Hand the next frame to every agent's entry."""
        i = self.fed
        if max(self.starts) + i >= self.n_frames:
            raise RunError(f"the sequence ran out after {self.n_frames} frames, as many as "
                           f"the window can use at the camera's {self.fps} frames/s: the "
                           "window never loops back over frames already seen")
        self.t_in[i] = time.perf_counter()
        for agent, s in zip(self.agents, self.starts):
            views = self.frames[s + i]
            getattr(agent, self.cfg["entry"])(*views, (s + i) / self.fps)
        self.fed += 1

    def returned(self) -> int:
        return sum(len(a.tracker.trajectory) for a in self.agents)

    def new_rows(self) -> list:
        """Feed indices of the poses that came back since the last call."""
        out = []
        for j, (a, s) in enumerate(zip(self.agents, self.starts)):
            rows = a.tracker.trajectory[self._seen[j]:]
            self._seen[j] += len(rows)
            out += [int(round(ts * self.fps)) - s for ts, _, _ in rows]
        return out

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def measure(cell, seconds: float, clock=time.perf_counter) -> tuple:
    """The window: feed frames until `seconds` have passed and then until
    the next pose comes back. Returns (poses returned inside the window, its start, its end after a
    synchronise, [(seconds into the window, poses so far)] at each return).
    Poses of frames fed before the start that come back
    inside count, as those fed inside that come back after the end do not:
    in a steady state the two edges hold the same work in flight."""
    n0 = n_prev = cell.returned()
    t0 = clock()
    deadline = t0 + seconds
    returns = []
    while True:
        cell.feed()
        n = cell.returned()
        t = clock()
        if n > n_prev:
            returns.append((round(t - t0, 4), n - n0))
            if t >= deadline:
                break
        n_prev = n
    cell.sync()
    return n - n0, t0, clock(), returns


def trace_after(cell, stretch):
    """Feed on past the window until the traced stretch has ended."""
    n_prev = cell.returned()
    while True:
        cell.feed()
        n = cell.returned()
        if n > n_prev and not stretch.on_return(n, time.perf_counter()):
            return
        n_prev = n


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool, root: Path,
             device=None, control=None, t_start=None) -> tuple:
    """One run. Returns (result dict, check lines, host record)."""
    t_start = time.perf_counter() if t_start is None else t_start
    t_cell = time.perf_counter()
    spec = manifest.load_cell(workload, root)
    traffic = spec["traffic"]
    if device is None:
        chips = int(spec["cell"]["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise RunError(f"{workload} needs {chips} CUDA device(s); "
                           f"torch.cuda.is_available() = {torch.cuda.is_available()}")
        device = "cuda:0"
    cell = Cell(spec, root, seed, device, seconds, control)
    on_card = cell.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(cell.device)
    warm = int(traffic["warm_frames"])
    t = time.perf_counter()
    for _ in range(warm):
        cell.feed()
    cell.setup_parts.update(imports_s=t_cell - t_start, warm_s=time.perf_counter() - t)
    if any(a.tracker.state != "OK" for a in cell.agents):
        raise RunError(f"after {warm} warm frames the tracker states are "
                       f"{[a.tracker.state for a in cell.agents]}, not OK")
    host = {"cores": len(os.sched_getaffinity(0)), "threads": torch.get_num_threads(),
            "probe_us_before": launch_probe(cell.device) if on_card else None,
            "smi_before": smi() if on_card else {},
            "cpu_ms_before": cpu_probe()}
    cell.sync()
    gc.collect()

    # ---- the measured window
    tr_spec = manifest.load_json(root / manifest.BENCH_DIR / "spans.json")
    stretch = tracing.Stretch(cell, tr_spec, int(traffic["trace_frames"])) if trace_on else None
    i0 = cell.fed
    frames, t0, t_end, returns = measure(cell, seconds)
    setup_s = t0 - t_start
    fed_window = cell.fed - i0
    mem_peak = torch.cuda.max_memory_allocated(cell.device) if on_card else None
    host["probe_us_after"] = launch_probe(cell.device) if on_card else None
    host["smi_after"] = smi() if on_card else {}
    host["cpu_ms_after"] = cpu_probe()
    if stretch is not None:
        trace_after(cell, stretch)

    # ---- every answer due: retire what is in flight, then read the outputs
    for a in cell.agents:
        a.tracker.drain_auto()
    outputs = [_outputs(a, cell.fps) for a in cell.agents]
    kf_window = sum(sum(i0 <= k - s < i0 + fed_window for k in o["kf_frames"])
                    for o, s in zip(outputs, cell.starts))
    window_frames = set(range(i0, cell.fed))   # the window's and the traced stretch's
    failed = sum(len(window_frames - {k - s for k in o["row_frames"]})
                 for o, s in zip(outputs, cell.starts))
    del cell.agents
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    numbers = _check(cell, outputs)
    numbers["poses_missing"] = failed   # frames of the window that never got a pose

    readings = dict(setup_s=setup_s, window_s=t_end - t0, frames=frames,
                    keyframes=kf_window, fed=fed_window,
                    memory_gib=None if mem_peak is None
                    else (mem_peak - cell.input_bytes) / 2**30)
    if trace_on:
        readings["trace"] = stretch.readings(on_card)
    metrics = {}
    for m in (spec["per_layer"] if trace_on else spec["end_to_end"]):
        value = load_metric(root, m["name"]).read(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = spec["checks"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(cell.device) if on_card else "cpu",
                "count": 1 if on_card else 0, "memory_peak_bytes": mem_peak}
    if trace_on and "busy_s" in readings["trace"]:
        dev_info["busy_s"] = readings["trace"]["busy_s"]
        dev_info["window_s"] = readings["trace"]["window_s"]
    result = {"correct": correct, "attempted": fed_window, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace_on and "device_ops" in readings["trace"]:
        result["breakdown"] = {"device_ops": readings["trace"]["device_ops"],
                               "idle_gaps": readings["trace"]["idle_gaps"]}
    result["checks"] = checks
    host.update(workload=workload, seed=seed, trace=int(trace_on), setup_s=setup_s,
                setup_parts=cell.setup_parts,
                window_s=t_end - t0, frames=frames, frames_per_s=frames / (t_end - t0),
                input_bytes=cell.input_bytes, keyframes=kf_window, returns=returns,
                compared={k: numbers[k] for k in numbers if k.startswith("n_")},
                pose_errors=numbers["pose_errors"])
    lines = [f"check {k}: {c['value']!r} <= {c['limit']!r}" for k, c in checks.items()]
    return result, lines, host


def _outputs(agent, fps: float) -> dict:
    """The answers one agent gave, on the host: its returned poses with
    their frame indices, and its keyframes and map points."""
    t = agent.tracker
    rows = [(int(round(ts * fps)), np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p,
                                              np.float64)) for ts, p, _ in t.trajectory]
    m = agent.map
    n_kf = int(m.n_kf)
    kf_valid = m.kf_valid.cpu().numpy()
    kfs = [(s, int(round(ts * fps))) for s, ts in sorted(t.kf_timestamps.items())
           if s < n_kf and kf_valid[s]]
    slots = [s for s, _ in kfs]
    get = lambda x: x[slots].cpu().numpy()  # noqa: E731
    obs = m.kf_obs[slots].cpu().numpy()
    pt_valid = m.pt_valid.cpu().numpy()
    obs = np.where((obs >= 0) & pt_valid[np.clip(obs, 0, None)], obs, -1)
    n_obs = np.bincount(obs[obs >= 0].ravel(), minlength=len(pt_valid))
    pt_pos = m.pt_pos.cpu().numpy()
    return dict(row_frames=[k for k, _ in rows], rows=rows, kf_frames=[k for _, k in kfs],
                kf_pose=get(m.kf_pose), kf_xy=get(m.kf_xy), kf_level=get(m.kf_level),
                kf_angle=get(m.kf_angle), kf_desc=get(m.kf_desc),
                kf_feat_valid=get(m.kf_feat_valid), kf_obs=obs, pt_pos_all=pt_pos,
                pt_pos=pt_pos[pt_valid], pt_obs=n_obs[pt_valid])


def _check(cell: Cell, outputs: list) -> dict:
    """The numbers compared, worked out by the plain reference."""
    cam_cfg, orb_cfg = cell.cfg["settings"]["camera"], cell.cfg["settings"]["orb"]
    sx = (cam_cfg.get("new_width") or cam_cfg["width"]) / cam_cfg["width"]
    sy = (cam_cfg.get("new_height") or cam_cfg["height"]) / cam_cfg["height"]
    K = (cam_cfg["fx"] * sx, cam_cfg["fy"] * sy, cam_cfg["cx"] * sx, cam_cfg["cy"] * sy)
    with_scale = cell.cfg["sensor"] == "monocular"
    kfs, est, gt, frames, kf_est, kf_gt, kf_pose, kf_R, pts, pt_obs = ([] for _ in range(10))
    for o, s in zip(outputs, cell.starts):
        for (k, pose) in o["rows"]:
            est.append(reference.centers_of(pose)[0])
            gt.append(cell.centers[k])
            frames.append(k)
        kf_est.append(reference.centers_of(o["kf_pose"]))
        kf_gt.append(cell.centers[np.asarray(o["kf_frames"], np.int64)])
        kf_R.append(cell.R_wc[np.asarray(o["kf_frames"], np.int64)])
        kf_pose.append(o["kf_pose"])
        for j, k in enumerate(o["kf_frames"]):
            kfs.append((k, o["kf_xy"][j], o["kf_level"][j], o["kf_angle"][j], o["kf_desc"][j],
                        o["kf_feat_valid"][j]))
        pts.append(o["pt_pos"])
        pt_obs.append(o["pt_obs"])
    bits, angle, kp_odd, n_feat = reference.check_keyframes(
        kfs, cell.frames, (cell.settings.camera.out_height, cell.settings.camera.out_width),
        orb_cfg)
    ate, _, err = reference.ate(np.asarray(est), np.asarray(gt), with_scale)
    kf_ate, _, _ = reference.ate(np.concatenate(kf_est), np.concatenate(kf_gt), with_scale)
    sim = reference.align_poses(np.concatenate(kf_pose), np.concatenate(kf_R),
                                np.concatenate(kf_gt), with_scale)
    map_med, n_pts = reference.map_error(np.concatenate(pts), np.concatenate(pt_obs), sim,
                                         cell.world)
    # local BA: how far the reference moves the points of the newest
    # keyframe that another keyframe sees too, each to where its
    # observations put it (the newest keyframe's BA was the last to run)
    shift = []
    for o in outputs:
        if not o["kf_frames"]:
            continue
        obs = o["kf_obs"]
        P = len(o["pt_pos_all"])
        kf_of = np.zeros((len(obs), P), bool)
        r_, f_ = np.nonzero(obs >= 0)
        kf_of[r_, obs[r_, f_]] = True
        ids = np.nonzero(kf_of[int(np.argmax(o["kf_frames"]))] & (kf_of.sum(0) >= 2))[0]
        p_ref, p_prog, n_in = reference.refine_points(
            o["kf_pose"], o["kf_xy"], o["kf_level"], obs, o["pt_pos_all"], K,
            float(orb_cfg["scale_factor"]), ids)
        shift.append(sim[0] * np.linalg.norm(p_ref - p_prog, axis=1)[n_in >= BA_MIN_OBS])
    shift = np.concatenate(shift) if shift else np.zeros(0)
    # where the pose error lies, for the host record: every 10th pose's
    sampled = [[int(k), round(float(e), 4)] for k, e in zip(frames, err)][::10]
    return dict(desc_bits_worst_kf=bits, angle_gap_rad=angle, keypoints_odd_worst_kf=kp_odd,
                ate_m=ate, kf_ate_m=kf_ate, map_median_m=map_med,
                ba_point_shift_m=float(np.median(shift)) if len(shift) else math.nan,
                n_features=n_feat, n_poses=len(est), n_keyframes=len(kfs), n_points=n_pts,
                n_ba_points=int(len(shift)), pose_errors=sampled)
