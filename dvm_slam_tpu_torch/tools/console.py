"""Operator console: experiment runner, recorder, replayer, evaluator.

Port of `dvm_slam_tpu/tools/console.py`, the CLI replacement for
`src/central_management_interface` (the PyQt operator GUI,
`central_management_interface/main.py`): dataset/synthetic replay into N
agents (the `ros2 bag play` remapping path, `main.py:270-317`), run
recording of trajectories + transmission stats (the `ros2 bag record` topic
set, `main.py:364-379`), and offline evaluation (the evo notebook,
`src/evaluation/evaluation.ipynb`): per-agent ATE RMSE after Sim3 alignment
+ per-channel bandwidth.

The agents run on `device` (`--device`, default `cuda`; `--device cpu` runs
the plain versions of the kernels on the CPU). Settings are a YAML path or
a `SystemSettings`; the files a run writes are the JAX package's:
`robot{aid}_trajectory.txt`, `robot{aid}_state.json`, `robot{aid}_map.ply`,
`bandwidth.json`, `gt.bin` and `evaluation.json`.

Usage:
  python -m dvm_slam_tpu_torch.tools.console run-synthetic --agents 2 --frames 80
  python -m dvm_slam_tpu_torch.tools.console run-dataset --root <dir> --agents 2
  python -m dvm_slam_tpu_torch.tools.console run-dataset --root <dir> --device cpu
  python -m dvm_slam_tpu_torch.tools.console evaluate --run-dir out/
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A pose (tensor on any device, or array) as a host f32 array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float32)
    return np.asarray(x, np.float32)


def _settings(settings_path, fmt: str):
    """A `SystemSettings` as given, or loaded from its YAML path (the
    format's `configs/{fmt}.yaml` when None)."""
    from ..io import config as config_mod

    if isinstance(settings_path, config_mod.SystemSettings):
        return settings_path
    if settings_path is None:
        settings_path = os.path.join(os.path.dirname(__file__), "..", "..", "configs",
                                     f"{fmt}.yaml")
    return config_mod.load_settings(settings_path)


def build_agents(n_agents, cfg, K, voc, bus, mapper_kw=None, device="cuda"):
    from ..mapping import local_mapping
    from ..multiagent.agent import SlamAgent

    mapper_kw = mapper_kw or dict(n_neighbors=4, ba_local=8, ba_fixed=8,
                                  ba_pts=2048, ba_iters=6)
    ids = list(range(1, n_agents + 1))
    return {
        aid: SlamAgent(aid, cfg, K, np.zeros(4, np.float32), voc, bus, ids,
                       mapper=local_mapping.LocalMapper(**mapper_kw), device=device)
        for aid in ids
    }


def train_vocabulary_from_frames(imgs, cfg, K, n_desc=6000, device="cuda"):
    """A branch-8, depth-2 vocabulary from the ORB descriptors the front end
    extracts on `device` from `imgs` (numpy or tensors)."""
    from ..frontend.extractor import make_frame
    from ..placerec import vocabulary

    dev = torch.device(device)
    Kt = torch.as_tensor(np.asarray(K, np.float32), device=dev)
    dist = torch.zeros(4, device=dev)
    descs = []
    for im in imgs:
        img = torch.as_tensor(im, dtype=torch.float32).to(dev)
        f = make_frame(img, Kt, dist, cfg.frontend)
        descs.append(f.desc[f.valid].cpu().numpy())
    return vocabulary.train(np.concatenate(descs)[:n_desc], branch=8, depth=2)


def run_synthetic(n_agents=2, n_frames=80, out_dir="out_synth", seed=3,
                  height=240, width=320, fps=4.0, n_features=600, device="cuda"):
    """N agents split one synthetic trajectory with overlap — BASELINE.json
    configs 3-5 in miniature; the world renders on `device`."""
    from ..frontend.extractor import FrontendConfig
    from ..io import synthetic
    from ..multiagent import transport
    from ..tracking import tracker as trk

    os.makedirs(out_dir, exist_ok=True)
    K = np.array([width * 0.8, width * 0.8, width / 2, height / 2], np.float32)
    world = synthetic.PlaneWorld(seed=seed, tex_size=1024, plane_z=6.0, extent=30.0,
                                 device=device)
    traj = synthetic.smooth_trajectory(n_frames, lateral=2.2, forward=0.6, yaw=0.08)
    cfg = trk.TrackerConfig(
        frontend=FrontendConfig(height=height, width=width, n_features=n_features),
        kf_cap=96, pt_cap=6144, fps=fps,
    )
    sample = [world.render(traj[i], K, height, width) for i in range(0, n_frames // 2, 8)]
    voc = train_vocabulary_from_frames(sample, cfg, K, device=device)

    bus = transport.LoopbackTransport()
    agents = build_agents(n_agents, cfg, K, voc, bus, device=device)

    # overlapping segments
    seg = int(n_frames / (n_agents - (n_agents - 1) * 0.35)) if n_agents > 1 else n_frames
    step = int(seg * 0.65)
    segs = {aid: (min((aid - 1) * step, n_frames - seg),
                  min((aid - 1) * step, n_frames - seg) + seg)
            for aid in agents}
    gt = {aid: [] for aid in agents}
    for t in range(max(hi - lo for lo, hi in segs.values())):
        for aid, (lo, hi) in segs.items():
            i = lo + t
            if i >= hi:
                continue
            img = world.render(traj[i], K, height, width)
            ts = t * 0.1
            pose = agents[aid].process_image(img, ts)
            if pose is not None:
                gt[aid].append((ts, _host(pose), traj[i]))
    for a in agents.values():
        a.flush()  # end of stream: dispatch buffered frames, retire flags
    for e in range(6):
        for a in agents.values():
            a.run_once((t + 1 + e) * 0.1)

    record_run(out_dir, agents, bus, gt)
    return evaluate(out_dir)


def run_dataset(dataset_root, fmt="euroc", settings_path=None, n_agents=2,
                out_dir="out_dataset", overlap=0.25, max_frames=None,
                gt_path=None, device="cuda"):
    """Replay a real dataset split across N agents (the rosbag-remap
    evaluation flow, `central_management_interface/main.py:270-317`).
    `settings_path`: a YAML path or a `SystemSettings`."""
    from ..io import datasets
    from ..multiagent import transport

    os.makedirs(out_dir, exist_ok=True)
    loaders = {"euroc": datasets.load_euroc, "tum": datasets.load_tum,
               "kitti": datasets.load_kitti}
    seq = loaders[fmt](dataset_root)
    if max_frames:
        seq = seq[:max_frames]
    settings = _settings(settings_path, fmt)
    cfg = settings.tracker_config()
    K = settings.camera.K()

    # vocabulary from a frame sample
    sample = [img for _, img in seq[:: max(len(seq) // 10, 1)]]
    voc = train_vocabulary_from_frames(sample[:8], cfg, K, device=device)

    bus = transport.LoopbackTransport()
    agents = build_agents(n_agents, cfg, K, voc, bus, device=device)
    parts = seq.split_for_agents(n_agents, overlap=overlap)

    gt_poses = None
    if gt_path:
        gt_stamps, gt_all = datasets.load_groundtruth_tum(gt_path)
        gt_poses = (gt_stamps, gt_all)

    gt = {aid: [] for aid in agents}
    iters = [iter(p) for p in parts]
    stamps0 = [p.stamps[0] for p in parts]
    done = [False] * n_agents
    while not all(done):
        for ai, (aid, a) in enumerate(sorted(agents.items())):
            if done[ai]:
                continue
            try:
                ts, img = next(iters[ai])
            except StopIteration:
                done[ai] = True
                continue
            a.process_image(img, ts - stamps0[ai])
    for a in agents.values():
        a.flush()  # end of stream: dispatch buffered frames, retire flags
    for e in range(6):
        for a in agents.values():
            a.run_once(1e9 + e)
    # pair ground truth AFTER the run from the (drained) per-frame
    # trajectory — the streamed return pose runs up to auto_batch +
    # async_depth frames stale in the production autonomous mode, exactly
    # like the reference's offline evo evaluation pairs from recorded bags
    if gt_poses is not None:
        for ai, (aid, a) in enumerate(sorted(agents.items())):
            a.tracker.exit_autonomous()
            for ts_rel, pose, _state in a.tracker.trajectory:
                ts = ts_rel + stamps0[ai]
                i = int(np.argmin(np.abs(gt_poses[0] - ts)))
                if abs(gt_poses[0][i] - ts) < 0.05:
                    gt[aid].append((ts, _host(pose), gt_poses[1][i]))
    record_run(out_dir, agents, bus, gt)
    return evaluate(out_dir) if gt_path else {"run_dir": out_dir}


def run_dataset_sensor(dataset_root, sensor="stereo", settings_path=None,
                       out_dir="out_sensor", max_frames=None, gt_path=None, device="cuda"):
    """Single-agent stereo / RGB-D dataset replay through the System facade
    (the reference's `ros_stereo`/`ros_rgbd` executables' role): EuRoC
    cam0+cam1 for stereo, TUM rgb+depth for rgbd. Metric ATE is evaluated
    WITHOUT scale alignment — depth sensors must deliver true scale.
    `settings_path`: a YAML path or a `SystemSettings`."""
    from ..eval import metrics
    from ..io import datasets
    from ..models.system import System

    os.makedirs(out_dir, exist_ok=True)
    if settings_path is None:
        raise ValueError("run_dataset_sensor needs settings (a YAML path or a SystemSettings)")
    settings = _settings(settings_path, sensor)
    system = System(settings, sensor=sensor, device=device)
    if sensor == "stereo":
        # EuRoC layout (mav0/cam0+cam1) or KITTI odometry (image_0+image_1)
        if os.path.isdir(os.path.join(dataset_root, "image_0")):
            seq = datasets.load_kitti_stereo(dataset_root)
        else:
            seq = datasets.load_euroc_stereo(dataset_root)
    elif sensor == "rgbd":
        seq = datasets.load_tum_rgbd(dataset_root)
    else:
        raise ValueError(f"run_dataset_sensor: unknown sensor {sensor!r}")

    n = len(seq) if max_frames is None else min(len(seq), max_frames)
    t0 = seq.stamps[0]
    rows = []
    for i in range(n):
        ts, a, b = seq[i]
        if sensor == "stereo":
            pose = system.track_stereo(a, b, ts - t0)
        else:
            pose = system.track_rgbd(a, b, ts - t0)
        if pose is not None:
            rows.append((ts, _host(pose)))
    system.save_trajectory_tum(os.path.join(out_dir, "trajectory.txt"))
    report = {"sensor": sensor, "frames": len(rows),
              "state": system.get_tracking_state(),
              "n_keyframes": system.tracker.n_kf_host}
    if gt_path and len(rows) >= 3:
        gt_stamps, gt_all = datasets.load_groundtruth_tum(gt_path)
        est, gtp = [], []
        for ts, e in rows:
            j = int(np.argmin(np.abs(gt_stamps - ts)))
            if abs(gt_stamps[j] - ts) < 0.05:
                est.append(e)
                gtp.append(gt_all[j])
        if len(est) >= 3:
            rmse, _, _ = metrics.ate_rmse(np.stack(est), np.stack(gtp),
                                          correct_scale=False)
            report["ate_rmse_metric_m"] = rmse
    with open(os.path.join(out_dir, "evaluation.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def record_run(out_dir, agents, bus, gt):
    """Record trajectories + transmission stats (the rosbag record set)."""
    from ..io import trajectory as traj_mod, viz
    from ..multiagent import wirecodec

    os.makedirs(out_dir, exist_ok=True)
    for a in agents.values():
        a.flush_gba()  # end-of-run barrier for any in-flight global BA
        a.tracker.drain_auto()
    for aid, a in agents.items():
        traj_mod.save_tum(os.path.join(out_dir, f"robot{aid}_trajectory.txt"),
                          a.tracker.trajectory)
        viz.export_state_json(os.path.join(out_dir, f"robot{aid}_state.json"), a)
        viz.export_pointcloud_ply(os.path.join(out_dir, f"robot{aid}_map.ply"), a.map)
    with open(os.path.join(out_dir, "bandwidth.json"), "w") as f:
        json.dump(bus.bandwidth_report(), f, indent=2)
    with open(os.path.join(out_dir, "gt.bin"), "wb") as f:
        f.write(wirecodec.dumps({aid: [(t, _host(e), np.asarray(g)) for t, e, g in v]
                                 for aid, v in gt.items()}))


def evaluate(run_dir):
    """Offline evaluation (the evo notebook): per-agent ATE RMSE (Sim3
    aligned) + bandwidth summary."""
    from ..eval import metrics
    from ..multiagent import wirecodec

    with open(os.path.join(run_dir, "gt.bin"), "rb") as f:
        gt = wirecodec.loads(f.read())
    report = {"agents": {}, "bandwidth": {}}
    for aid, rows in gt.items():
        if len(rows) < 3:
            continue
        est = np.stack([e for _, e, _ in rows])
        gtp = np.stack([g for _, _, g in rows])
        rmse, _, _ = metrics.ate_rmse(est, gtp)
        report["agents"][str(aid)] = {"ate_rmse_m": rmse, "frames": len(rows)}
    bw_path = os.path.join(run_dir, "bandwidth.json")
    if os.path.exists(bw_path):
        with open(bw_path) as f:
            report["bandwidth"] = json.load(f)
    with open(os.path.join(run_dir, "evaluation.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def main(argv=None):
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="torch device of the agents (default cuda; cpu runs the plain "
                             "versions of the kernels)")
    p = argparse.ArgumentParser(prog="dvm-console-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("run-synthetic", parents=[common])
    ps.add_argument("--agents", type=int, default=2)
    ps.add_argument("--frames", type=int, default=80)
    ps.add_argument("--out", default="out_synth")
    pd = sub.add_parser("run-dataset", parents=[common])
    pd.add_argument("--root", required=True, help="dataset directory")
    pd.add_argument("--format", default="euroc", choices=["euroc", "tum", "kitti"])
    pd.add_argument("--settings", default=None)
    pd.add_argument("--agents", type=int, default=2)
    pd.add_argument("--out", default="out_dataset")
    pd.add_argument("--max-frames", type=int, default=None)
    pd.add_argument("--gt", default=None, help="TUM-format ground truth")
    px = sub.add_parser("run-sensor", parents=[common], help="single-agent stereo/RGB-D replay")
    px.add_argument("--root", required=True)
    px.add_argument("--sensor", default="stereo", choices=["stereo", "rgbd"])
    px.add_argument("--settings", required=True)
    px.add_argument("--out", default="out_sensor")
    px.add_argument("--max-frames", type=int, default=None)
    px.add_argument("--gt", default=None)
    pe = sub.add_parser("evaluate")
    pe.add_argument("--run-dir", required=True)
    args = p.parse_args(argv)
    if args.cmd == "run-synthetic":
        rep = run_synthetic(n_agents=args.agents, n_frames=args.frames,
                            out_dir=args.out, device=args.device)
    elif args.cmd == "run-dataset":
        rep = run_dataset(args.root, fmt=args.format, settings_path=args.settings,
                          n_agents=args.agents, out_dir=args.out,
                          max_frames=args.max_frames, gt_path=args.gt, device=args.device)
    elif args.cmd == "run-sensor":
        rep = run_dataset_sensor(args.root, sensor=args.sensor,
                                 settings_path=args.settings, out_dir=args.out,
                                 max_frames=args.max_frames, gt_path=args.gt,
                                 device=args.device)
    else:
        rep = evaluate(args.run_dir)
    print(json.dumps(rep, indent=2))


if __name__ == "__main__":
    main()
