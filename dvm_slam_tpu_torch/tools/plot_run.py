"""Static run visualization: trajectories + maps -> PNG.

The human-viewable substitute for the reference's RViz/Pangolin windows
(`Viewer.cc`, `publish_ros_viz_topics.cpp`): reads the artifacts a
`tools.console` run records (per-robot TUM trajectories, PLY maps, state
JSON) and renders a top-down figure with keyframe covisibility edges.

Port of `dvm_slam_tpu/tools/plot_run.py`: the camera centers come from the
port's `geometry/lie`; matplotlib is imported only to draw.

Usage: python -m dvm_slam_tpu_torch.tools.plot_run --run-dir out_synth --out run.png
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch


def load_ply(path):
    pts = []
    with open(path) as f:
        header = True
        for line in f:
            if header:
                if line.strip() == "end_header":
                    header = False
                continue
            vals = line.split()
            if len(vals) >= 3:
                pts.append([float(v) for v in vals[:3]])
    return np.asarray(pts) if pts else np.zeros((0, 3))


def _centers(poses_cw):
    """Camera centers [N,3] of world->camera poses [N,7]."""
    from ..geometry import lie

    T = torch.as_tensor(np.asarray(poses_cw, np.float32)).reshape(-1, 7)
    return lie.se3_t(lie.se3_inv(T)).numpy()


def plot_run(run_dir: str, out_path: str, axes=(0, 2)):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..io import trajectory as traj_mod

    a, b = axes
    fig, ax = plt.subplots(figsize=(9, 7))
    colors = plt.cm.tab10.colors
    for ti, tpath in enumerate(sorted(glob.glob(os.path.join(run_dir, "robot*_trajectory.txt")))):
        name = os.path.basename(tpath).split("_")[0]
        rows = traj_mod.load_tum(tpath)
        centers = _centers([T for _, T in rows]) if rows else np.zeros((0, 3))
        c = colors[ti % len(colors)]
        ax.plot(centers[:, a], centers[:, b], "-", color=c, lw=1.5, label=f"{name} trajectory")
        mpath = os.path.join(run_dir, f"{name}_map.ply")
        if os.path.exists(mpath):
            pts = load_ply(mpath)
            if len(pts):
                ax.scatter(pts[:, a], pts[:, b], s=1, color=c, alpha=0.15)
        spath = os.path.join(run_dir, f"{name}_state.json")
        if os.path.exists(spath):
            with open(spath) as f:
                doc = json.load(f)
            kfs = {k["slot"]: k["T_cw"] for k in doc["markers"]["keyframes"]}
            kc = {}
            for slot, T in kfs.items():
                cpos = _centers(T)[0]
                kc[slot] = cpos
                ax.plot(cpos[a], cpos[b], "s", color=c, ms=3)
            for e in doc["markers"]["edges"]:
                s0, s1 = e[0], e[1]
                if s0 in kc and s1 in kc:
                    ax.plot([kc[s0][a], kc[s1][a]], [kc[s0][b], kc[s1][b]],
                            "-", color=c, alpha=0.25, lw=0.5)
    ax.set_xlabel("xyz"[a])
    ax.set_ylabel("xyz"[b])
    ax.set_aspect("equal")
    ax.legend(fontsize=8)
    ax.set_title(os.path.basename(os.path.abspath(run_dir)))
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run-dir", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    out = args.out or os.path.join(args.run_dir, "run.png")
    print(plot_run(args.run_dir, out))


if __name__ == "__main__":
    main()
