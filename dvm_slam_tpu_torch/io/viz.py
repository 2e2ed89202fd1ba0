"""Visualization/state export.

Port of `dvm_slam_tpu/io/viz.py`. Replaces `PublishRosVizTopics`
(`src/slam_system/src/publish_ros_viz_topics.cpp`) with file/object exports
consumable by any viewer: camera pose + frustum wireframe, tracked/all
map-point clouds (PLY), keyframe pose markers with covisibility edges
(JSON), and the Sim3 frame tree (the TF broadcast equivalent). Delta
encoding of keyframe markers (`last_sent_keyframe_poses`) becomes a
`changed_since` filter.

The exports read the port's `MapState` (tensors on any device), each in one
host transfer, through the port's `geometry/lie`; the files they write are
the JAX package's, byte for byte on the same map. matplotlib is imported by
`LiveViewer` only, so the package imports where it is missing.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..geometry import lie
from ..mapping import map_state


def _host(x, dtype=None):
    """A tensor or array as a numpy array on the host."""
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a if dtype is None else a.astype(dtype)


def _t32(x):
    return torch.as_tensor(_host(x, np.float32))


def camera_wireframe(T_cw, scale: float = 0.1):
    """5-vertex camera frustum in world coords (`publish_camera_pose`'s
    wireframe marker, `publish_ros_viz_topics.cpp:65-113`). Returns [5,3]."""
    pts_c = np.array(
        [[0, 0, 0], [1, 0.75, 2], [1, -0.75, 2], [-1, -0.75, 2], [-1, 0.75, 2]],
        np.float32,
    ) * scale
    T_wc = lie.se3_inv(_t32(T_cw))
    return lie.se3_apply(T_wc[None], torch.from_numpy(pts_c)).numpy()


def export_pointcloud_ply(path: str, m: map_state.MapState, tracked_mask=None):
    """Map points to PLY (the PointCloud2 topics: all + tracked)."""
    valid = _host(m.pt_valid)
    if tracked_mask is not None:
        valid = valid & _host(tracked_mask)
    pts = _host(m.pt_pos)[valid]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\nend_header\n")
        for p in pts:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


def keyframe_markers(m: map_state.MapState, meta=None, changed_since=None,
                     min_covis: int = 30):
    """Keyframe poses + covisibility edges as a JSON-able dict."""
    n = int(m.n_kf)
    valid = _host(m.kf_valid[:n])
    poses = _host(m.kf_pose[:n])
    out = {"keyframes": [], "edges": []}
    prev = changed_since or {}
    for i in range(n):
        if not valid[i]:
            continue
        pose = poses[i].tolist()
        if prev.get(i) == pose:
            continue  # delta encoding: unchanged markers skipped
        entry = {"slot": i, "T_cw": pose}
        if meta is not None:
            entry["uuid"] = [int(v) for v in meta.kf_uuid[i]]
            entry["creator"] = int(meta.kf_creator[i])
        out["keyframes"].append(entry)
    W = _host(map_state.covisibility(m))
    ii, jj = np.nonzero(np.triu(W >= min_covis, 1))
    out["edges"] = [[int(a), int(b), int(W[a, b])] for a, b in zip(ii, jj)]
    return out


def draw_frame(img, frame, obs=None):
    """`FrameDrawer::DrawFrame` role (`orb_slam3/src/FrameDrawer.cc`): render
    the grayscale frame with keypoints overlaid — green squares for features
    matched to map points, blue dots for unmatched detections. Returns an
    RGB uint8 array."""
    img = _host(img)
    h, w = img.shape
    rgb = np.repeat(np.clip(img, 0, 255).astype(np.uint8)[..., None], 3, -1)
    xy = _host(frame.xy)
    valid = _host(frame.valid)
    matched = (_host(obs) >= 0) if obs is not None else np.zeros(len(xy), bool)

    def mark(x, y, color, r):
        x0, x1 = max(x - r, 0), min(x + r + 1, w)
        y0, y1 = max(y - r, 0), min(y + r + 1, h)
        rgb[y0:y1, x0:x1] = color

    for i in range(len(xy)):
        if not valid[i]:
            continue
        x, y = int(round(xy[i, 0])), int(round(xy[i, 1]))
        if not (0 <= x < w and 0 <= y < h):
            continue
        if matched[i]:
            mark(x, y, (0, 220, 0), 2)
        else:
            mark(x, y, (60, 120, 255), 1)
    return rgb


def frame_tree(agents):
    """Sim3 TF tree of all agents (the `Sim3TransformStamped` broadcast)."""
    return {a.agent_id: a.frames.tree() for a in agents}


def export_state_json(path: str, agent, changed_since=None):
    m = agent.map
    last_pose = _host(agent.tracker.last_pose)
    doc = {
        "agent_id": agent.agent_id,
        "camera_pose": last_pose.tolist(),
        "camera_wireframe": camera_wireframe(last_pose).tolist(),
        "n_keyframes": int(m.n_kf),
        "n_points": int(_host(m.pt_valid).sum()),
        "markers": keyframe_markers(m, agent.meta, changed_since),
        "frame_tree": agent.frames.tree(),
        "merged_with": [p.agent_id for p in agent.peers if p.successfully_merged],
        # own-map place-recognition hits (loop correction itself is disabled
        # like the reference, LoopClosing.cc:328-339 — triggers are recorded)
        "loop_triggers": sum(1 for e in agent.log
                             if e and e[0] == "loop_trigger"),
    }
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


class LiveViewer:
    """Interactive map/trajectory viewer — the role of the reference's
    Pangolin `Viewer` + `MapDrawer` + `FrameDrawer` windows
    (`orb_slam3/src/Viewer.cc`, `MapDrawer.cc`, `FrameDrawer.cc`),
    re-targeted to matplotlib so it runs anywhere:

    * with a display (and ``interactive=True``) it opens a live window and
      refreshes in place (plt.ion);
    * headless it renders the same layout to PNG frames under ``out_dir``
      (one per ``update`` call), which is also what CI exercises.

    Layout: left pane = 3D map (point cloud, keyframe frusta, trajectory),
    right pane = current frame with tracked-feature overlay (FrameDrawer).
    """

    def __init__(self, out_dir: str | None = None, interactive: bool = False,
                 max_points: int = 4000):
        import matplotlib
        if not interactive:
            matplotlib.use("Agg", force=True)
        import matplotlib.pyplot as plt

        self._plt = plt
        self.interactive = interactive
        self.out_dir = out_dir
        self.max_points = max_points
        self._frame_idx = 0
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        self.fig = plt.figure(figsize=(12, 5))
        self.ax3d = self.fig.add_subplot(1, 2, 1, projection="3d")
        self.ax_img = self.fig.add_subplot(1, 2, 2)
        if interactive:
            plt.ion()
            self.fig.show()

    def update(self, m: map_state.MapState, trajectory=None, img=None,
               frame=None, obs=None, title: str = ""):
        """Redraw from the current MapState (+ optional trajectory list of
        (ts, T_cw, state) and current image/frame for the overlay)."""
        ax = self.ax3d
        ax.cla()
        pts = _host(m.pt_pos)
        ok = _host(m.pt_valid)
        P = pts[ok]
        if len(P) > self.max_points:
            P = P[:: max(1, len(P) // self.max_points)]
        if len(P):
            ax.scatter(P[:, 0], P[:, 1], P[:, 2], s=1, c="k", alpha=0.4)
        n_kf = int(m.n_kf)
        kf_ok = _host(m.kf_valid[:n_kf])
        kf_pose = _host(m.kf_pose[:n_kf])
        for i in range(n_kf):
            if not kf_ok[i]:
                continue
            W = camera_wireframe(kf_pose[i], scale=0.15)
            ax.plot(W[:, 0], W[:, 1], W[:, 2], c="b", lw=0.6)
        if trajectory:
            T_cw = torch.stack([_t32(T) for _, T, _ in trajectory])
            C = lie.se3_t(lie.se3_inv(T_cw)).numpy()
            ax.plot(C[:, 0], C[:, 1], C[:, 2], c="g", lw=1.2)
        ax.set_title(title or f"map: {int(ok.sum())} pts, {n_kf} KFs")

        self.ax_img.cla()
        if img is not None:
            overlay = (draw_frame(img, frame, obs=obs)
                       if frame is not None else _host(img))
            self.ax_img.imshow(overlay.astype(np.uint8)
                               if overlay.ndim == 3 else overlay,
                               cmap=None if overlay.ndim == 3 else "gray")
            self.ax_img.set_title("current frame")
        self.ax_img.set_axis_off()

        if self.interactive:
            self.fig.canvas.draw_idle()
            self.fig.canvas.flush_events()
        if self.out_dir:
            path = os.path.join(self.out_dir,
                                f"viewer_{self._frame_idx:05d}.png")
            self.fig.savefig(path, dpi=72)
            self._frame_idx += 1
            return path
        return None

    def close(self):
        self._plt.close(self.fig)
