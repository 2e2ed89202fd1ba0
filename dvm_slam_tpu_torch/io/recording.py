"""Frame-stream recording and replay.

The `ros2 bag record/play` role of `central_management_interface`
(`main.py:20-74`): capture a timestamped grayscale frame stream (plus
optional ground truth) into one compressed .npz "bag", replay it later into
any agent — including rate control and topic remapping's moral equivalent
(re-targeting a recorded stream to any agent id).

A copy of `dvm_slam_tpu/io/recording.py` (numpy only): the port imports nothing of
the JAX package. The .npz layout is the same, so a recording saved by
either package replays in the other.
"""

from __future__ import annotations

import numpy as np


class FrameRecorder:
    def __init__(self):
        self.stamps = []
        self.frames = []
        self.gt = []

    def add(self, ts: float, img, gt_pose=None):
        self.stamps.append(float(ts))
        self.frames.append(np.asarray(img, np.float32))
        self.gt.append(np.asarray(gt_pose, np.float32) if gt_pose is not None
                       else np.full(7, np.nan, np.float32))

    def save(self, path: str):
        np.savez_compressed(
            path,
            stamps=np.asarray(self.stamps, np.float64),
            frames=np.stack(self.frames) if self.frames else np.zeros((0, 1, 1)),
            gt=np.stack(self.gt) if self.gt else np.zeros((0, 7)),
        )


class FrameReplay:
    """Iterate a recorded bag; `rate` scales timestamps (the GUI's playback
    rate control), `start`/`stop` slice it."""

    def __init__(self, path: str, rate: float = 1.0, start: int = 0,
                 stop: int | None = None):
        z = np.load(path)
        self.stamps = z["stamps"][start:stop]
        self.frames = z["frames"][start:stop]
        self.gt = z["gt"][start:stop]
        self.rate = rate

    def __len__(self):
        return len(self.stamps)

    def __iter__(self):
        t0 = self.stamps[0] if len(self.stamps) else 0.0
        for ts, img, gt in zip(self.stamps, self.frames, self.gt):
            ts_scaled = t0 + (ts - t0) / self.rate
            yield ts_scaled, img, (None if np.isnan(gt).any() else gt)
