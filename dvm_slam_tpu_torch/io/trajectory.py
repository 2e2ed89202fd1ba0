"""Trajectory export in TUM / EuRoC / KITTI formats.

Port of `dvm_slam_tpu/io/trajectory.py` (`System::SaveTrajectoryTUM /
SaveTrajectoryEuRoC / SaveTrajectoryKITTI`). A trajectory is a list of
(timestamp, T_cw [7], ...) rows whose poses may be tensors on the card or
numpy arrays; they are materialized here, in one transfer, and nowhere
earlier.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import lie


def _twc_all(trajectory):
    """[N,7] camera->world poses (f32, CPU) of the trajectory's rows."""
    if not trajectory:
        return torch.zeros((0, 7), dtype=torch.float32)
    rows = [T if isinstance(T, torch.Tensor) else torch.as_tensor(np.asarray(T, np.float32))
            for _, T, *_ in trajectory]
    dev = rows[0].device
    T_cw = torch.stack([r.to(dev, torch.float32) for r in rows]).cpu()
    return lie.se3_inv(T_cw)


def save_tum(path: str, trajectory):
    """Lines: `ts tx ty tz qx qy qz qw` (camera->world)."""
    T = _twc_all(trajectory).numpy()
    with open(path, "w") as f:
        for (ts, *_), row in zip(trajectory, T):
            q, t = row[:4], row[4:]
            f.write(f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")


def save_euroc(path: str, trajectory):
    """Lines: `ts_ns,tx,ty,tz,qw,qx,qy,qz` (EuRoC csv convention)."""
    T = _twc_all(trajectory).numpy()
    with open(path, "w") as f:
        for (ts, *_), row in zip(trajectory, T):
            q, t = row[:4], row[4:]
            f.write(f"{int(ts * 1e9)},{t[0]:.7f},{t[1]:.7f},{t[2]:.7f},"
                    f"{q[0]:.7f},{q[1]:.7f},{q[2]:.7f},{q[3]:.7f}\n")


def save_kitti(path: str, trajectory):
    """Per line: row-major 3x4 camera-to-world matrix."""
    M = lie.se3_matrix(_twc_all(trajectory))[:, :3, :].numpy()
    with open(path, "w") as f:
        for m in M:
            f.write(" ".join(f"{v:.7e}" for v in m.reshape(-1)) + "\n")


def load_tum(path: str):
    """Returns a list of (ts, T_cw [7] numpy f32)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, tx, ty, tz, qx, qy, qz, qw = [float(v) for v in line.split()[:8]]
            T_wc = torch.tensor([qw, qx, qy, qz, tx, ty, tz], dtype=torch.float32)
            out.append((ts, lie.se3_inv(T_wc).numpy()))
    return out
