"""IMU types and preintegration.

Port of `dvm_slam_tpu/geometry/imu.py` (`ImuTypes.cc`): the calibration
(noise densities and bias walk), the preintegrated delta between two
keyframes with first-order bias Jacobians and the discrete covariance
propagation of `IntegrateNewMeasurement` (`ImuTypes.cc:178`), the
bias-corrected delta getters and the dead-reckoned state prediction.
Deltas are in the body frame of the first keyframe (Forster et al.);
gravity is the consumer's.

`preintegrate` runs the window sample by sample, as the reference's
`lax.scan` does; the terms that do not depend on the running state (the
bias-corrected samples, each sample's rotation increment and right
Jacobian) are computed for the whole window at once. The reference's
`preintegrate_padded` pads the window with dt = 0 samples only to reuse
XLA compilations; such a sample is an exact identity step, so the port
integrates the window as it is.

Every function takes tensors with optional leading batch dims (a stack of
preintegrations along axis 0 is a `Preintegrated` of stacked fields).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import lie

GRAVITY = (0.0, 0.0, -9.81)


@functools.lru_cache(maxsize=8)
def gravity(device=None):
    """GRAVITY as an f32 tensor on `device`, uploaded once."""
    return torch.tensor(GRAVITY, dtype=torch.float32, device=device)


def _f32(x) -> float:
    return float(np.float32(x))


class ImuCalib(NamedTuple):
    """`IMU::Calib`: per-sample noise (discretized) and bias walk, as
    Python floats of the reference's f32 values."""

    gyro_noise2: float
    acc_noise2: float
    gyro_walk2: float
    acc_walk2: float

    @staticmethod
    def create(gyro_noise=1.7e-4, acc_noise=2e-3, gyro_walk=1.9e-5, acc_walk=3e-3,
               freq=200.0):
        f = np.sqrt(np.float32(freq))
        sq = lambda v: _f32(v ** 2)  # noqa: E731
        return ImuCalib(gyro_noise2=sq(np.float32(gyro_noise) * f),
                        acc_noise2=sq(np.float32(acc_noise) * f),
                        gyro_walk2=sq(float(gyro_walk)), acc_walk2=sq(float(acc_walk)))


class Preintegrated(NamedTuple):
    """`IMU::Preintegrated` (all in the first body frame)."""

    dT: torch.Tensor      # [] total time
    dR: torch.Tensor      # [3,3] delta rotation
    dV: torch.Tensor      # [3]
    dP: torch.Tensor      # [3]
    JRg: torch.Tensor     # [3,3] first-order bias Jacobians
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    C: torch.Tensor       # [15,15] covariance (rot, vel, pos, bg walk, ba walk)
    bias_g: torch.Tensor  # [3] gyro bias used during integration
    bias_a: torch.Tensor  # [3] accel bias


def create_preintegrated(bias_g=None, bias_a=None, dtype=torch.float32, device=None):
    z3 = torch.zeros(3, dtype=dtype, device=device)
    z33 = torch.zeros((3, 3), dtype=dtype, device=device)
    as3 = lambda b: z3 if b is None else torch.as_tensor(b, dtype=dtype).to(device)  # noqa: E731
    return Preintegrated(
        dT=torch.zeros((), dtype=dtype, device=device),
        dR=torch.eye(3, dtype=dtype, device=device), dV=z3, dP=z3,
        JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33,
        C=torch.zeros((15, 15), dtype=dtype, device=device),
        bias_g=as3(bias_g), bias_a=as3(bias_a))


def stack(pres) -> Preintegrated:
    """A list of `Preintegrated` -> one with every field stacked on axis 0."""
    return Preintegrated(*[torch.stack(f) for f in zip(*pres)])


def index(p: Preintegrated, k) -> Preintegrated:
    return Preintegrated(*[f[k] for f in p])


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _right_jacobian(phi):
    """SO(3) right Jacobian Jr(phi) [...,3] -> [...,3,3] (ImuTypes'
    RightJacobianSO3; the reference's 1e-10 small-angle switch)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < 1e-10
    th = torch.sqrt(torch.where(small, 1.0, theta2))
    K = lie.hat(phi)
    A = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(th)) / (th * th))
    B = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (th - torch.sin(th)) / th ** 3)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye - A[..., None, None] * K + B[..., None, None] * (K @ K)


def _step(p: Preintegrated, calib: ImuCalib, a, dt, dRi, Jr):
    """One IMU sample with its bias-corrected acceleration `a`, rotation
    increment `dRi` and right Jacobian `Jr` (`IntegrateNewMeasurement`):
    position and velocity with the old dR, then the bias Jacobians, then
    the rotation, then the covariance."""
    dR, dV, dP = p.dR, p.dV, p.dP
    dRa = (0.5 * dR) @ a
    dP_new = dP + dV * dt + dRa * dt * dt
    dV_new = dV + (dR @ a) * dt

    a_hat = lie.hat(a)
    dRah = dR @ a_hat
    JPa_new = p.JPa + p.JVa * dt - 0.5 * dR * dt * dt
    JPg_new = p.JPg + p.JVg * dt - 0.5 * dt * dt * (dRah @ p.JRg)
    JVa_new = p.JVa - dR * dt
    JVg_new = p.JVg - dt * (dRah @ p.JRg)

    dR_new = dR @ dRi
    JRg_new = dRi.T @ p.JRg - Jr * dt

    dev, dtype = dR.device, dR.dtype
    I3 = torch.eye(3, dtype=dtype, device=dev)
    Z3 = torch.zeros((3, 3), dtype=dtype, device=dev)
    A = torch.cat([
        torch.cat([dRi.T, Z3, Z3], 1),
        torch.cat([-dR @ a_hat * dt, I3, Z3], 1),
        torch.cat([-0.5 * dR @ a_hat * dt * dt, I3 * dt, I3], 1),
    ])
    B = torch.cat([
        torch.cat([Jr * dt, Z3], 1),
        torch.cat([Z3, dR * dt], 1),
        torch.cat([Z3, 0.5 * dR * dt * dt], 1),
    ])
    Nga = torch.cat([
        torch.cat([I3 * calib.gyro_noise2, Z3], 1),
        torch.cat([Z3, I3 * calib.acc_noise2], 1),
    ])
    C9 = A @ p.C[:9, :9] @ A.T + B @ Nga @ B.T
    C = p.C.clone()
    C[:9, :9] = C9
    C[9:12, 9:12] = C[9:12, 9:12] + I3 * calib.gyro_walk2 * dt
    C[12:15, 12:15] = C[12:15, 12:15] + I3 * calib.acc_walk2 * dt
    return p._replace(dT=p.dT + dt, dR=dR_new, dV=dV_new, dP=dP_new, JRg=JRg_new, JVg=JVg_new,
                      JVa=JVa_new, JPg=JPg_new, JPa=JPa_new, C=C)


def integrate_measurement(p: Preintegrated, calib: ImuCalib, acc, gyro, dt):
    """One IMU sample (`IMU::Preintegrated::IntegrateNewMeasurement`)."""
    a = acc - p.bias_a
    phi = (gyro - p.bias_g) * dt
    return _step(p, calib, a, dt, lie.quat_to_matrix(lie.so3_exp(phi)), _right_jacobian(phi))


def preintegrate(calib: ImuCalib, acc, gyro, dts, bias_g=None, bias_a=None):
    """Integrate a window: acc, gyro [N,3], dts [N] -> Preintegrated."""
    acc = torch.as_tensor(acc, dtype=torch.float32)
    dev = acc.device
    gyro = torch.as_tensor(gyro, dtype=torch.float32).to(dev)
    dts = torch.as_tensor(dts, dtype=torch.float32).to(dev)
    p = create_preintegrated(bias_g, bias_a, device=dev)
    a = acc - p.bias_a
    phi = (gyro - p.bias_g) * dts[:, None]
    dRi = lie.quat_to_matrix(lie.so3_exp(phi))
    Jr = _right_jacobian(phi)
    for i in range(acc.shape[0]):
        p = _step(p, calib, a[i], dts[i], dRi[i], Jr[i])
    return p


# -- bias-corrected getters (ImuTypes.cc GetDeltaRotation/Velocity/Position) --

def delta_rotation(p: Preintegrated, new_bias_g):
    db = new_bias_g - p.bias_g
    return p.dR @ lie.quat_to_matrix(lie.so3_exp(_mv(p.JRg, db)))


def delta_velocity(p: Preintegrated, new_bias_g, new_bias_a):
    return p.dV + _mv(p.JVg, new_bias_g - p.bias_g) + _mv(p.JVa, new_bias_a - p.bias_a)


def delta_position(p: Preintegrated, new_bias_g, new_bias_a):
    return p.dP + _mv(p.JPg, new_bias_g - p.bias_g) + _mv(p.JPa, new_bias_a - p.bias_a)


def predict_state(p: Preintegrated, R_wb, v_w, t_w, bias_g=None, bias_a=None, g=None):
    """Dead-reckon a state through the preintegrated delta
    (`Tracking::PredictStateIMU`). Returns (R_wb', v_w', t_w')."""
    bg = p.bias_g if bias_g is None else bias_g
    ba = p.bias_a if bias_a is None else bias_a
    g = gravity(R_wb.device) if g is None else g
    dR = delta_rotation(p, bg)
    dV = delta_velocity(p, bg, ba)
    dP = delta_position(p, bg, ba)
    R2 = R_wb @ dR
    v2 = v_w + g * p.dT + _mv(R_wb, dV)
    t2 = t_w + v_w * p.dT + 0.5 * g * p.dT ** 2 + _mv(R_wb, dP)
    return R2, v2, t2
