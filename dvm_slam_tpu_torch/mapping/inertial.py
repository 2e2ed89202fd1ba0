"""Inertial factors and the inertial-only optimization.

Port of `dvm_slam_tpu/mapping/inertial.py` (`Optimizer.cc`: `FullInertialBA`
`:358`, `InertialOptimization` `:2820,2996`, the inertial edge of
`G2oTypes.cc`): the preintegration residual between consecutive keyframe
states, bias random-walk factors, a Gauss-Newton solver over (pose,
velocity, bias) chains, and the Schur-complement marginalization. State per
keyframe: (q_wb [4], p_w [3], v_w [3], bg [3], ba [3]), body to world.

Jacobians are forward-mode derivatives of the residual through the tangent
retraction at zero, as the reference's `jax.jacfwd`: `jacfwd` below pushes
all n tangent directions through one `torch.func.jvp` on n stacked copies of
the problem (every function here takes leading batch dims).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp

from ..geometry import imu, lie


class ImuState(NamedTuple):
    q: torch.Tensor   # [N,4] body->world rotation
    p: torch.Tensor   # [N,3] position (world)
    v: torch.Tensor   # [N,3] velocity (world)
    bg: torch.Tensor  # [N,3] gyro bias
    ba: torch.Tensor  # [N,3] accel bias


def jacfwd(f, n: int, dtype, device):
    """Residual r [M] and Jacobian J [M,n] of f at dx = 0, where f maps
    dx [B,n] to residuals [B,M] for B stacked copies: column k is the JVP
    along the k-th basis vector."""
    zero = torch.zeros((n, n), dtype=dtype, device=device)
    r, t = jvp(f, (zero,), (torch.eye(n, dtype=dtype, device=device),))
    return r[0], t.transpose(0, 1)


def _T(M):
    return M.transpose(-1, -2)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def preint_residual(Ri, pi, vi, bgi, bai, Rj, pj, vj, pre: imu.Preintegrated, g):
    """The 9-dof preintegration residual between body states i and j given
    as rotations R_wb and world positions (`EdgeInertial::computeError`):
       r_R = Log(dR(bg)^T R_i^T R_j)
       r_v = R_i^T (v_j - v_i - g dT) - dV(bg, ba)
       r_p = R_i^T (p_j - p_i - v_i dT - 0.5 g dT^2) - dP(bg, ba)"""
    dT = pre.dT[..., None]
    dR = imu.delta_rotation(pre, bgi)
    dV = imu.delta_velocity(pre, bgi, bai)
    dP = imu.delta_position(pre, bgi, bai)
    r_R = lie.so3_log(lie.quat_from_matrix(_T(dR) @ _T(Ri) @ Rj))
    r_v = _mv(_T(Ri), vj - vi - g * dT) - dV
    r_p = _mv(_T(Ri), pj - pi - vi * dT - 0.5 * g * dT * dT) - dP
    return torch.cat([r_R, r_v, r_p], dim=-1)


def inertial_residual(qi, pi, vi, bgi, bai, qj, pj, vj, pre: imu.Preintegrated, g=None):
    """`preint_residual` for states given by their body->world quaternions."""
    g = imu.gravity(qi.device) if g is None else g
    return preint_residual(lie.quat_to_matrix(qi), pi, vi, bgi, bai, lie.quat_to_matrix(qj),
                           pj, vj, pre, g)


def _retract_state(s: ImuState, dx):
    """dx [...,N,15] = (dphi, dp, dv, dbg, dba)."""
    q = lie.quat_mul(lie.so3_exp(dx[..., 0:3]), s.q)
    return ImuState(q=lie.quat_normalize(q), p=s.p + dx[..., 3:6], v=s.v + dx[..., 6:9],
                    bg=s.bg + dx[..., 9:12], ba=s.ba + dx[..., 12:15])


def inertial_optimization(state: ImuState, pres: imu.Preintegrated, prior_q, prior_p, fixed,
                          w_inertial: float = 1.0, w_prior_rot: float = 1e2,
                          w_prior_pos: float = 1e2, w_bias_walk: float = 1e3,
                          iters: int = 15, damping: float = 1e-4):
    """Chain visual-inertial optimization with pose priors standing in for
    the reprojection factors: inertial edges between consecutive states
    (`pres` stacked, entry k links k -> k+1), bias random walks, rotation
    and position priors. A fixed state pins its pose only; its velocity and
    biases stay free. Returns (state', final_cost)."""
    N = state.q.shape[0]
    dtype, dev = state.q.dtype, state.q.device
    g = imu.gravity(dev)
    sq = lambda w: float(torch.sqrt(torch.tensor(w, dtype=torch.float32)))  # noqa: E731

    def residuals(s: ImuState):
        r_in = inertial_residual(s.q[..., :-1, :], s.p[..., :-1, :], s.v[..., :-1, :],
                                 s.bg[..., :-1, :], s.ba[..., :-1, :], s.q[..., 1:, :],
                                 s.p[..., 1:, :], s.v[..., 1:, :], pres, g)
        r_bw = torch.cat([s.bg[..., 1:, :] - s.bg[..., :-1, :],
                          s.ba[..., 1:, :] - s.ba[..., :-1, :]], dim=-1)
        r_pr_rot = lie.so3_log(lie.quat_mul(lie.quat_conj(prior_q), s.q))
        r_pr_pos = s.p - prior_p
        flat = lambda x: x.reshape(x.shape[:-2] + (-1,))  # noqa: E731
        return torch.cat([sq(w_inertial) * flat(r_in), sq(w_bias_walk) * flat(r_bw),
                          sq(w_prior_rot) * flat(r_pr_rot), sq(w_prior_pos) * flat(r_pr_pos)],
                         dim=-1)

    def stacked(dx_flat, s):
        return residuals(_retract_state(s, dx_flat.reshape(dx_flat.shape[:-1] + (N, 15))))

    pose_only = torch.cat([torch.ones(6, dtype=torch.bool), torch.zeros(9, dtype=torch.bool)])
    mask = (~(fixed.to(torch.bool)[:, None] & pose_only.to(dev)[None, :])).reshape(-1).to(dtype)
    eye = torch.eye(N * 15, dtype=dtype, device=dev)
    s = state
    for _ in range(iters):
        r, J = jacfwd(lambda dx: stacked(dx, s), N * 15, dtype, dev)
        J = J * mask[None, :]
        H = J.T @ J
        H = H + damping * (1.0 + torch.trace(H) / H.shape[0]) * eye
        b = J.T @ r
        dx = torch.linalg.solve_ex(H, -b)[0] * mask
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        s = _retract_state(s, dx.reshape(N, 15))
    final = torch.sum(torch.square(stacked(torch.zeros(N * 15, dtype=dtype, device=dev), s)))
    return s, final


def marginalize(H, b, start: int, end: int):
    """Schur-complement marginalization of the state block [start, end) out
    of a Gauss-Newton system (`Optimizer::Marginalize`, `Optimizer.cc:2744`):
    (H', b') of the remaining states with the block's information folded in
    as a dense prior, at the original indices with the marginalized rows and
    columns zero. The marginal block is inverted through its eigenvalues,
    those at or below 1e-8 dropped."""
    D = H.shape[0]
    dev = H.device
    ki = torch.cat([torch.arange(0, start), torch.arange(end, D)]).to(dev)
    mi = torch.arange(start, end, device=dev)
    Hrr = H[ki][:, ki]
    Hrm = H[ki][:, mi]
    Hmm = H[mi][:, mi]
    br, bm = b[ki], b[mi]
    Hmm = 0.5 * (Hmm + Hmm.T)
    w, V = torch.linalg.eigh(Hmm)
    w_inv = torch.where(w > 1e-8, 1.0 / w, 0.0)
    Hmm_inv = (V * w_inv[None, :]) @ V.T
    Hp = Hrr - Hrm @ Hmm_inv @ Hrm.T
    bp = br - Hrm @ (Hmm_inv @ bm)
    Hout = torch.zeros_like(H)
    Hout[ki[:, None], ki[None, :]] = Hp
    bout = torch.zeros_like(b)
    bout[ki] = bp
    return Hout, bout
