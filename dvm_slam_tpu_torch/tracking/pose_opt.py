"""Pose-only optimization (motion-only bundle adjustment).

Port of `dvm_slam_tpu/tracking/pose_opt.py::pose_optimization`: 4 outer
rounds x 10 Gauss-Newton iterations, Huber kernel at delta = sqrt(5.991),
chi2(2 dof) = 5.991 outlier re-classification between rounds, outliers
excluded from the next round. A stereo or RGB-D observation (`ur` >= 0)
adds a third residual row, ur - (u - bf/z), and is gated at chi2(3 dof) =
7.815 with the Huber delta sqrt(7.815).
The damping decays x0.3 per iteration, as in the reference: a constant
damping leaves the weak forward-translation direction unconverged every
round, and the motion model compounds that undershoot.

Jacobians are [6, N] planes (left-multiplied se3 tangent (v, omega) at
zero), with pc = T X, r = uv - pi(pc), a00 = fx/z, a02 = -fx x/z^2,
a11 = fy/z, a12 = -fy y/z^2:
  J_u = [-a00, 0, -a02, -a02*y, -a00*z + a02*x,  a00*y]
  J_v = [0, -a11, -a12,  a11*z - a12*y,  a12*x, -a11*x]

The 6x6 solve is `torch.linalg.solve_ex`, which does not wait on the device
to check for a singular matrix; a non-finite step becomes zero instead.
"""

from __future__ import annotations

import math

import torch

from ..geometry import lie
from ..utils import profiling

CHI2_MONO = 5.991
CHI2_STEREO = 7.815  # chi2(3 dof)
HUBER_DELTA = math.sqrt(CHI2_MONO)
HUBER_DELTA_STEREO = math.sqrt(CHI2_STEREO)


def _residuals_and_planes(T, pts, uv, K):
    """Returns (r [N,2], z [N], Ju [6,N], Jv [6,N])."""
    pc = lie.quat_rotate(lie.se3_q(T)[None], pts) + lie.se3_t(T)[None]
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    inv_z = 1.0 / zs
    u_pred = K[0] * x * inv_z + K[2]
    v_pred = K[1] * y * inv_z + K[3]
    r = uv - torch.stack([u_pred, v_pred], dim=-1)

    a00 = K[0] * inv_z
    a02 = -K[0] * x * inv_z * inv_z
    a11 = K[1] * inv_z
    a12 = -K[1] * y * inv_z * inv_z
    zero = torch.zeros_like(x)
    Ju = torch.stack([-a00, zero, -a02, -a02 * y, -a00 * z + a02 * x, a00 * y])
    Jv = torch.stack([zero, -a11, -a12, a11 * z - a12 * y, a12 * x, -a11 * x])
    return r, z, Ju, Jv


def _stereo_residual_and_plane(T, pts, ur, bf, K):
    """The third row of a stereo observation: r_ur = ur - (u_pred - bf/z)
    and its Jacobian plane [6,N], the u row's pattern plus the bf/z^2 term
    of dz."""
    pc = lie.quat_rotate(lie.se3_q(T)[None], pts) + lie.se3_t(T)[None]
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    inv_z = 1.0 / zs
    r_ur = ur - (K[0] * x * inv_z + K[2] - bf * inv_z)
    a00 = K[0] * inv_z
    a02 = -K[0] * x * inv_z * inv_z
    zero = torch.zeros_like(x)
    c = bf * inv_z * inv_z
    Ju = torch.stack([-a00, zero, -a02, -a02 * y, -a00 * z + a02 * x, a00 * y])
    Jz = torch.stack([zero, zero, -c, -c * y, c * x, zero])
    return r_ur, Ju + Jz


@profiling.traced("tracking.pose_optimization")
def pose_optimization(T_init, pts, uv, sigma2, valid, K,
                      rounds: int = 4, iters: int = 10, damping: float = 1e-3,
                      ur=None, bf=None):
    """Optimize a world->camera pose against fixed 3D points.

    T_init [7]; pts [N,3] world points; uv [N,2] observed undistorted
    pixels; sigma2 [N] level variance (px^2); valid [N] bool; K [4]; ur
    optional [N] right-u observations (-1: a monocular row) with bf = fx *
    baseline. Returns (T [7], inliers [N] bool, chi2 [N])."""
    dt = T_init.dtype
    info = 1.0 / torch.clamp(sigma2, min=1e-12)
    eye = torch.eye(6, dtype=dt, device=T_init.device)
    stereo = None if ur is None else (ur >= 0.0) & valid
    chi2_th = CHI2_MONO if ur is None else torch.where(stereo, CHI2_STEREO, CHI2_MONO)
    delta_h = HUBER_DELTA if ur is None else torch.where(stereo, HUBER_DELTA_STEREO, HUBER_DELTA)

    def chi2_of(T):
        r, z, _, _ = _residuals_and_planes(T, pts, uv, K)
        chi2 = torch.sum(r * r, dim=-1) * info
        if ur is not None:
            r_ur, _ = _stereo_residual_and_plane(T, pts, ur, bf, K)
            chi2 = chi2 + torch.where(stereo, r_ur * r_ur * info, 0.0)
        return chi2, z

    def gn_round(T, active):
        for i in range(iters):
            r, z, Ju, Jv = _residuals_and_planes(T, pts, uv, K)
            chi2 = torch.sum(r * r, dim=-1) * info
            if ur is not None:
                r_ur, Jur = _stereo_residual_and_plane(T, pts, ur, bf, K)
                chi2 = chi2 + torch.where(stereo, r_ur * r_ur * info, 0.0)
            rn = torch.sqrt(torch.clamp(chi2, min=1e-12))
            w = info * torch.clamp(delta_h / rn, max=1.0) * active
            Juw = Ju * w
            Jvw = Jv * w
            H = Juw @ Ju.T + Jvw @ Jv.T
            b = Juw @ r[:, 0] + Jvw @ r[:, 1]
            if ur is not None:
                Jsw = Jur * (w * stereo)
                H = H + Jsw @ Jur.T
                b = b + Jsw @ r_ur
            H = H + (damping * 0.3 ** i) * eye * (1.0 + torch.trace(H) / 6.0)
            dx = torch.linalg.solve_ex(H, -b)[0]
            dx = torch.where(torch.all(torch.isfinite(dx)), dx, torch.zeros_like(dx))
            T = lie.se3_retract(T, dx)
        return T

    active = valid.to(dt)
    T = T_init
    for _ in range(rounds):
        T = gn_round(T, active)
        chi2, z = chi2_of(T)
        active = (valid & (chi2 <= chi2_th) & (z > 0)).to(dt)

    chi2, z = chi2_of(T)
    inliers = valid & (chi2 <= chi2_th) & (z > 0)
    return T, inliers, chi2


def _proj_residual(T, pts, uv, K):
    """r = uv - pi(T X) [...,N,2] and depth z [...,N] for poses T [...,7]."""
    pc = lie.quat_rotate(lie.se3_q(T)[..., None, :], pts) + lie.se3_t(T)[..., None, :]
    z = pc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    pred = torch.stack([K[0] * pc[..., 0] * inv_z + K[2], K[1] * pc[..., 1] * inv_z + K[3]], -1)
    return uv - pred, z


def pose_inertial_optimization(T_bw_init, v_init, bg_init, ba_init, T_bw_anchor, v_anchor,
                               bg_anchor, ba_anchor, pre, pts, uv, sigma2, valid, K, T_cb,
                               gravity, rounds: int = 4, iters: int = 6,
                               damping: float = 1e-3):
    """Per-frame pose-inertial optimization
    (`Optimizer::PoseInertialOptimizationLastKeyFrame`, `Optimizer.cc:4181`):
    one 15-dof state (pose tangent 6, velocity 3, gyro bias 3, accel bias
    3) against (a) the reprojection residuals with Huber and chi2(2 dof)
    reclassification over `rounds` rounds of `iters` Gauss-Newton
    iterations, (b) the 9-dof preintegration edge from the fixed anchor
    keyframe `pre` describes, whitened by the inverse Cholesky factor of
    its covariance, (c) bias random walks to the anchor biases, whitened by
    the walk blocks. The Jacobian of the whole [2N+15] residual is forward
    mode (`inertial.jacfwd`); the damping decays x0.3 per iteration.
    T_bw_* are world->body; T_cb camera-from-body. Returns (T_bw, v, bg, ba,
    inliers [N] bool, chi2_vis [N])."""
    from ..mapping.inertial import jacfwd
    from ..mapping.vi_ba import inertial_edge_residual, whiten

    dtype, dev = T_bw_init.dtype, T_bw_init.device
    info = 1.0 / torch.clamp(sigma2, min=1e-12)
    W9 = whiten(pre.C[:9, :9].to(dtype), 1e-8)
    Wg = whiten(pre.C[9:12, 9:12].to(dtype), 1e-12)
    Wa = whiten(pre.C[12:15, 12:15].to(dtype), 1e-12)
    g = torch.as_tensor(gravity, dtype=dtype).to(dev)
    eye = torch.eye(15, dtype=dtype, device=dev)
    mv = lambda M, v: (M @ v[..., None])[..., 0]  # noqa: E731

    def vis_chi2(T_bw):
        r, z = _proj_residual(lie.se3_mul(T_cb, T_bw), pts, uv, K)
        return torch.sum(r * r, dim=-1) * info, z

    def retract(state, dx):
        T_bw, v, bg, ba = state
        return (lie.se3_retract(T_bw, dx[..., :6]), v + dx[..., 6:9], bg + dx[..., 9:12],
                ba + dx[..., 12:15])

    def residual_vec(state, sw):
        """The stacked whitened residual [...,2N+15]; sw holds the square
        roots of this iteration's frozen robust weights."""
        T_bw, v, bg, ba = state
        r, _ = _proj_residual(lie.se3_mul(T_cb, T_bw), pts, uv, K)
        r_v = (r * sw[:, None]).reshape(r.shape[:-2] + (-1,))
        r_i = mv(W9, inertial_edge_residual(T_bw_anchor, v_anchor, bg, ba, T_bw, v, pre, g))
        r_b = torch.cat([mv(Wg, bg - bg_anchor), mv(Wa, ba - ba_anchor)], dim=-1)
        return torch.cat([r_v, r_i, r_b], dim=-1)

    def gn_round(state, active):
        for i in range(iters):
            chi2, z = vis_chi2(state[0])
            rn = torch.sqrt(torch.clamp(chi2, min=1e-12))
            w = info * torch.clamp(HUBER_DELTA / rn, max=1.0) * active * (z > 0)
            sw = torch.sqrt(w)
            st = state
            r0, J = jacfwd(lambda dx: residual_vec(retract(st, dx), sw), 15, dtype, dev)
            H = J.T @ J
            b = J.T @ r0
            H = H + (damping * 0.3 ** i) * eye * (1.0 + torch.trace(H) / 15.0)
            dx = torch.linalg.solve_ex(H, -b)[0]
            dx = torch.where(torch.all(torch.isfinite(dx)), dx, torch.zeros_like(dx))
            state = retract(state, dx)
        return state

    state = (T_bw_init, v_init, bg_init, ba_init)
    active = valid.to(dtype)
    for _ in range(rounds):
        state = gn_round(state, active)
        chi2, z = vis_chi2(state[0])
        active = (valid & (chi2 <= CHI2_MONO) & (z > 0)).to(dtype)
    chi2, z = vis_chi2(state[0])
    inliers = valid & (chi2 <= CHI2_MONO) & (z > 0)
    return state[0], state[1], state[2], state[3], inliers, chi2
