"""Joint visual-inertial bundle adjustment and the IMU initialization.

Port of `dvm_slam_tpu/mapping/vi_ba.py` (`Optimizer::LocalInertialBA`,
`Optimizer.cc:2214`, and `FullInertialBA`, `:358`): one Gauss-Newton
problem over per-keyframe 15-dof states (world->body pose tangent 6,
velocity 3, gyro bias 3, accel bias 3) and map points, with

  * visual reprojection residuals (closed-form Jacobians, Huber at
    sqrt(5.991)) through the body-camera extrinsic `T_cb`,
  * 9-dof preintegration edges between consecutive keyframes whitened by
    the inverse Cholesky factor of their covariance, Jacobians by forward
    mode (one batched `torch.func.jvp` over stacked copies),
  * bias random-walk factors,

points Schur-eliminated by 3x3 blocks and the reduced [15L,15L] system
solved dense after a Jacobi equilibration (the whitened inertial blocks
carry ~1e8 of information against ~1e2 visual). The per-keyframe pose
blocks are sums over each row's features; the point blocks and the dense
coupling [L,P,6,3] are `index_put_(accumulate=True)` over the observations
that exist, which sums in one order on every run. No Pallas kernel: the
reference computes this outside Pallas, and so does the port.

The IMU initialization (`LocalMapping::InitializeIMU`, `:1174`): the gyro
bias from rotation alignment, gravity, scale and velocities from a linear
system solved by the reference's SVD least squares (on the host, in f32,
so every device gives one answer), and the rotation taking the estimated
gravity to (0, 0, -g).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..geometry import imu, lie
from .ba import inv3x3
from .inertial import _T, _mv, preint_residual

CHI2_MONO = 5.991
HUBER_DELTA = math.sqrt(CHI2_MONO)


class ViWindow(NamedTuple):
    """Per-keyframe inertial states of a BA window."""

    T_bw: torch.Tensor   # [L,7] world->body SE3
    v: torch.Tensor      # [L,3] velocity (world)
    bg: torch.Tensor     # [L,3] gyro bias
    ba: torch.Tensor     # [L,3] accel bias


def whiten(C, eps: float):
    """Inverse Cholesky factor W of a covariance C [...,n,n] (W^T W = C^-1),
    the symmetrized C plus eps I factored."""
    n = C.shape[-1]
    eye = torch.eye(n, dtype=C.dtype, device=C.device)
    Lc = torch.linalg.cholesky_ex(0.5 * (C + _T(C)) + eps * eye)[0]
    return torch.linalg.solve_triangular(Lc, eye.expand(C.shape), upper=False)


def _body_from_Tbw(T_bw):
    """T_bw (world->body) -> (R_wb, p_w): body rotation and position in the
    world."""
    R_wb = _T(lie.quat_to_matrix(lie.se3_q(T_bw)))
    return R_wb, -_mv(R_wb, lie.se3_t(T_bw))


def inertial_edge_residual(T_bw_i, v_i, bg_i, ba_i, T_bw_j, v_j, pre: imu.Preintegrated, g):
    """The 9-dof preintegration residual between world->body poses
    (EdgeInertial::computeError), not whitened."""
    Ri, pi = _body_from_Tbw(T_bw_i)
    Rj, pj = _body_from_Tbw(T_bw_j)
    return preint_residual(Ri, pi, v_i, bg_i, ba_i, Rj, pj, v_j, pre, g)


def _retract_one(T_bw, v, bg, ba, dx):
    return (lie.se3_retract(T_bw, dx[..., 0:6]), v + dx[..., 6:9], bg + dx[..., 9:12],
            ba + dx[..., 12:15])


def _edge_linearization(win: ViWindow, pres: imu.Preintegrated, Wwh, g):
    """Whitened residuals r [E,9] and Jacobians Ji, Jj [E,9,15] of every
    edge k -> k+1 at zero tangents: 30 stacked copies of the edge list, the
    first 15 pushing a basis direction through dx_i, the rest through
    dx_j."""
    E = Wwh.shape[0]
    dtype, dev = win.v.dtype, win.v.device
    Ti, vi, bgi, bai = win.T_bw[:-1], win.v[:-1], win.bg[:-1], win.ba[:-1]
    Tj, vj = win.T_bw[1:], win.v[1:]
    z3 = torch.zeros_like(vj)

    def f(d):   # d [30,E,30]: (dx_i | dx_j) per copy
        Ti2, vi2, bgi2, bai2 = _retract_one(Ti, vi, bgi, bai, d[..., :15])
        Tj2, vj2, _, _ = _retract_one(Tj, vj, z3, z3, d[..., 15:])
        return _mv(Wwh, inertial_edge_residual(Ti2, vi2, bgi2, bai2, Tj2, vj2, pres, g))

    basis = torch.eye(30, dtype=dtype, device=dev)[:, None, :].expand(30, E, 30)
    zero = torch.zeros((30, E, 30), dtype=dtype, device=dev)
    r, t = torch.func.jvp(f, (zero,), (basis.contiguous(),))
    J = t.permute(1, 2, 0)                     # [E,9,30]
    return r[0], J[..., :15], J[..., 15:]


def _vis_chi2(T_bw_all, points, optc, okf, ouv, oinfo, K, T_cb):
    Tc = lie.se3_mul(T_cb[None], T_bw_all)
    X = points[optc]
    pc = lie.quat_rotate(lie.se3_q(Tc)[okf], X) + lie.se3_t(Tc)[okf]
    z = pc[:, 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    ru = ouv[:, 0] - (K[0] * pc[:, 0] / zs + K[2])
    rv = ouv[:, 1] - (K[1] * pc[:, 1] / zs + K[3])
    return (ru * ru + rv * rv) * oinfo, z


def vi_bundle_adjust(win: ViWindow, kf_fixed, kf_xy, kf_sigma2, obs_pt, pts, pt_opt, K, T_cb,
                     pres: imu.Preintegrated, pre_valid, gravity=None,
                     w_bias_walk: float = 1e4, iters: int = 8, damping: float = 1e-3):
    """win [L] keyframe states; kf_fixed [L] bool (pose gauge-fixed,
    velocity and biases free); kf_xy [L,F,2], kf_sigma2 [L,F], obs_pt [L,F]
    rows into pts (-1 none); pts [P,3]; pt_opt [P] bool; K [4]; T_cb [7];
    pres stacked [L-1] (edge k links k -> k+1); pre_valid [L-1] bool.
    Returns (win', pts', total_chi2_visual)."""
    L, F = obs_pt.shape
    P = pts.shape[0]
    dtype, dev = pts.dtype, pts.device
    O = L * F
    g = imu.gravity(dev) if gravity is None else torch.as_tensor(gravity, dtype=dtype).to(dev)
    okf = torch.arange(L, device=dev)[:, None].expand(L, F).reshape(O)
    opt_row = obs_pt.reshape(O).to(torch.int64)
    ovalid = opt_row >= 0
    optc = torch.clamp(opt_row, min=0)
    ouv = kf_xy.reshape(O, 2)
    oinfo = (1.0 / torch.clamp(kf_sigma2, min=1e-12)).reshape(O)
    kf_fixed = kf_fixed.to(torch.bool)
    free_pose = (~kf_fixed).to(dtype)
    popt = pt_opt.to(dtype)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    E = L - 1
    eI = torch.arange(E, device=dev)
    Wwh = whiten(pres.C[:, :9, :9], 1e-8)                    # [E,9,9]
    vobs = torch.nonzero(ovalid).squeeze(1)                  # the observations that exist
    okf_v, optc_v = okf[vobs], optc[vobs]

    # the camera-tangent Jacobian chained to the body tangent: with
    # T_cw = T_cb T_bw, [dt; dw]_cam = [R_cb dt + hat(t_cb) R_cb dw; R_cb dw]
    R_cb = lie.quat_to_matrix(lie.se3_q(T_cb))
    Adj = torch.zeros((6, 6), dtype=dtype, device=dev)
    Adj[0:3, 0:3] = R_cb
    Adj[0:3, 3:6] = lie.hat(lie.se3_t(T_cb)) @ R_cb
    Adj[3:6, 3:6] = R_cb
    pose_cols = torch.cat([torch.ones(6, dtype=dtype, device=dev),
                           torch.zeros(9, dtype=dtype, device=dev)])
    pose_mask = kf_fixed[:, None].to(dtype) * pose_cols[None, :]     # [L,15] 1 = pinned
    pm = pose_mask.reshape(-1) > 0
    mi = torch.where(kf_fixed[:E, None], 1.0 - pose_cols[None, :], 1.0)
    mj = torch.where(kf_fixed[1:, None], 1.0 - pose_cols[None, :], 1.0)
    wv = pre_valid.to(dtype)
    wbw = w_bias_walk * wv
    ii = torch.arange(L, device=dev)

    def visual_system(T_bw_all, points, active):
        Tc = lie.se3_mul(T_cb[None], T_bw_all)
        X = points[optc]
        pc = lie.quat_rotate(lie.se3_q(Tc)[okf], X) + lie.se3_t(Tc)[okf]
        x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
        iz = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        ru = ouv[:, 0] - (K[0] * x * iz + K[2])
        rv = ouv[:, 1] - (K[1] * y * iz + K[3])
        chi2 = (ru * ru + rv * rv) * oinfo
        rn = torch.sqrt(torch.clamp(chi2, min=1e-12))
        w = oinfo * active * torch.clamp(HUBER_DELTA / rn, max=1.0) * (z > 0)
        a00 = K[0] * iz
        a02 = -K[0] * x * iz * iz
        a11 = K[1] * iz
        a12 = -K[1] * y * iz * iz
        zero = torch.zeros_like(x)
        Ju_c = torch.stack([-a00, zero, -a02, -a02 * y, -a00 * z + a02 * x, a00 * y], -1)
        Jv_c = torch.stack([zero, -a11, -a12, a11 * z - a12 * y, a12 * x, -a11 * x], -1)
        Ju = (Ju_c @ Adj) * free_pose[okf, None]
        Jv = (Jv_c @ Adj) * free_pose[okf, None]
        Rm = lie.quat_to_matrix(lie.se3_q(Tc))[okf]
        Pu = -(Rm[:, 0, :] * a00[:, None] + Rm[:, 2, :] * a02[:, None]) * popt[optc, None]
        Pv = -(Rm[:, 1, :] * a11[:, None] + Rm[:, 2, :] * a12[:, None]) * popt[optc, None]
        return ru, rv, Ju, Jv, Pu, Pv, w, chi2, z

    def gn_step(state: ViWindow, points, active):
        ru, rv, Ju, Jv, Pu, Pv, w, chi2, z = visual_system(state.T_bw, points, active)
        # ---- visual blocks: pose rows as sums over each row's features
        Hcc6 = (w[:, None, None] * (Ju[:, :, None] * Ju[:, None, :]
                                    + Jv[:, :, None] * Jv[:, None, :])).reshape(L, F, 6, 6).sum(1)
        bc6 = (w[:, None] * (Ju * ru[:, None] + Jv * rv[:, None])).reshape(L, F, 6).sum(1)
        wo = w[vobs]
        Pu_v, Pv_v, ru_v, rv_v = Pu[vobs], Pv[vobs], ru[vobs], rv[vobs]
        Hpp = torch.zeros((P, 3, 3), dtype=dtype, device=dev).index_put_(
            (optc_v,), wo[:, None, None] * (Pu_v[:, :, None] * Pu_v[:, None, :]
                                            + Pv_v[:, :, None] * Pv_v[:, None, :]),
            accumulate=True)
        bp = torch.zeros((P, 3), dtype=dtype, device=dev).index_put_(
            (optc_v,), wo[:, None] * (Pu_v * ru_v[:, None] + Pv_v * rv_v[:, None]),
            accumulate=True)
        Ju_v, Jv_v = Ju[vobs], Jv[vobs]
        Wo = wo[:, None, None] * (Ju_v[:, :, None] * Pu_v[:, None, :]
                                  + Jv_v[:, :, None] * Pv_v[:, None, :])        # [V,6,3]
        Wd = torch.zeros((L, P, 6, 3), dtype=dtype, device=dev).index_put_(
            (okf_v, optc_v), Wo, accumulate=True)

        # point-block inversion
        trp = Hpp[:, 0, 0] + Hpp[:, 1, 1] + Hpp[:, 2, 2]
        lam_p = damping * (1.0 + trp / 3.0)
        empty = trp < 1e-12
        Hpp_d = torch.where(empty[:, None, None], eye3, Hpp + lam_p[:, None, None] * eye3)
        Hpi = torch.where(empty[:, None, None], 0.0, inv3x3(Hpp_d))

        # Schur corrections (pose rows only)
        A = (Wd @ Hpi[None]).permute(0, 2, 1, 3).reshape(L * 6, P * 3)
        B = Wd.permute(0, 2, 1, 3).reshape(L * 6, P * 3)
        S6 = (A @ B.T).reshape(L, 6, L, 6).permute(0, 2, 1, 3)           # [L,L,6,6] blocks
        bc_corr = (A @ bp.reshape(-1)).reshape(L, 6)

        # ---- the full system as [L,L,15,15] blocks
        H = torch.zeros((L, L, 15, 15), dtype=dtype, device=dev)
        H[:, :, 0:6, 0:6] = -S6
        H[ii, ii, 0:6, 0:6] = Hcc6 - S6[ii, ii]
        b = torch.zeros((L, 15), dtype=dtype, device=dev)
        b[:, 0:6] = bc6 - bc_corr

        # ---- inertial edges (fixed pose columns zeroed; vel/bias free)
        r_in, Ji, Jj = _edge_linearization(state, pres, Wwh, g)
        Ji = Ji * wv[:, None, None] * mi[:, None, :]
        Jj = Jj * wv[:, None, None] * mj[:, None, :]
        r_inw = r_in * wv[:, None]
        Hij = torch.einsum("eki,ekj->eij", Ji, Jj)
        H[eI, eI] += torch.einsum("eki,ekj->eij", Ji, Ji)
        H[eI + 1, eI + 1] += torch.einsum("eki,ekj->eij", Jj, Jj)
        H[eI, eI + 1] += Hij
        H[eI + 1, eI] += Hij.transpose(-1, -2)
        b[eI] += torch.einsum("eki,ek->ei", Ji, r_inw)
        b[eI + 1] += torch.einsum("eki,ek->ei", Jj, r_inw)

        # ---- bias random walk
        r_bg = state.bg[1:] - state.bg[:-1]
        r_ba = state.ba[1:] - state.ba[:-1]
        wI = wbw[:, None, None] * eye3
        for base, rwall in ((9, r_bg), (12, r_ba)):
            sl = slice(base, base + 3)
            H[eI, eI, sl, sl] += wI
            H[eI + 1, eI + 1, sl, sl] += wI
            H[eI, eI + 1, sl, sl] += -wI
            H[eI + 1, eI, sl, sl] += -wI
            b[eI, sl] += -wbw[:, None] * rwall
            b[eI + 1, sl] += wbw[:, None] * rwall

        # ---- damping, gauge, solve
        Hm = H.permute(0, 2, 1, 3).reshape(L * 15, L * 15)
        diag = torch.diagonal(Hm)
        Hm = Hm + torch.diag(damping * (1.0 + diag / 15.0) + 1e-8)
        Hm = torch.where(pm[:, None] | pm[None, :], 0.0, Hm) + torch.diag(pm.to(dtype))
        bv = torch.where(pm, 0.0, b.reshape(-1))
        d = torch.sqrt(torch.clamp(torch.diagonal(Hm), min=1e-12))
        di = 1.0 / d
        Heq = Hm * di[:, None] * di[None, :]
        dx = (torch.linalg.solve_ex(Heq, -bv * di)[0] * di).reshape(L, 15)
        dx = torch.where(torch.isfinite(dx), dx, 0.0) * (1.0 - pose_mask)

        # point back-substitution: dp = Hpi (-(bp + W^T dc6))
        WTdc = (dx[:, 0:6].reshape(-1) @ B).reshape(P, 3)
        dp = (Hpi @ (-(bp + WTdc))[..., None])[..., 0]
        dp = torch.where(torch.isfinite(dp), dp, 0.0) * pt_opt[:, None]
        return ViWindow(*_retract_one(state.T_bw, state.v, state.bg, state.ba, dx)), points + dp

    state, points = win, pts
    active = ovalid.to(dtype)
    for _ in range(iters):
        state, points = gn_step(state, points, active)
    # outlier pass, then a short re-optimization (two stages like the
    # visual solvers)
    chi2, z = _vis_chi2(state.T_bw, points, optc, okf, ouv, oinfo, K, T_cb)
    active = (ovalid & (chi2 <= CHI2_MONO) & (z > 0)).to(dtype)
    for _ in range(3):
        state, points = gn_step(state, points, active)
    chi2, z = _vis_chi2(state.T_bw, points, optc, okf, ouv, oinfo, K, T_cb)
    total = torch.sum(torch.where(ovalid & (chi2 <= CHI2_MONO) & (z > 0), chi2, 0.0))
    return state, points, total


# --------------------------------------------------------------------------
# IMU initialization (LocalMapping::InitializeIMU, LocalMapping.cc:1174)
# --------------------------------------------------------------------------

def estimate_gyro_bias(T_bw_list, pres: imu.Preintegrated):
    """Gyro bias from rotation-only alignment over the keyframe chain: the
    linearized closed form of min sum_k |Log(dR_k(bg)^T R_i^T R_j)|^2."""
    Rwb = _T(lie.quat_to_matrix(lie.se3_q(T_bw_list)))
    Ri, Rj = Rwb[:-1], Rwb[1:]
    r = lie.so3_log(lie.quat_from_matrix(_T(pres.dR) @ (_T(Ri) @ Rj)))
    J = pres.JRg
    H = torch.einsum("kij,kil->jl", J, J)
    b = torch.einsum("kij,ki->j", J, r)
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    return torch.linalg.solve_ex(H + 1e-9 * eye, b)[0]


def lstsq_svd(A: np.ndarray, y: np.ndarray) -> np.ndarray:
    """The reference's least squares (`jnp.linalg.lstsq`): a thin SVD,
    singular values below eps * max(M, N) * s_max dropped. f32 numpy in
    and out; computed on the CPU so that every device gives one answer."""
    m, n = A.shape
    rcond = float(np.finfo(np.float32).eps) * max(m, n)
    u, s, vt = torch.linalg.svd(torch.from_numpy(A), full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, 1.0), 0.0)[:, None]
    x = vt.T @ (s_inv * (u.T @ torch.from_numpy(y)[:, None]))
    return x[:, 0].numpy()


def estimate_gravity_scale(T_bw_list, dts, pres: imu.Preintegrated, g_norm: float = 9.81,
                           bias_g=None):
    """Linear gravity + scale + per-keyframe velocity initialization from
    up-to-scale visual poses and preintegrated deltas: x = [s, g_w (3),
    v_0..v_{L-1} (3L)] minimizing the position and velocity
    preintegration residuals, then g projected to norm g_norm. Returns
    (scale [], g_w [3], velocities [L,3]) on the poses' device."""
    L = T_bw_list.shape[0]
    dev = T_bw_list.device
    Rwb, p = _body_from_Tbw(T_bw_list)
    bg = torch.zeros(3, dtype=torch.float32, device=dev) if bias_g is None else \
        torch.as_tensor(bias_g, dtype=torch.float32).to(dev)
    dP = imu.delta_position(pres, bg, pres.bias_a)
    dV = imu.delta_velocity(pres, bg, pres.bias_a)
    rp = _mv(Rwb[:-1], dP).cpu().numpy()
    rv = _mv(Rwb[:-1], dV).cpu().numpy()
    p = p.cpu().numpy()
    dT = pres.dT.cpu().numpy()
    n_unk = 4 + 3 * L
    A = np.zeros((6 * (L - 1), n_unk), np.float32)
    y = np.zeros(6 * (L - 1), np.float32)
    I3 = np.eye(3, dtype=np.float32)
    for k in range(L - 1):
        t = dT[k]
        r0 = 6 * k
        # position: s (p_j - p_i) = R_i dP + v_i dT + 0.5 g dT^2
        A[r0:r0 + 3, 0] = p[k + 1] - p[k]
        A[r0:r0 + 3, 1:4] = np.float32(-0.5) * t * t * I3
        A[r0:r0 + 3, 4 + 3 * k:7 + 3 * k] = -t * I3
        y[r0:r0 + 3] = rp[k]
        # velocity: v_j - v_i - g dT = R_i dV
        A[r0 + 3:r0 + 6, 1:4] = -t * I3
        A[r0 + 3:r0 + 6, 4 + 3 * k:7 + 3 * k] = -I3
        A[r0 + 3:r0 + 6, 7 + 3 * k:10 + 3 * k] = I3
        y[r0 + 3:r0 + 6] = rv[k]
    x = lstsq_svd(A, y)
    g_est = x[1:4]
    g_w = g_est / np.maximum(np.linalg.norm(g_est), np.float32(1e-9)) * np.float32(g_norm)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    return f32(x[0]), f32(g_w), f32(x[4:].reshape(L, 3))


def gravity_alignment_rotation(g_w, g_norm: float = 9.81):
    """The rotation (quaternion [4]) taking the estimated world gravity to
    (0, 0, -g_norm), applied to the whole map so that GRAVITY holds."""
    g_target = torch.tensor([0.0, 0.0, -g_norm], dtype=g_w.dtype, device=g_w.device)
    a = g_w / torch.clamp(torch.linalg.norm(g_w), min=1e-9)
    b = g_target / g_norm
    v = torch.linalg.cross(a, b)
    c = torch.dot(a, b)
    s = torch.linalg.norm(v)
    axis = v / torch.where(s < 1e-9, 1.0, s)
    return lie.so3_exp(axis * torch.atan2(s, c))
