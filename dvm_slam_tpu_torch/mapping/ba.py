"""Windowed Levenberg-Marquardt bundle adjustment with Schur complement.

Port of `dvm_slam_tpu/mapping/ba.py`: `bundle_adjust`
(`Optimizer::LocalBundleAdjustment` semantics) and `bundle_adjust_pcg`, the
full-map solve of global BA. A stereo or RGB-D observation (`kf_ur` >= 0,
with `bf` = fx * baseline) adds the disparity row ur - (u - bf/z), gated at
chi2(3 dof) = 7.815 with the Huber delta sqrt(7.815); its terms fold into
the same 30 value planes, so K2 and K3 see the shapes of a monocular BA.

Same layout as the reference: observation-indexed tensors keep F or P last
(camera Jacobian planes [6,L,F], point planes [3,L,F], point blocks
[3,3,P] / [L,6,3,P]). Per LM step the point positions are gathered to the
observations once (K3, `ops/scatter.py::onehot_gather`) and the 30 value
planes of H_pp, b_p and W are scattered to the points once (K2,
`onehot_adjoint`). The reduced camera system S = H_cc - W H_pp^-1 W^T is one
[6L,3P] x [3P,6L] `torch.matmul`, solved by 32 iterations of block-Jacobi
PCG. Huber kernel at sqrt(5.991) px; the reference's two-stage scheme
(outlier edges dropped after `iters` accepted steps) and its deferred LM
acceptance (revert to the best state, raise lambda) are copied step for
step, with one repair: a non-finite cost is rejected, where the reference
accepts it. Every decision stays on the device (`torch.where`): the solve
never waits for the host.

The bf16 adjoint of the reference is TPU-only; the port holds BA to the
f32 CPU reference.

`bundle_adjust_batched` is `bundle_adjust` for B windows at once (the
reference's `jax.vmap` of `local_ba`): every LM decision per window, one K3
and one K2 call per LM step for all of them.

`bundle_adjust_pcg` keeps both of the reference's Schur strategies with the
port's own rule: the dense coupling [L,P,6,3] (one `index_put_` per LM step,
every Schur product a matmul, the reduced system solved by block-Jacobi
PCG) while it takes at most `DENSE_W_MAX_BYTES` (1 GiB, a small share of
the card's 80 GB), else the matrix-free PCG whose matvecs scatter per
observation. Its scatters are `index_put_(accumulate=True)`, which sums in
one order on every run. Neither calls K2 or K3: the reference computes
global BA outside Pallas.
"""

from __future__ import annotations

import math

import torch

from ..geometry import lie
from ..ops import scatter
from ..utils import profiling

CHI2_MONO = 5.991
HUBER_DELTA = math.sqrt(CHI2_MONO)
CHI2_STEREO = 7.815  # chi2(3 dof)
HUBER_DELTA_STEREO = math.sqrt(CHI2_STEREO)
DENSE_W_MAX_BYTES = 1 << 30


def _block_jacobi_pcg(Sm, Minv_d, r0, iters: int):
    """PCG on the dense SPD reduced camera system with 6x6 block-Jacobi
    preconditioning, `iters` fixed iterations. Sm [6L,6L], Minv_d [L,6,6]
    inverse diagonal blocks, r0 [6L]."""
    L = Minv_d.shape[0]

    def precond(r):
        return (Minv_d @ r.reshape(L, 6, 1)).reshape(-1)

    x = torch.zeros_like(r0)
    r = r0
    z = precond(r0)
    p = z
    rz = torch.dot(r0, z)
    for _ in range(iters):
        Ap = Sm @ p
        alpha = rz / torch.clamp(torch.dot(p, Ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rzn = torch.dot(r, z)
        beta = rzn / torch.clamp(rz, min=1e-30)
        p = z + beta * p
        rz = rzn
    return x


def _cofactors(a, b, c, d, e, f, g, h, i):
    return [[e * i - f * h, c * h - b * i, b * f - c * e],
            [f * g - d * i, a * i - c * g, c * d - a * f],
            [d * h - e * g, b * g - a * h, a * e - b * d]]


def inv3x3_planes(A, eps: float = 1e-12):
    """Closed-form 3x3 inverse in plane-major layout: A [3,3,...] with the
    batch in trailing dims -> [3,3,...]."""
    C = _cofactors(A[0, 0], A[0, 1], A[0, 2], A[1, 0], A[1, 1], A[1, 2],
                   A[2, 0], A[2, 1], A[2, 2])
    det = A[0, 0] * C[0][0] + A[0, 1] * C[1][0] + A[0, 2] * C[2][0]
    inv_det = 1.0 / torch.where(torch.abs(det) < eps, eps, det)
    return torch.stack([torch.stack(r) for r in C]) * inv_det[None, None]


def inv3x3(A, eps: float = 1e-12):
    """Closed-form batched 3x3 inverse (adjugate / det): [...,3,3]."""
    C = _cofactors(A[..., 0, 0], A[..., 0, 1], A[..., 0, 2], A[..., 1, 0], A[..., 1, 1],
                   A[..., 1, 2], A[..., 2, 0], A[..., 2, 1], A[..., 2, 2])
    det = A[..., 0, 0] * C[0][0] + A[..., 0, 1] * C[1][0] + A[..., 0, 2] * C[2][0]
    inv_det = 1.0 / torch.where(torch.abs(det) < eps, eps, det)
    M = torch.stack([torch.stack(r, -1) for r in C], -2)
    return M * inv_det[..., None, None]


def _inv6x6_block(H, eps: float = 1e-12):
    """Batched 6x6 inverse via the 2x2-of-3x3 block Schur complement.
    H: [...,6,6], assumed invertible (damped)."""
    A, B = H[..., :3, :3], H[..., :3, 3:]
    C, D = H[..., 3:, :3], H[..., 3:, 3:]
    Ai = inv3x3(A, eps)
    Si = inv3x3(D - C @ Ai @ B, eps)
    AiB = Ai @ B
    CAi = C @ Ai
    top = torch.cat([Ai + AiB @ Si @ CAi, -AiB @ Si], -1)
    bot = torch.cat([-Si @ CAi, Si], -1)
    return torch.cat([top, bot], -2)


@profiling.traced("ba.bundle_adjust")
def bundle_adjust(kf_pose, kf_fixed, kf_xy, kf_sigma2, obs_pt, pts, pt_opt, K,
                  iters: int = 10, damping: float = 1e-4, stage2_iters: int = 5,
                  kf_ur=None, bf=None, schur_iters: int = 32, use_kernel=None):
    """Windowed BA. kf_pose [L,7] world->camera; kf_fixed [L] bool; kf_xy
    [L,F,2]; kf_sigma2 [L,F]; obs_pt [L,F] int32 row into `pts` (-1 none);
    pts [P,3]; pt_opt [P] bool; K [4]. `use_kernel` picks K2/K3 or their
    plain versions (`ops/scatter.py`). `kf_ur` [L,F] (-1: monocular) with
    `bf` adds the stereo rows. Runs `iters + stage2_iters + 1` LM steps,
    each with one K3 and one K2 call, then one final K3 residual pass.
    Returns (kf_pose', pts', total_chi2, inlier_mask [L,F])."""
    L, F = obs_pt.shape
    P = pts.shape[0]
    dtype = pts.dtype
    dev = pts.device

    info = 1.0 / torch.clamp(kf_sigma2, min=1e-12)
    obs_valid = obs_pt >= 0
    pidx = torch.clamp(obs_pt, min=0).to(torch.int64)
    free_cam = (~kf_fixed).to(dtype)                               # [L]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    pidx_adj = torch.where(obs_valid, obs_pt, -1).to(torch.int32).contiguous()
    popt_obs = (pt_opt[pidx] & obs_valid).to(dtype)                # [L,F]
    ru_obs = kf_xy[..., 0]
    rv_obs = kf_xy[..., 1]
    ii = torch.arange(L, device=dev)
    stereo = None if kf_ur is None else (kf_ur >= 0.0) & obs_valid
    chi2_th = CHI2_MONO if kf_ur is None else torch.where(stereo, CHI2_STEREO, CHI2_MONO)
    delta_h = HUBER_DELTA if kf_ur is None else torch.where(stereo, HUBER_DELTA_STEREO,
                                                            HUBER_DELTA)

    def compute_system(poses, points_pl):
        """Residuals + Jacobian planes, all [., L, F]. points_pl: [3,P]."""
        Xo = scatter.onehot_gather(points_pl.contiguous(), pidx_adj, use_kernel)  # [L,3,F]
        R = lie.quat_to_matrix(lie.se3_q(poses))                   # [L,3,3]
        t = lie.se3_t(poses)

        def rot_row(i):
            return (R[:, i, 0, None] * Xo[:, 0] + R[:, i, 1, None] * Xo[:, 1]
                    + R[:, i, 2, None] * Xo[:, 2] + t[:, i, None])

        x, y, z = rot_row(0), rot_row(1), rot_row(2)               # [L,F]
        zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        inv_z = 1.0 / zs
        ru = ru_obs - (K[0] * x * inv_z + K[2])
        rv = rv_obs - (K[1] * y * inv_z + K[3])

        a00 = K[0] * inv_z
        a02 = -K[0] * x * inv_z * inv_z
        a11 = K[1] * inv_z
        a12 = -K[1] * y * inv_z * inv_z
        zero = torch.zeros_like(x)
        Ju = torch.stack([-a00, zero, -a02, -a02 * y, -a00 * z + a02 * x, a00 * y])
        Jv = torch.stack([zero, -a11, -a12, a11 * z - a12 * y, a12 * x, -a11 * x])

        R0 = R[:, 0, :].T                                          # [3,L]
        R1 = R[:, 1, :].T
        R2 = R[:, 2, :].T
        Pu = -(R0[:, :, None] * a00[None] + R2[:, :, None] * a02[None])  # [3,L,F]
        Pv = -(R1[:, :, None] * a11[None] + R2[:, :, None] * a12[None])

        chi2 = (ru * ru + rv * rv) * info
        if kf_ur is None:
            rw = Jw = Pw = None
        else:
            # the stereo row: the u row's pattern with a02 -> a02 + bf/z^2
            a02s = a02 + bf * inv_z * inv_z
            rw = torch.where(stereo, kf_ur - (K[0] * x * inv_z + K[2] - bf * inv_z), 0.0)
            Jw = torch.stack([-a00, zero, -a02s, -a02s * y, -a00 * z + a02s * x, a00 * y])
            Pw = -(R0[:, :, None] * a00[None] + R2[:, :, None] * a02s[None])
            chi2 = chi2 + rw * rw * info
        rn = torch.sqrt(torch.clamp(chi2, min=1e-12))
        w_base = info * torch.clamp(delta_h / rn, max=1.0) * (z > 0)
        return ru, rv, rw, z, Ju, Jv, Jw, Pu, Pv, Pw, chi2, w_base

    def robust_cost(chi2, active):
        # Huber rho on the whitened squared residual (g2o's robustChi2)
        rn = torch.sqrt(torch.clamp(chi2, min=1e-12))
        rho = torch.where(rn <= delta_h, chi2, 2.0 * delta_h * rn - delta_h * delta_h)
        return torch.sum(rho * active)

    poses, points_pl = kf_pose, pts.T
    active = obs_valid.to(dtype)
    best_poses, best_points = kf_pose, points_pl
    best_cost = torch.full((), math.inf, dtype=dtype, device=dev)
    lam = torch.full((), damping, dtype=dtype, device=dev)
    stage_done = torch.zeros((), dtype=torch.bool, device=dev)

    # +1 step so the last real step is itself cost-evaluated
    for k in range(iters + stage2_iters + 1):
        ru, rv, rw, z, Ju, Jv, Jw, Pu, Pv, Pw, chi2, w_base = compute_system(poses, points_pl)
        # LM acceptance, deferred by one step: a state worse than the best
        # accepted one is reverted, lambda rises and the step is retried. A
        # non-finite cost counts as worse: the reference's `cost > best`
        # accepts a NaN state, and a single step through an indefinite f32
        # Schur system (dropped stage-2 edges leave a point with one
        # observation) then poisons the window with NaN poses
        cost_cur = robust_cost(chi2, active)
        reject = ~(cost_cur <= best_cost)
        # stage boundary: past `iters` steps and on an accepted state, drop
        # outlier edges by chi2 at the current estimate
        stage2_mask = (obs_valid & (chi2 <= chi2_th) & (z > 0)).to(dtype)
        do_stage = ~reject & (k >= iters) & ~stage_done
        active = torch.where(do_stage, stage2_mask, active)
        stage_done = stage_done | do_stage
        cost_eff = torch.where(do_stage, robust_cost(chi2, active), cost_cur)
        best_cost = torch.where(reject, best_cost, cost_eff)
        best_poses = torch.where(reject, best_poses, poses)
        best_points = torch.where(reject, best_points, points_pl)
        lam = torch.clamp(torch.where(reject, lam * 4.0, lam * 0.5), 1e-7, 1e3)
        w = w_base * active

        # gate fixed cameras / constant points
        Juc = Ju * free_cam[None, :, None]
        Jvc = Jv * free_cam[None, :, None]
        Puc = Pu * popt_obs[None]
        Pvc = Pv * popt_obs[None]

        Hcc = (torch.einsum("ilf,lf,jlf->lij", Juc, w, Juc)
               + torch.einsum("ilf,lf,jlf->lij", Jvc, w, Jvc))
        bc = torch.einsum("ilf,lf->li", Juc, w * ru) + torch.einsum("ilf,lf->li", Jvc, w * rv)

        HppV = (Puc[:, None] * Puc[None, :] + Pvc[:, None] * Pvc[None, :]) * w[None, None]
        bpV = Puc * (w * ru)[None] + Pvc * (w * rv)[None]          # [3,L,F]
        WV = (Juc[:, None] * Puc[None, :] + Jvc[:, None] * Pvc[None, :]) * w[None, None]
        if kf_ur is not None:
            ws = w * stereo
            Jwc = Jw * free_cam[None, :, None]
            Pwc = Pw * popt_obs[None]
            Hcc = Hcc + torch.einsum("ilf,lf,jlf->lij", Jwc, ws, Jwc)
            bc = bc + torch.einsum("ilf,lf->li", Jwc, ws * rw)
            HppV = HppV + (Pwc[:, None] * Pwc[None, :]) * ws[None, None]
            bpV = bpV + Pwc * (ws * rw)[None]
            WV = WV + (Jwc[:, None] * Pwc[None, :]) * ws[None, None]

        # one adjoint scatter per step over the 30 stacked value planes
        # (HppV 9 | bpV 3 | WV 18), stored feature-major [L,F,30] (a
        # feature's 30 values in one 128-byte line for K2's gather) and
        # handed over as an [L,30,F] view
        vals = torch.cat([HppV.reshape(9, L, F).permute(1, 2, 0), bpV.permute(1, 2, 0),
                          WV.reshape(18, L, F).permute(1, 2, 0)], -1)
        fused = scatter.onehot_adjoint(vals.permute(0, 2, 1), pidx_adj, P, use_kernel)  # [L,30,P]
        HppP = torch.sum(fused[:, :9], dim=0).reshape(3, 3, P)
        bpP = torch.sum(fused[:, 9:12], dim=0)                    # [3,P]
        W = fused[:, 12:].reshape(L, 6, 3, P)

        # damp + closed-form invert point blocks
        trp = HppP[0, 0] + HppP[1, 1] + HppP[2, 2]
        lam_p = lam * (1.0 + trp / 3.0)
        eyeP = eye3[:, :, None]
        Hpp_d = HppP + lam_p[None, None] * eyeP
        empty = trp < 1e-12
        Hpp_d = torch.where(empty[None, None], eyeP, Hpp_d)
        Hpi = torch.where(empty[None, None], 0.0, inv3x3_planes(Hpp_d))

        # WHi[l,i,k,p] = sum_j W[l,i,j,p] Hpi[j,k,p]
        WHi = torch.stack(
            [W[:, :, 0] * Hpi[None, None, 0, kk] + W[:, :, 1] * Hpi[None, None, 1, kk]
             + W[:, :, 2] * Hpi[None, None, 2, kk] for kk in range(3)], dim=2)
        # S_off[l1,i,l2,k] = sum_{j,p} WHi[l1,i,j,p] W[l2,k,j,p]
        WHi2 = WHi.reshape(L * 6, 3 * P)
        S_off = (WHi2 @ W.reshape(L * 6, 3 * P).T).reshape(L, 6, L, 6)

        S = -S_off
        S[ii, :, ii, :] += Hcc
        lam_c = lam * (1.0 + torch.einsum("lii->l", Hcc) / 6.0)
        S[ii, :, ii, :] += lam_c[:, None, None] * eye6
        # fixed cameras: identity rows keep S well-posed
        fix2 = kf_fixed[:, None] | kf_fixed[None, :]
        S = torch.where(fix2[:, None, :, None], 0.0, S)
        S[ii, :, ii, :] += kf_fixed.to(dtype)[:, None, None] * eye6

        # rhs[l,i] = -(bc - sum_{j,p} WHi[l,i,j,p] bpP[j,p])
        rhs = -(bc - (WHi2 @ bpP.reshape(3 * P)).reshape(L, 6))
        rhs = (rhs * free_cam[:, None]).reshape(-1)

        Minv_d = _inv6x6_block(S[ii, :, ii, :])
        dc = _block_jacobi_pcg(S.reshape(L * 6, L * 6), Minv_d, rhs, schur_iters).reshape(L, 6)
        dc = torch.where(torch.isfinite(dc), dc, 0.0) * free_cam[:, None]

        # back-substitution: dp = Hpp^-1 (-(bp + W^T dc)), all [3,P] planes
        Wt_dc = (dc.reshape(1, L * 6) @ W.reshape(L * 6, 3 * P)).reshape(3, P)
        rhs_p = -(bpP + Wt_dc)
        dpP = torch.sum(Hpi * rhs_p[None], dim=1)
        dpP = torch.where(torch.isfinite(dpP), dpP, 0.0) * pt_opt[None, :]

        # on reject: revert to the best state and take no step
        poses = torch.where(reject, best_poses, lie.se3_retract(poses, dc))
        points_pl = torch.where(reject, best_points, points_pl + dpP)

    # the result is the best ACCEPTED state (the last step's proposal is
    # never evaluated), then a final residual pass classifies its edges
    sys_fin = compute_system(best_poses, best_points)
    z, chi2 = sys_fin[3], sys_fin[10]
    inliers = obs_valid & (chi2 <= chi2_th) & (z > 0)
    total = torch.sum(torch.where(inliers, chi2, 0.0))
    return best_poses, best_points.T, total, inliers


def _block_jacobi_pcg_batched(Sm, Minv_d, r0, iters: int):
    """`_block_jacobi_pcg` for B systems at once: Sm [B,6L,6L], Minv_d
    [B,L,6,6], r0 [B,6L]; each system's step sizes are its own."""
    B, L = Minv_d.shape[:2]

    def precond(r):
        return (Minv_d @ r.reshape(B, L, 6, 1)).reshape(B, -1)

    x = torch.zeros_like(r0)
    r = r0
    z = precond(r0)
    p = z
    rz = torch.sum(r0 * z, dim=1)
    for _ in range(iters):
        Ap = (Sm @ p[..., None])[..., 0]
        alpha = rz / torch.clamp(torch.sum(p * Ap, dim=1), min=1e-30)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        z = precond(r)
        rzn = torch.sum(r * z, dim=1)
        beta = rzn / torch.clamp(rz, min=1e-30)
        p = z + beta[:, None] * p
        rz = rzn
    return x


def bundle_adjust_batched(kf_pose, kf_fixed, kf_xy, kf_sigma2, obs_pt, pts, pt_opt, K,
                          iters: int = 10, damping: float = 1e-4, stage2_iters: int = 5,
                          schur_iters: int = 32, use_kernel=None):
    """B windowed BAs in one solve: `bundle_adjust` with a leading batch
    axis on every argument (kf_pose [B,L,7], kf_fixed [B,L], kf_xy
    [B,L,F,2], kf_sigma2 [B,L,F], obs_pt [B,L,F] into the window's own
    pts [B,P,3], pt_opt [B,P]; K [4] shared or [B,4]). Damping, the cost
    test, the stage boundary and the accept/reject are per window, so each
    window's result is what `bundle_adjust` alone gives it (to f32
    rounding: the batched products and the solve may round differently).
    Each LM step makes ONE K3 call and ONE K2 call for all B windows
    (`scatter.onehot_gather_batched`, `onehot_adjoint_batched`). Returns
    (kf_pose' [B,L,7], pts' [B,P,3], total_chi2 [B], inlier_mask [B,L,F])."""
    B, L, F = obs_pt.shape
    P = pts.shape[1]
    dtype = pts.dtype
    dev = pts.device
    K = K.expand(B, 4) if K.dim() == 1 else K
    fx, fy, cx, cy = (K[:, i, None, None] for i in range(4))        # [B,1,1]

    info = 1.0 / torch.clamp(kf_sigma2, min=1e-12)
    obs_valid = obs_pt >= 0
    pidx = torch.clamp(obs_pt, min=0).to(torch.int64)
    free_cam = (~kf_fixed).to(dtype)                                 # [B,L]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    pidx_adj = torch.where(obs_valid, obs_pt, -1).to(torch.int32).contiguous()
    popt_obs = (torch.gather(pt_opt, 1, pidx.reshape(B, L * F)).reshape(B, L, F)
                & obs_valid).to(dtype)                               # [B,L,F]
    ru_obs = kf_xy[..., 0]
    rv_obs = kf_xy[..., 1]

    def diag_blocks(S):
        """The [B,6,6,L] view of S's diagonal 6x6 blocks, S [B,L,6,L,6]."""
        return torch.diagonal(S, dim1=1, dim2=3)

    def compute_system(poses, points_pl):
        """Residuals + Jacobian planes, all [., B, L, F]. points_pl: [B,3,P]."""
        Xo = scatter.onehot_gather_batched(points_pl.contiguous(), pidx_adj,
                                           use_kernel)               # [B,L,3,F]
        R = lie.quat_to_matrix(lie.se3_q(poses))                     # [B,L,3,3]
        t = lie.se3_t(poses)

        def rot_row(i):
            return (R[..., i, 0, None] * Xo[:, :, 0] + R[..., i, 1, None] * Xo[:, :, 1]
                    + R[..., i, 2, None] * Xo[:, :, 2] + t[..., i, None])

        x, y, z = rot_row(0), rot_row(1), rot_row(2)                 # [B,L,F]
        zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        inv_z = 1.0 / zs
        ru = ru_obs - (fx * x * inv_z + cx)
        rv = rv_obs - (fy * y * inv_z + cy)

        a00 = fx * inv_z
        a02 = -fx * x * inv_z * inv_z
        a11 = fy * inv_z
        a12 = -fy * y * inv_z * inv_z
        zero = torch.zeros_like(x)
        Ju = torch.stack([-a00, zero, -a02, -a02 * y, -a00 * z + a02 * x, a00 * y])
        Jv = torch.stack([zero, -a11, -a12, a11 * z - a12 * y, a12 * x, -a11 * x])

        R0 = R[..., 0, :].permute(2, 0, 1)                           # [3,B,L]
        R1 = R[..., 1, :].permute(2, 0, 1)
        R2 = R[..., 2, :].permute(2, 0, 1)
        Pu = -(R0[..., None] * a00[None] + R2[..., None] * a02[None])  # [3,B,L,F]
        Pv = -(R1[..., None] * a11[None] + R2[..., None] * a12[None])

        chi2 = (ru * ru + rv * rv) * info
        rn = torch.sqrt(torch.clamp(chi2, min=1e-12))
        w_base = info * torch.clamp(HUBER_DELTA / rn, max=1.0) * (z > 0)
        return ru, rv, z, Ju, Jv, Pu, Pv, chi2, w_base

    def robust_cost(chi2, active):
        rn = torch.sqrt(torch.clamp(chi2, min=1e-12))
        rho = torch.where(rn <= HUBER_DELTA, chi2,
                          2.0 * HUBER_DELTA * rn - HUBER_DELTA * HUBER_DELTA)
        return torch.sum(rho * active, dim=(1, 2))                   # [B]

    poses, points_pl = kf_pose, pts.transpose(1, 2)
    active = obs_valid.to(dtype)
    best_poses, best_points = kf_pose, points_pl
    best_cost = torch.full((B,), math.inf, dtype=dtype, device=dev)
    lam = torch.full((B,), damping, dtype=dtype, device=dev)
    stage_done = torch.zeros((B,), dtype=torch.bool, device=dev)

    for k in range(iters + stage2_iters + 1):
        ru, rv, z, Ju, Jv, Pu, Pv, chi2, w_base = compute_system(poses, points_pl)
        # the deferred LM acceptance and stage boundary of `bundle_adjust`,
        # each decision per window
        cost_cur = robust_cost(chi2, active)
        reject = ~(cost_cur <= best_cost)                            # [B]
        stage2_mask = (obs_valid & (chi2 <= CHI2_MONO) & (z > 0)).to(dtype)
        do_stage = ~reject & (k >= iters) & ~stage_done
        active = torch.where(do_stage[:, None, None], stage2_mask, active)
        stage_done = stage_done | do_stage
        cost_eff = torch.where(do_stage, robust_cost(chi2, active), cost_cur)
        best_cost = torch.where(reject, best_cost, cost_eff)
        best_poses = torch.where(reject[:, None, None], best_poses, poses)
        best_points = torch.where(reject[:, None, None], best_points, points_pl)
        lam = torch.clamp(torch.where(reject, lam * 4.0, lam * 0.5), 1e-7, 1e3)
        w = w_base * active

        Juc = Ju * free_cam[None, :, :, None]
        Jvc = Jv * free_cam[None, :, :, None]
        Puc = Pu * popt_obs[None]
        Pvc = Pv * popt_obs[None]

        Hcc = (torch.einsum("iblf,blf,jblf->blij", Juc, w, Juc)
               + torch.einsum("iblf,blf,jblf->blij", Jvc, w, Jvc))  # [B,L,6,6]
        bc = (torch.einsum("iblf,blf->bli", Juc, w * ru)
              + torch.einsum("iblf,blf->bli", Jvc, w * rv))         # [B,L,6]

        HppV = (Puc[:, None] * Puc[None, :] + Pvc[:, None] * Pvc[None, :]) * w[None, None]
        bpV = Puc * (w * ru)[None] + Pvc * (w * rv)[None]            # [3,B,L,F]
        WV = (Juc[:, None] * Puc[None, :] + Jvc[:, None] * Pvc[None, :]) * w[None, None]

        # one adjoint scatter per step for all B windows, feature-major
        # storage [B,L,F,30] handed over as a [B,L,30,F] view
        vals = torch.cat([HppV.reshape(9, B, L, F).permute(1, 2, 3, 0),
                          bpV.permute(1, 2, 3, 0),
                          WV.reshape(18, B, L, F).permute(1, 2, 3, 0)], -1)
        fused = scatter.onehot_adjoint_batched(vals.permute(0, 1, 3, 2), pidx_adj, P,
                                               use_kernel)            # [B,L,30,P]
        HppP = torch.sum(fused[:, :, :9], dim=1).reshape(B, 3, 3, P)
        bpP = torch.sum(fused[:, :, 9:12], dim=1)                    # [B,3,P]
        W = fused[:, :, 12:].reshape(B, L, 6, 3, P)

        trp = HppP[:, 0, 0] + HppP[:, 1, 1] + HppP[:, 2, 2]          # [B,P]
        lam_p = lam[:, None] * (1.0 + trp / 3.0)
        eyeP = eye3[None, :, :, None]
        Hpp_d = HppP + lam_p[:, None, None] * eyeP
        empty = (trp < 1e-12)[:, None, None]
        Hpp_d = torch.where(empty, eyeP, Hpp_d)
        Hpi = torch.where(empty, 0.0, inv3x3_planes(Hpp_d.movedim(0, 2)).movedim(2, 0))

        # WHi[b,l,i,k,p] = sum_j W[b,l,i,j,p] Hpi[b,j,k,p]
        WHi = torch.stack(
            [W[:, :, :, 0] * Hpi[:, None, None, 0, kk] + W[:, :, :, 1] * Hpi[:, None, None, 1, kk]
             + W[:, :, :, 2] * Hpi[:, None, None, 2, kk] for kk in range(3)], dim=3)
        WHi2 = WHi.reshape(B, L * 6, 3 * P)
        W2 = W.reshape(B, L * 6, 3 * P)
        S = -(WHi2 @ W2.transpose(1, 2)).reshape(B, L, 6, L, 6)

        lam_c = lam[:, None] * (1.0 + torch.einsum("blii->bl", Hcc) / 6.0)
        diag_blocks(S).add_(Hcc.permute(0, 2, 3, 1))
        diag_blocks(S).add_((lam_c[..., None, None] * eye6).permute(0, 2, 3, 1))
        fix2 = kf_fixed[:, :, None] | kf_fixed[:, None, :]
        S = torch.where(fix2[:, :, None, :, None], 0.0, S)
        diag_blocks(S).add_((kf_fixed.to(dtype)[..., None, None] * eye6).permute(0, 2, 3, 1))

        rhs = -(bc - (WHi2 @ bpP.reshape(B, 3 * P, 1)).reshape(B, L, 6))
        rhs = (rhs * free_cam[..., None]).reshape(B, -1)

        Minv_d = _inv6x6_block(diag_blocks(S).permute(0, 3, 1, 2))
        dc = _block_jacobi_pcg_batched(S.reshape(B, L * 6, L * 6), Minv_d, rhs,
                                       schur_iters).reshape(B, L, 6)
        dc = torch.where(torch.isfinite(dc), dc, 0.0) * free_cam[..., None]

        Wt_dc = (dc.reshape(B, 1, L * 6) @ W2).reshape(B, 3, P)
        rhs_p = -(bpP + Wt_dc)
        dpP = torch.sum(Hpi * rhs_p[:, None], dim=2)
        dpP = torch.where(torch.isfinite(dpP), dpP, 0.0) * pt_opt[:, None, :]

        poses = torch.where(reject[:, None, None], best_poses, lie.se3_retract(poses, dc))
        points_pl = torch.where(reject[:, None, None], best_points, points_pl + dpP)

    sys_fin = compute_system(best_poses, best_points)
    z, chi2 = sys_fin[2], sys_fin[7]
    inliers = obs_valid & (chi2 <= CHI2_MONO) & (z > 0)
    total = torch.sum(torch.where(inliers, chi2, 0.0), dim=(1, 2))
    return best_poses, best_points.transpose(1, 2), total, inliers


def bundle_adjust_pcg(kf_pose, kf_fixed, kf_xy, kf_sigma2, obs_pt, pts, pt_opt, K,
                      kf_ur=None, bf=None, lm_iters: int = 8, pcg_iters: int = 40,
                      stage2_iters: int = 4, damping: float = 1e-4, dense=None):
    """Full-map BA over observation lists: LM with deferred acceptance and
    PCG on the reduced camera system S = H_cc - W H_pp^-1 W^T, two stages
    (outlier edges dropped after the first), as the reference. Same
    arguments as `bundle_adjust`; `dense` picks the Schur strategy (None:
    dense while the coupling takes at most DENSE_W_MAX_BYTES). Returns
    (kf_pose', pts', total_chi2, inlier_mask [L,F])."""
    L, F = obs_pt.shape
    P = pts.shape[0]
    dtype, dev = pts.dtype, pts.device
    O = L * F
    if dense is None:
        dense = L * P * 72 <= DENSE_W_MAX_BYTES

    okf = torch.arange(L, device=dev).repeat_interleave(F)                 # [O]
    opt_row = obs_pt.reshape(O)
    ovalid0 = opt_row >= 0
    optc = torch.clamp(opt_row, min=0).to(torch.int64)
    ouv = kf_xy.reshape(O, 2)
    oinfo = (1.0 / torch.clamp(kf_sigma2, min=1e-12)).reshape(O)
    free_cam = (~kf_fixed).to(dtype)
    fixed_f = kf_fixed.to(dtype)
    popt = pt_opt.to(dtype)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    ii = torch.arange(L, device=dev)
    vmask3 = ovalid0.to(dtype)
    if kf_ur is not None:
        our = kf_ur.reshape(O)
        stereo_o = (our >= 0.0) & ovalid0
        stereo_f = stereo_o.to(dtype)
        chi2_th = torch.where(stereo_o, CHI2_STEREO, CHI2_MONO)
        delta_h = torch.where(stereo_o, HUBER_DELTA_STEREO, HUBER_DELTA)
    else:
        chi2_th, delta_h = CHI2_MONO, HUBER_DELTA

    def residuals(poses, points):
        X = points[optc]
        pc = lie.quat_rotate(lie.se3_q(poses)[okf], X) + lie.se3_t(poses)[okf]
        x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
        inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        ru = ouv[:, 0] - (K[0] * x * inv_z + K[2])
        rv = ouv[:, 1] - (K[1] * y * inv_z + K[3])
        if kf_ur is None:
            rw = torch.zeros_like(ru)
        else:
            rw = torch.where(stereo_o, our - (K[0] * x * inv_z + K[2] - bf * inv_z), 0.0)
        return ru, rv, rw, x, y, z, inv_z

    def robust_cost(chi2, active):
        rn = torch.sqrt(torch.clamp(chi2, min=1e-12))
        rho = torch.where(rn <= delta_h, chi2, 2.0 * delta_h * rn - delta_h * delta_h)
        return torch.sum(rho * active)

    # the observations that exist, listed once per solve: the scatters add
    # only these. index_put_ with accumulate sums each point's terms in one
    # order on every run (index_add_'s float atomics do not), but it adds
    # the terms of one index one after another: with the empty slots, all
    # clamped to point 0, one call took 78 ms instead of 0.2 ms on the card
    vobs = torch.nonzero(ovalid0).squeeze(1)
    okf_v, optc_v = okf[vobs], optc[vobs]

    def scatter_p(v):
        out = torch.zeros((P,) + v.shape[1:], dtype=dtype, device=dev)
        return out.index_put_((optc_v,), v[vobs], accumulate=True)

    def schur_step(poses, Ju, Jv, Jw, Pu, Pv, Pw, w, ru, rv, rw, lam):
        """One damped Gauss-Newton step (dc [L,6], dp [P,3]); Jw/Pw the
        stereo rows' Jacobians or None."""
        ccv = w[:, None, None] * (Ju[:, :, None] * Ju[:, None, :] + Jv[:, :, None] * Jv[:, None, :])
        bcv = w[:, None] * (Ju * ru[:, None] + Jv * rv[:, None])
        hpv = w[:, None, None] * (Pu[:, :, None] * Pu[:, None, :] + Pv[:, :, None] * Pv[:, None, :])
        bpv = w[:, None] * (Pu * ru[:, None] + Pv * rv[:, None])
        Wo = w[:, None, None] * (Ju[:, :, None] * Pu[:, None, :] + Jv[:, :, None] * Pv[:, None, :])
        if Jw is not None:
            ws = w * stereo_f
            ccv = ccv + ws[:, None, None] * (Jw[:, :, None] * Jw[:, None, :])
            bcv = bcv + (ws * rw)[:, None] * Jw
            hpv = hpv + ws[:, None, None] * (Pw[:, :, None] * Pw[:, None, :])
            bpv = bpv + (ws * rw)[:, None] * Pw
            Wo = Wo + ws[:, None, None] * (Jw[:, :, None] * Pw[:, None, :])
        Hcc = ccv.reshape(L, F, 6, 6).sum(dim=1)
        bc = bcv.reshape(L, F, 6).sum(dim=1)
        Hpp = scatter_p(hpv)
        bp = scatter_p(bpv)

        trp = torch.einsum("pii->p", Hpp)
        Hpp_d = Hpp + (lam * (1.0 + trp / 3.0))[:, None, None] * eye3
        empty = (trp < 1e-12)[:, None, None]
        Hpp_inv = torch.where(empty, 0.0, inv3x3(torch.where(empty, eye3, Hpp_d)))
        Hcc_d = Hcc + (lam * (1.0 + torch.einsum("lii->l", Hcc) / 6.0))[:, None, None] * eye6
        Hcc_d = torch.where(kf_fixed[:, None, None], eye6, Hcc_d)

        if dense:
            Wd = torch.zeros((L, P, 6, 3), dtype=dtype, device=dev)
            Wd.index_put_((okf_v, optc_v), Wo[vobs], accumulate=True)
            A = (Wd @ Hpp_inv[None]).permute(0, 2, 1, 3).reshape(L * 6, P * 3)
            B = Wd.permute(0, 2, 1, 3).reshape(L * 6, P * 3)
            S = -(A @ B.T).reshape(L, 6, L, 6)
            S[ii, :, ii, :] += Hcc_d
            fix2 = kf_fixed[:, None] | kf_fixed[None, :]
            S = torch.where(fix2[:, None, :, None], 0.0, S)
            S[ii, :, ii, :] += fixed_f[:, None, None] * eye6
            rhs = -(bc - (A @ bp.reshape(-1)).reshape(L, 6)) * free_cam[:, None]
            Minv_d = _inv6x6_block(S[ii, :, ii, :])
            dc = _block_jacobi_pcg(S.reshape(L * 6, L * 6), Minv_d, rhs.reshape(-1),
                                   pcg_iters).reshape(L, 6)
            dc = torch.where(torch.isfinite(dc), dc, 0.0) * free_cam[:, None]
            WTdc = (dc.reshape(1, -1) @ B).reshape(P, 3)
        else:
            def WT_x(xc):      # [L,6] -> [P,3]: W^T x, scattered per observation
                return scatter_p(torch.einsum("oij,oi->oj", Wo, xc[okf]))

            def W_u(u):        # [P,3] -> [L,6]; observations are [L,F] row-major
                g = torch.einsum("oij,oj->oi", Wo, u[optc]) * vmask3[:, None]
                return g.reshape(L, F, 6).sum(dim=1)

            def S_mv(xc):      # the reduced camera system's matvec
                Hx = torch.einsum("lij,lj->li", Hcc_d, xc)
                u = torch.einsum("pij,pj->pi", Hpp_inv, WT_x(xc))
                return (Hx - W_u(u)) * free_cam[:, None] + xc * fixed_f[:, None]

            rhs = -(bc - W_u(torch.einsum("pij,pj->pi", Hpp_inv, bp))) * free_cam[:, None]
            Minv = _inv6x6_block(Hcc_d)
            xk = torch.zeros((L, 6), dtype=dtype, device=dev)
            rk = rhs
            zk = torch.einsum("lij,lj->li", Minv, rk)
            pk = zk
            rz = torch.sum(rk * zk)
            for _ in range(pcg_iters):
                Ap = S_mv(pk)
                alpha = rz / torch.clamp(torch.sum(pk * Ap), min=1e-30)
                xk = xk + alpha * pk
                rk = rk - alpha * Ap
                zk = torch.einsum("lij,lj->li", Minv, rk)
                rzn = torch.sum(rk * zk)
                pk = zk + (rzn / torch.clamp(rz, min=1e-30)) * pk
                rz = rzn
            dc = torch.where(torch.isfinite(xk), xk, 0.0) * free_cam[:, None]
            WTdc = WT_x(dc)
        dp = torch.einsum("pij,pj->pi", Hpp_inv, -(bp + WTdc))
        dp = torch.where(torch.isfinite(dp), dp, 0.0) * popt[:, None]
        return dc, dp

    def run_stage(poses, points, active, n):
        """n + 1 LM steps with deferred acceptance (see `bundle_adjust`);
        returns the best accepted state."""
        best_poses, best_points = poses, points
        best_cost = torch.full((), math.inf, dtype=dtype, device=dev)
        lam = torch.full((), damping, dtype=dtype, device=dev)
        for _ in range(n + 1):
            ru, rv, rw, x, y, z, inv_z = residuals(poses, points)
            chi2 = (ru * ru + rv * rv + rw * rw) * oinfo
            cost_cur = robust_cost(chi2, active)
            reject = ~(cost_cur <= best_cost)        # a non-finite cost counts as worse
            best_cost = torch.where(reject, best_cost, cost_cur)
            best_poses = torch.where(reject, best_poses, poses)
            best_points = torch.where(reject, best_points, points)
            lam = torch.clamp(torch.where(reject, lam * 4.0, lam * 0.5), 1e-7, 1e3)
            rn = torch.sqrt(torch.clamp(chi2, min=1e-12))
            w = oinfo * active * torch.clamp(delta_h / rn, max=1.0) * (z > 0)

            a00 = K[0] * inv_z
            a02 = -K[0] * x * inv_z * inv_z
            a11 = K[1] * inv_z
            a12 = -K[1] * y * inv_z * inv_z
            zero = torch.zeros_like(x)
            Ju = torch.stack([-a00, zero, -a02, -a02 * y, -a00 * z + a02 * x, a00 * y], -1)
            Jv = torch.stack([zero, -a11, -a12, a11 * z - a12 * y, a12 * x, -a11 * x], -1)
            Ju = Ju * free_cam[okf, None]
            Jv = Jv * free_cam[okf, None]
            Rm = lie.quat_to_matrix(lie.se3_q(poses))[okf]
            Pu = -(Rm[:, 0, :] * a00[:, None] + Rm[:, 2, :] * a02[:, None]) * popt[optc, None]
            Pv = -(Rm[:, 1, :] * a11[:, None] + Rm[:, 2, :] * a12[:, None]) * popt[optc, None]
            Jw = Pw = None
            if kf_ur is not None:
                # the stereo row: the u row's pattern with a02 -> a02 + bf/z^2
                a02s = a02 + bf * inv_z * inv_z
                Jw = torch.stack([-a00, zero, -a02s, -a02s * y, -a00 * z + a02s * x, a00 * y], -1)
                Jw = Jw * free_cam[okf, None]
                Pw = -(Rm[:, 0, :] * a00[:, None] + Rm[:, 2, :] * a02s[:, None]) * popt[optc, None]
            dc, dp = schur_step(poses, Ju, Jv, Jw, Pu, Pv, Pw, w, ru, rv, rw, lam)
            poses = torch.where(reject, best_poses, lie.se3_retract(poses, dc))
            points = torch.where(reject, best_points, points + dp)
        return best_poses, best_points

    poses, points = run_stage(kf_pose, pts, ovalid0.to(dtype), lm_iters)
    # stage 2: drop the outlier edges, re-optimize (the reference's two stages)
    ru, rv, rw, _, _, z, _ = residuals(poses, points)
    chi2 = (ru * ru + rv * rv + rw * rw) * oinfo
    stage2 = ovalid0 & (chi2 <= chi2_th) & (z > 0)
    poses, points = run_stage(poses, points, stage2.to(dtype), stage2_iters)
    ru, rv, rw, _, _, z, _ = residuals(poses, points)
    chi2 = (ru * ru + rv * rv + rw * rw) * oinfo
    inliers = ovalid0 & (chi2 <= chi2_th) & (z > 0)
    total = torch.sum(torch.where(inliers, chi2, 0.0))
    return poses, points, total, inliers.reshape(L, F)
