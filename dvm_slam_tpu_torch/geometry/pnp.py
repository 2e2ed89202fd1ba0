"""RANSAC PnP for relocalization.

Port of `dvm_slam_tpu/geometry/pnp.py` (the role of `MLPnPsolver` in
`Tracking::Relocalization`): hypothesize and verify in one batched pass.
All hypotheses are solved together as minimal 6-point DLT poses (one batched
12x12 f32 `eigh`, batched 3x3 SVDs), inliers are counted in one [H,N]
reprojection pass, and the caller refines the winner with the pose-only
Gauss-Newton.

The random draws are an input: `ransac_pnp` takes the Gumbel noise [H,N]
(one row per hypothesis) where the reference draws it from a key, and
samples each minimal set as the 6 largest of noise + mask (a stable sort,
ties to the lowest index, as `jax.lax.top_k`).
"""

from __future__ import annotations

import torch

from . import lie
from .two_view import sample_indices


def _extract(P, X):
    """Nearest rotation to the 3x3 part of P [...,3,4] and the translation
    scaled to match; returns (SE3 [...,7], points in front [...]) for the
    normalized world points X [...,K,3]."""
    M = P[..., :3]
    U, s, Vt = torch.linalg.svd(M)
    d = torch.linalg.det(U @ Vt)
    diag = torch.cat([torch.ones(d.shape + (2,), dtype=P.dtype, device=P.device),
                      d[..., None]], dim=-1)
    R = (U * diag[..., None, :]) @ Vt
    scale = torch.mean(s, dim=-1) * d
    t = P[..., 3] / torch.where(torch.abs(scale) < 1e-12, 1e-12, scale)[..., None]
    pc_z = (X @ R.transpose(-1, -2) + t[..., None, :])[..., 2]
    return lie.se3(lie.quat_from_matrix(R), t), torch.sum(pc_z > 0, dim=-1)


def _dlt_pose(X_raw, xn):
    """6+ point DLT: camera pose from world points X [...,K,3] and
    normalized image points xn [...,K,2]. Returns SE3 [...,7] (world ->
    camera). World points are centered and scaled to unit RMS before the
    12x12 system is built, or the f32 eigendecomposition is too
    ill-conditioned for minimal sets."""
    c = torch.mean(X_raw, dim=-2)
    s = torch.sqrt(torch.mean(torch.sum((X_raw - c[..., None, :]) ** 2, dim=-1), dim=-1)) + 1e-9
    X = (X_raw - c[..., None, :]) / s[..., None, None]
    o = torch.ones(X.shape[:-1] + (1,), dtype=X.dtype, device=X.device)
    z = torch.zeros(X.shape[:-1] + (4,), dtype=X.dtype, device=X.device)
    Xh = torch.cat([X, o], dim=-1)                                  # [...,K,4]
    r1 = torch.cat([Xh, z, -xn[..., 0:1] * Xh], dim=-1)
    r2 = torch.cat([z, Xh, -xn[..., 1:2] * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                                 # [...,2K,12]
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    P0 = V[..., :, 0].reshape(V.shape[:-2] + (3, 4))
    # the DLT null vector's sign is free: pick by cheirality. The counts tie
    # whenever every point lies in front under both signs (a scene shallow
    # against its distance); the reference then keeps the eigensolver's
    # arbitrary sign. Here a tie goes to the sign with det(M) > 0, the sign
    # of P = lambda [R|t] with lambda > 0, so the hypothesis is the same on
    # every eigensolver.
    Ta, na = _extract(P0, X)
    Tb, nb = _extract(-P0, X)
    pick_a = torch.where(na == nb, torch.linalg.det(P0[..., :3]) > 0, na > nb)
    Tn = torch.where(pick_a[..., None], Ta, Tb)
    # denormalize: R = R', t = s t' - R' c
    q = lie.se3_q(Tn)
    t = s[..., None] * lie.se3_t(Tn) + lie.quat_rotate(q, -c)
    return lie.se3(q, t)


def ransac_pnp(noise, X, uv, mask, K, sample_size: int = 6, inlier_px: float = 5.99):
    """Vectorized RANSAC PnP.

    noise: [H,N] Gumbel noise, one row per hypothesis; X: [N,3] world
    points; uv: [N,2] observed pixels; mask: [N] valid; K: [4] fx fy cx cy.
    Returns (T_cw [7], inliers [N] bool, n_inliers)."""
    xn = torch.stack([(uv[:, 0] - K[2]) / K[0], (uv[:, 1] - K[3]) / K[1]], -1)
    idx = sample_indices(noise, mask, sample_size)                  # [H,6]
    hyps = _dlt_pose(X[idx], xn[idx])                               # [H,7]
    pc = lie.se3_apply(hyps[:, None, :], X[None])                   # [H,N,3]
    zc = torch.clamp(pc[..., 2], min=1e-9)
    u = K[0] * pc[..., 0] / zc + K[2]
    v = K[1] * pc[..., 1] / zc + K[3]
    err2 = (u - uv[None, :, 0]) ** 2 + (v - uv[None, :, 1]) ** 2
    inls = mask[None] & (pc[..., 2] > 0) & (err2 < inlier_px * inlier_px)
    counts = torch.sum(inls, dim=-1)
    best = torch.argmax(counts)
    return hyps[best], inls[best], counts[best]
