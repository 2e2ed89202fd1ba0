"""Monocular two-view reconstruction (map initialization).

Port of `dvm_slam_tpu/geometry/two_view.py` (`TwoViewReconstruction`):
RANSAC homography and essential-matrix estimation, both batched over all
hypotheses, model selection by SH/(SH+SF) > 0.5, then pose recovery with
cheirality and parallax checks over all 12 candidate decompositions (8
Faugeras homography solutions, 4 essential) in one batched triangulation.

Works in normalized bearing coordinates (z=1); chi-squared thresholds are in
pixels and scaled by the focal length.

The random draws are inputs: `reconstruct_two_views` takes the Gumbel noise
of both RANSAC samplers, `[iters, N]` each, and applies the reference's mask
and top-8 to it (a stable descending sort, so ties go to the lowest index as
in `jax.lax.top_k`). The caller owns the generator.

The eigen- and singular vectors of the f32 solvers have a free sign, and
LAPACK and cuSOLVER differ by ulps. The chi2 scores do not depend on the
sign of H or E; the order of `_decompose_h`'s candidates can permute (a
flipped U maps 0<->3 and 1<->2), which can change the candidate `argmax`
picks when two tie in support.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie, triangulation

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_GAMMA = 5.991  # both models score against 5.991 (reference CheckFundamental)
SAMPLE = 8


class TwoViewResult(NamedTuple):
    ok: torch.Tensor               # [] bool
    T21: torch.Tensor              # [7] SE3 camera1 -> camera2
    points: torch.Tensor           # [N,3] in camera-1 frame
    good: torch.Tensor             # [N] bool triangulated inliers
    used_homography: torch.Tensor  # [] bool


def _smallest_eigvec(A):
    """Eigenvector of A^T A [...,9,9] with the smallest eigenvalue, as [...,3,3]."""
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    return V[..., :, 0].reshape(A.shape[:-2] + (3, 3))


def _dlt_h(x1, x2):
    """Homography from >= 4 correspondences ([...,K,2] normalized): DLT via
    the smallest eigenvector of A^T A."""
    u, v = x2[..., 0], x2[..., 1]
    x, y = x1[..., 0], x1[..., 1]
    o = torch.ones_like(x)
    z = torch.zeros_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], dim=-1)
    r2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], dim=-1)
    return _smallest_eigvec(torch.cat([r1, r2], dim=-2))           # A [...,2K,9]


def _eight_point_e(x1, x2):
    """Essential matrix from 8 normalized correspondences ([...,8,2]),
    projected onto the essential manifold (singular values 1, 1, 0)."""
    x, y = x1[..., 0], x1[..., 1]
    u, v = x2[..., 0], x2[..., 1]
    o = torch.ones_like(x)
    A = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, o], dim=-1)  # [...,8,9]
    E = _smallest_eigvec(A)
    U, _, Vt = torch.linalg.svd(E)
    diag = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (U * diag[..., None, :]) @ Vt


def _hom(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _h_transfer_chi2(H, x1, x2, f2):
    """Symmetric transfer chi2 (pixel units) of homographies H [...,3,3] on
    [N,2] points. Returns (e12, e21), each [...,N]."""
    def apply(Hm, p):
        q = _hom(p) @ Hm.transpose(-1, -2)
        w = q[..., 2:]
        return q[..., :2] / torch.where(torch.abs(w) < 1e-12, 1e-12, w)

    Hinv = torch.linalg.inv(H)
    e12 = torch.sum((x2 - apply(H, x1)) ** 2, dim=-1) * f2
    e21 = torch.sum((x1 - apply(Hinv, x2)) ** 2, dim=-1) * f2
    return e12, e21


def _e_epipolar_chi2(E, x1, x2, f2):
    """Squared point-to-epipolar-line distance both ways (pixel units) of
    essential matrices E [...,3,3]. Returns (d1, d2), each [...,N]."""
    x1h, x2h = _hom(x1), _hom(x2)
    l2 = x1h @ E.transpose(-1, -2)   # lines in image 2
    l1 = x2h @ E                     # lines in image 1
    num2 = torch.sum(l2 * x2h, dim=-1) ** 2
    num1 = torch.sum(l1 * x1h, dim=-1) ** 2
    d2 = num2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12) * f2
    d1 = num1 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12) * f2
    return d1, d2


def _decompose_e(E):
    """E [3,3] -> 4 candidates (R [4,3,3], t [4,3]) with |t| = 1."""
    U, _, Vt = torch.linalg.svd(E)
    # proper rotations
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_h(H):
    """Faugeras 1988 SVD decomposition of a Euclidean homography [3,3] -> 8
    candidates (R [8,3,3], t [8,3]) (`TwoViewReconstruction::ReconstructH`)."""
    dt, dev = H.dtype, H.device
    U, d, Vt = torch.linalg.svd(H)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    eps = 1e-9
    den13 = torch.clamp(d1 * d1 - d3 * d3, min=eps)
    aux1 = torch.sqrt(torch.clamp(d1 * d1 - d2 * d2, min=0.0) / den13)
    aux3 = torch.sqrt(torch.clamp(d2 * d2 - d3 * d3, min=0.0) / den13)
    x1s = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=dt, device=dev) * aux1
    x3s = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=dt, device=dev) * aux3
    sign_pos = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=dt, device=dev)  # sign(x1*x3)
    zero4, one4 = torch.zeros_like(x1s), torch.ones_like(x1s)
    sq = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))

    # case d' = +d2
    sin_t = sq / torch.clamp((d1 + d3) * d2, min=eps)
    cos_t = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=eps)
    st = sign_pos * sin_t
    ct = cos_t.expand(4)
    Rp = torch.stack([ct, zero4, -st, zero4, one4, zero4, st, zero4, ct], -1).reshape(4, 3, 3)
    tp = (d1 - d3) * torch.stack([x1s, zero4, -x3s], dim=-1)

    # case d' = -d2
    sin_p = sq / torch.clamp((d1 - d3) * d2, min=eps)
    cos_p = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=eps)
    sp = sign_pos * sin_p
    cp = cos_p.expand(4)
    Rn = torch.stack([cp, zero4, sp, zero4, -one4, zero4, sp, zero4, -cp], -1).reshape(4, 3, 3)
    tn = (d1 + d3) * torch.stack([x1s, zero4, x3s], dim=-1)

    Rs = s * (U @ torch.cat([Rp, Rn]) @ Vt)
    ts = torch.cat([tp, tn]) @ U.T
    ts = ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True), min=1e-12)
    return Rs, ts


def _check_rt(R, t, x1, x2, mask, f2, sigma2: float):
    """Cheirality check of candidates R [C,3,3], t [C,3]
    (`TwoViewReconstruction::CheckRT`): triangulate every match, keep points
    with positive depth in both views, a reprojection error < 4 sigma2 px^2
    in both, and real parallax. Returns (n_good [C], good [C,N], points
    [C,N,3])."""
    C, n = R.shape[0], x1.shape[0]
    T1 = lie.se3_identity((C, n), dtype=x1.dtype, device=x1.device)
    T2 = lie.se3(lie.quat_from_matrix(R), t)[:, None, :].expand(C, n, 7)
    X, okt = triangulation.triangulate(x1[None, :, :2].expand(C, n, 2),
                                       x2[None, :, :2].expand(C, n, 2), T1, T2)
    z1 = X[..., 2]
    Xc2 = lie.se3_apply(T2, X)
    z2 = Xc2[..., 2]
    cpar = triangulation.parallax_cos(T1, T2, X)
    p1 = X[..., :2] / torch.where(torch.abs(z1[..., None]) < 1e-12, 1e-12, z1[..., None])
    p2 = Xc2[..., :2] / torch.where(torch.abs(z2[..., None]) < 1e-12, 1e-12, z2[..., None])
    e1 = torch.sum((p1 - x1[None, :, :2]) ** 2, dim=-1) * f2
    e2 = torch.sum((p2 - x2[None, :, :2]) ** 2, dim=-1) * f2
    th = 4.0 * sigma2
    good = (mask[None] & okt & (z1 > 0) & (z2 > 0) & (e1 < th) & (e2 < th)
            & (cpar < 0.99998))
    return torch.sum(good, dim=-1), good, X


def gumbel(generator, shape):
    """Standard Gumbel noise of `shape`, f32 on the CPU, from `generator`:
    every RANSAC of the port draws its minimal sets from such a block."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


def sample_indices(noise, mask, sample: int = SAMPLE):
    """Minimal sets of the RANSAC: per row of `noise` [I,N] the `sample`
    largest of noise + (0 where mask, -1e9 elsewhere), ties to the lowest
    index (the masked entries all tie at -1e9 in f32). Returns [I,sample]."""
    g = noise + torch.where(mask, 0.0, -1e9)
    return torch.sort(g, dim=-1, descending=True, stable=True).indices[:, :sample]


def _ransac_best(noise, x1, x2, mask, solver, chi2_fn, th_inlier):
    idx = sample_indices(noise, mask)
    models = solver(x1[idx, :2], x2[idx, :2])                       # [I,3,3]
    e1, e2 = chi2_fn(models)                                        # [I,N]
    inl = (e1 < th_inlier) & (e2 < th_inlier) & mask[None]
    scores = torch.sum(torch.where(inl, (SCORE_GAMMA - e1) + (SCORE_GAMMA - e2), 0.0), dim=-1)
    best = torch.argmax(scores)
    return models[best], scores[best], inl[best]


def reconstruct_two_views(noise_h, noise_e, xn1, xn2, mask, focal,
                          sigma_px: float = 1.0, min_triangulated: int = 50):
    """Full monocular initializer on N putative matches.

    noise_h, noise_e: [iters, N] Gumbel noise of the homography and the
    essential sampler; xn1, xn2: [N,3] normalized bearings (z=1) of matched
    keypoints; mask: [N] bool valid matches; focal: focal length in pixels
    (a scalar tensor) for threshold scaling."""
    f2 = focal * focal
    sigma2 = sigma_px * sigma_px
    fs = f2 / sigma2
    x1, x2 = xn1[:, :2], xn2[:, :2]

    H, sh, _ = _ransac_best(noise_h, xn1, xn2, mask, _dlt_h,
                            lambda M: _h_transfer_chi2(M, x1, x2, fs), CHI2_H)
    E, sf, _ = _ransac_best(noise_e, xn1, xn2, mask, _eight_point_e,
                            lambda M: _e_epipolar_chi2(M, x1, x2, fs), CHI2_F)
    use_h = sh / torch.clamp(sh + sf, min=1e-9) > 0.5

    Rh, th_ = _decompose_h(H)
    Re, te = _decompose_e(E)
    Rs = torch.cat([Rh, Re])                                         # [12,3,3]
    ts = torch.cat([th_, te])                                        # [12,3]
    cand_is_h = torch.arange(12, device=xn1.device) < 8
    cand_on = torch.where(use_h, cand_is_h, ~cand_is_h)

    ngood, goods, Xs = _check_rt(Rs, ts, xn1, xn2, mask, fs, sigma2)
    ngood = torch.where(cand_on, ngood, -1)
    best = torch.argmax(ngood)
    n_best = ngood[best]

    # uniqueness: no second enabled candidate with > 0.75x the best support
    second = torch.sort(ngood).values[-2]
    n_matches = torch.sum(mask, dtype=torch.int32)
    half = (0.5 * n_matches.to(torch.float32)).to(torch.int32)
    enough = n_best >= torch.clamp(half, min=min_triangulated)
    unique = second.to(torch.float32) < 0.75 * n_best.to(torch.float32)
    ok = enough & unique & (n_best > 0)

    T21 = lie.se3(lie.quat_from_matrix(Rs[best]), ts[best])
    return TwoViewResult(ok=ok, T21=T21, points=Xs[best], good=goods[best] & ok,
                         used_homography=use_h)
