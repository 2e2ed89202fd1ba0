"""Closed-form point-set alignment (Umeyama / Horn).

Port of `dvm_slam_tpu/geometry/alignment.py`
(`OrbSlam3Wrapper::pointSetAlignment`, `ransacPointSetAlignment` and the
closed form inside `Sim3Solver::ComputeSim3`). `umeyama` takes leading
batch dimensions, so `ransac_umeyama` solves all its minimal sets in one
call. The RANSAC's Gumbel draws are an input (ROADMAP fault b) and its
minimal sets a stable top-k (fault a).
"""

from __future__ import annotations

import torch

from ..ops.fast import _top_k
from . import lie


def umeyama(src, dst, mask=None, with_scale: bool = True):
    """Least-squares similarity `dst ~ s R src + t`.

    src, dst: [...,N,3] corresponding points; mask: optional [...,N] bool or
    float weights. Returns the Sim3 [...,8] (q, t, s) mapping src -> dst."""
    w = (torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device) if mask is None
         else mask.to(src.dtype))
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)[..., None]          # [...,1]
    mu_s = torch.sum(w[..., None] * src, dim=-2) / wsum
    mu_d = torch.sum(w[..., None] * dst, dim=-2) / wsum
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    cov = (dc * w[..., None]).transpose(-1, -2) @ sc / wsum[..., None]   # E[dst_c src_c^T]
    var_s = torch.sum(w * torch.sum(sc * sc, dim=-1), dim=-1) / wsum[..., 0]

    U, D, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    S = torch.cat([torch.ones(det.shape + (2,), dtype=src.dtype, device=src.device),
                   torch.sign(det)[..., None]], dim=-1)
    R = (U * S[..., None, :]) @ Vt
    if with_scale:
        s = torch.sum(D * S, dim=-1) / torch.clamp(var_s, min=1e-12)
    else:
        s = torch.ones(det.shape, dtype=src.dtype, device=src.device)
    t = mu_d - s[..., None] * (R @ mu_s[..., None])[..., 0]
    q = lie.quat_from_matrix(R)
    return torch.cat([q, t, s[..., None]], dim=-1)


def alignment_residuals(S, src, dst):
    """Per-point Euclidean error of `dst - S (x) src`, [N]."""
    return torch.linalg.norm(dst - lie.sim3_apply(S, src), dim=-1)


def horn_sim3(p1, p2, with_scale: bool = True):
    """Horn's closed-form similarity from 3 (or more) correspondences, the
    minimal solver of `Sim3Solver::ComputeSim3`: the same math as
    `umeyama`, batched like it."""
    return umeyama(p1, p2, with_scale=with_scale)


def ransac_umeyama(noise, src, dst, mask, sample_size: int = 4, inlier_sigma: float = 1e-5,
                   with_scale: bool = True):
    """Hypothesize-and-verify similarity alignment
    (`ransacPointSetAlignment`): one 4-point minimal set per row of the
    Gumbel noise [H,N] (the `sample_size` largest of noise + (0 where mask,
    -1e9 elsewhere), ties to the lowest index), inliers by squared error
    under `inlier_sigma` times the source cloud's variance, the best count
    (first on a tie) refit on its inliers. Returns (S [8] src -> dst,
    inlier mask [N], inlier count)."""
    w = mask.to(src.dtype)
    wsum = torch.clamp(torch.sum(w), min=1.0)
    mu = torch.sum(w[:, None] * src, dim=0) / wsum
    var = torch.sum(w * torch.sum((src - mu) ** 2, dim=-1)) / wsum
    thresh = inlier_sigma * torch.clamp(var, min=1e-12)

    g = noise + torch.where(mask, 0.0, -1e9)[None, :]
    _, idx = _top_k(g, sample_size)                                     # [H,sample]
    hyps = umeyama(src[idx], dst[idx], with_scale=with_scale)            # [H,8]
    err = alignment_residuals(hyps[:, None, :], src[None], dst[None])    # [H,N]
    inl = (err * err < thresh) & mask[None, :]
    counts = torch.sum(inl, dim=1)
    best = torch.argmax(counts)
    best_inl = inl[best]
    refined = umeyama(src, dst, mask=best_inl.to(src.dtype), with_scale=with_scale)
    S = torch.where(counts[best] >= sample_size, refined, hyps[best])
    return S, best_inl, counts[best]
