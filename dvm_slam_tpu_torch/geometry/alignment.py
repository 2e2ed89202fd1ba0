"""Closed-form point-set alignment (Umeyama).

Port of `umeyama` from `dvm_slam_tpu/geometry/alignment.py`
(`OrbSlam3Wrapper::pointSetAlignment`), the part trajectory evaluation
needs; `ransac_umeyama` and `horn_sim3` wait for the loop-closing slice.
"""

from __future__ import annotations

import torch

from . import lie


def umeyama(src, dst, mask=None, with_scale: bool = True):
    """Least-squares similarity `dst ~ s R src + t`.

    src, dst: [N,3] corresponding points; mask: optional [N] bool or float
    weights. Returns the Sim3 [8] (q, t, s) mapping src -> dst."""
    n = src.shape[0]
    w = (torch.ones((n,), dtype=src.dtype, device=src.device) if mask is None
         else mask.to(src.dtype))
    wsum = torch.clamp(torch.sum(w), min=1e-9)
    mu_s = torch.sum(w[:, None] * src, dim=0) / wsum
    mu_d = torch.sum(w[:, None] * dst, dim=0) / wsum
    sc = src - mu_s
    dc = dst - mu_d
    cov = (dc * w[:, None]).T @ sc / wsum                 # [3,3] = E[dst_c src_c^T]
    var_s = torch.sum(w * torch.sum(sc * sc, dim=-1)) / wsum

    U, D, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    S = torch.cat([torch.ones((2,), dtype=src.dtype, device=src.device),
                   torch.sign(det)[None]])
    R = (U * S[None, :]) @ Vt
    if with_scale:
        s = torch.sum(D * S) / torch.clamp(var_s, min=1e-12)
    else:
        s = torch.ones((), dtype=src.dtype, device=src.device)
    t = mu_d - s * R @ mu_s
    q = lie.quat_from_matrix(R)
    return torch.cat([q, t, s[None]])
