"""Binary descriptor matching as dense masked Hamming matrices.

Port of `dvm_slam_tpu/ops/matching.py`: the searches of tracking,
triangulation and monocular initialization. Hamming distances come from one
f32 matmul of the unpacked {0,1} descriptors:

  ham(a, b) = pop(a) + pop(b) - 2 * (a . b)

Every partial sum is an integer <= 256, so the f32 product is exact (TF32 is
off, `device.py`). A bf16 `torch.matmul` would return bf16 and is not used.
Reference constants (`ORBmatcher.cc:36-38`): TH_LOW = 50, TH_HIGH = 100,
rotation-consistency histogram of 30 bins, top 3.
"""

from __future__ import annotations

import math

import torch

TH_LOW = 50
TH_HIGH = 100
HISTO_BINS = 30

_BIG = 1 << 20


def hamming_matrix(desc_a, desc_b):
    """[N,256] x [M,256] {0,1} uint8 -> [N,M] int32 Hamming distances."""
    a = desc_a.to(torch.float32)
    b = desc_b.to(torch.float32)
    common = (a @ b.T).to(torch.int32)
    pop_a = torch.sum(desc_a.to(torch.int32), dim=-1)
    pop_b = torch.sum(desc_b.to(torch.int32), dim=-1)
    return pop_a[:, None] + pop_b[None, :] - 2 * common


def masked_best_match(dist, mask, max_dist: int, ratio: float | None = None,
                      tie_ok: bool = False):
    """Row-wise best match under a validity mask; the first index wins a tie
    (`torch.argmin`, as `jnp.argmin`).

    ratio: optional Lowe ratio, best < ratio * second best; tie_ok also
    accepts an exact tie best == second. Returns (idx [N] int64, best [N]
    int32, ok [N] bool); idx is -1 where not ok."""
    d = torch.where(mask, dist, _BIG)
    idx = torch.argmin(d, dim=-1)
    best = torch.gather(d, -1, idx[:, None])[:, 0]
    ok = best <= max_dist
    if ratio is not None:
        d2 = d.scatter(-1, idx[:, None], _BIG)
        second = torch.amin(d2, dim=-1)
        pass_ratio = best.to(torch.float32) < ratio * second.to(torch.float32)
        if tie_ok:
            pass_ratio = pass_ratio | (best == second)
        ok = ok & pass_ratio
    return torch.where(ok, idx, -1), best, ok


def mutual_filter(idx_ab, idx_ba):
    """Keep matches where argmin is mutual: idx_ba[idx_ab[i]] == i."""
    n = idx_ab.shape[0]
    back = torch.where(idx_ab >= 0, idx_ba[torch.clamp(idx_ab, min=0)], -2)
    ok = back == torch.arange(n, device=idx_ab.device)
    return torch.where(ok, idx_ab, -1), ok


def rotation_consistency(angle_a, angle_b, idx, ok):
    """Keep only matches whose angle difference falls in the top-3 of a
    30-bin orientation histogram (`ORBmatcher::ComputeThreeMaxima`
    semantics). Returns the filtered ok mask.

    The reference's `top_k` of the histogram feeds only its values, which do
    not depend on how ties are ordered, so `torch.topk` serves as it is."""
    diff = angle_a - angle_b[torch.clamp(idx, min=0)]
    two_pi = 2.0 * math.pi
    diff = torch.remainder(diff, two_pi)                 # jnp.mod: [0, 2pi)
    # the cast truncates toward zero, as astype(int32) does
    bin_idx = torch.clamp((diff * (HISTO_BINS / two_pi)).to(torch.int32), 0, HISTO_BINS - 1)
    bin_idx = bin_idx.to(torch.int64)
    hist = torch.zeros((HISTO_BINS,), dtype=torch.int32, device=idx.device)
    hist = hist.scatter_add(0, bin_idx, ok.to(torch.int32))
    top3 = torch.topk(hist, 3).values
    # the 3 fullest bins; bins 2 and 3 only if >= 0.1x the fullest
    keep_bins = (hist >= torch.clamp(top3[2], min=1)) & (
        hist.to(torch.float32) >= 0.1 * top3[0].to(torch.float32))
    return ok & keep_bins[bin_idx]


def search_for_initialization(f1_xy, f1_desc, f1_angle, f1_valid,
                              f2_xy, f2_desc, f2_angle, f2_valid,
                              window: float = 100.0):
    """Match initial-frame keypoints to a second frame within a pixel window
    (`ORBmatcher::SearchForInitialization`): window search, TH_LOW, Lowe
    ratio 0.9, mutual best, rotation consistency. Returns (idx [N] into
    frame 2, -1 where not ok; ok [N])."""
    dist = hamming_matrix(f1_desc, f2_desc)
    diff = f1_xy[:, None, :] - f2_xy[None, :, :]
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    mask = (d2 <= window * window) & f1_valid[:, None] & f2_valid[None, :]
    idx_ab, _, ok_ab = masked_best_match(dist, mask, TH_LOW, ratio=0.9)
    idx_ba, _, _ = masked_best_match(dist.T, mask.T, TH_LOW)
    idx, ok = mutual_filter(torch.where(ok_ab, idx_ab, -1), idx_ba)
    ok = ok & ok_ab
    ok = rotation_consistency(f1_angle, f2_angle, idx, ok)
    return torch.where(ok, idx, -1), ok


def search_by_projection(proj_xy, proj_valid, proj_desc, proj_level,
                         f_xy, f_desc, f_level, f_valid,
                         radii, max_dist: int = TH_HIGH,
                         level_window: int = 1,
                         ratio: float | None = None):
    """Project-and-match: for each projected map point (row), the best frame
    keypoint (column) within `radii[i]` pixels and +/-`level_window` levels
    of the predicted level. Returns (idx [P], dist [P], ok [P])."""
    dist = hamming_matrix(proj_desc, f_desc)
    diff = proj_xy[:, None, :] - f_xy[None, :, :]
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    lvl_ok = torch.abs(f_level[None, :] - proj_level[:, None]) <= level_window
    mask = (
        (d2 <= (radii * radii)[:, None])
        & lvl_ok
        & proj_valid[:, None]
        & f_valid[None, :]
    )
    return masked_best_match(dist, mask, max_dist, ratio=ratio)


def dedupe_matches(idx, ok, n_cols: int):
    """Resolve many-to-one matches: where several rows matched one column,
    keep only the lowest row. Returns the filtered ok mask."""
    n = idx.shape[0]
    rows = torch.arange(n, device=idx.device)
    col = torch.where(ok, idx, n_cols).to(torch.int64)
    first_row = torch.full((n_cols + 1,), n, dtype=torch.int64, device=idx.device)
    first_row = first_row.scatter_reduce(0, col, rows, reduce="amin", include_self=True)
    return ok & (first_row[col] == rows)


def epipolar_mask(xn1, xn2, E12, sigma2_lv2, th: float = 3.84):
    """Pairwise epipolar-band mask for the triangulation search
    (`ORBmatcher::SearchForTriangulation`). xn1 [N,3], xn2 [M,3]: normalized
    bearings (z=1); E12 maps frame-1 bearings to epipolar lines in frame 2;
    sigma2_lv2 [M]: per-keypoint level variance in normalized units. True
    where kp2 lies within the chi2 band of kp1's epipolar line. f32
    products (TF32 is off, `device.py`)."""
    lines = xn1 @ E12.T                                  # [N,3] lines in image 2
    num = torch.abs(lines @ xn2.T)                       # [N,M]
    den2 = lines[:, 0] ** 2 + lines[:, 1] ** 2
    d2 = num * num / torch.clamp(den2[:, None], min=1e-12)
    return d2 < th * sigma2_lv2[None, :]
