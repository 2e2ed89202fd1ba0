"""Binary descriptor matching as dense masked Hamming matrices.

Port of the tracking and triangulation half of `dvm_slam_tpu/ops/matching.py`
(`mutual_filter`, `rotation_consistency` and `search_for_initialization`
wait for monocular initialization). Hamming
distances come from one f32 matmul of the unpacked {0,1} descriptors:

  ham(a, b) = pop(a) + pop(b) - 2 * (a . b)

Every partial sum is an integer <= 256, so the f32 product is exact (TF32 is
off, `device.py`). A bf16 `torch.matmul` would return bf16 and is not used.
Reference constants (`ORBmatcher.cc:36-38`): TH_LOW = 50, TH_HIGH = 100.
"""

from __future__ import annotations

import torch

TH_LOW = 50
TH_HIGH = 100

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
