"""The plain reference that decides `correct`.

Plain PyTorch and NumPy. It imports nothing of the program and takes
nothing the program made but the outputs it judges: the poses the entry
returned, and the keyframes and map points in the program's map after the
window. Everything the program derived from the inputs (the resized image,
the pyramid, the blur) is worked out again here from the benchmark's own
frames, and the ground truth comes from the benchmark's own world.

Three layers are judged:

* front end (K1 and the detector before it): each keyframe's keypoint set
  against the reference's own FAST-9/16 detection and selection on the
  frame the keyframe was made of, and the keypoints' angles and
  steered-BRIEF bits recomputed at the program's keypoints (the ORB recipe:
  a linear antialiased resize and pyramid, a 7x7 Gaussian blur with sigma
  2, intensity-centroid moments over a radius-15 disc, the 256 pattern
  pairs of seed 20240131 rotated and rounded);
* tracking: the returned poses against the ground-truth path, after a
  Sim(3) alignment (monocular) or an SE(3) one (a depth sensor);
* mapping (local BA, K2/K3): the keyframe poses against the path, each
  map point seen from two keyframes or more against the world's surfaces,
  after the keyframes' alignment, and how far the reference's own
  least-squares placement moves the newest keyframe's points: its local
  BA leaves them where their observations put them, and a two-view
  triangulation does not.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .world import resize_weights

PATCH = 31
HALF = 15
BITS = 256
PATTERN_SEED = 20240131
# the 16-pixel Bresenham circle of radius 3, (dx, dy), clockwise from 12 o'clock
RING = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3))
ARC = 9            # FAST-9: nine contiguous ring pixels
EDGE = 16          # no corner within this many pixels of a level's edge
GRID = 35          # ORBextractor's cell side (W = 35)
CHI2_MONO = 5.991  # chi2 of 2 degrees of freedom at 95%: ORB-SLAM's gate


def _pattern() -> np.ndarray:
    """[256, 4] (x1, y1, x2, y2): Gaussian with sigma = patch / 5, rounded,
    clipped to 13."""
    rs = np.random.RandomState(PATTERN_SEED)
    return np.clip(np.round(rs.randn(BITS, 4) * (PATCH / 5.0)), -13, 13).astype(np.int32)


def resize(img, h: int, w: int):
    """Linear (antialiased-down) resize of [H,W] f32: rows, then columns."""
    H, W = img.shape
    if h != H:
        img = torch.from_numpy(resize_weights(H, h)).to(img.device).T @ img
    if w != W:
        img = img @ torch.from_numpy(resize_weights(W, w)).to(img.device)
    return img


def pyramid(img, n_levels: int, scale_factor: float):
    """Levels of `img`, each resized from the one before to
    round(size / scale_factor^l)."""
    h, w = img.shape
    levels = [img]
    for lv in range(1, n_levels):
        s = scale_factor ** lv
        levels.append(resize(levels[-1], int(round(h / s)), int(round(w / s))))
    return levels


def blur(img, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur with replicated edges, rows then columns."""
    x = np.arange(-(ksize // 2), ksize // 2 + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    r = ksize // 2
    h, w = img.shape
    rows = torch.arange(-r, h + r, device=img.device).clamp(0, h - 1)
    xp = img[rows]
    out = torch.zeros_like(img)
    for i in range(ksize):
        out = out + float(k[i]) * xp[i:i + h]
    cols = torch.arange(-r, w + r, device=img.device).clamp(0, w - 1)
    xp = out[:, cols]
    out = torch.zeros_like(img)
    for i in range(ksize):
        out = out + float(k[i]) * xp[:, i:i + w]
    return out


def orb(raw, blurred, xy):
    """(angle [N], bits [N,256] uint8) of keypoints xy [N,2] (level px) on
    one level: the intensity-centroid angle on the raw level, the steered
    BRIEF bits on the blurred one."""
    dev = raw.device
    h, w = raw.shape
    d = torch.arange(-HALF, HALF + 1, device=dev)
    mask = ((d[:, None] ** 2 + d[None, :] ** 2) <= HALF * HALF + 1).to(torch.float32)
    cx = torch.round(xy[:, 0]).long().clamp(HALF, w - HALF - 1)
    cy = torch.round(xy[:, 1]).long().clamp(HALF, h - HALF - 1)
    patch = raw[cy[:, None, None] + d[None, :, None], cx[:, None, None] + d[None, None, :]]
    pm = patch * mask
    dy = d.to(torch.float32)[:, None]
    dx = d.to(torch.float32)[None, :]
    m01 = (pm * dy).sum((1, 2))
    m10 = (pm * dx).sum((1, 2))
    rlen = torch.sqrt(m01 * m01 + m10 * m10)
    safe = rlen > 1e-9
    inv = torch.where(safe, 1.0 / torch.where(safe, rlen, 1.0), 0.0)
    ca = torch.where(safe, m10 * inv, 1.0)[:, None]
    sa = torch.where(safe, m01 * inv, 0.0)[:, None]
    pat = torch.from_numpy(_pattern()).to(dev, torch.float32)
    kx = torch.round(xy[:, 0]).long()[:, None]
    ky = torch.round(xy[:, 1]).long()[:, None]

    def sample(px, py):
        c = (kx + torch.round(px[None] * ca - py[None] * sa).long()).clamp(0, w - 1)
        r = (ky + torch.round(px[None] * sa + py[None] * ca).long()).clamp(0, h - 1)
        return blurred[r, c]

    bits = sample(pat[:, 0], pat[:, 1]) < sample(pat[:, 2], pat[:, 3])
    return torch.atan2(m01, m10), bits.to(torch.uint8)


def fast_score(img, th: float):
    """[H,W] FAST-9/16 score at threshold `th`: where nine contiguous ring
    pixels are all brighter than the centre by more than `th` (or all
    darker), the sum over the ring of how far each passes it on that side,
    in ring order; 0 elsewhere and within EDGE of the border."""
    h, w = img.shape
    c = img[EDGE:h - EDGE, EDGE:w - EDGE]
    ring = [img[EDGE + dy:h - EDGE + dy, EDGE + dx:w - EDGE + dx] for dx, dy in RING]
    out = torch.zeros_like(img)
    score = None
    for sign in (1.0, -1.0):
        diff = [sign * (r - c) - th for r in ring]
        flags = torch.stack([d > 0 for d in diff]).to(torch.int32)
        wrapped = torch.cat([flags, flags[:ARC - 1]])
        runs = wrapped.unfold(0, ARC, 1).sum(-1)              # [16, h', w']
        corner = (runs == ARC).any(0)
        total = torch.zeros_like(c)
        for d in diff:
            total = total + torch.clamp(d, min=0.0)
        side = torch.where(corner, total, 0.0)
        score = side if score is None else torch.maximum(score, side)
    out[EDGE:h - EDGE, EDGE:w - EDGE] = score
    return out


def strict_max3(score):
    """score where it is greater than all eight neighbours, else 0."""
    p = torch.nn.functional.pad(score, (1, 1, 1, 1))
    h, w = score.shape
    neigh = torch.stack([p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dx or dy]).amax(0)
    return torch.where(score > neigh, score, 0.0)


def level_budgets(n_features: int, n_levels: int, scale_factor: float):
    """Features per level, geometric in 1/scale (ORBextractor), at least 8."""
    f = 1.0 / scale_factor
    raw = [n_features * (1 - f) / (1 - f ** n_levels) * f ** i for i in range(n_levels)]
    return [max(8, int(round(r))) for r in raw]


def select_keypoints(img, ini_th: float, min_th: float, budget: int):
    """The keypoints ORB keeps on one level, as a set of (x, y) level px:
    strict 3x3 maxima of the FAST score, at `ini_th` in a GRID x GRID cell
    that has any and at `min_th` in one that has none; then, breadth-first
    over the cells, each cell's best first (ties by the lower row-major
    index in the cell), ordered by the rank in the cell and then by score
    (the key rank * 1e9 - score rounded once to f32, ties by cell order)."""
    h, w = img.shape
    gh, gw = -(-h // GRID), -(-w // GRID)

    def cells(x):
        x = torch.nn.functional.pad(x, (0, gw * GRID - w, 0, gh * GRID - h))
        return x.reshape(gh, GRID, gw, GRID).permute(0, 2, 1, 3).reshape(gh, gw, GRID * GRID)

    hi = cells(strict_max3(fast_score(img, ini_th)))
    lo = cells(strict_max3(fast_score(img, min_th)))
    resp = torch.where((hi > 0).any(-1, keepdim=True), hi, lo)
    k = min(budget, GRID * GRID)
    score, local = torch.sort(resp, dim=-1, descending=True, stable=True)
    score, local = score[..., :k].reshape(-1), local[..., :k]
    dev = img.device
    ys = (torch.arange(gh, device=dev)[:, None, None] * GRID + local // GRID).reshape(-1)
    xs = (torch.arange(gw, device=dev)[None, :, None] * GRID + local % GRID).reshape(-1)
    rank = torch.arange(k, device=dev).repeat(gh * gw).to(torch.float64)
    key = (rank * 1e9 - score.to(torch.float64)).to(torch.float32)
    key = torch.where(score > 0, key, math.inf)
    order = torch.sort(key, stable=True)[1][:budget]
    order = order[score[order] > 0]
    return set(zip(xs[order].tolist(), ys[order].tolist()))


def check_keyframes(kfs, frames, out_hw, orb_cfg: dict):
    """Front end: the program's keyframe features against the recipe.

    kfs: list of (frame index, xy [F,2] level-0 px, level [F], angle [F],
    bits [F,256], valid [F]) as numpy; frames: uint8 [N,V,H,W] (view 0 is
    the one described); orb_cfg: the configuration's `orb` settings.
    Returns (the largest share of differing bits in a keyframe, the largest
    angle gap in radians, the largest share of a keyframe's keypoints that
    one side selects and the other does not, features compared)."""
    n_levels, scale_factor = int(orb_cfg["n_levels"]), float(orb_cfg["scale_factor"])
    budgets = level_budgets(int(orb_cfg["n_features"]), n_levels, scale_factor)
    n_feat = 0
    worst = worst_bits = worst_kp = 0.0
    for idx, xy, level, angle, bits, valid in kfs:
        n_bits = n_diff = n_kp = n_odd = 0
        img = frames[idx, 0].to(torch.float32)
        if tuple(img.shape) != tuple(out_hw):
            img = resize(img, *out_hw)
        raws = pyramid(img, n_levels, scale_factor)
        dev = img.device
        for lv, raw in enumerate(raws):
            sel = valid & (level == lv)
            xy_lv = torch.round(torch.from_numpy(xy[sel]).to(dev) / (scale_factor ** lv))
            mine = select_keypoints(raw, float(orb_cfg["ini_th_fast"]),
                                    float(orb_cfg["min_th_fast"]), budgets[lv])
            theirs = set(map(tuple, xy_lv.long().tolist()))
            n_odd += len(mine ^ theirs)
            n_kp += len(mine)
            if not sel.any():
                continue
            ang, b = orb(raw, blur(raw), xy_lv)
            gap = torch.remainder(torch.from_numpy(angle[sel]).to(dev) - ang + math.pi,
                                  2 * math.pi) - math.pi
            worst = max(worst, float(gap.abs().max()))
            n_diff += int((torch.from_numpy(bits[sel]).to(dev) != b).sum())
            n_bits += b.numel()
            n_feat += int(sel.sum())
        if n_bits:
            worst_bits = max(worst_bits, n_diff / n_bits)
        worst_kp = max(worst_kp, n_odd / max(n_kp, 1))
    nan = math.nan
    return (worst_bits if n_feat else nan), worst, (worst_kp if kfs else nan), n_feat


def quat_to_matrix(q):
    """[N,4] (w, x, y, z) unit quaternions -> [N,3,3] f64."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)], -2)


def centers_of(poses_cw):
    """Camera centres [N,3] of world->camera poses [N,7] (q w x y z | t)."""
    poses_cw = np.asarray(poses_cw, np.float64).reshape(-1, 7)
    R = quat_to_matrix(poses_cw[:, :4])
    return -np.einsum("nji,nj->ni", R, poses_cw[:, 4:])


def umeyama(src, dst, with_scale: bool):
    """(s, R, t) minimising |dst - (s R src + t)|^2 (Umeyama 1991)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(dc.T @ sc / len(src))
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U) * np.linalg.det(Vt))])
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / max((sc * sc).sum() / len(src), 1e-300)) \
        if with_scale else 1.0
    return s, R, mu_d - s * R @ mu_s


def ate(est_centers, gt_centers, with_scale: bool):
    """(RMSE of the aligned centres, the alignment (s, R, t), each centre's
    error)."""
    sim = umeyama(est_centers, gt_centers, with_scale)
    s, R, t = sim
    err = np.linalg.norm((s * est_centers @ R.T + t) - gt_centers, axis=1)
    return float(np.sqrt((err * err).mean())), sim, err


def align_poses(est_cw, gt_R_wc, gt_centers, with_scale: bool):
    """(s, R, t) taking the program's world to the truth, from whole poses:
    R the rotation nearest to the mean of R_gt_wc R_est_wc^T, then s and t
    by least squares on the centres. Unlike a fit of the centres alone it
    holds the rotation about a straight path."""
    est_cw = np.asarray(est_cw, np.float64).reshape(-1, 7)
    R_est_wc = quat_to_matrix(est_cw[:, :4]).transpose(0, 2, 1)
    U, _, Vt = np.linalg.svd(np.einsum("nij,nkj->ik", gt_R_wc, R_est_wc))
    R = U @ np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))]) @ Vt
    c_est = centers_of(est_cw) @ R.T
    de, dg = c_est - c_est.mean(0), gt_centers - gt_centers.mean(0)
    s = float((de * dg).sum() / max((de * de).sum(), 1e-300)) if with_scale else 1.0
    return s, R, gt_centers.mean(0) - s * c_est.mean(0)


def reprojection(kf_pose, kf_xy, kf_level, kf_obs, pt_pos, K, scale_factor: float,
                 min_obs: int = 2):
    """chi2 of each observation of a map point seen by `min_obs` keyframes
    or more: the squared pixel distance between the keypoint (level-0 px)
    and the point projected by the keyframe's pose with the pinhole K =
    (fx, fy, cx, cy), over the level's variance scale^(2 level); inf behind
    the camera. kf_obs [L,F] holds each feature's point index or -1, into
    pt_pos [P,3] of valid points only (others -1). Returns (chi2 [O],
    keyframe row [O])."""
    kf_obs = np.asarray(kf_obs)
    n_obs = np.bincount(kf_obs[kf_obs >= 0].ravel(), minlength=len(pt_pos))
    rows, feats = np.nonzero(kf_obs >= 0)
    pid = kf_obs[rows, feats]
    keep = n_obs[pid] >= min_obs
    rows, feats, pid = rows[keep], feats[keep], pid[keep]
    pose = np.asarray(kf_pose, np.float64).reshape(-1, 7)
    R = quat_to_matrix(pose[:, :4])
    pc = np.einsum("nij,nj->ni", R[rows], np.asarray(pt_pos, np.float64)[pid]) + pose[rows, 4:]
    z = pc[:, 2]
    zs = np.where(z > 0, z, 1.0)
    uv = np.stack([K[0] * pc[:, 0] / zs + K[2], K[1] * pc[:, 1] / zs + K[3]], -1)
    e2 = ((uv - np.asarray(kf_xy, np.float64)[rows, feats]) ** 2).sum(-1)
    chi2 = e2 / scale_factor ** (2.0 * np.asarray(kf_level)[rows, feats])
    return np.where(z > 0, chi2, np.inf), rows


def refine_points(kf_pose, kf_xy, kf_level, kf_obs, pt_pos, K, scale_factor: float,
                  point_ids, iters: int = 10):
    """Each point of `point_ids` placed where its observations put it: with
    the keyframe poses held, Gauss-Newton on the level-weighted
    reprojection error over the point's observations that pass the chi2
    gate where the program left it (a local BA's Huber cost is that sum
    there), from the program's position. Arguments as `reprojection`.
    Returns (refined [N,3], the program's [N,3], inlier observations [N])."""
    kf_obs = np.asarray(kf_obs)
    pt_pos = np.asarray(pt_pos, np.float64)
    chi2, rows = reprojection(kf_pose, kf_xy, kf_level, kf_obs, pt_pos, K, scale_factor, 1)
    r_all, f_all = np.nonzero(kf_obs >= 0)
    keep = chi2 <= CHI2_MONO
    r_all, f_all = r_all[keep], f_all[keep]
    pid_all = kf_obs[r_all, f_all]
    slot = np.full(len(pt_pos), -1)
    slot[point_ids] = np.arange(len(point_ids))
    use = slot[pid_all] >= 0
    r, f, j = r_all[use], f_all[use], slot[pid_all[use]]
    pose = np.asarray(kf_pose, np.float64).reshape(-1, 7)
    R = quat_to_matrix(pose[:, :4])[r]
    t = pose[r, 4:]
    xy = np.asarray(kf_xy, np.float64)[r, f]
    w = scale_factor ** (-2.0 * np.asarray(kf_level)[r, f])
    p0 = pt_pos[point_ids].copy()
    p = p0.copy()
    for _ in range(iters):
        pc = np.einsum("nij,nj->ni", R, p[j]) + t
        z = np.maximum(pc[:, 2], 1e-6)
        res = np.stack([K[0] * pc[:, 0] / z + K[2], K[1] * pc[:, 1] / z + K[3]], -1) - xy
        dpi = np.zeros((len(z), 2, 3))
        dpi[:, 0, 0] = K[0] / z
        dpi[:, 0, 2] = -K[0] * pc[:, 0] / (z * z)
        dpi[:, 1, 1] = K[1] / z
        dpi[:, 1, 2] = -K[1] * pc[:, 1] / (z * z)
        J = dpi @ R                                               # [O,2,3]
        H = np.zeros((len(p), 3, 3))
        g = np.zeros((len(p), 3))
        np.add.at(H, j, w[:, None, None] * np.einsum("nki,nkj->nij", J, J))
        np.add.at(g, j, w[:, None] * np.einsum("nki,nk->ni", J, res))
        H += 1e-9 * np.trace(H, axis1=1, axis2=2)[:, None, None] * np.eye(3)
        ok = np.linalg.det(H) > 0
        step = np.zeros_like(p)
        step[ok] = np.linalg.solve(H[ok], -g[ok][..., None])[..., 0]
        p = p + step
    return p, p0, np.bincount(j, minlength=len(p))


def map_error(points, n_obs, sim, world, min_obs: int = 2):
    """Median distance (m) from the map points seen by `min_obs` keyframes
    or more, taken to the truth by `sim` (`align_poses`), to the world's
    nearest surface, and their count."""
    s, R, t = sim
    sel = n_obs >= min_obs
    if not sel.any():
        return math.nan, 0
    pts = s * np.asarray(points, np.float64)[sel] @ R.T + t
    return float(np.median(world.distance_to_surface(pts))), int(sel.sum())
