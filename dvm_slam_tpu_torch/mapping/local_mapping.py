"""Local mapping: point culling, new-point triangulation, duplicate fusion
and windowed BA, per new keyframe.

Port of the per-keyframe chain of `dvm_slam_tpu/mapping/local_mapping.py`
(`LocalMapping.cc` semantics): `cull_points`, `create_new_points`,
`fuse_duplicates`, `_compact_obs`, `local_ba` (with the two-camera gauge
pin of a monocular window, or a stereo / RGB-D map's disparity rows and one
anchor), `_mapper_step` / `_mapper_chain`, the visual part of the host
`LocalMapper`, the post-merge `global_ba` with `apply_gba_correction`, and
`local_ba_batched` (B monocular maps' windows in one solve, the agents'
batch axis of `parallel/multi_agent.py`), and the inertial stages of
`LocalMapper` (IMU initialization, scale refinement, the VI local BA of
`vi_ba.py`).

Three rules keep the outputs equal to the reference's:

* every `jax.lax.top_k` is `ops/fast.py::_top_k`, a stable descending sort
  (ties lowest index first); covisibility rows and 0/1 scores are full of
  ties, and `local_ba`'s writeback relies on `_compact_obs` being stable;
* every `.at[i].set(v)` that can repeat a real index goes through
  `map_state.scatter_set_last` (last update wins, as XLA applies them);
* `torch.argmax` over a bool mask runs on uint8 and returns the first
  maximum, which is the reference's first-True rule.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import imu, lie
from ..geometry import triangulation as tri
from ..loopclosing import merge as merge_mod
from ..ops import matching
from ..ops.fast import _top_k
from ..utils import profiling
from . import ba, map_state, vi_ba


def _level_scales(n_levels: int, scale_factor: float, device):
    return torch.tensor([scale_factor ** i for i in range(n_levels)], dtype=torch.float32,
                        device=device)


def _nanmedian(x):
    """`jnp.nanmedian` of a 1-D f32 tensor: linear interpolation between the
    two middle values of an even count (torch.nanmedian returns the lower
    one); nan when every value is nan. No host sync."""
    valid = ~torch.isnan(x)
    s = torch.sort(torch.where(valid, x, torch.inf)).values
    n = torch.sum(valid).to(x.dtype)
    q = 0.5 * (n - 1.0)
    lo, hi = torch.floor(q), torch.ceil(q)
    w_hi = q - lo
    top = torch.clamp(n - 1.0, min=0.0)
    lo_i = torch.clamp(lo, min=0.0).minimum(top).to(torch.int64)
    hi_i = torch.clamp(hi, min=0.0).minimum(top).to(torch.int64)
    med = s[lo_i] * (1.0 - w_hi) + s[hi_i] * w_hi
    return torch.where(n > 0, med, torch.nan)


# --------------------------------------------------------------------------
# new point creation
# --------------------------------------------------------------------------

def create_new_points(m: map_state.MapState, center, K, n_neighbors: int = 5,
                      n_levels: int = 8, scale_factor: float = 1.2):
    """Triangulate new map points between the center KF and its top covisible
    neighbors (`LocalMapping::CreateNewMapPoints`). Returns (map, n_added)."""
    dev = m.pt_pos.device
    scales = _level_scales(n_levels, scale_factor, dev)
    sigma2 = scales * scales
    F = m.feat_capacity
    f = K[0]
    arF = torch.arange(F, device=dev)

    cov = map_state.covis_row(m, center)
    nw, nidx = _top_k(cov, n_neighbors)
    nvalid = (nw > 0) & m.kf_valid[nidx]

    Tc = m.kf_pose[center]
    xc = (m.kf_xy[center] - K[None, 2:4]) / K[None, 0:2]          # normalized
    xc3 = torch.cat([xc, torch.ones((F, 1), dtype=xc.dtype, device=dev)], -1)
    free_c = (m.kf_obs[center] < 0) & m.kf_feat_valid[center]
    lvl_c = m.kf_level[center].to(torch.int64)
    center_c = lie.se3_t(lie.se3_inv(Tc))

    # median scene depth of the center KF for the baseline check
    obs_c = m.kf_obs[center]
    pc_all = lie.se3_apply(Tc[None], m.pt_pos)
    zvals = torch.where(obs_c >= 0, pc_all[torch.clamp(obs_c, min=0).to(torch.int64), 2],
                        torch.nan)
    med_depth = _nanmedian(zvals)
    med_depth = torch.where(torch.isfinite(med_depth), med_depth, 1.0)

    def reproj_err(T, xn_obs, Xp):
        pc = lie.se3_apply(T[None], Xp)
        uv = pc[:, :2] / torch.clamp(pc[:, 2:3], min=1e-9)
        return torch.sum((uv - xn_obs) ** 2, -1) * f * f

    Xs, js, goods = [], [], []
    for ni in range(nidx.shape[0]):
        n = nidx[ni]
        Tn = m.kf_pose[n]
        Tnc = lie.se3_mul(Tn, lie.se3_inv(Tc))
        R = lie.quat_to_matrix(lie.se3_q(Tnc))
        t = lie.se3_t(Tnc)
        center_n = lie.se3_t(lie.se3_inv(Tn))
        baseline = torch.linalg.norm(center_n - center_c)
        enough_baseline = baseline / torch.clamp(med_depth, min=1e-9) > 0.01

        E = lie.hat(t) @ R                                         # xn^T E xc = 0
        xn = (m.kf_xy[n] - K[None, 2:4]) / K[None, 0:2]
        xn3 = torch.cat([xn, torch.ones((F, 1), dtype=xn.dtype, device=dev)], -1)
        free_n = (m.kf_obs[n] < 0) & m.kf_feat_valid[n]
        lvl_n = m.kf_level[n].to(torch.int64)
        sig_n = sigma2[lvl_n] / (f * f)                            # normalized units
        epi = matching.epipolar_mask(xc3, xn3, E, sig_n)
        dist = matching.hamming_matrix(m.kf_desc[center], m.kf_desc[n])
        mask = epi & free_c[:, None] & free_n[None, :] & nvalid[ni] & enough_baseline
        idx, _, ok = matching.masked_best_match(dist, mask, matching.TH_LOW, ratio=0.75)
        ok = matching.dedupe_matches(idx, ok, F)
        j = torch.clamp(idx, min=0)

        Tcb = Tc.expand(F, 7)
        Tnb = Tn.expand(F, 7)
        X, okt = tri.triangulate(xc, xn[j], Tcb, Tnb)
        z1 = lie.se3_apply(Tc[None], X)[:, 2]
        z2 = lie.se3_apply(Tn[None], X)[:, 2]
        cpar = tri.parallax_cos(Tcb, Tnb, X)
        e1 = reproj_err(Tc, xc, X)
        e2 = reproj_err(Tn, xn[j], X)
        s1 = sigma2[lvl_c]
        s2 = sigma2[lvl_n[j]]
        # scale consistency (ratioDist vs ratioOctave within 1.5x)
        d1 = torch.linalg.norm(X - center_c[None], dim=-1)
        d2 = torch.linalg.norm(X - center_n[None], dim=-1)
        ratio_d = d2 / torch.clamp(d1, min=1e-9)
        ratio_o = scales[lvl_c] / scales[lvl_n[j]]
        scale_ok = ((ratio_d < ratio_o * scale_factor * 1.5)
                    & (ratio_d * scale_factor * 1.5 > ratio_o))
        good = (ok & okt & (z1 > 0) & (z2 > 0) & (cpar < 0.9998)
                & (e1 < 5.991 * s1) & (e2 < 5.991 * s2) & scale_ok)
        Xs.append(X)
        js.append(torch.where(good, j, -1))
        goods.append(good)
    Xs, js, goods = torch.stack(Xs), torch.stack(js), torch.stack(goods)   # [NN,F,...]

    # one new point per center feature: the first neighbor that produced a
    # good triangulation for it
    any_good = torch.any(goods, dim=0)
    first = torch.argmax(goods.to(torch.uint8), dim=0)
    Xsel = Xs[first, arF]
    jsel = js[first, arF]
    nsel = nidx[first]

    m2, slots = map_state.add_points(
        m, pos=Xsel, desc=m.kf_desc[center],
        normal=torch.zeros((F, 3), dtype=m.pt_pos.dtype, device=dev),
        min_dist=torch.zeros((F,), dtype=m.pt_pos.dtype, device=dev),
        max_dist=torch.full((F,), 1e9, dtype=m.pt_pos.dtype, device=dev),
        ref_kf=center, valid=any_good,
    )
    added = slots >= 0
    # wire observations: center feature -> slot, neighbor feature -> slot
    kf_obs = m2.kf_obs.clone()
    kf_obs[center] = torch.where(added, slots, m2.kf_obs[center]).to(torch.int32)
    # neighbor writes at (nsel, jsel); the others go to a pad row
    Kcap = m2.kf_capacity
    rown = torch.where(added, nsel, Kcap)
    coln = torch.where(added, jsel, 0)
    big = torch.cat([kf_obs, torch.full((1, F), -1, dtype=torch.int32, device=dev)])
    flat = (rown * F + coln).to(torch.int64)
    cur = big.reshape(-1)[flat]
    big = map_state.scatter_set_last(big.reshape(-1), flat,
                                     torch.where(added, slots, cur)).reshape(Kcap + 1, F)
    return m2._replace(kf_obs=big[:-1]), torch.sum(added, dtype=torch.int32)


# --------------------------------------------------------------------------
# fusion of duplicate points
# --------------------------------------------------------------------------

def fuse_duplicates(m: map_state.MapState, center, K, n_neighbors: int = 5,
                    n_levels: int = 8, scale_factor: float = 1.2):
    """Project the center KF's points into its neighbors and fuse
    (`LocalMapping::SearchInNeighbors` + `ORBmatcher::Fuse`): a matched
    feature that observes another point merges the two (the more-observed
    one survives, the other is remapped everywhere); a free matched feature
    gains the observation."""
    dev = m.pt_pos.device
    scales = _level_scales(n_levels, scale_factor, dev)
    F = m.feat_capacity
    P = m.pt_capacity

    cov = map_state.covis_row(m, center)
    nw, nidx = _top_k(cov, n_neighbors)
    nvalid = (nw > 0) & m.kf_valid[nidx]

    pts_c = m.kf_obs[center]
    src_valid = (pts_c >= 0) & m.kf_feat_valid[center]
    psl = torch.clamp(pts_c, min=0).to(torch.int64)
    pos = m.pt_pos[psl]
    desc = m.pt_desc[psl]
    n_obs = map_state.point_observers(m)

    idxs, oks = [], []
    for ni in range(nidx.shape[0]):
        n = nidx[ni]
        Tn = m.kf_pose[n]
        pc = lie.se3_apply(Tn[None], pos)
        uv = K[0:2] * pc[:, :2] / torch.clamp(pc[:, 2:3], min=1e-9) + K[2:4]
        front = pc[:, 2] > 0
        dist_c = torch.linalg.norm(pos - lie.se3_t(lie.se3_inv(Tn))[None], dim=-1)
        lvl = map_state.predict_scale(dist_c, m.pt_max_dist[psl], n_levels, scale_factor)
        radii = 3.0 * scales[lvl.to(torch.int64)]
        dmat = matching.hamming_matrix(desc, m.kf_desc[n])
        d2 = torch.sum((uv[:, None, :] - m.kf_xy[n][None, :, :]) ** 2, -1)
        lvl_ok = torch.abs(m.kf_level[n][None, :] - lvl[:, None]) <= 1
        mask = ((d2 <= (radii ** 2)[:, None]) & lvl_ok & src_valid[:, None]
                & m.kf_feat_valid[n][None, :] & front[:, None] & nvalid[ni])
        idx, _, ok = matching.masked_best_match(dmat, mask, matching.TH_LOW)
        ok = matching.dedupe_matches(idx, ok, F)
        idxs.append(torch.where(ok, idx, -1))
        oks.append(ok)

    # merge remap + new observations, neighbor by neighbor
    remap = torch.arange(P, dtype=torch.int32, device=dev)
    kf_obs = m.kf_obs.clone()
    pt_valid = m.pt_valid
    no_kill = torch.zeros((P,), dtype=torch.bool, device=dev)
    for ni in range(nidx.shape[0]):
        n = nidx[ni]
        ok = oks[ni]
        feat = torch.clamp(idxs[ni], min=0)
        row = kf_obs[n]
        tgt = row[feat]                                            # existing point at target
        p_src = remap[psl]                                         # follow prior merges
        has_tgt = (tgt >= 0) & ok
        tgt_c = torch.clamp(remap[torch.clamp(tgt, min=0).to(torch.int64)], min=0)
        keep_src = n_obs[p_src.to(torch.int64)] >= n_obs[tgt_c.to(torch.int64)]
        winner = torch.where(keep_src, p_src, tgt_c)
        loser = torch.where(keep_src, tgt_c, p_src)
        do_merge = has_tgt & (p_src != tgt_c) & src_valid
        # loser -> winner (one hop per round); the dummy target P-1 is a real
        # slot, so the in-order last-write-wins matters
        remap = map_state.scatter_set_last(
            remap, torch.where(do_merge, loser, P - 1), torch.where(do_merge, winner, remap[P - 1]))
        pt_valid = pt_valid & ~map_state.scatter_set_last(
            no_kill, torch.where(do_merge, loser, 0), do_merge)
        # free feature -> add observation of the source point
        add_obs = ok & (tgt < 0) & src_valid
        kf_obs[n] = map_state.scatter_set_last(
            row, torch.where(add_obs, feat, F - 1), torch.where(add_obs, p_src, row[F - 1]))

    # apply the remap across the whole observation table
    kf_obs = torch.where(kf_obs >= 0, remap[torch.clamp(kf_obs, min=0).to(torch.int64)], -1)
    return m._replace(kf_obs=kf_obs, pt_valid=pt_valid)


# --------------------------------------------------------------------------
# culling
# --------------------------------------------------------------------------

def cull_points(m: map_state.MapState, current_kf):
    """`LocalMapping::MapPointCulling`: found/visible < 0.25 -> bad; >= 2
    keyframes since creation and <= 2 observers -> bad; only points at most
    3 keyframes old are tested. Observations of culled points are dropped."""
    age = current_kf - m.pt_first_kf
    ratio = m.pt_found.to(torch.float32) / torch.clamp(m.pt_visible, min=1).to(torch.float32)
    nobs = map_state.point_observers(m)
    young = age <= 3
    bad = (ratio < 0.25) & young
    bad = bad | ((age >= 2) & (nobs <= 2) & young)
    dead = m.pt_valid & bad
    kf_obs = torch.where((m.kf_obs >= 0) & dead[torch.clamp(m.kf_obs, min=0).to(torch.int64)],
                         -1, m.kf_obs)
    return m._replace(pt_valid=m.pt_valid & ~bad, kf_obs=kf_obs)


# --------------------------------------------------------------------------
# windowed bundle adjustment
# --------------------------------------------------------------------------

def _compact_obs(kf_xy, kf_sig, obs_pt, n_obs: int, kf_ur=None):
    """Keep the `n_obs` best slots per keyframe row, valid observations
    first, each group in ascending feature order (stable)."""
    _, sel = _top_k((obs_pt >= 0).to(torch.float32), n_obs)       # [L,n_obs]
    return (torch.take_along_dim(kf_xy, sel[..., None], dim=1),
            torch.take_along_dim(kf_sig, sel, dim=1),
            torch.take_along_dim(obs_pt, sel, dim=1),
            None if kf_ur is None else torch.take_along_dim(kf_ur, sel, dim=1))


def _ba_window(m: map_state.MapState, center, n_local: int, n_fixed: int, n_pts: int,
               n_levels: int, scale_factor: float, n_obs: int, depth: bool = False):
    """`local_ba`'s window around `center` at fixed shapes: the BA's inputs
    (poses, fixed, compacted observations, points, pt_opt; then the
    compacted right-u, None unless `depth`) and what the writeback needs."""
    dev = m.pt_pos.device
    i32 = torch.int32
    scales = _level_scales(n_levels, scale_factor, dev)
    sigma2_lv = scales * scales
    P = m.pt_capacity
    F = m.feat_capacity
    Kcap = m.kf_capacity
    n_pts = min(n_pts, P)
    n_local = min(n_local, Kcap + 1)
    n_fixed = min(n_fixed, Kcap)
    center = torch.as_tensor(center, dtype=i32, device=dev)

    obs_all = torch.where(m.kf_obs >= 0, m.kf_obs, P).to(torch.int64)   # [K,F]
    cov = map_state.covis_row(m, center)
    cw, cidx = _top_k(cov, n_local - 1)
    lmask = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                       (cw > 0) & m.kf_valid[cidx]])
    lidx = torch.cat([center[None], cidx.to(i32)])

    # local points: observed by any local KF (a scatter into a sentinel slot)
    obs_l = torch.where(lmask[:, None], m.kf_obs[lidx.to(torch.int64)], -1)
    is_local_pt = torch.zeros((P + 1,), dtype=torch.bool, device=dev)
    is_local_pt[torch.where(obs_l >= 0, obs_l, P).reshape(-1).to(torch.int64)] = True
    is_local_pt = is_local_pt[:P] & m.pt_valid
    # the best-constrained local points win when there are more than n_pts
    sel_score = torch.where(is_local_pt, 1.0 + m.pt_found.to(torch.float32), 0.0)
    _, sel = _top_k(sel_score, n_pts)
    sel_ok = is_local_pt[sel]
    sel_tgt = torch.where(sel_ok, sel, P)
    inv = map_state.scatter_set_last(torch.full((P + 1,), -1, dtype=i32, device=dev), sel_tgt,
                                     torch.arange(n_pts, dtype=i32, device=dev))

    # fixed KFs: observers of selected points that are not local
    sel_flag = map_state.scatter_set_last(torch.zeros((P + 1,), dtype=torch.bool, device=dev),
                                          sel_tgt, sel_ok)
    obs_sel_count = torch.sum(sel_flag[obs_all], dim=1, dtype=i32)
    # the dummy target 0 is a real slot: in-order last write wins
    is_local_kf = map_state.scatter_set_last(torch.zeros((Kcap,), dtype=torch.bool, device=dev),
                                             torch.where(lmask, lidx, 0), lmask)
    fscore = torch.where(m.kf_valid & ~is_local_kf, obs_sel_count, 0)
    fw, fidx = _top_k(fscore, n_fixed)
    fmask = fw > 0

    rows = torch.cat([lidx, fidx.to(i32)])                          # [L+X]
    rmask = torch.cat([lmask, fmask])
    fixed = torch.cat([torch.zeros((n_local,), dtype=torch.bool, device=dev),
                       torch.ones((n_fixed,), dtype=torch.bool, device=dev)])
    fixed = fixed | (rows == 0) | ~rmask          # keyframe 0 is the gauge anchor
    # A monocular window needs the full Sim(3) gauge pinned: one fixed
    # camera leaves the scale direction free. Pin the two oldest valid rows
    # whenever the window brought fewer than two anchors of its own. The
    # disparity rows of a depth map fix its scale, but it still needs one
    # anchor when keyframe 0 is not in the window.
    ids = torch.where(rmask, rows, 2 ** 30)
    oldest = torch.min(ids)
    n_anchor = torch.sum(fixed & rmask)
    if depth:
        fixed = fixed | ((n_anchor == 0) & (rows == oldest) & rmask)
    else:
        second = torch.min(torch.where(ids == oldest, 2 ** 30, ids))
        fixed = fixed | ((n_anchor < 2) & ((rows == oldest) | (rows == second)) & rmask)

    rowc = torch.clamp(rows, min=0).to(torch.int64)
    obs_pt_g = torch.where(rmask[:, None], m.kf_obs[rowc], -1)      # global slots
    obs_pt = torch.where(obs_pt_g >= 0, inv[torch.clamp(obs_pt_g, min=0).to(torch.int64)], -1)

    no = min(n_obs, F)
    kf_ur = torch.where(rmask[:, None], m.kf_ur[rowc], -1.0) if depth else None
    kf_xy_c, kf_sig_c, obs_pt_c, kf_ur_c = _compact_obs(
        m.kf_xy[rowc], sigma2_lv[m.kf_level[rowc].to(torch.int64)], obs_pt, no, kf_ur)
    ba_in = (m.kf_pose[rowc], fixed, kf_xy_c, kf_sig_c, obs_pt_c, m.pt_pos[sel], sel_ok)
    return ba_in, kf_ur_c, (rows, rmask, fixed, inv, sel_flag, obs_pt, obs_pt_g, no)


def _ba_writeback(m: map_state.MapState, ctx, new_poses, new_pts, inliers_c):
    """Fold a window's BA result back into the map: the non-fixed poses, the
    window's points, and the observations that ended as outliers erased."""
    rows, rmask, fixed, inv, sel_flag, obs_pt, obs_pt_g, no = ctx
    dev = m.pt_pos.device
    i32 = torch.int32
    P = m.pt_capacity
    Kcap = m.kf_capacity
    # expand the compacted inlier mask onto the full feature table: compacted
    # slot i of row l is the i-th valid observation, so a rank gather undoes it
    LX = obs_pt.shape[0]
    valid_o = obs_pt >= 0
    rank = torch.cumsum(valid_o.to(i32), dim=1, dtype=i32) - 1
    in_c = torch.take_along_dim(inliers_c, torch.clamp(rank, 0, no - 1).to(torch.int64), dim=1)
    inliers = torch.where(valid_o & (rank < no), in_c, valid_o)

    # write back poses (non-fixed window rows) and points via inverse row maps
    upd = rmask & ~fixed
    arangeLX = torch.arange(LX, dtype=i32, device=dev)

    def row_of(mask):
        w = torch.full((Kcap,), -1, dtype=i32, device=dev)
        return w.scatter_reduce(0, torch.where(mask, rows, Kcap - 1).to(torch.int64),
                                torch.where(mask, arangeLX, -1), "amax")

    wpos_all = row_of(rmask)
    wpos_upd = row_of(upd)
    kf_pose = torch.where((wpos_upd >= 0)[:, None],
                          new_poses[torch.clamp(wpos_upd, min=0).to(torch.int64)], m.kf_pose)
    has_p = (inv[:P] >= 0) & sel_flag[:P]
    pt_pos = torch.where(has_p[:, None], new_pts[torch.clamp(inv[:P], min=0).to(torch.int64)],
                         m.pt_pos)
    # erase the observations that ended as BA outliers; only edges that took
    # part in the solve (obs_pt >= 0) are eligible
    new_rows = torch.where(valid_o & ~inliers, -1, obs_pt_g)
    kf_obs = torch.where((wpos_all >= 0)[:, None],
                         new_rows[torch.clamp(wpos_all, min=0).to(torch.int64)], m.kf_obs)
    return m._replace(kf_pose=kf_pose, pt_pos=pt_pos, kf_obs=kf_obs)


@profiling.traced("mapping.local_ba")
def local_ba(m: map_state.MapState, center, K, n_local: int = 16, n_fixed: int = 16,
             n_pts: int = 4096, iters: int = 6, n_levels: int = 8,
             scale_factor: float = 1.2, n_obs: int = 512, bf=None, use_kernel=None):
    """Covisibility-window BA around `center` (`Optimizer::
    LocalBundleAdjustment` window): local = center + covisible keyframes;
    points = those observed by local keyframes (the best `n_pts` by
    `pt_found`); fixed = other observers of those points + keyframe 0, and
    at least two pinned cameras for a monocular window (the Sim(3) gauge),
    one for a depth map's. `bf` (fx * baseline) adds the stereo rows of the
    keyframes' right-u channel. Returns (map, chi2)."""
    ba_in, kf_ur, ctx = _ba_window(m, center, n_local, n_fixed, n_pts, n_levels, scale_factor,
                                   n_obs, depth=bf is not None)
    new_poses, new_pts, chi2, inliers_c = ba.bundle_adjust(*ba_in, K, iters=iters, kf_ur=kf_ur,
                                                           bf=bf, use_kernel=use_kernel)
    return _ba_writeback(m, ctx, new_poses, new_pts, inliers_c), chi2


def local_ba_batched(ms: map_state.MapState, centers, K, n_local: int = 16, n_fixed: int = 16,
                     n_pts: int = 4096, iters: int = 6, n_levels: int = 8,
                     scale_factor: float = 1.2, n_obs: int = 512, bf=None, use_kernel=None):
    """B covisibility-window BAs in one solve (the reference's `jax.vmap` of
    `local_ba`; one window per agent's map). `ms` is a MapState stacked on a
    leading batch axis (`map_state.stack_maps`), `centers` [B] the window
    centers, K [4] shared or [B,4]. Each map's window is selected at
    `local_ba`'s fixed shapes, then ONE `ba.bundle_adjust_batched` solves
    all B windows, with one K3 and one K2 launch per LM step, LM damping
    and acceptance per map. Returns (ms', chi2 [B]), every map updated as
    `local_ba` alone would update it. Monocular maps only: the JAX mesh
    step that batches agents is monocular, and `bf` raises."""
    if bf is not None:
        raise NotImplementedError("the batched BA is monocular; a depth map's BA is local_ba")
    maps = map_state.unstack_maps(ms, ms.kf_pose.shape[0])
    wins = [_ba_window(m, c, n_local, n_fixed, n_pts, n_levels, scale_factor, n_obs)
            for m, c in zip(maps, centers)]
    ba_in = [torch.stack(xs) for xs in zip(*(w[0] for w in wins))]
    new_poses, new_pts, chi2, inliers_c = ba.bundle_adjust_batched(*ba_in, K, iters=iters,
                                                                   use_kernel=use_kernel)
    out = [_ba_writeback(m, w[2], new_poses[b], new_pts[b], inliers_c[b])
           for b, (m, w) in enumerate(zip(maps, wins))]
    return map_state.stack_maps(out), chi2


def global_ba(m: map_state.MapState, K, n_kf_max: int | None = None, n_pts: int | None = None,
              iters: int = 10, n_levels: int = 8, scale_factor: float = 1.2, bf=None):
    """Global BA (`Optimizer::GlobalBundleAdjustemnt`, spawned after a
    merge by `LoopClosing::RunGlobalBundleAdjustment`) with
    `ba.bundle_adjust_pcg`. The full keyframe and point capacity by default;
    `n_kf_max`/`n_pts` cap the problem to a slot prefix and the `n_pts` best
    observed points. Keyframe 0 is the gauge, and a monocular map pins the
    second-oldest valid keyframe too (the Sim(3) scale); `bf` adds the
    disparity rows of a depth map, which fix its scale. Returns (map, chi2)."""
    dev = m.pt_pos.device
    i32 = torch.int32
    scales = _level_scales(n_levels, scale_factor, dev)
    sigma2_lv = scales * scales
    P = m.pt_capacity
    n_kf_max = m.kf_capacity if n_kf_max is None else n_kf_max
    n_pts = P if n_pts is None else n_pts

    rows = torch.arange(n_kf_max, dtype=i32, device=dev)
    rmask = m.kf_valid[:n_kf_max]
    fixed = (rows == 0) | ~rmask
    if bf is None:
        ids = torch.where(rmask & (rows != 0), rows, 2 ** 30)
        fixed = fixed | (rows == torch.min(ids))

    obs = m.kf_obs[:n_kf_max]
    if n_pts >= P:
        # the full point table: observation rows index pt_pos directly
        obs_pt = torch.where(rmask[:, None] & (obs >= 0)
                             & m.pt_valid[torch.clamp(obs, min=0).to(torch.int64)], obs, -1)
        pts0, pt_opt, sel = m.pt_pos, m.pt_valid, None
    else:
        nobs = map_state.point_observers(m)
        _, sel = _top_k(torch.where(m.pt_valid, nobs.to(torch.float32), 0.0), n_pts)
        sel_ok = m.pt_valid[sel]
        inv = map_state.scatter_set_last(torch.full((P + 1,), -1, dtype=i32, device=dev),
                                         torch.where(sel_ok, sel, P),
                                         torch.arange(n_pts, dtype=i32, device=dev))
        obs_pt_g = torch.where(rmask[:, None], obs, -1)
        obs_pt = torch.where(obs_pt_g >= 0, inv[torch.clamp(obs_pt_g, min=0).to(torch.int64)], -1)
        pts0, pt_opt = m.pt_pos[sel], sel_ok

    kf_ur = None if bf is None else torch.where(rmask[:, None], m.kf_ur[:n_kf_max], -1.0)
    new_poses, new_pts, chi2, _ = ba.bundle_adjust_pcg(
        m.kf_pose[:n_kf_max], fixed, m.kf_xy[:n_kf_max],
        sigma2_lv[m.kf_level[:n_kf_max].to(torch.int64)], obs_pt.to(i32), pts0, pt_opt, K,
        kf_ur=kf_ur, bf=bf, lm_iters=iters)
    upd = rmask & ~fixed
    kf_pose = m.kf_pose.clone()
    kf_pose[:n_kf_max] = torch.where(upd[:, None], new_poses, m.kf_pose[:n_kf_max])
    if sel is None:
        pt_pos = torch.where(m.pt_valid[:, None], new_pts, m.pt_pos)
    else:
        # the unselected rows all land in the padding row, which is dropped
        ppad = torch.cat([m.pt_pos, torch.zeros((1, 3), dtype=m.pt_pos.dtype, device=dev)])
        ppad[torch.where(sel_ok, sel, P)] = torch.where(sel_ok[:, None], new_pts,
                                                         ppad[torch.where(sel_ok, sel, P)])
        pt_pos = ppad[:-1]
    return m._replace(kf_pose=kf_pose, pt_pos=pt_pos), chi2


def apply_gba_correction(m: map_state.MapState, res_pose, res_pt, n_kf_snap, n_pt_snap, anchor):
    """Fold a global-BA result computed on a snapshot back into the live map,
    which may have grown since (the catch-up of `RunGlobalBundleAdjustment`):
    snapshot keyframes (< n_kf_snap) take the optimized poses, newer ones
    T' = T T_anchor_live^-1 T_anchor_gba; snapshot points take the optimized
    positions, newer ones re-project through their reference keyframe,
    x' = T_ref_new^-1 (T_ref_old x)."""
    dev = m.pt_pos.device
    Kc, Pc = m.kf_capacity, m.pt_capacity
    anchor = int(anchor)
    old_kf = (torch.arange(Kc, device=dev) < int(n_kf_snap)) & m.kf_valid
    corr = lie.se3_mul(lie.se3_inv(m.kf_pose[anchor]), res_pose[anchor])
    prop = lie.se3_mul(m.kf_pose, corr[None])
    kf_pose = torch.where(old_kf[:, None], res_pose,
                          torch.where(m.kf_valid[:, None], prop, m.kf_pose))

    old_pt = (torch.arange(Pc, device=dev) < int(n_pt_snap)) & m.pt_valid
    ref = torch.clamp(m.pt_ref_kf, 0, Kc - 1).to(torch.int64)
    reproj = lie.se3_apply(lie.se3_inv(kf_pose[ref]), lie.se3_apply(m.kf_pose[ref], m.pt_pos))
    pt_pos = torch.where(old_pt[:, None], res_pt,
                         torch.where(m.pt_valid[:, None], reproj, m.pt_pos))
    return m._replace(kf_pose=kf_pose, pt_pos=pt_pos)


# --------------------------------------------------------------------------
# the per-keyframe chain
# --------------------------------------------------------------------------

def _mapper_step(m, c, K, n_neighbors: int, n_levels: int, scale_factor: float,
                 run_ba: bool, ba_local: int = 12, ba_fixed: int = 8, ba_pts: int = 4096,
                 ba_iters: int = 6, bf=None, use_kernel=None):
    """The per-keyframe chain: cull -> triangulate -> fuse -> point stats
    (-> windowed BA -> geometry-only point stats)."""
    with profiling.span("mapping.cull"):
        m = cull_points(m, c)
    with profiling.span("mapping.triangulate"):
        m, _ = create_new_points(m, c, K, n_neighbors=n_neighbors, n_levels=n_levels,
                                 scale_factor=scale_factor)
    with profiling.span("mapping.fuse"):
        m = fuse_duplicates(m, c, K, n_neighbors=n_neighbors, n_levels=n_levels,
                            scale_factor=scale_factor)
    with profiling.span("mapping.point_stats"):
        m = map_state.update_point_stats(m, n_levels, scale_factor)
    if run_ba:
        m, _ = local_ba(m, c, K, n_local=ba_local, n_fixed=ba_fixed, n_pts=ba_pts,
                        iters=ba_iters, n_levels=n_levels, scale_factor=scale_factor, bf=bf,
                        use_kernel=use_kernel)
        # BA moved geometry; the descriptor vote is skipped as in the reference
        with profiling.span("mapping.point_stats"):
            m = map_state.update_point_stats(m, n_levels, scale_factor, with_desc=False)
    return m


@profiling.traced("mapping.chain")
def _mapper_chain(m, c, K, *, n_neighbors: int, n_levels: int, scale_factor: float,
                  run_ba_traced, ba_local: int, ba_fixed: int, ba_pts: int, ba_iters: int,
                  bf=None, use_kernel=None):
    """The chain as `autonomous_step` calls it; the reference's `lax.cond`
    on the BA cadence is a Python `if` on `run_ba_traced` here."""
    return _mapper_step(m, c, K, n_neighbors, n_levels, scale_factor, bool(run_ba_traced),
                        ba_local=ba_local, ba_fixed=ba_fixed, ba_pts=ba_pts,
                        ba_iters=ba_iters, bf=bf, use_kernel=use_kernel)


# --------------------------------------------------------------------------
# host-side local mapper
# --------------------------------------------------------------------------

class LocalMapper:
    """Host side of the mapping pipeline, the reference's LocalMapping
    thread as synchronous calls: the initial map's BA, then the
    per-keyframe chain; for an inertial tracker the IMU initialization
    (`LocalMapping.cc:1174`), the scale refinement (`:1413`) and, once the
    IMU is initialized, the visual-inertial local BA in place of the
    visual one."""

    def __init__(self, n_neighbors=5, ba_local=16, ba_fixed=16, ba_pts=4096,
                 ba_iters=8, run_ba_every=1, imu_init_kfs=8, imu_init_min_time=2.0,
                 vi_window=10):
        self.n_neighbors = n_neighbors
        self.ba_local = ba_local
        self.ba_fixed = ba_fixed
        self.ba_pts = ba_pts
        self.ba_iters = ba_iters
        self.run_ba_every = run_ba_every
        self.imu_init_kfs = imu_init_kfs
        self.imu_init_min_time = imu_init_min_time
        self.vi_window = vi_window
        self._kfs_at_init = 0
        self._scale_refinements = 0
        self._kf_count = 0

    # -- visual-inertial stages (`LocalMapping.cc:199-256,1174,1413`) ------

    def _chain_arrays(self, tracker, slots):
        """The inertial states and preintegrations of a slot chain: (T_bw
        [L,7], v [L,3], pres stacked [L-1], valid [L-1] bool numpy)."""
        m = tracker.map
        dev = tracker.device
        idx = torch.as_tensor(slots, dtype=torch.int64, device=dev)
        T_bw = lie.se3_mul(lie.se3_inv(tracker.T_cb)[None], m.kf_pose[idx])
        v = torch.as_tensor(np.stack([np.asarray(tracker.kf_vel.get(s, np.zeros(3)), np.float32)
                                      for s in slots]), device=dev)
        pres, valid = [], []
        for s in slots[1:]:
            pre = tracker.kf_preint.get(s)
            valid.append(pre is not None)
            pres.append(imu.create_preintegrated(device=dev) if pre is None else pre)
        return T_bw, v, imu.stack(pres), np.asarray(valid)

    def _rebase(self, tracker, slots, g_w, s: float, vels):
        """Re-base the map and the tracker by S = (R, 0, s), R taking the
        estimated gravity g_w to (0, 0, -g) (ApplyScaledRotation): gravity
        becomes canonical and the map metric; the chain's estimated
        velocities `vels` [L,3] rotate into the new frame."""
        Rq = vi_ba.gravity_alignment_rotation(g_w)
        S = torch.cat([Rq, torch.zeros(3, dtype=Rq.dtype, device=Rq.device),
                       torch.tensor([s], dtype=Rq.dtype, device=Rq.device)])
        tracker.map = merge_mod.transform_map(tracker.map, S)
        tracker.apply_world_sim3(S)
        R = lie.quat_to_matrix(Rq).cpu().numpy()
        vels = vels.cpu().numpy()
        for i, sl in enumerate(slots):
            tracker.kf_vel[sl] = (R @ vels[i]).astype(np.float32)
        tracker.vel_w = tracker.kf_vel[slots[-1]]

    def initialize_imu(self, tracker):
        """`LocalMapping::InitializeIMU`: the gyro bias from rotation
        alignment, then gravity, metric scale and velocities from the linear
        system; re-base the map by them and finish with a VI BA over the
        whole chain (VIBA1/VIBA2). A depth sensor's map is metric: its scale
        must agree within [0.80, 1.25] and stays 1. Returns True on
        success."""
        slots = list(tracker.kf_chain)
        T_bw, _, pres, pre_valid = self._chain_arrays(tracker, slots)
        if not pre_valid.all():
            return False
        bg = vi_ba.estimate_gyro_bias(T_bw, pres)
        s, g_w, vels = vi_ba.estimate_gravity_scale(T_bw, None, pres, bias_g=bg)
        s = float(s)
        g_ok = bool(np.isfinite(g_w.cpu().numpy()).all())
        if tracker.config.depth_sensor:
            if not (0.80 < s < 1.25) or not g_ok:
                return False
            s = 1.0
        elif not (0.02 < s < 50.0) or not g_ok:
            return False
        self._rebase(tracker, slots, g_w, s, vels)
        tracker.bias_g = bg.cpu().numpy().astype(np.float32)
        for sl in slots:   # the chain keyframes carry the estimated bias now
            tracker.kf_bias[sl] = (tracker.bias_g.copy(), tracker.bias_a.copy())
        tracker.imu_initialized = True
        tracker.map = self._vi_local_ba(tracker, slots[-1], window=len(slots))
        tracker.last_pose = tracker.map.kf_pose[slots[-1]]
        return True

    def refine_scale(self, tracker):
        """`LocalMapping::ScaleRefinement`: re-estimate the residual scale
        and gravity on the current chain and re-base by them when in
        (0.5, 2.0). A depth sensor never rescales."""
        if tracker.config.depth_sensor:
            return False
        slots = list(tracker.kf_chain)
        if len(slots) < 4 or not all(s in tracker.kf_preint for s in slots[1:]):
            return False
        T_bw, _, pres, pre_valid = self._chain_arrays(tracker, slots)
        if not pre_valid.all():
            return False
        s, g_w, vels = vi_ba.estimate_gravity_scale(T_bw, None, pres,
                                                    bias_g=tracker._mirror(tracker.bias_g))
        s = float(s)
        self._scale_refinements += 1
        if not (0.5 < s < 2.0) or not np.isfinite(g_w.cpu().numpy()).all():
            return False
        self._rebase(tracker, slots, g_w, s, vels)
        return True

    def _vi_local_ba(self, tracker, center_slot, window=None):
        """`Optimizer::LocalInertialBA`: the joint VI BA over the newest
        `window` chain keyframes; the oldest one's pose is the gauge (its
        velocity and biases stay free). Returns the map; the tracker's
        velocity and bias mirrors and per-keyframe states are updated."""
        m = tracker.map
        fc = tracker.config.frontend
        dev = tracker.device
        slots = list(tracker.kf_chain)[-(window or self.vi_window):]
        if len(slots) < 2:
            return m
        T_bw, v0, pres, pre_valid = self._chain_arrays(tracker, slots)
        L = len(slots)
        win = vi_ba.ViWindow(T_bw=T_bw, v=v0,
                             bg=tracker._mirror(np.tile(tracker.bias_g, (L, 1))),
                             ba=tracker._mirror(np.tile(tracker.bias_a, (L, 1))))
        fixed = torch.zeros(L, dtype=torch.bool, device=dev)
        fixed[0] = True
        idx = torch.as_tensor(slots, dtype=torch.int64, device=dev)
        sigma2_lv = _level_scales(fc.n_levels, fc.scale_factor, dev) ** 2
        obs = m.kf_obs[idx]
        obs_pt = torch.where((obs >= 0) & m.pt_valid[torch.clamp(obs, min=0).to(torch.int64)],
                             obs, -1)
        w2, pts2, _ = vi_ba.vi_bundle_adjust(
            win, fixed, m.kf_xy[idx], sigma2_lv[m.kf_level[idx].to(torch.int64)], obs_pt,
            m.pt_pos, m.pt_valid, tracker.K, tracker.T_cb, pres,
            torch.as_tensor(pre_valid, device=dev), iters=self.ba_iters)
        T_cw_new = lie.se3_mul(tracker.T_cb[None], w2.T_bw)
        kf_pose = m.kf_pose.clone()
        kf_pose[idx[1:]] = T_cw_new[1:]
        pt_pos = torch.where(m.pt_valid[:, None], pts2, m.pt_pos)
        st = torch.cat([w2.v, w2.bg, w2.ba], dim=1).cpu().numpy()
        for i, sl in enumerate(slots):
            tracker.kf_vel[sl] = st[i, 0:3].copy()
            tracker.kf_bias[sl] = (st[i, 3:6].copy(), st[i, 6:9].copy())
        tracker.vel_w = st[-1, 0:3].copy()
        tracker.bias_g = st[-1, 3:6].copy()
        tracker.bias_a = st[-1, 6:9].copy()
        return m._replace(kf_pose=kf_pose, pt_pos=pt_pos)

    def on_initial_map(self, tracker):
        """BA of the two-keyframe initial map (4 local, 4 fixed rows, 16
        iterations), then the point statistics. A depth sensor's initial map
        is one keyframe at identity with metric points: nothing to adjust."""
        if tracker.n_kf_host < 2:
            self._kfs_at_init = 1
            return
        fc = tracker.config.frontend
        m, _ = local_ba(tracker.map, 1, tracker.K, n_local=4, n_fixed=4, n_pts=self.ba_pts,
                        iters=16, n_levels=fc.n_levels, scale_factor=fc.scale_factor,
                        use_kernel=fc.use_kernel)
        tracker.map = map_state.update_point_stats(m, fc.n_levels, fc.scale_factor)

    @profiling.traced("mapping.chain")
    def on_new_keyframe(self, tracker, slot: int):
        """The per-keyframe chain (cull, triangulate, fuse, point stats,
        windowed BA every `run_ba_every` keyframes) around `slot`. With an
        initialized IMU the VI local BA replaces the visual one
        (`LocalMapping.cc:167-175`); before it, the IMU-initialization
        schedule, after it at most three scale refinements."""
        fc = tracker.config.frontend
        self._kf_count += 1
        run_ba = self._kf_count % self.run_ba_every == 0
        c = torch.as_tensor(slot, dtype=torch.int32, device=tracker.K.device)
        inertial_live = tracker.inertial and tracker.imu_initialized
        if run_ba and inertial_live:
            m = _mapper_step(tracker.map, c, tracker.K, n_neighbors=self.n_neighbors,
                             n_levels=fc.n_levels, scale_factor=fc.scale_factor, run_ba=False)
            tracker.map = m
            m = self._vi_local_ba(tracker, slot)
            m = map_state.update_point_stats(m, fc.n_levels, fc.scale_factor, with_desc=False)
        else:
            bf = tracker.fx * tracker.config.baseline if tracker.config.depth_sensor else None
            m = _mapper_step(tracker.map, c, tracker.K, n_neighbors=self.n_neighbors,
                             n_levels=fc.n_levels, scale_factor=fc.scale_factor, run_ba=run_ba,
                             ba_local=self.ba_local, ba_fixed=self.ba_fixed,
                             ba_pts=self.ba_pts, ba_iters=self.ba_iters, bf=bf,
                             use_kernel=fc.use_kernel)
        tracker.map = m
        tracker.last_pose = m.kf_pose[slot]
        if tracker.inertial and not tracker.imu_initialized:
            # enough keyframes, or at least 4 spanning >= 2 s (mTinit)
            chain = tracker.kf_chain
            span = 0.0
            if len(chain) >= 2:
                ts = tracker.kf_timestamps
                span = ts.get(chain[-1], 0.0) - ts.get(chain[0], 0.0)
            ready = (len(chain) >= self.imu_init_kfs
                     or (len(chain) >= 4 and span >= self.imu_init_min_time))
            if ready and all(s in tracker.kf_preint for s in chain[1:]):
                if self.initialize_imu(tracker):
                    self._kfs_at_init = len(tracker.kf_chain)
        elif tracker.inertial:
            grown = len(tracker.kf_chain) - self._kfs_at_init
            if self._scale_refinements < 3 and grown >= 4 * (self._scale_refinements + 1):
                self.refine_scale(tracker)
        # uuids of the new points are assigned lazily (`tracker.flush_meta`)
        tracker.meta_dirty = True
