"""Inter-map Sim(3) alignment and map merging.

Port of `dvm_slam_tpu/loopclosing/merge.py` (the verification chain of
`LoopClosing::DetectCommonRegionsFromBoW` and the splice of `MergeLocal`):
given a local map A, a foreign map B and a pair of keyframes that place
recognition matched, estimate S_ab (B-world -> A-world) by descriptor
matching, RANSAC Horn and a Sim3-guided projection, then re-base B and
splice it into A's slot arrays with host-side uuid dedup. The welding BA is
the caller running `local_ba` around the merge keyframe.

The guided projection compares every point slot of B with every feature of
A's keyframe: [P,F] planes (16384 x 1250 f32, 82 MB each at EuRoC
capacities), as few as the reference makes.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..geometry import alignment, lie
from ..mapping import map_state
from ..ops import matching
from . import sim3_solver

# the reference's geometric-verification gates
N_BOW_MATCHES = 20
N_SIM3_INLIERS = 20
N_PROJ_MATCHES = 50


class Sim3Result(NamedTuple):
    ok: torch.Tensor         # [] bool
    S_ab: torch.Tensor       # [8] Sim3 mapping B-world -> A-world
    n_inliers: torch.Tensor  # []
    n_proj: torch.Tensor     # []


def compute_sim3_between(noise, mA: map_state.MapState, kfA, mB: map_state.MapState, kfB, K,
                         with_scale: bool = True):
    """Estimate S_ab from one candidate keyframe pair. noise: [300, F] the
    draws of `ransac_sim3`. with_scale=False fixes s = 1 (maps whose scale
    is observable)."""
    F = mA.feat_capacity
    kfA, kfB = int(kfA), int(kfB)
    TA, TB = mA.kf_pose[kfA], mB.kf_pose[kfB]

    obsA, obsB = mA.kf_obs[kfA], mB.kf_obs[kfB]
    okA = (obsA >= 0) & mA.kf_feat_valid[kfA]
    okB = (obsB >= 0) & mB.kf_feat_valid[kfB]
    pA = torch.clamp(obsA, min=0).to(torch.int64)
    pB = torch.clamp(obsB, min=0).to(torch.int64)

    dist = matching.hamming_matrix(mA.kf_desc[kfA], mB.kf_desc[kfB])
    mask = okA[:, None] & okB[None, :]
    idx, _, ok = matching.masked_best_match(dist, mask, matching.TH_LOW, ratio=0.75)
    idx_ba, _, _ = matching.masked_best_match(dist.T, mask.T, matching.TH_LOW)
    idx, mut = matching.mutual_filter(torch.where(ok, idx, -1), idx_ba)
    ok = ok & mut
    n_matches = torch.sum(ok)

    j = torch.clamp(idx, min=0)
    # the matched map points in each camera frame, in A's feature order
    pcA = lie.se3_apply(TA[None], mA.pt_pos[pA])
    pcB = lie.se3_apply(TB[None], mB.pt_pos[pB[j]])
    uvA = mA.kf_xy[kfA]
    uvB = mB.kf_xy[kfB][j]
    # level variances at the default scale factor 1.2, as the reference
    sigA = torch.pow(1.2, mA.kf_level[kfA].to(torch.float32)) ** 2
    sigB = torch.pow(1.2, mB.kf_level[kfB][j].to(torch.float32)) ** 2
    S12, inl, n_inl = sim3_solver.ransac_sim3(noise, pcA, pcB, uvA, uvB, sigA, sigB, ok, K,
                                              with_scale=with_scale)   # camB -> camA

    # ---- guided projection: every B point into kfA through S12 ----
    XB_all_cb = lie.se3_apply(TB[None], mB.pt_pos)
    Xb_in_a = lie.sim3_apply(S12[None], XB_all_cb)
    z = torch.clamp(Xb_in_a[:, 2], min=1e-9)
    uv_proj = torch.stack([K[0] * Xb_in_a[:, 0] / z + K[2], K[1] * Xb_in_a[:, 1] / z + K[3]], -1)
    d2 = torch.sum((uv_proj[:, None, :] - mA.kf_xy[kfA][None, :, :]) ** 2, -1)       # [P,F]
    pmask = (mB.pt_valid[:, None] & (Xb_in_a[:, 2:3] > 0) & mA.kf_feat_valid[kfA][None, :]
             & (d2 <= 7.5 ** 2))
    del d2
    pdist = matching.hamming_matrix(mB.pt_desc, mA.kf_desc[kfA])                   # [P,F]
    pidx, _, pok = matching.masked_best_match(pdist, pmask, matching.TH_HIGH)
    del pdist, pmask
    pok = matching.dedupe_matches(pidx, pok, F)
    n_proj = torch.sum(pok)

    # final refit on the RANSAC inliers and the projected matches that land
    # on A's map points
    obsA_at = obsA[torch.clamp(pidx, min=0)]
    strong = pok & (obsA_at >= 0)
    XA2 = lie.se3_apply(TA[None], mA.pt_pos[torch.clamp(obsA_at, min=0).to(torch.int64)])
    src = torch.cat([pcB, XB_all_cb])          # camB coordinates
    dst = torch.cat([pcA, XA2])                # camA coordinates
    w = torch.cat([inl, strong]).to(pcA.dtype)
    S_ref = alignment.umeyama(src, dst, mask=w, with_scale=with_scale)
    S12f = torch.where(n_proj >= N_PROJ_MATCHES, S_ref, S12)

    # world level: S_ab = sim3(TA)^-1 . S12 . sim3(TB)
    S_ab = lie.sim3_mul(lie.sim3_inv(lie.sim3_from_se3(TA)),
                        lie.sim3_mul(S12f, lie.sim3_from_se3(TB)))
    ok_all = ((n_matches >= N_BOW_MATCHES) & (n_inl >= N_SIM3_INLIERS)
              & (n_proj >= N_PROJ_MATCHES))
    return Sim3Result(ok=ok_all, S_ab=S_ab, n_inliers=n_inl, n_proj=n_proj)


def transform_map(m: map_state.MapState, S):
    """Re-base a whole map by a world-level Sim3: points X' = S(X),
    keyframe poses T'_cw = fold(S_cB . S^-1), the scale folded into the
    translation; viewing normals rotate with the frame, distance ranges
    scale."""
    S = torch.as_tensor(S, dtype=torch.float32, device=m.pt_pos.device)
    pt = lie.sim3_apply(S[None], m.pt_pos)
    kf = lie.sim3_fold(lie.sim3_mul(lie.sim3_from_se3(m.kf_pose), lie.sim3_inv(S)[None]))
    s = lie.sim3_s(S)
    nrm = lie.quat_rotate(lie.sim3_q(S)[None], m.pt_normal)
    return m._replace(
        pt_pos=torch.where(m.pt_valid[:, None], pt, m.pt_pos),
        pt_normal=torch.where(m.pt_valid[:, None], nrm, m.pt_normal),
        kf_pose=torch.where(m.kf_valid[:, None], kf, m.kf_pose),
        pt_min_dist=m.pt_min_dist * s,
        pt_max_dist=m.pt_max_dist * s,
    )


def build_slot_maps(metaA, validA_kf, validA_pt, n_kf_A, n_pt_A,
                    metaB, validB_kf, validB_pt):
    """Host-side uuid dedup (`Map::PostLoad`'s relink): returns (kf_map
    [KB], pt_map [PB], kf_new [KB], pt_new [PB], n_kf_after, n_pt_after)
    mapping each valid B slot to its A slot (the existing one on a uuid
    match, else a fresh one)."""
    def build(uuidA, validA, n_A, uuidB, validB, cap):
        lut = {tuple(u): i for i, u in enumerate(np.asarray(uuidA)[: int(n_A)])
               if validA[i]}
        mp = np.full(uuidB.shape[0], -1, np.int64)
        new = np.zeros(uuidB.shape[0], bool)
        nxt = int(n_A)
        for j in range(uuidB.shape[0]):
            if not validB[j]:
                continue
            key = tuple(np.asarray(uuidB[j]))
            if key in lut:
                mp[j] = lut[key]
            elif nxt < cap:
                mp[j] = nxt
                new[j] = True
                nxt += 1
        return mp, new, nxt

    kf_map, kf_new, n_kf = build(
        metaA.kf_uuid, validA_kf, n_kf_A, metaB.kf_uuid, validB_kf,
        metaA.kf_uuid.shape[0],
    )
    pt_map, pt_new, n_pt = build(
        metaA.pt_uuid, validA_pt, n_pt_A, metaB.pt_uuid, validB_pt,
        metaA.pt_uuid.shape[0],
    )
    return kf_map, pt_map, kf_new, pt_new, n_kf, n_pt


def _scatter_rows(a, tgt, b):
    """a with rows tgt [n] (in [0, len(a)], len(a) = the padding row) set
    from b [n,...]. The real targets are fresh slots, distinct; every other
    row of b lands on the padding row, which is dropped, so which of those
    writes wins (arbitrary on CUDA) does not matter."""
    out = torch.cat([a, torch.zeros((1,) + a.shape[1:], dtype=a.dtype, device=a.device)])
    out[tgt] = b.to(a.dtype)
    return out[:-1]


def splice_map(mA: map_state.MapState, mB: map_state.MapState, kf_map, pt_map, kf_new, pt_new,
               n_kf_after, n_pt_after):
    """Append B's novel keyframes and points into A at the host-assigned
    slots and remap B's observation table through the point slot map.
    Duplicates (same uuid) keep A's copy; B's observations of them stay on
    B's keyframes, and `fuse_duplicates` cleans what is left."""
    dev = mA.pt_pos.device
    as_t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    kf_map, pt_map = as_t(kf_map).to(torch.int64), as_t(pt_map).to(torch.int64)
    kf_new, pt_new = as_t(kf_new).to(torch.bool), as_t(pt_new).to(torch.bool)
    tgt_p = torch.where(pt_new, pt_map, mA.pt_capacity)
    tgt_k = torch.where(kf_new, kf_map, mA.kf_capacity)

    def kf_of(ref):
        return torch.where(ref >= 0, kf_map[torch.clamp(ref, min=0).to(torch.int64)],
                           -1).to(torch.int32)

    scat_p = lambda a, b: _scatter_rows(a, tgt_p, b)  # noqa: E731
    m = mA._replace(
        pt_pos=scat_p(mA.pt_pos, mB.pt_pos),
        pt_valid=scat_p(mA.pt_valid, mB.pt_valid & pt_new),
        pt_desc=scat_p(mA.pt_desc, mB.pt_desc),
        pt_normal=scat_p(mA.pt_normal, mB.pt_normal),
        pt_min_dist=scat_p(mA.pt_min_dist, mB.pt_min_dist),
        pt_max_dist=scat_p(mA.pt_max_dist, mB.pt_max_dist),
        pt_ref_kf=scat_p(mA.pt_ref_kf, kf_of(mB.pt_ref_kf)),
        pt_visible=scat_p(mA.pt_visible, mB.pt_visible),
        pt_found=scat_p(mA.pt_found, mB.pt_found),
        pt_first_kf=scat_p(mA.pt_first_kf, kf_of(mB.pt_first_kf)),
        n_pt=torch.tensor(int(n_pt_after), dtype=torch.int32, device=dev),
    )

    obsB = torch.where(mB.kf_obs >= 0, pt_map[torch.clamp(mB.kf_obs, min=0).to(torch.int64)],
                       -1).to(torch.int32)
    scat_k = lambda a, b: _scatter_rows(a, tgt_k, b)  # noqa: E731
    return m._replace(
        kf_pose=scat_k(m.kf_pose, mB.kf_pose),
        kf_valid=scat_k(m.kf_valid, mB.kf_valid & kf_new),
        kf_xy=scat_k(m.kf_xy, mB.kf_xy),
        kf_level=scat_k(m.kf_level, mB.kf_level),
        kf_angle=scat_k(m.kf_angle, mB.kf_angle),
        kf_desc=scat_k(m.kf_desc, mB.kf_desc),
        kf_feat_valid=scat_k(m.kf_feat_valid, mB.kf_feat_valid),
        kf_obs=scat_k(m.kf_obs, obsB),
        kf_ur=scat_k(m.kf_ur, mB.kf_ur),
        n_kf=torch.tensor(int(n_kf_after), dtype=torch.int32, device=dev),
    )


def merge_maps(mA, metaA, mB, metaB, S_ab):
    """Full merge: re-base B by S_ab, splice it into A (uuid dedup), merge
    the host metadata into a copy of metaA, which is never changed (it may
    be a stored snapshot). Returns (merged MapState, merged MapMeta, kf_map,
    pt_map)."""
    mBt = transform_map(mB, S_ab)
    vB_kf, vB_pt = mB.kf_valid.cpu().numpy(), mB.pt_valid.cpu().numpy()
    kf_map, pt_map, kf_new, pt_new, n_kf, n_pt = build_slot_maps(
        metaA, mA.kf_valid.cpu().numpy(), mA.pt_valid.cpu().numpy(), int(mA.n_kf), int(mA.n_pt),
        metaB, vB_kf, vB_pt)
    merged = splice_map(mA, mBt, kf_map, pt_map, kf_new, pt_new, n_kf, n_pt)
    if (kf_map[vB_kf] < 0).any() or (pt_map[vB_pt] < 0).any():
        warnings.warn("merge_maps: capacity overflow dropped keyframes/points from the "
                      "incoming map", stacklevel=2)
    meta = map_state.MapMeta(
        kf_uuid=metaA.kf_uuid.copy(), pt_uuid=metaA.pt_uuid.copy(),
        kf_creator=metaA.kf_creator.copy(), pt_creator=metaA.pt_creator.copy(),
        agent_id=metaA.agent_id,
    )
    for j in np.nonzero(kf_new)[0]:
        meta.kf_uuid[kf_map[j]] = metaB.kf_uuid[j]
        meta.kf_creator[kf_map[j]] = metaB.kf_creator[j]
    for j in np.nonzero(pt_new)[0]:
        meta.pt_uuid[pt_map[j]] = metaB.pt_uuid[j]
        meta.pt_creator[pt_map[j]] = metaB.pt_creator[j]
    return merged, meta, kf_map, pt_map
