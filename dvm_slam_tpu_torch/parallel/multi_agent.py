"""Agents as a batch axis on one card: the SPMD agent step and the
protocol-on-mesh.

Port of `dvm_slam_tpu/parallel/multi_agent.py`. The reference maps N agents
onto an `("agent",)` device mesh (SURVEY §2.6-2: "N agents = N mesh slices;
batched front ends; keyframe exchange = device-to-device collectives for
co-located agents"): every per-agent stage runs as the same program on each
slice under `shard_map`, and the exchange rides `all_gather`.

On one card there is no mesh. The A agents' state lives on the card as
tensors stacked on a leading agent axis (`stack_agents`), the agent count
is an argument, and `make_mesh` has no counterpart. An `all_gather` over the
agent axis is a read of the stacked tensor. Work that is per agent in the
port's kernels' terms runs once for all agents: `extract_batch` describes
every agent's frame in ONE K1 launch, and `local_ba_batched` (and the
protocol's welding BA) serves every agent's window with ONE K2 and ONE K3
launch per LM step. The rest (FAST and the pyramid, `track_frame`, BoW,
Sim3 verification, splicing, the essential graph, global BA) loops over
agents; batching those is speed work for later.

The reference's `lax.cond`s become host decisions, read once per round:
which (receiver, peer) pairs need a Sim3 verification, which window entries
a receiver splices, and which receivers spliced anything. A skipped branch
gives the reference's skipped outputs (the standing Sim3, `passed` false,
the map unchanged), and a masked write with a false mask is skipped because
it writes nothing. The protocol's bookkeeping (merge rows, `last_seen`,
`dropped`, the refresh cadence) is integer work on those host values.

RANSAC draws are inputs (fault b of ROADMAP §3): the protocol step takes a
Gumbel block [A, A, hypotheses, F] per round, row [me, a] being receiver
`me`'s draws for peer `a` (the reference folds `a` into `keys[me]`);
without one it draws the block from its own CPU generator.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..frontend.extractor import extract_batch
from ..geometry import alignment, lie
from ..geometry.two_view import gumbel
from ..loopclosing import pose_graph as pg_mod
from ..mapping import local_mapping, map_state as ms
from ..ops import matching
from ..ops.fast import _top_k
from ..placerec import database, vocabulary
from ..tracking import tracker as trk

SEED = 2718  # the protocol step's own generator, when the caller passes no draws


def stack_agents(trees):
    """Stack per-agent NamedTuples (MapStates, protocol states) along a
    leading agent axis; maps must share one capacity (`ms.stack_maps`)."""
    if isinstance(trees[0], ms.MapState):
        return ms.stack_maps(trees)
    return type(trees[0])(*(torch.stack(xs) for xs in zip(*trees)))


def unstack_agents(tree, n: int):
    """Inverse of `stack_agents`: the n per-agent NamedTuples."""
    return [type(tree)(*(x[i] for x in tree)) for i in range(n)]


def build_multi_agent_step(n_agents: int, config: trk.TrackerConfig,
                           voc: vocabulary.Vocabulary, ba_local=4, ba_fixed=2,
                           ba_pts=256, ba_iters=2, device="cuda"):
    """Returns the per-frame agent step:
        (maps [A,...], imgs [A,H,W], T_pred [A,7], K [A,4])
          -> (T [A,7], inliers [A], merge_scores [A,A], maps' [A,...])

    Per agent: extraction (`extract_batch`, one K1 launch for the A frames),
    two-stage tracking and the BoW of the tracked frame (`_agent_step`);
    then one `local_ba_batched` around each agent's newest keyframe (one K2
    and one K3 launch per LM step for the A windows), and the cross-agent
    BoW similarity 1 - |bow_i - bow_j|_1 / 2 of the stacked BoWs (the
    reference's `all_gather`)."""
    fc = config.frontend
    levels, idf = voc.device_arrays(torch.device(device))
    branch, words = voc.branch, voc.n_words

    def step(maps, imgs, T_pred, K):
        frames = extract_batch(imgs, fc)
        T_new, inl, bows = [], [], []
        for m, frame, T, Ka in zip(unstack_agents(maps, n_agents), frames, T_pred, K):
            res = trk.track_frame(m, frame, T, Ka, config)
            T_new.append(res.T_cw)
            inl.append(res.n_inliers)
            bows.append(vocabulary.bow_vector(levels, idf, frame.desc, frame.valid, branch, words))
        centers = torch.clamp(maps.n_kf - 1, min=0)
        maps_ba, _ = local_mapping.local_ba_batched(
            maps, centers, K, n_local=ba_local, n_fixed=ba_fixed, n_pts=ba_pts, iters=ba_iters,
            n_levels=fc.n_levels, scale_factor=fc.scale_factor, use_kernel=fc.use_kernel)
        all_bows = torch.stack(bows)                                     # [A,W]
        scores = 1.0 - 0.5 * torch.sum(torch.abs(all_bows[:, None, :] - all_bows[None, :, :]), -1)
        return torch.stack(T_new), torch.stack(inl), scores, maps_ba

    return step


# --------------------------------------------------------------------------
# protocol-on-mesh: collective keyframe exchange + merge detection
# --------------------------------------------------------------------------

class MeshProtocolState(NamedTuple):
    """Per-agent protocol state (the reference's fields, `Peer` dedup state
    + the BoW database; `peer.h:64-72`, `KeyFrameDatabase.h:83`)."""

    db_bow: torch.Tensor     # [K,W] dense BoW per keyframe slot
    db_valid: torch.Tensor   # [K] bool
    merged: torch.Tensor     # [A] bool merged-with flags (row of the merge matrix)
    last_seen: torch.Tensor  # [A] int32 newest peer keyframe id already integrated
    S_peer: torch.Tensor     # [A,8] Sim3 peer world -> my world (q, t, s)
    S_ok: torch.Tensor       # [A] bool Sim3 geometrically verified
    round: torch.Tensor      # [] int32 protocol round counter (refresh cadence)
    dropped: torch.Tensor    # [A] int32 peer keyframes lost to backlog gaps > window
    refresh_interval: torch.Tensor  # [A] int32 AIMD Sim3-refresh cadence in rounds
    next_refresh: torch.Tensor      # [A] int32 round at which the refit is next due


def create_protocol_state(kf_cap: int, n_words: int, n_agents: int, refresh_base: int = 5,
                          device="cuda") -> MeshProtocolState:
    dev = torch.device(device)
    base = max(refresh_base, 1)
    i32 = torch.int32
    return MeshProtocolState(
        db_bow=torch.zeros((kf_cap, n_words), dtype=torch.float32, device=dev),
        db_valid=torch.zeros((kf_cap,), dtype=torch.bool, device=dev),
        merged=torch.zeros((n_agents,), dtype=torch.bool, device=dev),
        last_seen=torch.full((n_agents,), -1, dtype=i32, device=dev),
        S_peer=lie.sim3_identity((n_agents,), device=dev),
        S_ok=torch.zeros((n_agents,), dtype=torch.bool, device=dev),
        round=torch.zeros((), dtype=i32, device=dev),
        dropped=torch.zeros((n_agents,), dtype=i32, device=dev),
        refresh_interval=torch.full((n_agents,), base, dtype=i32, device=dev),
        next_refresh=torch.full((n_agents,), base - 1, dtype=i32, device=dev),
    )


def _add_keyframe_masked(m, pose, xy, level, angle, desc, feat_valid, obs, accept):
    """Conditionally append a keyframe at slot min(n_kf, capacity - 1): a
    no-op when `accept` is false or the map is full. Returns (map, slot)."""
    i = torch.clamp(m.n_kf, max=m.kf_capacity - 1)
    acc = torch.as_tensor(accept, device=m.n_kf.device) & (m.n_kf < m.kf_capacity)

    def wr(arr, val):
        return ms._set_row(arr, i, torch.where(acc, val.to(arr.dtype), arr[i]))

    m = m._replace(
        kf_pose=wr(m.kf_pose, pose),
        kf_valid=wr(m.kf_valid, torch.ones((), dtype=torch.bool, device=i.device)),
        kf_xy=wr(m.kf_xy, xy),
        kf_level=wr(m.kf_level, level),
        kf_angle=wr(m.kf_angle, angle),
        kf_desc=wr(m.kf_desc, desc),
        kf_feat_valid=wr(m.kf_feat_valid, feat_valid & acc),
        kf_obs=wr(m.kf_obs, obs),
        n_kf=m.n_kf + acc.to(torch.int32),
    )
    return m, i


def protocol_noise(generator, n_agents: int, hypotheses: int, n_feat: int, device="cuda"):
    """One round's Gumbel block [A, A, hypotheses, F] from a CPU generator."""
    return gumbel(generator, (n_agents, n_agents, hypotheses, n_feat)).to(device)


def _closure(ok_rows):
    """The merge matrix [A,A] bool from the per-agent merge rows: symmetric,
    reflexive, transitively closed (`M | M @ M`, ceil(log2 A) times, as an
    int32 product: CUDA has no bool matmul)."""
    A = ok_rows.shape[0]
    M = ok_rows | ok_rows.T | torch.eye(A, dtype=torch.bool, device=ok_rows.device)
    for _ in range(max(1, int(np.ceil(np.log2(max(A, 2)))))):
        Mi = M.to(torch.float32)
        M = M | ((Mi @ Mi) > 0)
    return M


def build_protocol_step(n_agents: int, config: trk.TrackerConfig, voc: vocabulary.Vocabulary,
                        fuse_after: bool = True, window: int = 4, sim3_min_inliers: int = 20,
                        proj_min_matches: int = 50, ransac_hypotheses: int = 200,
                        match_max_dist: int = 60, refresh_every: int = 5,
                        weld_ba: bool = True, pose_graph_after: bool = True,
                        pose_graph_iters: int = 8, global_ba_after: bool = True,
                        global_ba_iters: int = 6, device="cuda"):
    """One collective protocol round for the A agents (the reference's
    docstring, steps 1-10): each agent registers the BoW of its `window`
    newest own keyframes; the newest BoWs are advertised; each agent runs
    `DetectMergePossibility` (0.9x baseline) against every peer; the merge
    matrix is closed symmetrically and transitively; the first fresh packet
    of a BoW-merged peer is verified geometrically (Hamming matches of the
    peer's observed points against the map, `ransac_umeyama`, the
    `proj_min_matches` / `sim3_min_inliers` gates) and re-verified on the
    AIMD cadence (`refresh_every` base rounds, doubling on a converged
    refit up to 32x, reset on a drifted one); verified peers' windows are
    spliced oldest first with backlog gaps larger than the window counted in
    `dropped`; then, for agents that spliced: fusion around the spliced
    keyframe, the welding BA (8 local + 4 fixed rows, 1024 points, 4
    iterations; one `local_ba_batched` for all of them), the essential graph
    (sequential chain + strongest covisibility neighbour) and the global BA,
    one agent after another.

    Returns fn:
      (maps [A,...], states [A,...], K [A,4], own_slots [A,window] int
       (-1 = empty, oldest -> newest), own_seqs [A,window] int (monotone
       own-keyframe ids), noise [A,A,hyps,F] or None, profile dict or None)
        -> (maps', states', merge_matrix [A,A] bool)
    `profile`, where given, gathers wall seconds per stage (the device
    synchronised at each boundary)."""
    fc = config.frontend
    dev = torch.device(device)
    levels, idf = voc.device_arrays(dev)
    branch, words = voc.branch, voc.n_words
    A, Wn = n_agents, window
    base_iv = max(refresh_every, 1)
    cap_iv = 32 * base_iv
    gen = torch.Generator(device="cpu")
    gen.manual_seed(SEED)

    def step(maps, states, K, own_slots, own_seqs, noise=None, profile=None):
        clock = [time.perf_counter()]

        def mark(stage):
            if profile is not None:
                if maps.pt_pos.is_cuda:
                    torch.cuda.synchronize(maps.pt_pos.device)
                now = time.perf_counter()
                profile[stage] = profile.get(stage, 0.0) + now - clock[0]
                clock[0] = now

        mlist = unstack_agents(maps, A)
        sts = unstack_agents(states, A)
        slots = np.asarray(torch.as_tensor(own_slots).cpu()).astype(np.int64)    # [A,Wn]
        seqs = np.asarray(torch.as_tensor(own_seqs).cpu()).astype(np.int64)
        F = mlist[0].feat_capacity
        Kcap = mlist[0].kf_capacity
        if noise is None:
            noise = protocol_noise(gen, A, ransac_hypotheses, F, maps.pt_pos.device)

        # 1. register each agent's window of own keyframes in its database
        dbs, newest = [], []
        for me, (m, st) in enumerate(zip(mlist, sts)):
            db = database.BowDatabase(bow=st.db_bow, valid=st.db_valid)
            nb = torch.zeros((words,), dtype=torch.float32, device=m.pt_pos.device)
            for c in slots[me]:
                if c < 0:
                    continue
                nb = vocabulary.bow_vector(levels, idf, m.kf_desc[c], m.kf_feat_valid[c],
                                           branch, words)
                db = database.add(db, int(c), nb)
            dbs.append(db)
            newest.append(nb)
        all_bows = torch.stack(newest)                                   # the all_gather

        # 2-3. every agent scores every advertised BoW (0.9x baseline)
        eye = torch.eye(A, dtype=torch.bool, device=all_bows.device)
        rows = []
        for me, (m, db) in enumerate(zip(mlist, dbs)):
            covis = ms.covisibility(m)
            ok = torch.stack([database.detect_merge_possibility(db, q, covis)[0]
                              for q in all_bows])
            rows.append(ok & ~eye[me] & (m.n_kf >= 2))
        # 4. the merge matrix, closed; read once
        M = _closure(torch.stack(rows))
        mark("advertise_detect")
        M_h = M.cpu().numpy()
        merged_h = M_h & ~np.eye(A, dtype=bool)

        # the packets every agent offers (its window, from the round's input map)
        kf_id = np.where(slots >= 0, seqs, -1)                           # [A,Wn]
        packets = []
        for a, m in enumerate(mlist):
            pk = []
            for c in slots[a]:
                cc = max(int(c), 0)
                obs_c = m.kf_obs[cc]
                obs_cl = torch.clamp(obs_c, min=0).to(torch.int64)
                pk.append(dict(
                    pose=m.kf_pose[cc], xy=m.kf_xy[cc], level=m.kf_level[cc],
                    angle=m.kf_angle[cc], desc=m.kf_desc[cc],
                    feat_valid=m.kf_feat_valid[cc] & bool(c >= 0) & (m.n_kf > 0),
                    pt_pos=m.pt_pos[obs_cl],
                    pt_ok=(obs_c >= 0) & m.pt_valid[obs_cl] & bool(c >= 0)))
            packets.append(pk)
        # newest valid window entry of each peer (the first maximum)
        newest_idx = [int(np.argmax(np.where(kf_id[a] >= 0, kf_id[a], -1))) for a in range(A)]

        # 5, 8. Sim3 verification where it is needed, and the AIMD cadence
        st_h = [dict(S_ok=st.S_ok.cpu().numpy().copy(), round=int(st.round),
                     **{f: getattr(st, f).cpu().numpy().astype(np.int64)
                        for f in ("last_seen", "dropped", "next_refresh")})
                for st in sts]
        S_peer = [st.S_peer.clone() for st in sts]
        refresh_iv = [st.refresh_interval.clone() for st in sts]
        next_refresh = [st.next_refresh.clone() for st in sts]
        verified = []                                     # (me, a, passed tensor)
        for me, m in enumerate(mlist):
            h = st_h[me]
            due = h["round"] >= h["next_refresh"]
            for a in range(A):
                if not (a != me and merged_h[me, a] and (not h["S_ok"][a] or due[a])):
                    continue
                pk = packets[a][newest_idx[a]]
                dist = matching.hamming_matrix(pk["desc"], m.pt_desc)
                mask = pk["pt_ok"][:, None] & m.pt_valid[None, :]
                # tie_ok: after a splice the map holds copies of peer points
                # (identical descriptors), which a strict ratio test rejects
                idx, _d, okm = matching.masked_best_match(dist, mask, max_dist=match_max_dist,
                                                          ratio=0.9, tie_ok=True)
                n_match = torch.sum(okm)
                dst = m.pt_pos[torch.clamp(idx, min=0)]
                S, _inl, n_inl = alignment.ransac_umeyama(noise[me, a], pk["pt_pos"], dst, okm)
                passed = ((n_match >= proj_min_matches) & (n_inl >= sim3_min_inliers)
                          & torch.all(torch.isfinite(S)))
                S_old = sts[me].S_peer[a]
                S_peer[me][a] = torch.where(passed, S, S_old)
                if due[a] and h["S_ok"][a]:                  # a refresh attempt
                    rel = S[7] / torch.clamp(S_old[7], min=1e-12)
                    conv = passed & (torch.abs(rel - 1.0) < 0.01)
                    iv = refresh_iv[me][a]
                    new_iv = torch.where(conv, torch.clamp(iv * 2, max=cap_iv),
                                         torch.where(passed, base_iv, iv))
                    refresh_iv[me][a] = new_iv
                    next_refresh[me][a] = h["round"] + new_iv
                verified.append((me, a, passed))
        if verified:
            for (me, a, _), p in zip(verified, torch.stack([v[2] for v in verified]).tolist()):
                st_h[me]["S_ok"][a] |= p
        mark("verify")

        # 6, 9. backlog accounting and the splice, sender ascending, then
        # window entry ascending
        has_any = (kf_id >= 0).any(axis=1)
        oldest = np.where(kf_id >= 0, kf_id, np.iinfo(np.int32).max).min(axis=1)
        spliced = {}                                      # me -> slot of its last splice
        for me in range(A):
            h = st_h[me]
            last, m = h["last_seen"], mlist[me]
            receiving = merged_h[me] & h["S_ok"] & has_any & (np.arange(A) != me)
            gap = np.maximum(0, oldest - last - 1)
            h["dropped"] = h["dropped"] + np.where(receiving, gap, 0)
            last = np.where(receiving & (gap > 0), oldest - 1, last)
            for a in range(A):
                if a == me or not (merged_h[me, a] and h["S_ok"][a]):
                    continue
                Sa = S_peer[me][a]
                for w in range(Wn):
                    if not (kf_id[a, w] >= 0 and kf_id[a, w] > last[a]):
                        continue
                    pk = packets[a][w]
                    pos_al = lie.sim3_apply(Sa, pk["pt_pos"])
                    Sc = lie.sim3_mul(lie.sim3_from_se3(pk["pose"]), lie.sim3_inv(Sa))
                    pose_al = lie.se3(lie.sim3_q(Sc),
                                      lie.sim3_t(Sc) / torch.clamp(lie.sim3_s(Sc), min=1e-12))
                    zeros = torch.zeros((F,), dtype=m.pt_pos.dtype, device=m.pt_pos.device)
                    m, pslots = ms.add_points(
                        m, pos=pos_al, desc=pk["desc"], normal=torch.zeros_like(pos_al),
                        min_dist=zeros, max_dist=torch.full_like(zeros, 1e9),
                        ref_kf=torch.clamp(m.n_kf, max=Kcap - 1), valid=pk["pt_ok"])
                    m, slot = _add_keyframe_masked(m, pose_al, pk["xy"], pk["level"], pk["angle"],
                                                   pk["desc"], pk["feat_valid"], pslots, True)
                    last[a] = kf_id[a, w]
                    spliced[me] = slot
            h["last_seen"] = last
            mlist[me] = m
        mark("splice")

        # 7. fusion around the spliced keyframe
        if fuse_after:
            for me, slot in spliced.items():
                mlist[me] = local_mapping.fuse_duplicates(
                    mlist[me], slot, K[me], n_neighbors=5, n_levels=fc.n_levels,
                    scale_factor=fc.scale_factor)
        mark("fuse")

        # 10. the welding BA, the essential graph and the global BA
        who = sorted(spliced)
        poses_pre = {me: mlist[me].kf_pose for me in who}
        if weld_ba and who:
            welded, _ = local_mapping.local_ba_batched(
                ms.stack_maps([mlist[me] for me in who]),
                torch.stack([spliced[me] for me in who]), K[who], n_local=8, n_fixed=4,
                n_pts=1024, iters=4, n_levels=fc.n_levels, scale_factor=fc.scale_factor,
                use_kernel=fc.use_kernel)
            for me, mw in zip(who, ms.unstack_maps(welded, len(who))):
                mlist[me] = mw
        mark("weld")
        if pose_graph_after:
            for me in who:
                mlist[me] = _essential_graph(mlist[me], poses_pre[me], spliced[me],
                                             pose_graph_iters)
        mark("pose_graph")
        if global_ba_after:
            for me in who:
                mlist[me], _ = local_mapping.global_ba(
                    mlist[me], K[me], iters=global_ba_iters, n_levels=fc.n_levels,
                    scale_factor=fc.scale_factor)
        mark("global_ba")

        d = maps.pt_pos.device

        def i32(v):
            return torch.as_tensor(np.asarray(v), dtype=torch.int32, device=d)

        out_states = []
        for me, db in enumerate(dbs):
            h = st_h[me]
            out_states.append(MeshProtocolState(
                db_bow=db.bow, db_valid=db.valid,
                merged=torch.as_tensor(merged_h[me], device=d),
                last_seen=i32(h["last_seen"]), S_peer=S_peer[me],
                S_ok=torch.as_tensor(h["S_ok"], device=d),
                round=sts[me].round + 1, dropped=i32(h["dropped"]),
                refresh_interval=refresh_iv[me], next_refresh=next_refresh[me]))
        return stack_agents(mlist), stack_agents(out_states), M

    return step


def _essential_graph(m, poses_pre, spliced_slot, iters: int):
    """The post-splice essential-graph Sim3 optimization of the reference's
    `_pg`: edges are the sequential chain and each node's strongest
    covisibility neighbour (weight >= 30); the splice-time poses give the
    measurements; keyframe 0, the spliced keyframe and every node the
    welding BA moved are held fixed; points follow their reference
    keyframes."""
    Kc = m.kf_capacity
    iiK = torch.arange(Kc, dtype=torch.int32, device=m.kf_pose.device)
    top_w, top_i = _top_k(ms.covisibility(m), 2)          # stable: ties lowest index first
    top_i = top_i.to(torch.int32)
    first_other = top_i[:, 0] != iiK
    nb = torch.where(first_other, top_i[:, 0], top_i[:, 1])
    nb_w = torch.where(first_other, top_w[:, 0], top_w[:, 1])
    nbl = nb.to(torch.int64)
    ei = torch.cat([iiK[1:], iiK]).to(torch.int64)
    ej = torch.cat([iiK[:-1], nb]).to(torch.int64)
    emask = torch.cat([m.kf_valid[1:] & m.kf_valid[:-1],
                       m.kf_valid & m.kf_valid[nbl] & (nb_w >= 30) & (nb != iiK)])
    poses_s = lie.sim3_from_se3(m.kf_pose)
    meas_src = lie.sim3_from_se3(poses_pre)
    meas = lie.sim3_mul(meas_src[ei], lie.sim3_inv(meas_src[ej]))
    moved = torch.any(m.kf_pose != poses_pre, dim=1)
    fixed = moved | ~m.kf_valid
    fixed[0] = True
    fixed[spliced_slot.to(torch.int64)] = True
    new_poses, _ = pg_mod.optimize_pose_graph(poses_s, fixed, ei, ej, meas, emask, iters=iters)
    pts = pg_mod.correct_points(m.pt_pos, m.pt_ref_kf, m.pt_valid, poses_s, new_poses)
    return m._replace(
        kf_pose=torch.where(m.kf_valid[:, None], pg_mod.se3_from_sim3_poses(new_poses), m.kf_pose),
        pt_pos=pts)

