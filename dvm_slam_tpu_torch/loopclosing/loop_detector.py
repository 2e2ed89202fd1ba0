"""Own-map loop detection and trigger recording (with an opt-in correction).

Port of `dvm_slam_tpu/loopclosing/loop_detector.py`. As in the reference
(`LoopClosing.cc`): loop candidates come from `DetectNBestCandidates`
outside the query's covisible set and are verified by descriptor matching,
Sim3 RANSAC and the projection gates; `CorrectLoop()` is disabled upstream
(`LoopClosing.cc:328-329`), so a confirmed loop (3 consistent keyframes)
only records a trigger uuid. `correct_loop` is the opt-in Sim3
essential-graph correction.

The verdict of one keyframe is a [12] f32 row [cand_ok, cand0, sim3_ok,
n_inliers, S_ab(8)], computed on the device and folded on the host in
keyframe order. Each row takes one [300, F] Gumbel block of the Sim3
RANSAC as an input; `LoopDetector` draws its blocks from a CPU
`torch.Generator` seeded 77 (the reference's `PRNGKey(77)`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import lie, two_view
from ..mapping import map_state
from ..placerec import database, vocabulary
from . import merge as merge_mod
from . import pose_graph, sim3_solver

CONSISTENCY_REQUIRED = 3  # LoopClosing.cc:451
MAX_MISSES = 2            # :462,501
SEED = 77


def _detect_verdict(noise, m, db, covis, q, kf_slot, K, with_scale: bool):
    """The detection verdict of one keyframe: candidate query + Sim3
    verification of the best candidate (unconditionally; the host gates on
    cand_ok when it folds), as a [12] f32 row."""
    kf_slot = int(kf_slot)
    exclude = covis[kf_slot] > 0
    exclude[kf_slot] = True
    cand, okc = database.detect_candidates(db, q, exclude, covis, n=3)
    res = merge_mod.compute_sim3_between(noise, m, kf_slot, m, cand[0], K, with_scale=with_scale)
    head = torch.stack([okc[0].to(torch.float32), cand[0].to(torch.float32),
                        res.ok.to(torch.float32), res.n_inliers.to(torch.float32)])
    return torch.cat([head, res.S_ab.to(torch.float32)])


def detect_verdict_batch(noises, m, db, covis, qs, kf_slots, K, with_scale: bool = True):
    """The verdicts of n keyframes -> [n,12]; noises [n,300,F], qs [n,W],
    kf_slots [n]."""
    slots = np.asarray(kf_slots.cpu() if isinstance(kf_slots, torch.Tensor) else kf_slots)
    return torch.stack([_detect_verdict(noises[i], m, db, covis, qs[i], slots[i], K, with_scale)
                        for i in range(len(slots))])


class LoopDetector:
    def __init__(self, voc, K, correct: bool = False, fix_scale: bool = False, device="cuda"):
        self.device = torch.device(device)
        self.voc = voc
        self.K = torch.as_tensor(K, dtype=torch.float32).to(self.device)
        self.correct = correct
        # stereo/RGB-D/inertial maps are metric: the loop Sim3 at s = 1
        self.fix_scale = fix_scale
        self.triggers = []           # recorded trigger uuids
        self._streak_target = None   # the candidate region's anchor keyframe
        self._streak = 0
        self._misses = 0
        self.rng = torch.Generator(device="cpu")
        self.rng.manual_seed(SEED)

    def _sim3_noise(self, n: int):
        """Gumbel noise [300, n] of one Sim3 verification, on the device."""
        return two_view.gumbel(self.rng, (sim3_solver.ITERS, n)).to(self.device)

    def on_keyframe(self, m: map_state.MapState, meta, db, kf_slot: int):
        """Loop detection for one new keyframe, dispatch and fold at once.
        `SlamAgent` batches the verdicts itself and folds them later.
        Returns (found, info)."""
        covis = map_state.covisibility(m)
        levels, idf = self.voc.device_arrays(self.device)
        q = vocabulary.bow_vector(levels, idf, m.kf_desc[kf_slot], m.kf_feat_valid[kf_slot],
                                  self.voc.branch, self.voc.n_words)
        rows = detect_verdict_batch(self._sim3_noise(m.feat_capacity)[None], m, db, covis,
                                    q[None], [kf_slot], self.K, with_scale=not self.fix_scale)
        return self.fold(rows[0].cpu().numpy(), meta, kf_slot)

    def fold(self, row, meta, kf_slot: int):
        """Apply one verdict row to the 3-consecutive-keyframe consistency
        state (`LoopClosing.cc:451,494`); rows fold in keyframe order.
        Returns (found, info)."""
        cand_ok, cand0, sim3_ok = bool(row[0] > 0.5), int(row[1]), bool(row[2] > 0.5)
        if not cand_ok or not sim3_ok:
            self._note_miss()
            return False, None
        # consistency on the same region
        region = cand0
        if self._streak_target is not None and abs(region - self._streak_target) <= 10:
            self._streak += 1
        else:
            self._streak = 1
        self._streak_target = region
        self._misses = 0
        if self._streak < CONSISTENCY_REQUIRED:
            return False, None
        # loop confirmed: record the trigger (the reference's behavior)
        uuid = tuple(int(v) for v in meta.kf_uuid[kf_slot])
        self.triggers.append(uuid)
        info = {"kf": kf_slot, "match": cand0, "S": np.asarray(row[4:12])}
        self._streak = 0
        self._streak_target = None
        return True, info

    def _note_miss(self):
        if self._streak_target is not None:
            self._misses += 1
            if self._misses > MAX_MISSES:
                self._streak = 0
                self._streak_target = None
                self._misses = 0

    def correct_loop(self, m: map_state.MapState, kf_slot: int, match_slot: int, S_loop,
                     iters: int = 20):
        """Sim3 essential-graph correction: the matched (older) side fixed,
        kf_slot constrained to the loop transform, points propagated.
        Returns the corrected map."""
        dev = m.kf_pose.device
        covis = map_state.covisibility(m)
        parent = pose_graph.compute_spanning_tree(covis, m.kf_valid)
        ei, ej = pose_graph.build_essential_edges(
            covis, m.kf_valid, min_weight=30, spanning_parent=parent,
            extra_edges=[(int(kf_slot), int(match_slot))])
        poses = lie.sim3_from_se3(m.kf_pose)
        ei_t = torch.as_tensor(ei, device=dev).to(torch.int64)
        ej_t = torch.as_tensor(ej, device=dev).to(torch.int64)
        meas = lie.sim3_mul(poses[ei_t], lie.sim3_inv(poses[ej_t]))
        # the loop edge measures the corrected pose of kf_slot
        loop_idx = int(np.nonzero((ei == min(kf_slot, match_slot))
                                  & (ej == max(kf_slot, match_slot)))[0][0])
        Si_corr = lie.sim3_mul(poses[kf_slot],
                               torch.as_tensor(np.asarray(S_loop), dtype=poses.dtype, device=dev))
        a, b = int(ei[loop_idx]), int(ej[loop_idx])
        Sa = Si_corr if a == kf_slot else poses[a]
        Sb = Si_corr if b == kf_slot else poses[b]
        meas[loop_idx] = lie.sim3_mul(Sa, lie.sim3_inv(Sb))

        fixed = torch.zeros((m.kf_capacity,), dtype=torch.bool, device=dev)
        fixed[match_slot] = True
        fixed[0] = True
        emask = torch.ones((len(ei),), dtype=torch.bool, device=dev)
        new_poses, _ = pose_graph.optimize_pose_graph(poses, fixed, ei_t, ej_t, meas, emask,
                                                      iters=iters)
        pts = pose_graph.correct_points(m.pt_pos, m.pt_ref_kf, m.pt_valid, poses, new_poses)
        return m._replace(
            kf_pose=torch.where(m.kf_valid[:, None], pose_graph.se3_from_sim3_poses(new_poses),
                                m.kf_pose),
            pt_pos=pts)
