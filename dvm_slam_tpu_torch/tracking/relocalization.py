"""Relocalization: recover a lost tracker by place recognition + PnP.

Port of `dvm_slam_tpu/tracking/relocalization.py` (`Tracking::
Relocalization`): BoW candidates from the keyframe database, descriptor
matching of the lost frame against each candidate keyframe's map points,
RANSAC PnP over 128 hypotheses and pose-only Gauss-Newton refinement,
accepted at `MIN_RELOC_INLIERS` or more.

The PnP draws come from a CPU `torch.Generator` seeded 4242 (the
reference's `PRNGKey(4242)`): one [128, F] Gumbel block per candidate tried,
so the card and the CPU see the same draws. `_noise_source` returns the
per-call draw function; tests replace it to replay the reference's keys.
"""

from __future__ import annotations

import torch

from ..geometry import pnp, two_view
from ..mapping import map_state
from ..ops import matching
from ..placerec import database, vocabulary
from . import pose_opt

MIN_RELOC_INLIERS = 30
PNP_HYPOTHESES = 128
SEED = 4242


class RelocalizationService:
    """Owns the vocabulary and the BoW database of relocalization; it
    registers the BoW of every valid keyframe it has not seen yet. A shared
    database (`db`) is read as it is."""

    def __init__(self, voc, K, sigma2, db=None, kf_cap: int = 0, device="cuda"):
        self.device = torch.device(device)
        self.voc = voc
        self.K = torch.as_tensor(K, dtype=torch.float32).to(self.device)
        self.sigma2 = torch.tensor(tuple(sigma2), dtype=torch.float32, device=self.device)
        self._own_db = db is None
        self.db = db if db is not None else database.create(kf_cap, voc.n_words, self.device)
        self._slots = set()
        self.rng = torch.Generator(device="cpu")
        self.rng.manual_seed(SEED)

    def reset(self, kf_cap: int):
        """Clear the database (the tracker started a new submap, or a merge
        renumbered the slots)."""
        if self._own_db:
            self.db = database.create(kf_cap, self.voc.n_words, self.device)
            self._slots = set()

    def _refresh(self, m):
        if not self._own_db:
            return
        levels, idf = self.voc.device_arrays(self.device)
        n = int(m.n_kf)
        valid = m.kf_valid[:n].cpu().numpy()
        for slot in range(n):
            if slot in self._slots or not valid[slot]:
                continue
            bow = vocabulary.bow_vector(levels, idf, m.kf_desc[slot], m.kf_feat_valid[slot],
                                        self.voc.branch, self.voc.n_words)
            self.db = database.add(self.db, slot, bow)
            self._slots.add(slot)

    def _noise_source(self):
        """The draw function of one relocalization call: n -> Gumbel noise
        [128, n] on the device, one block per candidate tried."""
        return lambda n: two_view.gumbel(self.rng, (PNP_HYPOTHESES, n)).to(self.device)

    def __call__(self, m, frame):
        """Returns (ok, T_cw or None, n_inliers)."""
        self._refresh(m)
        covis = map_state.covisibility(m)
        return relocalize(self._noise_source(), m, self.db, covis, self.voc, frame, self.K,
                          self.sigma2)


def _match_and_pnp(noise, m, kf_slot, frame_xy, frame_desc, frame_level, frame_valid, K,
                   sigma2):
    """Match a frame against one candidate keyframe's map points, solve PnP,
    refine. noise [H,F] the PnP draws; sigma2 [levels] tensor. Returns (T,
    n_inliers)."""
    obs = m.kf_obs[kf_slot]
    has_pt = (obs >= 0) & m.kf_feat_valid[kf_slot]
    psl = torch.clamp(obs, min=0).to(torch.int64)
    dist = matching.hamming_matrix(m.pt_desc[psl], frame_desc)
    mask = has_pt[:, None] & frame_valid[None, :]
    idx, _, ok = matching.masked_best_match(dist, mask, matching.TH_LOW, ratio=0.75)
    ok = matching.dedupe_matches(idx, ok, frame_desc.shape[0])
    j = torch.clamp(idx, min=0)
    X = m.pt_pos[psl]
    uv = frame_xy[j]
    T0, inl0, _ = pnp.ransac_pnp(noise, X, uv, ok, K)
    sig = sigma2[frame_level[j].to(torch.int64)]
    T, inl, _ = pose_opt.pose_optimization(T0, X, uv, sig, inl0, K)
    return T, torch.sum(inl)


def relocalize(noise, m: map_state.MapState, db, covis, voc, frame, K, sigma2, exclude=None,
               n_candidates: int = 3):
    """Try to relocalize `frame` against the map. `noise` is the call's draw
    function (n -> [H,n]), called once per candidate tried. Returns (ok,
    T_cw, inliers); a host loop over the few candidates."""
    dev = m.pt_pos.device
    levels, idf = voc.device_arrays(dev)
    sigma2 = torch.as_tensor(sigma2, dtype=torch.float32, device=dev)
    q = vocabulary.bow_vector(levels, idf, frame.desc, frame.valid, voc.branch, voc.n_words)
    if exclude is None:
        exclude = torch.zeros_like(db.valid)
    cand, ok = database.detect_candidates(db, q, exclude, covis, n=n_candidates)
    cand, ok = cand.tolist(), ok.tolist()
    best = (False, None, 0)
    for i in range(n_candidates):
        if not ok[i]:
            continue
        T, n = _match_and_pnp(noise(m.feat_capacity), m, cand[i], frame.xy, frame.desc,
                              frame.level, frame.valid, K, sigma2)
        n = int(n)
        if n > best[2]:
            best = (n >= MIN_RELOC_INLIERS, T, n)
        if best[0]:
            break
    return best
