"""Keyframe database: dense-BoW place recognition queries.

Port of `dvm_slam_tpu/placerec/database.py` (`KeyFrameDatabase`): with
dense [K,W] BoW storage every query is one batched pass:

  * common-word counts:        (q>0) . (B>0)^T, a {0,1} f32 product (exact)
  * min-common-words gate:     count > 0.8 * max
  * L1 similarity:             1 - 0.5 |q - b|_1
  * covisibility accumulation: scores summed over each candidate's top-10
    covisible neighbors
  * merge possibility:         best accumulated score > 0.9 * baseline

Every top-k whose indices matter is `ops/fast.py::_top_k`, a stable
descending sort (ties lowest index first, as `jax.lax.top_k`); `argmax`
returns the first maximum in both packages.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..mapping import map_state
from ..ops.fast import _top_k
from . import vocabulary


class BowDatabase(NamedTuple):
    """Dense BoW per keyframe slot."""

    bow: torch.Tensor    # [K, W] float32 L1-normalized tf-idf
    valid: torch.Tensor  # [K] bool


def create(kf_cap: int, n_words: int, device=None) -> BowDatabase:
    return BowDatabase(
        bow=torch.zeros((kf_cap, n_words), dtype=torch.float32, device=device),
        valid=torch.zeros((kf_cap,), dtype=torch.bool, device=device),
    )


def add(db: BowDatabase, slot, bow) -> BowDatabase:
    slot = int(slot)
    b, v = db.bow.clone(), db.valid.clone()
    b[slot] = bow
    v[slot] = True
    return BowDatabase(bow=b, valid=v)


def add_many(db: BowDatabase, slots, bows) -> BowDatabase:
    """Register a batch of keyframes: slots [n], bows [n,W]; where a slot
    repeats, the last write wins."""
    slots = torch.as_tensor(slots, device=db.bow.device).to(torch.int64)
    return BowDatabase(
        bow=map_state.scatter_set_last(db.bow, slots, bows),
        valid=map_state.scatter_set_last(db.valid, slots,
                                         torch.ones_like(slots, dtype=torch.bool)),
    )


def _common_words(q, bows):
    """[K] words shared by `q` and each row: a {0,1} product, exact in f32."""
    return (bows > 0).to(torch.float32) @ (q > 0).to(torch.float32)


def accumulated_scores(db: BowDatabase, q, exclude, covis):
    """Covisibility-group-accumulated BoW scores of query `q` against the
    database. q [W]; exclude [K] bool; covis [K,K] int32. Returns
    (acc_score [K], single_score [K], eligible [K]): acc_score[i] = score_i +
    the scores of i's top-10 covisible neighbors."""
    ok = db.valid & ~exclude
    cw = _common_words(q, db.bow) * ok
    min_cw = 0.8 * torch.max(cw)
    eligible = ok & (cw > torch.clamp(min_cw, min=0.0)) & (cw > 0)

    s = vocabulary.l1_score(q, db.bow)
    s = torch.where(ok & (cw > 0), s, 0.0)          # scored iff sharing words
    s_gated = torch.where(eligible, s, 0.0)

    K = covis.shape[0]
    top_w, top_i = _top_k(covis, min(10, K))        # [K,10]
    neigh = s[top_i] * (top_w > 0)
    acc = s_gated + torch.where(s_gated > 0, torch.sum(neigh, dim=-1), 0.0)
    return acc, s, eligible


def _best_in_group(covis, s, gi):
    """The group of keyframe `gi` (itself and its top-10 covisible
    neighbors) and its member with the highest single score."""
    top_w, top_i = _top_k(covis[gi], min(10, covis.shape[0]))
    group = torch.cat([gi.reshape(1), torch.where(top_w > 0, top_i, gi)])
    return group[torch.argmax(s[group])]


def best_group_match(db: BowDatabase, q, exclude, covis):
    """(score, best_kf): the best accumulated score and the best single
    keyframe inside the winning group."""
    acc, s, _ = accumulated_scores(db, q, exclude, covis)
    gi = torch.argmax(acc)
    return acc[gi], _best_in_group(covis, s, gi)


def detect_merge_possibility(db: BowDatabase, q, covis):
    """`KeyFrameDatabase::DetectMergePossibility`: score the foreign BoW
    against the whole map; baseline = the same query with the best match's
    own BoW, itself excluded; possible iff score > 0.9 * baseline.
    Returns (possible [] bool, best_kf [], score, baseline)."""
    no_exclude = torch.zeros_like(db.valid)
    score, best = best_group_match(db, q, no_exclude, covis)
    self_mask = torch.zeros_like(db.valid)
    self_mask[best] = True
    baseline, _ = best_group_match(db, db.bow[best], self_mask, covis)
    possible = (score > 0.0) & (baseline > 0.0) & (score > baseline * 0.9)
    return possible, best, score, baseline


def detect_candidates(db: BowDatabase, q, exclude, covis, n: int = 3):
    """`DetectNBestCandidates`: the top-n keyframes by accumulated group
    score, each group represented by its best single keyframe.
    Returns (idx [n], ok [n] bool)."""
    acc, s, _ = accumulated_scores(db, q, exclude, covis)
    top_acc, top_gi = _top_k(acc, n)
    idx = torch.stack([_best_in_group(covis, s, top_gi[i]) for i in range(n)])
    return idx, top_acc > 0.0
