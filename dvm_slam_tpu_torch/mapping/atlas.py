"""Atlas: multi-submap container with merge-back.

Port of `dvm_slam_tpu/mapping/atlas.py` (the reference's `Atlas` with
`Tracking::CreateMapInAtlas` and `LoopClosing`'s active-to-stored merge):

  * `stash_active` parks the current (map, meta, BoW database, covisibility)
    as inactive;
  * `try_merge_back` BoW-matches a new keyframe of the active map against
    every stored map; on a verified Sim3 it splices the active map INTO the
    stored one (the stored map's frame wins), fuses duplicates around the
    merge keyframe and runs the welding BA there.

The Sim3 draws come from a CPU `torch.Generator` seeded 31337 (the
reference's `PRNGKey(31337)`), one [300, F] Gumbel block per verification;
`_sim3_noise` is the draw function tests replace to replay the reference's
keys. The DVM merge registry (`add_successfully_merged`,
`add_loop_closure_trigger`) is kept for the multi-agent wrapper.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..geometry import two_view
from ..loopclosing import merge as merge_mod
from ..loopclosing import sim3_solver
from ..placerec import database, vocabulary
from . import local_mapping, map_state

SEED = 31337


@dataclasses.dataclass
class StoredMap:
    m: map_state.MapState
    meta: map_state.MapMeta
    db: database.BowDatabase
    kf_timestamps: dict
    covis: object = None  # covisibility, computed once at stash (the map is immutable)


class Atlas:
    def __init__(self, voc, K, fc, agent_id: int = 0, fix_scale: bool = False,
                 device="cuda"):
        self.device = torch.device(device)
        self.voc = voc
        self.K = torch.as_tensor(K, dtype=torch.float32).to(self.device)
        self.fc = fc
        self.agent_id = agent_id
        # metric maps (stereo/RGB-D/inertial): merge-back Sim3 at s = 1
        self.fix_scale = fix_scale
        self.inactive: List[StoredMap] = []
        self.rng = torch.Generator(device="cpu")
        self.rng.manual_seed(SEED)
        # DVM merge registry and loop triggers
        self.merged_agent_ids: List[int] = []
        self.merged_agent_sim3: dict = {}
        self.loop_closure_triggers: set = set()

    # -- DVM registry (merge bookkeeping used by the wrapper) --------------
    def add_successfully_merged(self, agent_id: int, S):
        if agent_id not in self.merged_agent_ids:
            self.merged_agent_ids.append(agent_id)
        self.merged_agent_sim3[agent_id] = np.asarray(S)

    def add_loop_closure_trigger(self, uuid):
        self.loop_closure_triggers.add(tuple(int(v) for v in np.asarray(uuid).reshape(-1)))

    # -- submap management ---------------------------------------------------

    def _sim3_noise(self, n: int):
        """Gumbel noise [300, n] of one Sim3 verification, on the device."""
        return two_view.gumbel(self.rng, (sim3_solver.ITERS, n)).to(self.device)

    def _bow(self, m, slot: int):
        levels, idf = self.voc.device_arrays(self.device)
        return vocabulary.bow_vector(levels, idf, m.kf_desc[slot], m.kf_feat_valid[slot],
                                     self.voc.branch, self.voc.n_words)

    def _build_db(self, m):
        db = database.create(m.kf_capacity, self.voc.n_words, self.device)
        n = int(m.n_kf)
        valid = m.kf_valid[:n].cpu().numpy()
        for slot in range(n):
            if valid[slot]:
                db = database.add(db, slot, self._bow(m, slot))
        return db

    def stash_active(self, m, meta, kf_timestamps):
        """Park the current map. Stored maps do not change, so the
        covisibility merge-back scoring reads is computed once, here."""
        self.inactive.append(StoredMap(
            m=m, meta=meta, db=self._build_db(m), kf_timestamps=dict(kf_timestamps),
            covis=map_state.covisibility(m),
        ))

    def try_merge_back(self, m_active, meta_active, query_slot: int):
        """Weld the active map into a stored one through the query keyframe.
        Returns None or (merged map, merged meta, kf_map, S_ab [8] Sim3
        active -> stored (numpy), stored keyframe timestamps)."""
        q = self._bow(m_active, query_slot)
        fc = self.fc
        for si, stored in enumerate(self.inactive):
            covis = (stored.covis if stored.covis is not None
                     else map_state.covisibility(stored.m))
            ok, best, _, _ = database.detect_merge_possibility(stored.db, q, covis)
            if not bool(ok):
                continue
            best = int(best)
            res = merge_mod.compute_sim3_between(
                self._sim3_noise(stored.m.feat_capacity), stored.m, best, m_active,
                query_slot, self.K, with_scale=not self.fix_scale)
            if not bool(res.ok):
                continue
            merged, meta, kf_map, _ = merge_mod.merge_maps(
                stored.m, stored.meta, m_active, meta_active, res.S_ab)
            c = torch.tensor(best, dtype=torch.int32, device=self.device)
            merged = local_mapping.fuse_duplicates(
                merged, c, self.K, n_neighbors=5, n_levels=fc.n_levels,
                scale_factor=fc.scale_factor)
            merged, _ = local_mapping.local_ba(
                merged, c, self.K, n_local=12, n_fixed=8, n_pts=2048, iters=6,
                n_levels=fc.n_levels, scale_factor=fc.scale_factor, use_kernel=fc.use_kernel)
            ts = dict(stored.kf_timestamps)
            self.inactive.pop(si)
            return merged, meta, kf_map, res.S_ab.cpu().numpy(), ts
        return None
