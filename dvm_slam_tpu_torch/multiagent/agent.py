"""SlamAgent: the per-agent decentralized C-SLAM runtime.

Port of `dvm_slam_tpu/multiagent/agent.py` (the reference's
`OrbSlam3Wrapper`, `src/slam_system/src/orb_slam3_wrapper.cpp`): a tracker,
a local mapper, a BoW database, a peer table and a frame tree, with the
per-frame protocol loop (`orb_slam3_wrapper.cpp:131-148`):

  updateSuccessfullyMerged -> updateIsLostFromBaseMap ->
  sendNewKeyFrameBows -> sendNewKeyFrames (+ the scale-alignment timer)

Protocol (constants `orb_slam3_wrapper.cpp:36-38`):
  * BoW advertisement before a merge: own new keyframes, >= 5 per batch,
    >= 12 keyframes in all (`:457-534`);
  * merge detection on the lead node only, the 0.9x-baseline BoW rule; the
    higher agent id pulls (or is pushed) the map and merges, so the merged
    map lands in the lower id's frame (`:536-618`, `System.cc:1386-1422`);
    Sim3 verification, splice, fuse, the welding BA, the Sim3 essential
    graph and the asynchronous global BA (`LoopClosing::MergeLocal`);
  * incremental keyframe sharing after a merge: own unsent keyframes
    outside the 3-keyframe culling window, >= 5 per batch (`:212-384`);
    receiving is a uuid-relinked splice, fuse and one local BA
    (`LocalMapping.cc:302-354`);
  * the SuccessfullyMerged broadcast with implicit transitive merges
    (`:620-731`), lost-from-base-map gating (`:733-764`);
  * RANSAC-Umeyama scale re-alignment against the lowest merged peer,
    >= 500 shared points, AIMD backoff (`:766-833`).

Every message carries numpy arrays, bytes and Python scalars only, so a JAX
agent and a port agent share one transport, and `wirecodec` frames cross
between the packages. Device work is asynchronous where the reference's is:
the protocol records (BoWs, sparse advertisements, loop verdicts) and the
post-merge global BA fold back once a CUDA event recorded after their
dispatch has completed (on the CPU at once).

Random draws are inputs (ROADMAP fault b): the agent's CPU generator,
seeded 1000 + agent_id like the reference's `PRNGKey(1000 + agent_id)`,
draws one [300, F] Gumbel block per loop verdict and per merge attempt and
one [500, n] block per scale alignment. The reference's `proto_pad`, a
fixed chunk shape for the TPU, is not ported: each protocol record takes
every keyframe retired since the last one.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..geometry import alignment, lie, two_view
from ..loopclosing import loop_detector as loop_mod
from ..loopclosing import merge as merge_mod
from ..loopclosing import pose_graph, sim3_solver
from ..mapping import local_mapping, map_state
from ..ops.fast import _top_k
from ..placerec import database, vocabulary
from ..tracking import tracker as trk
from ..tracking.relocalization import RelocalizationService
from . import codec, messages as msgs
from .peer import PeerTable
from .reference_frames import ReferenceFrameManager

MIN_KEY_FRAME_SHARE_SIZE = 5       # orb_slam3_wrapper.cpp:36
MIN_BOW_SHARE_SIZE = 5             # :37
MIN_MAP_POINTS_FOR_SCALE_ADJUSTMENT = 500  # :38
MIN_KEY_FRAMES_FOR_MERGE = 12      # :466,551
CULLING_WINDOW = 3                 # :243 (maxId - 3)
SCALE_ALIGN_BASE_INTERVAL = 5.0    # 5 s wall timer, :123
SCALE_HYPOTHESES = 500             # ransacPointSetAlignment's iterations
# sparse advertisement entries per keyframe: a BoW has at most n_features
# nonzeros, so 1024 keeps every word
_BOW_NZ = 1024


def _record_event(device):
    """A CUDA event recorded behind the work dispatched so far, or None on
    the CPU (where the work is done when the call returns)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _protocol_chunk(levels, idf, m, db, noises, idx, own_rows, own_slots, K, branch: int,
                    n_words: int, nz: int, with_scale: bool):
    """The per-retire protocol computation: the BoWs of the keyframes `idx`,
    their registration in the database, the sparse advertisement of the own
    rows (a stable top-k), the covisibility, and the own rows' loop
    verdicts. Returns (db', keys [n_own,nz] int32, values, verdicts
    [n_own,12] or None)."""
    bows = torch.stack([vocabulary.bow_vector(levels, idf, m.kf_desc[s], m.kf_feat_valid[s],
                                              branch, n_words) for s in idx])
    db2 = database.add_many(db, idx, bows)
    if not own_rows:
        return db2, None, None, None
    own_bows = bows[torch.as_tensor(own_rows, device=bows.device)]
    vals, keys = _top_k(own_bows, nz)
    covis = map_state.covisibility(m)
    rows = loop_mod.detect_verdict_batch(noises, m, db2, covis, own_bows, own_slots, K,
                                         with_scale=with_scale)
    return db2, keys.to(torch.int32), vals, rows


class SlamAgent:
    def __init__(self, agent_id: int, config: trk.TrackerConfig, K, dist, voc, transport,
                 peer_ids, mapper: local_mapping.LocalMapper | None = None,
                 rng_seed: int | None = None, post_merge_pose_graph: bool = True,
                 post_merge_global_ba: bool = True, autonomous: bool = True,
                 auto_batch: int = 4, async_depth: int = 8, loop_correction: bool = False,
                 device="cuda"):
        # post-merge stages of `LoopClosing::MergeLocal`: the welding BA,
        # the essential graph and a detached global BA on every merge
        self.post_merge_pose_graph = post_merge_pose_graph
        self.post_merge_global_ba = post_merge_global_ba
        # intra-map loop correction is disabled upstream (`LoopClosing.cc:
        # 328-339`): triggers are only recorded unless this is set
        self.loop_correction = loop_correction
        self.device = torch.device(device)
        self.agent_id = agent_id
        self.config = config
        self.voc = voc
        self.voc_levels, self.voc_idf = voc.device_arrays(self.device)
        mapper = mapper or local_mapping.LocalMapper()
        self.tracker = trk.MonocularTracker(
            config, K, dist, local_mapper=mapper,
            rng_seed=agent_id if rng_seed is None else rng_seed, device=self.device)
        self.tracker.meta.agent_id = agent_id
        # the tracking/mapping overlap: the autonomous lane is the default;
        # merges and rebases leave it and auto_mode re-enters it
        if autonomous:
            self.tracker.auto_mode = True
            self.tracker.auto_batch = auto_batch
            self.tracker.async_depth = async_depth
        self.peers = PeerTable(agent_id, peer_ids)
        self.transport = transport
        transport.register(agent_id)
        transport.register_service(agent_id, msgs.SRV_GET_CURRENT_MAP, self._srv_get_current_map)
        transport.register_service(agent_id, msgs.SRV_GET_MAP_POINTS, self._srv_get_map_points)
        self.frames = ReferenceFrameManager(agent_id)
        self.db = database.create(config.kf_cap, voc.n_words, self.device)
        self.tracker.relocalizer = RelocalizationService(
            voc, K, config.frontend.sigma2, kf_cap=config.kf_cap, device=self.device)
        self.loop_detector = loop_mod.LoopDetector(voc, K, fix_scale=config.depth_sensor,
                                                   device=self.device)
        self._db_slots = set()
        self._kf_bows = {}          # slot -> sparse (keys, values) BoW of an own keyframe
        # host mirror of map.kf_valid, refreshed once per tracker.map_epoch;
        # between epochs keyframe slots are append-only valid, so the loop
        # reads no kf_valid from the device per frame
        self._kf_valid_host = np.zeros(config.kf_cap, bool)
        self._kf_valid_n = 0
        self._kf_valid_epoch = self.tracker.map_epoch
        self.rng = torch.Generator(device="cpu")
        self.rng.manual_seed(1000 + agent_id)
        self._was_lost = False
        self._scale_interval = SCALE_ALIGN_BASE_INTERVAL
        self._next_scale_ts = SCALE_ALIGN_BASE_INTERVAL
        self._peer_merges = set()   # frozenset({a, b}) merge announcements seen
        # the in-flight post-merge global BA (the reference's detached GBA
        # thread with its mbStopGBA abort, LoopClosing.cc:1796-1799)
        self._pending_gba = None
        # in-flight protocol records, folded in keyframe order
        self._pending_protocol = []
        self.log = []

    # ------------------------------------------------------------------
    # random draws (inputs of the solvers; tests replace these)
    # ------------------------------------------------------------------

    def _sim3_noise(self, n: int):
        """Gumbel noise [300, n] of one Sim3 verification, on the device."""
        return two_view.gumbel(self.rng, (sim3_solver.ITERS, n)).to(self.device)

    def _protocol_noise(self, own_flags):
        """The Sim3 blocks of one protocol record: one per own keyframe
        among the record's new slots (`own_flags`, in slot order)."""
        return [self._sim3_noise(self.map.feat_capacity) for own in own_flags if own]

    def _align_noise(self, n: int):
        """Gumbel noise [500, n] of one scale alignment, on the device."""
        return two_view.gumbel(self.rng, (SCALE_HYPOTHESES, n)).to(self.device)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def process_image(self, img, ts: float):
        pose = self.tracker.process_image(img, ts)
        self.run_once(ts)
        return pose

    def flush(self):
        """End-of-stream barrier: dispatch buffered autonomous frames, retire
        the bookkeeping, fold in any in-flight global BA."""
        self.tracker.drain_auto()
        self.tracker.flush_meta()
        self._update_bow_db()
        self._poll_protocol(block=True)
        self._poll_gba(block=True)

    def run_once(self, ts: float):
        """One protocol-loop iteration (`orb_slam3_wrapper.cpp:131-148`)."""
        self._poll_gba()
        self._update_bow_db()
        self._drain_channels(ts)
        self._update_is_lost()
        if not self._is_lost():
            self._send_new_key_frame_bows()
            self._send_new_key_frames()
            if ts >= self._next_scale_ts:
                self._update_map_scale(ts)

    # ------------------------------------------------------------------
    # bookkeeping
    # ------------------------------------------------------------------

    @property
    def map(self):
        return self.tracker.map

    @property
    def meta(self):
        return self.tracker.meta

    def _is_lost(self):
        return self.tracker.state in (trk.RECENTLY_LOST, trk.LOST)

    def _host_kf_valid(self, n: int):
        """kf_valid[:n] from the host mirror; `n` from tracker.n_kf_host."""
        if self._kf_valid_epoch != self.tracker.map_epoch:
            self._kf_valid_host = self.map.kf_valid.cpu().numpy().copy()
            self._kf_valid_n = n
            self._kf_valid_epoch = self.tracker.map_epoch
        if n > self._kf_valid_n:
            self._kf_valid_host[self._kf_valid_n:n] = True
            self._kf_valid_n = n
        return self._kf_valid_host[:n]

    def check_invariants(self):
        """Test barrier: the host kf_valid mirror equals the device array.
        The mirror holds only if no path clears kf_valid between map_epoch
        bumps and every wholesale map rebuild bumps tracker.map_epoch.
        Synchronizes the device."""
        self.tracker.drain_auto()
        n = self.tracker.n_kf_host
        host = self._host_kf_valid(n)
        dev = self.map.kf_valid.cpu().numpy()[:n]
        if not bool((host == dev).all()):
            bad = np.nonzero(host != dev)[0]
            raise AssertionError(
                f"host kf_valid mirror desynced at slots {bad[:8].tolist()} (epoch "
                f"{self._kf_valid_epoch} vs map_epoch {self.tracker.map_epoch}): a "
                f"map-surgery path forgot to bump tracker.map_epoch")
        return True

    def _own_kf_slots(self):
        n = self.tracker.n_kf_host
        valid = self._host_kf_valid(n)
        creators = self.meta.kf_creator[:n]
        return [i for i in range(n) if valid[i] and creators[i] == self.agent_id]

    def _update_bow_db(self):
        """Register the BoWs of all new valid keyframes (own and spliced)
        and dispatch the own keyframes' loop detection as one device record,
        folded later by `_poll_protocol` (triggers recorded; the correction
        is disabled as in the reference, LoopClosing.cc:328-339). Only slots
        whose host metadata has retired count: in the autonomous lane the
        device keyframe counter runs ahead of the uuids and creators."""
        self._poll_protocol()
        n = self.tracker.n_kf_host
        valid = self._host_kf_valid(n)
        new_slots = [s for s in range(n) if s not in self._db_slots and valid[s]]
        if not new_slots:
            return
        own_flags = [bool(self.meta.kf_creator[s] == self.agent_id) for s in new_slots]
        own = [(j, s) for j, (s, o) in enumerate(zip(new_slots, own_flags)) if o]
        noises = self._protocol_noise(own_flags)
        self.db, keys, vals, rows = _protocol_chunk(
            self.voc_levels, self.voc_idf, self.map, self.db, noises, new_slots,
            [j for j, _ in own], [s for _, s in own], self.tracker.K,
            branch=self.voc.branch, n_words=self.voc.n_words,
            nz=min(_BOW_NZ, self.voc.n_words), with_scale=not self.loop_detector.fix_scale)
        self._db_slots.update(new_slots)
        if not own:
            return
        self._pending_protocol.append({
            "own": [s for _, s in own], "keys": trk._HostCopy(keys),
            "vals": trk._HostCopy(vals), "rows": trk._HostCopy(rows),
            "epoch": self.tracker.map_epoch,
        })

    def _poll_protocol(self, block: bool = False):
        """Fold landed protocol records (sparse BoWs for the advertisement,
        loop verdicts) into the host state, first in first out: the loop
        detector's consistency streak needs keyframe order."""
        while self._pending_protocol:
            rec = self._pending_protocol[0]
            if not block and not all(rec[a].ready() for a in ("keys", "vals", "rows")):
                return
            self._pending_protocol.pop(0)
            keys_np, vals_np, rows_np = (rec[a].numpy() for a in ("keys", "vals", "rows"))
            for j, slot in enumerate(rec["own"]):
                nz = vals_np[j] > 0
                self._kf_bows[slot] = (keys_np[j][nz].astype(np.int64),
                                       vals_np[j][nz].astype(np.float64))
                # verdicts against a superseded slot layout are dropped; the
                # BoWs stay (advertisement is uuid-keyed, own slots stable)
                if rec["epoch"] == self.tracker.map_epoch:
                    found, info = self.loop_detector.fold(rows_np[j], self.meta, slot)
                    if found:
                        self.log.append(("loop_trigger", slot, info["match"]))
                        if self.loop_correction:
                            self._apply_loop_correction(slot, info)

    def _apply_loop_correction(self, slot: int, info):
        """Opt-in intra-map loop correction (`CorrectLoop`, disabled
        upstream): the essential graph anchored at the matched keyframe;
        the tracker continuation follows the moved query keyframe."""
        self._abort_gba("loop_correction")
        self.tracker.exit_autonomous()
        self.tracker.flush_meta()
        old_kf_pose = self.map.kf_pose[slot]
        corrected = self.loop_detector.correct_loop(self.map, slot, int(info["match"]), info["S"])
        corr = lie.se3_mul(lie.se3_inv(old_kf_pose), corrected.kf_pose[slot])
        self.tracker.map = corrected
        self.tracker.last_pose = lie.se3_mul(self.tracker.last_pose, corr)
        self.tracker.velocity = lie.se3_identity(device=self.device)
        self.tracker.map_epoch += 1
        self.log.append(("loop_corrected", slot, int(info["match"])))

    def _slot_of_kf_uuid(self, uuid_pair):
        n = int(self.map.n_kf)
        match = np.all(self.meta.kf_uuid[:n] == np.asarray(uuid_pair, np.uint64), axis=1)
        idx = np.nonzero(match)[0]
        return int(idx[0]) if len(idx) else -1

    def _submap_bytes(self, slots) -> bytes:
        mask = np.zeros(self.map.kf_capacity, bool)
        mask[slots] = True
        return codec.extract_submap(self.map, self.meta, mask).to_bytes()

    # ------------------------------------------------------------------
    # outbound protocol
    # ------------------------------------------------------------------

    def _send_new_key_frame_bows(self):
        """BoW advertisement to not-yet-merged peers (`:457-534`)."""
        own = self._own_kf_slots()
        if len(own) < MIN_KEY_FRAMES_FOR_MERGE:
            return
        for peer in self.peers:
            if peer.successfully_merged or peer.is_lost_from_base_map:
                continue
            fresh = []
            for slot in own:
                u = msgs.uuid_key(self.meta.kf_uuid[slot])
                if u in peer.sent_key_frame_bow_uuids or slot not in self._kf_bows:
                    continue  # BoW still in flight: advertised next round
                keys, vals = self._kf_bows[slot]
                fresh.append((u, msgs.KeyFrameBowVector(uuid=u, keys=keys, values=vals)))
            if len(fresh) < MIN_BOW_SHARE_SIZE:
                continue
            self.transport.publish(
                self.agent_id, peer.agent_id, msgs.CH_NEW_KEY_FRAME_BOWS,
                msgs.NewKeyFrameBows(self.agent_id, [b for _, b in fresh]))
            peer.sent_key_frame_bow_uuids.update(u for u, _ in fresh)

    def _sharable_own_slots(self, peer):
        """Own keyframes not yet sent, outside the 3-keyframe culling window
        (`:240-247`)."""
        own = self._own_kf_slots()
        if not own:
            return []
        max_slot = max(own)
        return [slot for slot in own if slot <= max_slot - CULLING_WINDOW
                and msgs.uuid_key(self.meta.kf_uuid[slot]) not in peer.sent_key_frame_uuids]

    def _send_new_key_frames(self):
        """Incremental sharing to merged peers (`:212-384`)."""
        if not any(p.successfully_merged and not p.is_lost_from_base_map for p in self.peers):
            return  # nothing to share: keep the frame loop free of syncs
        self.tracker.flush_meta()
        for peer in self.peers:
            if not peer.successfully_merged or peer.is_lost_from_base_map:
                continue
            slots = self._sharable_own_slots(peer)
            if len(slots) < MIN_KEY_FRAME_SHARE_SIZE:
                continue
            mask = np.zeros(self.map.kf_capacity, bool)
            mask[slots] = True
            packet = codec.extract_submap(self.map, self.meta, mask)
            self.transport.publish(self.agent_id, peer.agent_id, msgs.CH_NEW_KEY_FRAMES,
                                   msgs.NewKeyFrames(self.agent_id, packet.to_bytes()))
            peer.sent_key_frame_uuids.update(msgs.uuid_key(u) for u in packet.kf_uuid)
            peer.sent_map_point_uuids.update(msgs.uuid_key(u) for u in packet.pt_uuid)

    def _update_is_lost(self):
        lost = self._is_lost()
        if lost != self._was_lost:
            self.transport.publish(self.agent_id, None, msgs.CH_IS_LOST,
                                   msgs.IsLostFromBaseMap(self.agent_id, lost))
            self._was_lost = lost

    # ------------------------------------------------------------------
    # inbound protocol
    # ------------------------------------------------------------------

    def _drain_channels(self, ts):
        for _, m in self.transport.poll(self.agent_id, msgs.CH_IS_LOST):
            if m.sender_agent_id in self.peers.peers:
                self.peers[m.sender_agent_id].is_lost_from_base_map = m.is_lost
        for _, m in self.transport.poll(self.agent_id, msgs.CH_SUCCESSFULLY_MERGED):
            self._receive_successfully_merged(m)
        for _, m in self.transport.poll(self.agent_id, msgs.CH_CHANGE_COORDINATE_FRAME):
            self._receive_change_coordinate_frame(m)
        for _, m in self.transport.poll(self.agent_id, msgs.CH_NEW_KEY_FRAME_BOWS):
            self._receive_new_key_frame_bows(m)
        for _, m in self.transport.poll(self.agent_id, msgs.CH_MAP_TO_ATTEMPT_MERGE):
            self._receive_map_to_attempt_merge(m)
        for _, m in self.transport.poll(self.agent_id, msgs.CH_NEW_KEY_FRAMES):
            self._receive_new_key_frames(m)
        # loop-closure triggers would re-enqueue loop keyframes; the
        # correction is disabled upstream (LoopClosing.cc:329)
        self.transport.poll(self.agent_id, msgs.CH_LOOP_CLOSURE_TRIGGERS)

    def _receive_new_key_frame_bows(self, m):
        """Merge-candidate detection (`:536-618`): lead node only, both maps
        >= 12 keyframes, the 0.9x-baseline BoW rule."""
        if not self.peers.is_lead_node():
            return
        self.tracker.flush_meta()
        peer = self.peers[m.sender_agent_id]
        if peer.successfully_merged:
            return
        if len(self._own_kf_slots()) < MIN_KEY_FRAMES_FOR_MERGE:
            return
        covis = map_state.covisibility(self.map)
        candidates = []
        for bow in m.bows:
            q = torch.zeros((self.voc.n_words,), dtype=torch.float32, device=self.device)
            q[torch.as_tensor(np.asarray(bow.keys, np.int64), device=self.device)] = \
                torch.as_tensor(np.asarray(bow.values, np.float32), device=self.device)
            ok, best, score, _ = database.detect_merge_possibility(self.db, q, covis)
            if bool(ok):
                candidates.append((bow.uuid, int(best), float(score)))
        if not candidates:
            return
        self.log.append(("merge_candidates", m.sender_agent_id, len(candidates)))
        uuids = [c[0] for c in candidates]
        if self.agent_id > m.sender_agent_id:
            # the higher id pulls the peer's map and merges, so the shared
            # frame is the lower id's (System.cc:1392-1421)
            resp = self.transport.call(self.agent_id, m.sender_agent_id, msgs.SRV_GET_CURRENT_MAP,
                                       msgs.GetCurrentMapRequest(self.agent_id, uuids))
            if resp is not None:
                self._attempt_merge(m.sender_agent_id, resp.serialized_map, uuids)
        else:
            # the lower id pushes its own map; the peer merges into our frame
            self.transport.publish(
                self.agent_id, m.sender_agent_id, msgs.CH_MAP_TO_ATTEMPT_MERGE,
                msgs.MapToAttemptMerge(self.agent_id, self._submap_bytes(self._own_kf_slots()),
                                       uuids))

    def _receive_map_to_attempt_merge(self, m):
        self._attempt_merge(m.sender_agent_id, m.serialized_map,
                            m.merge_candidate_key_frame_uuids)

    def _bow(self, m, slot: int):
        return vocabulary.bow_vector(self.voc_levels, self.voc_idf, m.kf_desc[slot],
                                     m.kf_feat_valid[slot], self.voc.branch, self.voc.n_words)

    def _attempt_merge(self, peer_id: int, blob: bytes, candidate_uuids):
        """Deserialize a foreign map and try the Sim3 merge on the candidate
        keyframes (`System::AddSerializedMapToTryMerge` + the LoopClosing
        merge). Returns True on a merge."""
        # map surgery ahead: leave the autonomous lane (auto_mode re-enters)
        self.tracker.exit_autonomous()
        self.tracker.flush_meta()
        if self.peers[peer_id].successfully_merged:
            return False  # a second in-flight copy of a merge already done
        packet = codec.MapPacket.from_bytes(blob)
        mB, metaB = codec.materialize(packet, self.config.frontend.capacity, device=self.device)
        tried = 0
        for cu in candidate_uuids:
            # a candidate uuid names a keyframe of either side
            fidx = np.nonzero(np.all(packet.kf_uuid == np.asarray(cu, np.uint64), axis=1))[0]
            if len(fidx):
                kfB = int(fidx[0])
                covis = map_state.covisibility(self.map)
                _, kfA = database.best_group_match(self.db, self._bow(mB, kfB),
                                                   torch.zeros_like(self.db.valid), covis)
                kfA = int(kfA)
            else:
                kfA = self._slot_of_kf_uuid(cu)
                if kfA < 0:
                    continue
                bowA = self._bow(self.map, kfA)
                scores = [float(vocabulary.l1_score(bowA, self._bow(mB, j)[None])[0])
                          for j in range(packet.n_kf)]
                kfB = int(np.argmax(scores))
            tried += 1
            # depth sensors give metric maps: the Sim3 at s = 1 (bFixScale)
            res = merge_mod.compute_sim3_between(
                self._sim3_noise(self.map.feat_capacity), self.map, kfA, mB, kfB, self.tracker.K,
                with_scale=not self.config.depth_sensor)
            if not bool(res.ok):
                continue
            if self.tracker.inertial and self.tracker.imu_initialized:
                # an inertial map is metric: a scale outside [0.90, 1.1] is
                # rejected (`LoopClosing.cc:151`)
                sc = float(res.S_ab[7])
                if not (0.90 <= sc <= 1.1):
                    self.log.append(("merge_scale_rejected", peer_id, sc))
                    continue
            self._do_merge(peer_id, mB, metaB, res.S_ab, kfA)
            return True
        self.log.append(("merge_failed", peer_id, tried))
        return False

    def _do_merge(self, peer_id: int, mB, metaB, S_ab, weld_kf: int):
        """Splice the foreign map in; the merged group's frame is the lower
        agent id's world (`System.cc:1392-1421`). If the peer has the lower
        id, re-base the whole map into its frame first and announce the
        frame change to the current group (`:920-999`). An IMU-initialized
        tracker welds with the joint visual-inertial BA over its own chain
        (MergeInertialBA), the others with the visual window BA."""
        fc = self.config.frontend
        K = self.tracker.K
        t_merge0 = time.perf_counter()
        # a newer merge supersedes any in-flight global BA (mbStopGBA)
        self._abort_gba("superseded_by_merge")
        if peer_id < self.agent_id:
            self._apply_frame_change(peer_id, lie.sim3_inv(S_ab))
            S_for_splice = lie.sim3_identity(device=self.device)
        else:
            S_for_splice = S_ab
        merged, meta, _, _ = merge_mod.merge_maps(self.map, self.meta, mB, metaB, S_for_splice)
        # the splice-time poses: their relative transforms are the essential
        # graph's edge measurements (NonCorrectedSim3, Optimizer.cc:1389)
        poses_pre = merged.kf_pose
        weld = torch.tensor(weld_kf, dtype=torch.int32, device=self.device)
        merged = local_mapping.fuse_duplicates(merged, weld, K, n_neighbors=5,
                                               n_levels=fc.n_levels, scale_factor=fc.scale_factor)
        mapper = self.tracker.local_mapper
        if (self.tracker.inertial and self.tracker.imu_initialized and mapper is not None
                and len(self.tracker.kf_chain) >= 2):
            # MergeInertialBA (`Optimizer.cc:3676`, from MergeLocal2,
            # `LoopClosing.cc:1811`): the own chain's poses, velocities and
            # biases re-estimated against the welded geometry
            saved = self.tracker.map
            self.tracker.map = merged
            merged = mapper._vi_local_ba(self.tracker, weld_kf)
            self.tracker.map = saved
        else:
            merged, _ = local_mapping.local_ba(
                merged, weld, K, n_local=12, n_fixed=8, n_pts=2048, iters=6,
                n_levels=fc.n_levels, scale_factor=fc.scale_factor, use_kernel=fc.use_kernel)
        if self.post_merge_pose_graph:
            merged = self._run_pose_graph(merged, weld_kf, poses_pre)
        self.tracker.map = merged
        self.tracker.meta = meta
        self.tracker.n_kf_host = int(merged.n_kf)
        self.tracker.map_epoch += 1  # the slot layout changed: refresh the mirrors
        if self.post_merge_global_ba:
            # the detached GBA thread's role (LoopClosing.cc:1796): dispatched
            # on the device, folded in by _poll_gba once its event completes
            self._dispatch_gba(merged, weld_kf)

        peer = self.peers[peer_id]
        peer.successfully_merged = True
        self._peer_merges.add(frozenset({self.agent_id, peer_id}))
        nB = int(mB.n_kf)
        peer.sent_key_frame_uuids.update(msgs.uuid_key(u) for u in metaB.kf_uuid[:nB])
        peer.sent_map_point_uuids.update(msgs.uuid_key(u) for u in metaB.pt_uuid[:int(mB.n_pt)])
        n = int(merged.n_kf)
        self.transport.publish(
            self.agent_id, None, msgs.CH_SUCCESSFULLY_MERGED,
            msgs.SuccessfullyMerged(
                sender_agent_id=self.agent_id, receiver_agent_id=peer_id,
                successfully_merged=True,
                merged_key_frame_uuids=[msgs.uuid_key(u) for u in metaB.kf_uuid[:nB]],
                all_key_frames_in_map=[msgs.uuid_key(u) for u in meta.kf_uuid[:n]]))
        self.log.append(("merged", peer_id))
        # the merge path's latency without the asynchronous global BA
        self.log.append(("merge_latency_s", round(time.perf_counter() - t_merge0, 4)))

    def _run_pose_graph(self, m, anchor_kf: int, poses_pre):
        """Sim3 essential-graph optimization over the merged map
        (`Optimizer::OptimizeEssentialGraph`). The edge measurements come
        from `poses_pre`, the splice-time poses; keyframes the welding BA
        moved are held fixed, so the optimization spreads their correction
        through the rest of the graph."""
        covis = map_state.covisibility(m)
        valid = m.kf_valid.cpu().numpy()
        parent = pose_graph.compute_spanning_tree(covis, valid)
        ei, ej = pose_graph.build_essential_edges(covis, valid, min_weight=50,
                                                  spanning_parent=parent)
        if len(ei) == 0:
            return m
        ei_t = torch.as_tensor(ei, device=self.device).to(torch.int64)
        ej_t = torch.as_tensor(ej, device=self.device).to(torch.int64)
        poses = lie.sim3_from_se3(m.kf_pose)
        meas_src = lie.sim3_from_se3(poses_pre)
        meas = lie.sim3_mul(meas_src[ei_t], lie.sim3_inv(meas_src[ej_t]))
        fixed = torch.any(m.kf_pose != poses_pre, dim=1)   # the window the welding BA moved
        fixed[0] = True
        fixed[anchor_kf] = True
        fixed = fixed | ~m.kf_valid
        if bool(torch.all(fixed)):
            return m  # nothing free to take the correction
        new_poses, _ = pose_graph.optimize_pose_graph(
            poses, fixed, ei_t, ej_t, meas, torch.ones((len(ei),), dtype=torch.bool,
                                                       device=self.device), iters=12)
        pts = pose_graph.correct_points(m.pt_pos, m.pt_ref_kf, m.pt_valid, poses, new_poses)
        return m._replace(
            kf_pose=torch.where(m.kf_valid[:, None], pose_graph.se3_from_sim3_poses(new_poses),
                                m.kf_pose),
            pt_pos=pts)

    # ------------------------------------------------------------------
    # the asynchronous post-merge global BA (`LoopClosing.cc:1796-1799`:
    # a detached GBA thread with the mbStopGBA abort). The device stream
    # plays the thread: the host dispatches the full-map solve and goes on;
    # the poll folds the result into the live, possibly grown, map, and any
    # rebase, splice or newer merge aborts it.
    # ------------------------------------------------------------------

    def _dispatch_gba(self, merged, weld_kf: int):
        fc = self.config.frontend
        res, _ = local_mapping.global_ba(merged, self.tracker.K, iters=8,
                                         n_levels=fc.n_levels, scale_factor=fc.scale_factor)
        self._pending_gba = {
            "res_pose": res.kf_pose, "res_pt": res.pt_pos,
            "n_kf": int(merged.n_kf), "n_pt": int(merged.n_pt),
            "anchor": int(weld_kf), "t0": time.perf_counter(),
            "event": _record_event(self.device),
        }

    def _gba_ready(self):
        ev = self._pending_gba.get("event")
        return ev is None or ev.query()

    def _poll_gba(self, block: bool = False):
        if self._pending_gba is None:
            return
        if not block and not self._gba_ready():
            return
        pg, self._pending_gba = self._pending_gba, None
        # map surgery: leave the autonomous lane first (auto_mode re-enters)
        self.tracker.exit_autonomous()
        self.tracker.flush_meta()
        if int(self.map.n_kf) < pg["n_kf"]:
            # the live map shrank (an atlas stash swapped in a fresh map)
            self.log.append(("gba_aborted", "map_replaced"))
            return
        # the tracker continuation moves with the map: the anchor correction
        # T' = T T_anchor_live^-1 T_anchor_gba composed into last_pose (the
        # velocity is a relative delta, unchanged by it)
        a = pg["anchor"]
        corr = lie.se3_mul(lie.se3_inv(self.map.kf_pose[a]), pg["res_pose"][a])
        self.tracker.map = local_mapping.apply_gba_correction(
            self.map, pg["res_pose"], pg["res_pt"], pg["n_kf"], pg["n_pt"], a)
        self.tracker.last_pose = lie.se3_mul(self.tracker.last_pose, corr)
        self.log.append(("gba_applied", round(time.perf_counter() - pg["t0"], 4)))

    def flush_gba(self):
        """Block until any in-flight global BA is folded in."""
        self._poll_gba(block=True)

    def _abort_gba(self, reason: str):
        """`mbStopGBA`: a newer merge, rebase or splice supersedes the
        in-flight solve; its result is dropped."""
        if self._pending_gba is not None:
            self._pending_gba = None
            self.log.append(("gba_aborted", reason))

    def _rebase(self, S):
        """Re-base the map, the tracker continuation and the trajectory by a
        world-level Sim3 S (a tensor on the device)."""
        self.tracker.exit_autonomous()
        self.tracker.map = merge_mod.transform_map(self.map, S)
        self.tracker.last_pose = lie.sim3_fold(
            lie.sim3_mul(lie.sim3_from_se3(self.tracker.last_pose), lie.sim3_inv(S)))
        self.tracker.rebase_history(S)

    def _apply_frame_change(self, parent_agent_id: int, S):
        """Re-base into a peer's frame and re-parent the frame tree
        (`receiveChangeCoordinateFrame`, `:951-999`)."""
        self._abort_gba("frame_change")
        self._rebase(S)
        S_np = S.cpu().numpy()
        self.frames.set_parent_frame(parent_agent_id, S_np)
        # inform the already-merged group (sendChangeCoordinateFrame, :920-948)
        for p in self.peers:
            if p.successfully_merged and p.agent_id != parent_agent_id:
                self.transport.publish(
                    self.agent_id, p.agent_id, msgs.CH_CHANGE_COORDINATE_FRAME,
                    msgs.ChangeCoordinateFrame(self.agent_id, parent_agent_id,
                                               msgs.Sim3Transform.from_sim3(S_np)))

    def _receive_change_coordinate_frame(self, m):
        S = torch.as_tensor(m.transform.as_sim3(), dtype=torch.float32, device=self.device)
        self._apply_frame_change(m.parent_agent_id, S)
        # the implicit merge with the new parent's group (announced, :974-997)
        if m.parent_agent_id in self.peers.peers:
            p = self.peers[m.parent_agent_id]
            if not p.successfully_merged:
                p.successfully_merged = True
                self.transport.publish(
                    self.agent_id, None, msgs.CH_SUCCESSFULLY_MERGED,
                    msgs.SuccessfullyMerged(sender_agent_id=self.agent_id,
                                            receiver_agent_id=m.parent_agent_id,
                                            successfully_merged=True, implicit_merge=True))

    def _receive_successfully_merged(self, m):
        if m.sender_agent_id == self.agent_id:
            return
        if m.successfully_merged:
            self._peer_merges.add(frozenset({m.sender_agent_id, m.receiver_agent_id}))
        if m.sender_agent_id in self.peers.peers:
            sender = self.peers[m.sender_agent_id]
            if m.receiver_agent_id == self.agent_id and m.successfully_merged:
                # the peer merged our map into theirs; its announced keyframe
                # set seeds our dedup (:663-682)
                sender.successfully_merged = True
                sender.remote_successfully_merged = True
                mine = {msgs.uuid_key(u) for u in self.meta.kf_uuid[:int(self.map.n_kf)]}
                sender.sent_key_frame_uuids.update(
                    u for u in (tuple(x) for x in m.all_key_frames_in_map) if u in mine)
        self._transitive_merge_closure()

    def _transitive_merge_closure(self):
        """Implicit transitive merges (`orb_slam3_wrapper.cpp:684-707`): a
        peer joined to my merged group through announced merges is merged
        with me too; runs to a fixpoint."""
        changed = True
        while changed:
            changed = False
            merged = {self.agent_id} | {p.agent_id for p in self.peers if p.successfully_merged}
            for p in self.peers:
                if p.successfully_merged:
                    continue
                if any(frozenset({p.agent_id, q}) in self._peer_merges for q in merged):
                    p.successfully_merged = True
                    changed = True
                    self._peer_merges.add(frozenset({self.agent_id, p.agent_id}))
                    self.log.append(("implicit_merge", p.agent_id))
                    self.transport.publish(
                        self.agent_id, None, msgs.CH_SUCCESSFULLY_MERGED,
                        msgs.SuccessfullyMerged(sender_agent_id=self.agent_id,
                                                receiver_agent_id=p.agent_id,
                                                successfully_merged=True, implicit_merge=True))

    def _receive_new_key_frames(self, m):
        """External keyframes (`:386-455` + `LocalMapping.cc:302-354`): a
        uuid-relinked splice, duplicate fusion, one local BA after the
        batch."""
        # the splice and its BA move snapshot-slot poses: an in-flight GBA
        # computed before would overwrite them with stale geometry
        self._abort_gba("kf_splice")
        self.tracker.exit_autonomous()
        self.tracker.flush_meta()
        packet = codec.MapPacket.from_bytes(m.serialized_map)
        if packet.n_kf == 0:
            return
        mB, metaB = codec.materialize(packet, self.config.frontend.capacity, device=self.device)
        merged, meta, kf_map, _ = merge_mod.merge_maps(
            self.map, self.meta, mB, metaB, lie.sim3_identity(device=self.device))
        fc = self.config.frontend
        # weld around the newest external keyframe
        new_slots = [int(kf_map[j]) for j in range(packet.n_kf) if kf_map[j] >= 0]
        if new_slots:
            c = torch.tensor(new_slots[-1], dtype=torch.int32, device=self.device)
            merged = local_mapping.fuse_duplicates(merged, c, self.tracker.K, n_neighbors=5,
                                                   n_levels=fc.n_levels,
                                                   scale_factor=fc.scale_factor)
            merged, _ = local_mapping.local_ba(
                merged, c, self.tracker.K, n_local=12, n_fixed=8, n_pts=2048, iters=4,
                n_levels=fc.n_levels, scale_factor=fc.scale_factor, use_kernel=fc.use_kernel)
            merged = map_state.update_point_stats(merged, fc.n_levels, fc.scale_factor)
        self.tracker.map = merged
        self.tracker.meta = meta
        self.tracker.n_kf_host = int(merged.n_kf)
        self.tracker.map_epoch += 1  # the slot layout changed: refresh the mirrors
        if m.sender_agent_id in self.peers.peers:
            self.peers[m.sender_agent_id].sent_key_frame_uuids.update(
                msgs.uuid_key(u) for u in packet.kf_uuid)

    # ------------------------------------------------------------------
    # services
    # ------------------------------------------------------------------

    def _srv_get_current_map(self, caller, req):
        """`handleGetCurrentMapRequest` (`:150-172`): the map pruned to own
        keyframes."""
        self.tracker.drain_auto()
        self.tracker.flush_meta()
        return msgs.GetCurrentMapResponse(self.agent_id, self._submap_bytes(self._own_kf_slots()),
                                          req.merge_candidate_key_frame_uuids)

    def _srv_get_map_points(self, caller, req):
        self.tracker.drain_auto()
        self.tracker.flush_meta()
        n = int(self.map.n_pt)
        valid = self.map.pt_valid[:n].cpu().numpy()
        return msgs.GetMapPointsResponse(uuids=self.meta.pt_uuid[:n][valid],
                                         positions=self.map.pt_pos[:n].cpu().numpy()[valid])

    # ------------------------------------------------------------------
    # scale alignment (`updateMapScale`, `:766-833`)
    # ------------------------------------------------------------------

    def _update_map_scale(self, ts):
        self._next_scale_ts = ts + self._scale_interval
        target = self.peers.lowest_merged_peer()
        if target is None or target > self.agent_id:
            return  # align to lower-id (lead-side) peers only
        resp = self.transport.call(self.agent_id, target, msgs.SRV_GET_MAP_POINTS,
                                   msgs.GetMapPointsRequest(self.agent_id))
        if resp is None or len(resp.uuids) == 0:
            return
        # real alignment work ahead: only now settle the pipeline
        self.tracker.drain_auto()
        self.tracker.flush_meta()
        n = int(self.map.n_pt)
        mine_valid = self.map.pt_valid[:n].cpu().numpy()
        lut = {msgs.uuid_key(u): i for i, u in enumerate(self.meta.pt_uuid[:n]) if mine_valid[i]}
        src_idx, dst_pos = [], []
        for u, p in zip(resp.uuids, resp.positions):
            i = lut.get(msgs.uuid_key(u))
            if i is not None:
                src_idx.append(i)
                dst_pos.append(p)
        if len(src_idx) < MIN_MAP_POINTS_FOR_SCALE_ADJUSTMENT:
            return
        src = self.map.pt_pos[torch.as_tensor(src_idx, device=self.device)]
        dst = torch.as_tensor(np.asarray(dst_pos, np.float32), device=self.device)
        S, _, _ = alignment.ransac_umeyama(
            self._align_noise(len(src_idx)), src, dst,
            torch.ones((len(src_idx),), dtype=torch.bool, device=self.device))
        s = float(S[7])
        # re-base the whole map: the in-flight GBA's snapshot is in the old frame
        self._abort_gba("scale_realign")
        self._rebase(S)
        # AIMD backoff around |s - 1| < 0.01 (`:804-812`)
        if abs(s - 1.0) < 0.01:
            self._scale_interval = min(self._scale_interval * 2.0, 160.0)
        else:
            self._scale_interval = SCALE_ALIGN_BASE_INTERVAL
        self._next_scale_ts = ts + self._scale_interval
        self.log.append(("scale_aligned", target, s))
