"""Per-frame monocular tracking: project the map, two Hamming searches by
projection, pose-only Gauss-Newton after each; then the keyframe decision
and, for a new keyframe, the mapper chain with windowed BA.

Port of `dvm_slam_tpu/tracking/tracker.py`: the device step
(`project_points`, `track_frame`, `make_and_track`, `update_visibility`,
`create_points_from_depth`, `autonomous_step`, `autonomous_step_batch`) and
the host state machine `MonocularTracker` for every sensor (a monocular
pinhole or KB8 fisheye camera, a rectified stereo pair, an RGB-D camera,
each with or without an IMU): two-view or single-frame depth
initialization, motion-model or IMU-predicted tracking with the stereo
residual rows, the pose-inertial refinement, the keyframe decision, the
pipelined lanes (visual and visual-inertial), the autonomous lane,
relocalization and the multi-map atlas. Two helpers come from the
reference's host code: `bootstrap_from_depth` (the map seeding of
`_try_initialize_depth`) and `motion_model_step` (the pose chain of
`autonomous_step`). `autonomous_step_batch` returns the reference's packed
[B,10] outcome rows; the reference's separate packed single step is that
call with B = 1.

As in the reference, both stages project against the full point table;
frustum, distance-range and viewing-angle gates (`Frame::isInFrustum`) cut
it to the candidate set.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..frontend.extractor import (Frame, FrontendConfig, make_frame, make_frame_rgbd,
                                  make_frame_stereo)
from ..geometry import cameras, imu, lie, two_view
from ..mapping import local_mapping, map_state
from ..ops import matching
from ..utils import profiling
from . import pose_opt


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """The reference's tracker settings, field for field (so configs cross
    between the packages); `frontend.use_kernel` also picks the BA kernels
    (K2, K3) of the mapper chain that `autonomous_step` runs."""

    frontend: FrontendConfig
    kf_cap: int = 512
    pt_cap: int = 8192
    fps: float = 20.0
    min_init_matches: int = 100
    min_track_inliers: int = 15   # lost below this
    kf_ref_ratio: float = 0.9
    kf_min_inliers: int = 15
    camera_model: str = "pinhole"  # "pinhole" | "kb8" (rectified keypoints)
    sensor: str = "monocular"      # "monocular" | "stereo" | "rgbd"
    baseline: float = 0.0          # stereo baseline / RGB-D virtual baseline, m
    th_depth_ratio: float = 40.0   # close-point depth = ratio * baseline
    min_init_stereo_points: int = 200

    @property
    def max_frames_between_kf(self):
        return int(self.fps)

    @property
    def depth_sensor(self):
        return self.sensor in ("stereo", "rgbd")

    @property
    def th_depth(self):
        return self.th_depth_ratio * self.baseline


class TrackResult(NamedTuple):
    T_cw: torch.Tensor       # [7] refined pose
    obs: torch.Tensor        # [F] int32 point slot per frame feature (-1 none)
    n_inliers: torch.Tensor  # [] int32
    n_stage1: torch.Tensor   # [] int32
    visible: torch.Tensor    # [P] bool points projected into the frustum
    found: torch.Tensor      # [P] bool points matched as inliers


@functools.lru_cache(maxsize=32)
def _const(values: tuple, device: torch.device):
    """A small f32 constant on `device`, uploaded once (a fresh upload per
    frame would make the host wait for the device)."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def project_points(m: map_state.MapState, T_cw, K, config: TrackerConfig):
    """Frustum + scale-range + viewing-angle gating of all map points
    (`Frame::isInFrustum`). Returns (uv [P,2], vis [P] bool, level [P] i32,
    view_cos [P])."""
    fc = config.frontend
    pc = lie.se3_apply(T_cw[None], m.pt_pos)
    uv, front = cameras.pinhole_project(K, pc)
    in_img = (uv[:, 0] >= 0) & (uv[:, 0] < fc.width) & (uv[:, 1] >= 0) & (uv[:, 1] < fc.height)
    center = lie.se3_t(lie.se3_inv(T_cw))
    rel = m.pt_pos - center[None, :]
    dist = torch.linalg.norm(rel, dim=-1)
    in_range = (dist >= 0.8 * m.pt_min_dist) & (dist <= 1.2 * m.pt_max_dist)
    view_cos = torch.sum(rel * m.pt_normal, dim=-1) / torch.clamp(dist, min=1e-9)
    level = map_state.predict_scale(dist, m.pt_max_dist, fc.n_levels, fc.scale_factor)
    vis = m.pt_valid & front & in_img & in_range & (view_cos > 0.5)
    return uv, vis, level, view_cos


def _match_and_assign(m, uv, vis, level, radii, frame: Frame, max_dist, ratio):
    """Match projected points (rows) to frame features, dedupe to 1-1.
    Returns per-point (feat_idx, ok)."""
    idx, _, ok = matching.search_by_projection(
        uv, vis, m.pt_desc, level,
        frame.xy, frame.desc, frame.level, frame.valid,
        radii, max_dist=max_dist, ratio=ratio,
    )
    ok = matching.dedupe_matches(idx, ok, frame.capacity)
    return torch.where(ok, idx, -1), ok


@profiling.traced("tracking.track_frame")
def track_frame(m: map_state.MapState, frame: Frame, T_pred, K, config: TrackerConfig):
    """Two-stage match + pose-only BA, with the stereo rows when the frame
    carries a right-u channel and the config a baseline. Returns
    TrackResult.

    The reference's `lax.cond` retry (too few stage-1 matches -> a 4x wider
    window) is a Python `if` here: one host sync per frame."""
    fc = config.frontend
    dev = m.pt_pos.device
    scales = _const(fc.scales, dev)
    sigma2 = _const(fc.sigma2, dev)
    level_of = lambda f: frame.level[f].to(torch.int64)  # noqa: E731

    # ---- stage 1: wide search at the predicted pose (TrackWithMotionModel)
    with profiling.span("tracking.match"):
        uv, vis, level, _ = project_points(m, T_pred, K, config)
        radii1 = 15.0 * scales[level.to(torch.int64)]
        feat1, ok1 = _match_and_assign(m, uv, vis, level, radii1, frame, matching.TH_HIGH, 0.9)
        if int(torch.sum(ok1)) < 20:
            feat1, ok1 = _match_and_assign(m, uv, vis, level, radii1 * 4.0, frame,
                                           matching.TH_HIGH, 0.9)
    bf = K[0] * config.baseline if frame.ur is not None and config.baseline > 0.0 else None
    f1 = torch.clamp(feat1, min=0)
    ur1 = None if bf is None else torch.where(ok1, frame.ur[f1], -1.0)
    T1, inl1, _ = pose_opt.pose_optimization(
        T_pred, m.pt_pos, frame.xy[f1], sigma2[level_of(f1)], ok1, K, ur=ur1, bf=bf)
    n1 = torch.sum(inl1, dtype=torch.int32)

    # ---- stage 2: tight search at the refined pose (TrackLocalMap)
    with profiling.span("tracking.match"):
        uv2, vis2, level2, view_cos2 = project_points(m, T1, K, config)
        base_r = torch.where(view_cos2 > 0.998, 2.5, 4.0)
        radii2 = base_r * scales[level2.to(torch.int64)]
        feat2, ok2 = _match_and_assign(m, uv2, vis2, level2, radii2, frame, matching.TH_HIGH,
                                       0.8)
        # keep stage-1 inlier associations where stage 2 found nothing
        feat = torch.where(ok2, feat2, torch.where(inl1, feat1, -1))
        okc = matching.dedupe_matches(feat, feat >= 0, frame.capacity)
    fc2 = torch.clamp(feat, min=0)
    ur2 = None if bf is None else torch.where(okc, frame.ur[fc2], -1.0)
    T2, inl2, _ = pose_opt.pose_optimization(
        T1, m.pt_pos, frame.xy[fc2], sigma2[level_of(fc2)], okc, K, ur=ur2, bf=bf)
    n2 = torch.sum(inl2, dtype=torch.int32)

    # invert point->feature into feature->point; dropped points all land in
    # the sentinel slot F, which is sliced off
    P = m.pt_capacity
    fsel = torch.where(inl2, fc2, frame.capacity)
    obs = torch.full((frame.capacity + 1,), -1, dtype=torch.int32, device=dev)
    obs.scatter_(0, fsel, torch.arange(P, dtype=torch.int32, device=dev))
    return TrackResult(T_cw=T2, obs=obs[:frame.capacity], n_inliers=n2, n_stage1=n1,
                       visible=vis2, found=inl2)


def create_points_from_depth(m: map_state.MapState, slot, frame: Frame, K,
                             th_depth, n_levels: int = 8,
                             scale_factor: float = 1.2):
    """Unproject frame features with known depth and no map association into
    new map points observed by keyframe `slot` (`Tracking::
    StereoInitialization` point creation). Returns (map, n_created)."""
    dev = m.pt_pos.device
    slot = torch.as_tensor(slot, dtype=torch.int64, device=dev)
    T_wc = lie.se3_inv(m.kf_pose[slot])
    z = frame.depth
    cand = frame.valid & (z > 0.0) & (z <= th_depth) & (m.kf_obs[slot] < 0)
    xn = cameras.pinhole_unproject(K, frame.xy)                  # [F,3] z=1
    Xw = lie.se3_apply(T_wc[None], xn * z[:, None])
    n = frame.capacity
    m, slots = map_state.add_points(
        m,
        pos=Xw,
        desc=frame.desc,
        normal=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        min_dist=torch.zeros((n,), dtype=torch.float32, device=dev),
        max_dist=torch.full((n,), 1e9, dtype=torch.float32, device=dev),
        ref_kf=slot,
        valid=cand,
    )
    obs_new = torch.where(slots >= 0, slots, m.kf_obs[slot])
    kf_obs = m.kf_obs.clone()
    kf_obs[slot] = obs_new
    m = map_state.update_point_stats(m._replace(kf_obs=kf_obs), n_levels, scale_factor)
    return m, torch.sum(slots >= 0, dtype=torch.int32)


def bootstrap_from_depth(m: map_state.MapState, frame: Frame, K, config: TrackerConfig):
    """Seed an empty map at true scale from one RGB-D frame: keyframe 0 at
    identity plus one point per keypoint with depth (the map seeding of the
    reference's `MonocularTracker._try_initialize_depth`). Returns (map,
    n_created)."""
    dev = m.pt_pos.device
    m, slot = map_state.add_keyframe(
        m, lie.se3_identity(device=dev), frame.xy, frame.level, frame.angle, frame.desc,
        frame.valid, torch.full((frame.capacity,), -1, dtype=torch.int32, device=dev),
        ur=frame.ur,
    )
    fc = config.frontend
    return create_points_from_depth(m, slot, frame, K, 1e9, fc.n_levels, fc.scale_factor)


def make_and_track(img, m: map_state.MapState, T_pred, K, dist, config: TrackerConfig):
    """The per-frame step: ORB extraction + two-stage tracking. Returns
    (frame, result, pt_visible, pt_found), the visibility counters advanced
    only on a good track (>= min_track_inliers)."""
    frame = make_frame(img, K, dist, config.frontend, camera_model=config.camera_model)
    res = track_frame(m, frame, T_pred, K, config)
    good = res.n_inliers >= config.min_track_inliers
    pt_visible = m.pt_visible + (res.visible & good).to(torch.int32)
    pt_found = m.pt_found + (res.found & good).to(torch.int32)
    return frame, res, pt_visible, pt_found


def motion_model_step(T_last, res: TrackResult, config: TrackerConfig):
    """The constant-velocity pose chain of the reference's
    `autonomous_step`: on a good track keep the refined pose and the
    velocity T_new * T_last^-1, otherwise hold the last pose and reset the
    velocity to identity. Returns (T_cw, velocity); the next prediction is
    `lie.se3_mul(velocity, T_cw)`."""
    good = res.n_inliers >= config.min_track_inliers
    T2 = torch.where(good, res.T_cw, T_last)
    vel = torch.where(good, lie.se3_mul(res.T_cw, lie.se3_inv(T_last)),
                      lie.se3_identity(device=T_last.device))
    return T2, vel


class AutoState(NamedTuple):
    """Tracker continuation for `autonomous_step`, all device tensors."""

    T_cw: torch.Tensor            # [7] last pose
    velocity: torch.Tensor        # [7] motion model
    frames_since_kf: torch.Tensor  # [] int32
    ref_tracked: torch.Tensor     # [] int32 inliers at the last keyframe
    kf_count: torch.Tensor        # [] int32 keyframes created


class AutoFlags(NamedTuple):
    """Per-frame outcome flags."""

    n_inliers: torch.Tensor  # [] int32
    made_kf: torch.Tensor    # [] bool
    good: torch.Tensor       # [] bool


def autonomous_step(img, m: map_state.MapState, st: AutoState, K, dist,
                    config: TrackerConfig, mapper_cfg: tuple):
    """One SLAM frame: extract + track + visibility + keyframe decision +
    (for a new keyframe) keyframe insertion and the whole mapper chain.

    mapper_cfg: (n_neighbors, n_levels, scale_factor, ba_local, ba_fixed,
    ba_pts, ba_iters, run_ba_every), as in the reference. With a depth
    sensor the keyframe ratio is 0.75, the keyframe keeps the frame's right
    u and the chain's BA takes the stereo rows. Returns (map, state,
    AutoFlags)."""
    (n_neighbors, n_levels, scale_factor,
     ba_local, ba_fixed, ba_pts, ba_iters, run_ba_every) = mapper_cfg
    frame = make_frame(img, K, dist, config.frontend, camera_model=config.camera_model)
    res = track_frame(m, frame, lie.se3_mul(st.velocity, st.T_cw), K, config)
    good = res.n_inliers >= config.min_track_inliers
    T2, vel2 = motion_model_step(st.T_cw, res, config)
    m = m._replace(
        pt_visible=m.pt_visible + (res.visible & good).to(torch.int32),
        pt_found=m.pt_found + (res.found & good).to(torch.int32),
    )
    fsk = torch.where(good, st.frames_since_kf + 1, st.frames_since_kf)

    # the keyframe decision, in f32 as the reference computes it
    ratio = 0.75 if config.depth_sensor else config.kf_ref_ratio
    thr = torch.clamp(ratio * st.ref_tracked.to(torch.float32), min=1.0)
    need_kf = (
        good
        & ((fsk >= config.max_frames_between_kf) | (res.n_inliers < thr.to(torch.int32)))
        & (res.n_inliers > config.kf_min_inliers)
        & (m.n_kf < config.kf_cap - 1)
    )
    # the reference's lax.cond is a Python `if`: one host sync per frame
    if bool(need_kf):
        m, slot = map_state.add_keyframe(m, res.T_cw, frame.xy, frame.level, frame.angle,
                                         frame.desc, frame.valid, res.obs,
                                         ur=frame.ur if config.depth_sensor else None)
        run_ba = run_ba_every == 1 or (int(st.kf_count) + 1) % run_ba_every == 0
        m = local_mapping._mapper_chain(
            m, slot, K, n_neighbors=n_neighbors, n_levels=n_levels,
            scale_factor=scale_factor, run_ba_traced=run_ba, ba_local=ba_local,
            ba_fixed=ba_fixed, ba_pts=ba_pts, ba_iters=ba_iters,
            bf=K[0] * config.baseline if config.depth_sensor else None,
            use_kernel=config.frontend.use_kernel)
    st2 = AutoState(
        T_cw=T2, velocity=vel2,
        frames_since_kf=torch.where(need_kf, 0, fsk).to(torch.int32),
        ref_tracked=torch.where(need_kf, res.n_inliers, st.ref_tracked).to(torch.int32),
        kf_count=st.kf_count + need_kf.to(torch.int32),
    )
    return m, st2, AutoFlags(n_inliers=res.n_inliers, made_kf=need_kf, good=good)


def autonomous_step_batch(imgs, m: map_state.MapState, st: AutoState, K, dist,
                          config: TrackerConfig, mapper_cfg: tuple, frames=None):
    """`autonomous_step` over the frames `imgs` [B,H,W] in turn (the
    reference's `lax.scan`), each step the span `lane.step` of its number
    in `frames`. Returns (map, state, outcomes [B,10] f32: pose 7 | made_kf
    | good | n_inliers), the reference's layout."""
    rows = []
    for i, img in enumerate(imgs):
        with profiling.span("lane.step", None if frames is None else frames[i]):
            m, st, fl = autonomous_step(img, m, st, K, dist, config, mapper_cfg)
            rows.append(torch.cat([st.T_cw, torch.stack([fl.made_kf.to(torch.float32),
                                                         fl.good.to(torch.float32),
                                                         fl.n_inliers.to(torch.float32)])]))
    return m, st, torch.stack(rows)


def update_visibility(m: map_state.MapState, visible, found):
    """`MapPoint::IncreaseVisible/IncreaseFound` counters for culling."""
    return m._replace(
        pt_visible=m.pt_visible + visible.to(torch.int32),
        pt_found=m.pt_found + found.to(torch.int32),
    )


# --------------------------------------------------------------------------
# host-side tracker (the "Tracking thread")
# --------------------------------------------------------------------------

NOT_INITIALIZED = "NOT_INITIALIZED"
OK = "OK"
RECENTLY_LOST = "RECENTLY_LOST"
LOST = "LOST"

RANSAC_ITERS = 200


class _HostCopy:
    """A device tensor on its way to the host: on the card a non-blocking
    copy into pinned memory and a CUDA event behind it; on the CPU the
    tensor itself, always ready."""

    def __init__(self, t):
        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def numpy(self):
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class MonocularTracker:
    """Host state machine around the tracking step (`Tracking::Track`):
    monocular two-view initialization (a stereo or RGB-D frame initializes
    alone, `Tracking::StereoInitialization`), motion-model prediction, lost
    handling and the keyframe decision, with two overlapped lanes: the
    pipelined lane (decisions `async_depth` frames behind the dispatch) and
    the autonomous lane (`autonomous_step`, keyframes and mapping inside the
    step, bookkeeping retired from outcome rows). Stereo and RGB-D frames
    come through `process_stereo_pair` / `process_rgbd` and take the host or
    the pipelined lane, as in the reference.

    `config.sensor` is monocular, stereo or rgbd (a pinhole or a KB8
    camera); `inertial=True` adds an IMU (`grab_imu` before each frame,
    `imu_calib` its noise, `T_cb` the camera-from-body extrinsic): the
    keyframe chain carries preintegrations, velocities and biases, the
    mapper initializes the IMU, and frames after it are predicted by dead
    reckoning and refined by `pose_inertial_optimization`. Inertial frames
    take the host lane or, with `async_depth` > 0, the pipelined VI lane,
    never the autonomous or the visual pipelined lane; that lane runs the
    pose-inertial refinement only on the weak frames whose result it takes
    (the reference runs it on every frame and selects on the device). Every
    tensor lives on `device`; the velocity and bias mirrors are host numpy.
    The two RANSAC
    samplers draw from a `torch.Generator` on the CPU seeded with `rng_seed`
    (`_ransac_noise`), so the card and the CPU see the same draws; keyframe
    and point uuids come from a numpy generator with the same seed.
    Relocalization (`relocalizer`, a `RelocalizationService`) and the
    multi-map atlas (`atlas`, a `mapping.atlas.Atlas`) stay None unless the
    caller sets them, as `System` does when given a vocabulary.

    Two repairs beyond the reference, both in the pipelined retire. It
    stashes the map in the atlas on persistent LOST, as `_track_resolve`
    does: the reference's visual pipelined retire lacks it, so its
    `System`, whose lost frames after the autonomous hand-back all take the
    pipelined lane, never starts a new map. And a keyframe made there leaves
    the prediction chain's head where it was: the reference's mapper sets
    it to the keyframe's pose, async_depth frames back, and its stereo and
    RGB-D `System`, whose frames all take this lane, loses track at the
    first keyframe after the initial one."""

    def __init__(self, config: TrackerConfig, K, dist, local_mapper=None, rng_seed=0,
                 relocalizer=None, inertial=False, imu_calib=None, T_cb=None,
                 device="cuda"):
        self.device = torch.device(device)
        self.config = config
        self.K = torch.as_tensor(np.asarray(K, np.float32), device=self.device)
        self.fx = float(np.asarray(K, np.float32)[0])   # for bf = fx * baseline, without a sync
        self.dist = torch.as_tensor(np.asarray(dist, np.float32), device=self.device)
        # ---- visual-inertial state (Tracking.cc's IMU members)
        self.inertial = inertial
        self.imu_calib = imu_calib
        self.T_cb = (lie.se3_identity(device=self.device) if T_cb is None
                     else torch.as_tensor(np.asarray(T_cb, np.float32), device=self.device))
        self.imu_initialized = False
        self.vel_w = np.zeros(3, np.float32)    # body velocity (world)
        self.bias_g = np.zeros(3, np.float32)
        self.bias_a = np.zeros(3, np.float32)
        self._imu_frame = []   # (acc, gyro, dts) chunks since the last frame
        self._imu_kf = []      # chunks since the last keyframe
        self._imu_seq = 0      # chunks ever grabbed (monotonic)
        self.kf_chain = []     # keyframe slots in creation order
        self.kf_preint = {}    # slot -> Preintegrated from the previous chain keyframe
        self.kf_vel = {}       # slot -> body velocity [3] np
        self.kf_bias = {}      # slot -> (bias_g, bias_a) np at creation
        self._last_good_ts = None
        self.map = map_state.create(config.kf_cap, config.pt_cap, config.frontend.capacity,
                                    device=self.device)
        self.meta = map_state.MapMeta.create(config.kf_cap, config.pt_cap, agent_id=0)
        self.state = NOT_INITIALIZED
        self.velocity = lie.se3_identity(device=self.device)
        self.last_pose = lie.se3_identity(device=self.device)
        self.init_frame = None
        self.frames_since_kf = 0
        self.ref_kf_tracked = 0
        self.last_kf_slot = -1
        self.local_mapper = local_mapper
        self.relocalizer = relocalizer  # callable (map, frame) -> (ok, T, n)
        self.atlas = None               # optional mapping.atlas.Atlas
        self.n_frames = 0
        self._lost_frames = 0
        self.rng = torch.Generator(device="cpu")
        self.rng.manual_seed(rng_seed)
        self.uuid_rng = np.random.default_rng(rng_seed)
        self.trajectory = []     # (timestamp, T_cw [7], state); poses stay on the device
        self.kf_timestamps = {}  # kf slot -> frame timestamp
        self._cur_ts = None
        self._init_ts = None
        self.meta_dirty = False  # new points exist whose uuids are unassigned
        self.n_kf_host = 0       # host mirror of map.n_kf (keyframes are append-only)
        # bumped whenever keyframe slots are rebuilt wholesale (atlas stash,
        # merge-back): host mirrors of per-slot state refresh on a bump
        self.map_epoch = 0
        # pipelined lane (async_depth > 0): state-machine decisions run
        # async_depth frames behind the dispatch
        self.async_depth = 0
        self._pipeline = []      # [(timestamp, frame, res, n_inliers copy)]
        # the pipelined VI lane: velocity and biases ride the device chain
        # like last_pose (None: re-seed from the host mirrors); VI records
        # are (timestamp, frame, res, packed copy, grab counter)
        self._vel_dev = None
        self._bias_g_dev = None
        self._bias_a_dev = None
        self.n_vi_refines = 0    # pose-inertial refinements the VI lane ran
        # bumped by apply_world_sim3: a retire that re-bases the world drops
        # the in-flight records; the composed Sim3 transports the chain head
        self._rebase_gen = 0
        self._pending_rebase_S = None
        # autonomous lane (enter_autonomous): keyframe decision and mapper
        # chain inside the step; outcome rows retire up to async_depth late
        self.autonomous = False
        self._auto_state = None
        self._auto_flags = []    # [(timestamps, outcome rows copy, n frames, frame numbers)]
        # auto_mode: (re)enter the autonomous lane whenever tracking is OK
        self.auto_mode = False
        # auto_batch: frames per autonomous dispatch; a loss inside a batch
        # hands the rest of the buffered frames back to the host path
        self.auto_batch = 1
        self._auto_imgs = []     # buffered (img, ts, frame number) awaiting a full batch
        # a keyframe retired from the autonomous lane while the atlas holds
        # stored maps: drain and try the merge-back
        self._atlas_check_pending = False

    def _ransac_noise(self, n: int):
        """Gumbel noise [iters, n] of the homography and the essential RANSAC
        samplers, drawn on the CPU from `self.rng` and moved to the device."""
        g = two_view.gumbel(self.rng, (2, RANSAC_ITERS, n)).to(self.device)
        return g[0], g[1]

    def _new_uuids(self, n: int):
        return self.meta.new_uuids(n, self.uuid_rng)

    def flush_meta(self):
        """Assign uuids to points the mapper created since the last flush;
        every consumer of `meta` calls it first."""
        if not self.meta_dirty:
            return
        npts = int(self.map.n_pt)
        fresh = self.meta.pt_uuid[:npts].sum(axis=1) == 0
        nf = int(fresh.sum())
        if nf:
            self.meta.pt_uuid[:npts][fresh] = self._new_uuids(nf)
            self.meta.pt_creator[:npts][fresh] = self.meta.agent_id
        self.meta_dirty = False

    # -- public API ---------------------------------------------------------

    def process_image(self, img, timestamp: float):
        """`System::TrackMonocular`: grayscale [H,W] (uint8 or float32,
        0..255) in, world->camera pose [7] out (None until initialized or
        when lost). The image is uploaded in the caller's dtype."""
        img = torch.as_tensor(img).to(self.device)
        if self.state == NOT_INITIALIZED:
            frame = make_frame(img, self.K, self.dist, self.config.frontend,
                               camera_model=self.config.camera_model)
            return self.process_frame(frame, timestamp)
        self.n_frames += 1
        self._cur_ts = timestamp
        if self.auto_mode and not self.autonomous and self.state == OK:
            self.enter_autonomous()
        if self.autonomous:
            return self._process_autonomous(img, timestamp)
        if (self.state in (RECENTLY_LOST, LOST) and self.relocalizer is not None
                and not (self.inertial and self.imu_initialized)):
            # relocalize first: the motion model is stale after a loss (an
            # initialized IMU dead-reckons instead). The frame is extracted
            # once; on failure it is tracked as it is
            frame = make_frame(img, self.K, self.dist, self.config.frontend,
                               camera_model=self.config.camera_model)
            pose = self._try_relocalize(frame, timestamp)
            if pose is None:
                T_pred, v_pred = self._predict_pose()
                res = track_frame(self.map, frame, T_pred, self.K, self.config)
                if self.async_depth > 0 and not self.inertial:
                    pose = self._pipeline_push(frame, timestamp, res)
                else:
                    pose = self._track_resolve(frame, timestamp, T_pred, v_pred, res)
            if pose is not None:
                self.trajectory.append((timestamp, pose, self.state))
            return pose
        if self._vi_pipeline_active(timestamp):
            # the IMU-predicted pose is part of the device chain: extraction
            # is a call of its own here
            frame = make_frame(img, self.K, self.dist, self.config.frontend,
                               camera_model=self.config.camera_model)
            pose = self._track_pipelined_vi(frame, timestamp)
            if pose is not None:
                self.trajectory.append((timestamp, pose, self.state))
            return pose
        T_pred, v_pred = self._predict_pose()
        frame, res, pv, pf = make_and_track(img, self.map, T_pred, self.K, self.dist,
                                            self.config)
        if self.async_depth > 0 and not self.inertial:
            # the pipelined retire applies incremental visibility updates
            pose = self._pipeline_push(frame, timestamp, res)
        else:
            pose = self._track_resolve(frame, timestamp, T_pred, v_pred, res, vis=(pv, pf))
        if pose is not None:
            self.trajectory.append((timestamp, pose, self.state))
        return pose

    def process_frame(self, frame: Frame, timestamp: float):
        self.n_frames += 1
        self._cur_ts = timestamp
        if self.state == NOT_INITIALIZED:
            if self.config.depth_sensor and frame.depth is not None:
                pose = self._try_initialize_depth(frame)
            else:
                pose = self._try_initialize(frame)
        elif self.async_depth > 0 and not self.inertial:
            pose = self._track_pipelined(frame, timestamp)
        elif self._vi_pipeline_active(timestamp):
            pose = self._track_pipelined_vi(frame, timestamp)
        else:
            pose = self._track(frame, timestamp)
        if pose is not None:
            # kept on the device; the savers materialize the trajectory
            self.trajectory.append((timestamp, pose, self.state))
        return pose

    def process_stereo_pair(self, img_l, img_r, timestamp: float):
        """`System::TrackStereo`: a rectified grayscale pair in, the pose
        out."""
        frame = make_frame_stereo(self._upload(img_l), self._upload(img_r), self.K, self.dist,
                                  self.config.frontend, self.config.baseline)
        return self.process_frame(frame, timestamp)

    def process_rgbd(self, img, depth_map, timestamp: float):
        """`System::TrackRGBD`: grayscale and the registered depth in meters
        (scale the sensor's units first, as `System.track_rgbd` does)."""
        bf = float(np.float32(self.fx * self.config.baseline))
        frame = make_frame_rgbd(self._upload(img), self._upload(depth_map), self.K, self.dist,
                                self.config.frontend, bf)
        return self.process_frame(frame, timestamp)

    def _upload(self, img):
        return torch.as_tensor(img).to(self.device, torch.float32)

    # -- visual-inertial input (Tracking::GrabImuData) ----------------------

    def grab_imu(self, acc, gyro, dts):
        """Queue the IMU samples (acc [M,3] m/s^2, gyro [M,3] rad/s, dts [M]
        s) that cover the span since the previous camera frame."""
        acc = np.asarray(acc, np.float32).reshape(-1, 3)
        if len(acc) == 0:
            return
        chunk = (acc, np.asarray(gyro, np.float32).reshape(-1, 3),
                 np.asarray(dts, np.float32).reshape(-1))
        self._imu_frame.append(chunk)
        self._imu_kf.append(chunk)
        self._imu_seq += 1   # anchors the pipelined VI lane's window splits

    def process_image_inertial(self, img, timestamp, acc, gyro, dts):
        """`System::TrackMonocular` with the IMU samples since the last frame."""
        self.grab_imu(acc, gyro, dts)
        return self.process_image(img, timestamp)

    def process_stereo_inertial(self, img_l, img_r, timestamp, acc, gyro, dts):
        """A stereo pair with the IMU samples since the last frame (IMU_STEREO)."""
        self.grab_imu(acc, gyro, dts)
        return self.process_stereo_pair(img_l, img_r, timestamp)

    def process_rgbd_inertial(self, img, depth_map, timestamp, acc, gyro, dts):
        """An RGB-D frame with the IMU samples since the last frame (IMU_RGBD)."""
        self.grab_imu(acc, gyro, dts)
        return self.process_rgbd(img, depth_map, timestamp)

    def _cat_imu(self, chunks):
        """Preintegrate the chunks under the current bias mirrors: one
        upload of the samples and the biases, then the scan on the
        device."""
        acc = np.concatenate([c[0] for c in chunks])
        n = len(acc)
        buf = np.zeros((n + 1, 7), np.float32)
        buf[:n, 0:3] = acc
        buf[:n, 3:6] = np.concatenate([c[1] for c in chunks])
        buf[:n, 6] = np.concatenate([c[2] for c in chunks])
        buf[n, 0:3] = self.bias_g
        buf[n, 3:6] = self.bias_a
        b = torch.from_numpy(buf).to(self.device)
        return imu.preintegrate(self.imu_calib, b[:n, 0:3], b[:n, 3:6], b[:n, 6],
                                bias_g=b[n, 0:3], bias_a=b[n, 3:6])

    def _body_state(self, T_cw):
        """T_cw -> (R_wb [3,3], p_w [3]) through the body-camera extrinsic."""
        T_bw = lie.se3_mul(lie.se3_inv(self.T_cb), T_cw)
        R_wb = lie.quat_to_matrix(lie.se3_q(T_bw)).T
        return R_wb, -(R_wb @ lie.se3_t(T_bw))

    def _mirror(self, x):
        return torch.as_tensor(np.asarray(x, np.float32)).to(self.device)

    def _dead_reckon(self, pre, T_cw, v_w, bg, ba):
        """`predict_state` from the camera pose T_cw: (T_cw' [7], v' [3])."""
        R_wb, p_w = self._body_state(T_cw)
        R2, v2, p2 = imu.predict_state(pre, R_wb, v_w, p_w, bias_g=bg, bias_a=ba)
        T_bw = lie.se3(lie.quat_from_matrix(R2.T), -(R2.T @ p2))
        return lie.se3_mul(self.T_cb, T_bw), v2

    def _imu_predict(self):
        """`Tracking::PredictStateIMU` (`Tracking.cc:1564`): dead-reckon the
        last pose through the samples since that frame. Returns (T_pred
        [7], v_pred [3] np), or None without samples."""
        if not self._imu_frame:
            return None
        pre = self._cat_imu(self._imu_frame)
        T_pred, v2 = self._dead_reckon(pre, self.last_pose, self._mirror(self.vel_w),
                                       pre.bias_g, pre.bias_a)
        return T_pred, v2.cpu().numpy()

    # -- pipelined tracking (decisions run async_depth frames late) ---------

    def _track_pipelined(self, frame: Frame, timestamp: float):
        T_pred = lie.se3_mul(self.velocity, self.last_pose)
        res = track_frame(self.map, frame, T_pred, self.K, self.config)
        return self._pipeline_push(frame, timestamp, res)

    def _pipeline_push(self, frame: Frame, timestamp: float, res):
        n_copy = _HostCopy(res.n_inliers)
        # the prediction chain stays per-frame fresh on the device
        self.velocity = lie.se3_mul(res.T_cw, lie.se3_inv(self.last_pose))
        self.last_pose = res.T_cw
        self._pipeline.append((timestamp, frame, res, n_copy))
        if len(self._pipeline) > self.async_depth:
            self._retire_pipelined()
        return res.T_cw

    def _retire_pipelined(self):
        """Resolve the oldest in-flight frame: lost handling, visibility
        counters, keyframe decision."""
        if len(self._pipeline[0]) == 5:   # a VI record
            return self._retire_vi(*self._pipeline.pop(0))
        ts, frame, res, n_copy = self._pipeline.pop(0)
        n_inl = int(n_copy.numpy())
        if n_inl < self.config.min_track_inliers:
            self.state = RECENTLY_LOST if self.state == OK else LOST
            self._lost_frames += 1
            # drop the poisoned chain: predict again from the last good pose
            self._pipeline.clear()
            self.velocity = lie.se3_identity(device=self.device)
            if self._atlas_due():
                self._new_map_in_atlas()
            return
        self._lost_frames = 0
        self.state = OK
        self._last_good_ts = ts
        # incremental update: other frames are still in flight
        self.map = update_visibility(self.map, res.visible, res.found)
        self.frames_since_kf += 1
        if self._need_new_keyframe(n_inl):
            self._cur_ts = ts   # stamp the retired frame, not the newest one
            head, epoch = self.last_pose, self.map_epoch
            self._create_keyframe(frame, res)
            # the mapper leaves last_pose at the keyframe's adjusted pose,
            # which is async_depth frames behind the chain head: predicting
            # from it would lose the next frame (ROADMAP fault v). Keep the
            # head unless a merge-back re-based the map
            if self.map_epoch == epoch:
                self.last_pose = head

    def flush_pipeline(self):
        """Retire every in-flight frame (sequence end, before map export)."""
        while self._pipeline:
            self._retire_pipelined()

    # -- the pipelined visual-inertial lane ---------------------------------
    #
    # Pose, velocity and biases ride the device chain; the per-frame
    # pose-inertial refinement runs on every frame with its inlier gate a
    # selection on the device, and the host state machine retires records
    # from one packed readback a frame ([10]: n_inliers | v | bg | ba).

    def _vi_pipeline_active(self, timestamp: float) -> bool:
        """Route a frame to the pipelined VI lane? OK frames always; an
        IMU-initialized RECENTLY_LOST span (under 5 s) too, since the chain
        dead-reckons through it and records are still in flight."""
        if not (self.async_depth > 0 and self.inertial):
            return False
        if self.state == OK:
            return True
        return (self.state == RECENTLY_LOST and self.imu_initialized
                and self._last_good_ts is not None and timestamp - self._last_good_ts < 5.0)

    def _track_pipelined_vi(self, frame: Frame, timestamp: float):
        if self._vel_dev is None:   # (re-)seed the device chain from the mirrors
            self._vel_dev = self._mirror(self.vel_w)
            self._bias_g_dev = self._mirror(self.bias_g)
            self._bias_a_dev = self._mirror(self.bias_a)
        # the prediction: dead-reckon the chained (in-flight) state
        T_pred, v_pred = None, None
        if self.imu_initialized and self._imu_frame:
            pre_f = self._cat_imu(self._imu_frame)
            T_pred, v_pred = self._dead_reckon(pre_f, self.last_pose, self._vel_dev,
                                               self._bias_g_dev, self._bias_a_dev)
        if T_pred is None:
            T_pred = lie.se3_mul(self.velocity, self.last_pose)
        self._imu_frame = []

        res = track_frame(self.map, frame, T_pred, self.K, self.config)
        n_inl = int(res.n_inliers)
        ok = n_inl >= self.config.min_track_inliers
        v_chain = self._vel_dev if v_pred is None else v_pred
        bg_chain, ba_chain = self._bias_g_dev, self._bias_a_dev
        # a bad frame: the chain dead-reckons through it
        res = res._replace(T_cw=res.T_cw if ok else T_pred)
        s = self.last_kf_slot
        # PoseInertialOptimizationLastKeyFrame serves weak visual frames; a
        # well-tracked frame keeps its visual solution. The reference always
        # runs it and selects its outputs on the device; the port reads the
        # inlier count (track_frame has synchronised already) and runs it
        # only where its outputs are taken: the same results
        weak = n_inl < 4 * self.config.min_track_inliers
        if (ok and weak and self.imu_initialized and self._imu_kf and s is not None
                and s >= 0):
            self.n_vi_refines += 1
            pre = self._cat_imu(self._imu_kf)
            T_cb_inv = lie.se3_inv(self.T_cb)
            T_bw0 = lie.se3_mul(T_cb_inv, res.T_cw)
            T_bw_a = lie.se3_mul(T_cb_inv, self.map.kf_pose[s])
            v_a = self._mirror(self.kf_vel.get(s, np.zeros(3, np.float32)))
            # the random walk anchors at the keyframe's bias (stable between
            # keyframes; the rolling mirror would 2-cycle through the lag)
            bg_a, ba_a = self.kf_bias.get(s, (self.bias_g, self.bias_a))
            valid = res.obs >= 0
            pts = self.map.pt_pos[torch.clamp(res.obs, min=0).to(torch.int64)]
            sigma2 = _const(self.config.frontend.sigma2, self.device)[frame.level.to(torch.int64)]
            T_bw, v_chain, bg_chain, ba_chain, inl, _ = pose_opt.pose_inertial_optimization(
                T_bw0, v_chain, bg_chain, ba_chain, T_bw_a, v_a, self._mirror(bg_a),
                self._mirror(ba_a), pre, pts, frame.xy, sigma2, valid, self.K, self.T_cb,
                imu.gravity(self.device))
            res = res._replace(T_cw=lie.se3_mul(self.T_cb, T_bw),
                               obs=torch.where(inl, res.obs, -1),
                               n_inliers=torch.sum(inl, dtype=torch.int32))
        packed = torch.cat([res.n_inliers.to(torch.float32)[None], v_chain, bg_chain, ba_chain])
        copy = _HostCopy(packed)   # one readback a frame
        self.velocity = lie.se3_mul(res.T_cw, lie.se3_inv(self.last_pose))
        self.last_pose = res.T_cw
        self._vel_dev = v_chain
        self._bias_g_dev, self._bias_a_dev = bg_chain, ba_chain
        self._pipeline.append((timestamp, frame, res, copy, self._imu_seq))
        # retire a record once its readback has landed and a newer one is
        # out, with the depth bound as the backstop
        while (self._pipeline
               and ((len(self._pipeline) >= 2 and self._record_ready((None, self._pipeline[0][3])))
                    or len(self._pipeline) > self.async_depth)):
            self._retire_pipelined()
        return res.T_cw

    def _retire_vi(self, ts, frame, res, copy, imu_seq):
        """Retire one VI record: fold the packed readback into the host
        mirrors and run the state machine (loss handling, visibility, the
        keyframe decision with the IMU window split at this frame)."""
        rec = copy.numpy()
        n_inl = int(rec[0])
        v_host = rec[1:4].astype(np.float32)
        bg_host = rec[4:7].astype(np.float32)
        ba_host = rec[7:10].astype(np.float32)
        if n_inl < self.config.min_track_inliers:
            if (self.imu_initialized and self._last_good_ts is not None
                    and ts - self._last_good_ts < 5.0):
                # the chain dead-reckoned through this frame: keep streaming
                self.state = RECENTLY_LOST
                self.vel_w, self.bias_g, self.bias_a = v_host, bg_host, ba_host
                self.frames_since_kf += 1
                return
            self.state = RECENTLY_LOST if self.state == OK else LOST
            self._lost_frames += 1
            self._pipeline.clear()
            self.velocity = lie.se3_identity(device=self.device)
            self._vel_dev = None
            if self._atlas_due():
                self._new_map_in_atlas()
            return
        self._lost_frames = 0
        self.state = OK
        self._last_good_ts = ts
        self.vel_w, self.bias_g, self.bias_a = v_host, bg_host, ba_host
        self.map = update_visibility(self.map, res.visible, res.found)
        self.frames_since_kf += 1
        self._cur_ts = ts   # the decision and the keyframe stamp use this frame
        if not self._need_new_keyframe(n_inl):
            return
        # the keyframe's IMU window ends at this frame: the split comes from
        # the monotonic grab counter (a list index goes stale once an
        # earlier retire truncated _imu_kf)
        n_after = self._imu_seq - imu_seq
        cut = max(0, len(self._imu_kf) - n_after)
        tail = self._imu_kf[cut:]
        self._imu_kf = self._imu_kf[:cut]
        gen0 = self._rebase_gen
        self._pending_rebase_S = None
        chain = (self.last_pose, self._vel_dev, self._bias_g_dev, self._bias_a_dev)
        self._create_keyframe(frame, res._replace(n_inliers=torch.tensor(n_inl)))
        self._imu_kf = tail
        if self._rebase_gen != gen0:
            # the keyframe re-based the world (IMU init, scale refinement):
            # the in-flight records hold old-frame poses and go; the chain
            # head is carried into the new frame by the composed Sim3, and
            # velocity and biases re-seed from the mirrors just written
            self._pipeline.clear()
            self.velocity = lie.se3_identity(device=self.device)
            self._vel_dev = None
            if self._pending_rebase_S is not None:
                self.last_pose = lie.sim3_fold(lie.sim3_mul(
                    lie.sim3_from_se3(chain[0]), lie.sim3_inv(self._pending_rebase_S)))
            self._pending_rebase_S = None
            if self.imu_initialized and tail:
                # the mirrored velocity holds at the keyframe; the chain head
                # is len(tail) frames ahead: propagate it through the rest
                pre_t = self._cat_imu(tail)
                R_wb, p_w = self._body_state(self.map.kf_pose[self.last_kf_slot])
                _, v_head, _ = imu.predict_state(pre_t, R_wb, self._mirror(self.vel_w), p_w,
                                                 bias_g=pre_t.bias_g, bias_a=pre_t.bias_a)
                self._vel_dev = v_head
                self._bias_g_dev = self._mirror(self.bias_g)
                self._bias_a_dev = self._mirror(self.bias_a)
        else:
            # keep the newest chain, carrying the mapper's correction of the
            # keyframe (tracked res.T_cw -> adjusted kf_pose) onto its head
            delta = lie.se3_mul(lie.se3_inv(res.T_cw), self.map.kf_pose[self.last_kf_slot])
            self.last_pose = lie.se3_mul(chain[0], delta)
            self._vel_dev, self._bias_g_dev, self._bias_a_dev = chain[1:]

    # -- the autonomous lane --------------------------------------------------

    def enter_autonomous(self):
        """Switch steady-state tracking to `autonomous_step`: the keyframe
        decision and the mapper chain run inside the step; the host catches
        up from outcome rows. Needs an initialized visual tracker and a
        mapper."""
        if self.state != OK or self.inertial or self.local_mapper is None:
            return False
        # a pipelined record left behind would retire against slots the
        # autonomous chain has since renumbered
        self.flush_pipeline()
        if self.state != OK:
            return False
        fc = self.config.frontend
        mc = self.local_mapper
        self._auto_cfg = (mc.n_neighbors, fc.n_levels, fc.scale_factor, mc.ba_local,
                          mc.ba_fixed, mc.ba_pts, mc.ba_iters, mc.run_ba_every)
        i32 = functools.partial(torch.tensor, dtype=torch.int32, device=self.device)
        self._auto_state = AutoState(
            T_cw=self.last_pose, velocity=self.velocity,
            frames_since_kf=i32(self.frames_since_kf),
            ref_tracked=i32(max(self.ref_kf_tracked, 1)),
            kf_count=i32(mc._kf_count),
        )
        self._auto_flags = []
        self._auto_imgs = []
        self.autonomous = True
        return True

    def _auto_dispatch(self, imgs, tss, fids):
        m, st, rows = autonomous_step_batch(imgs, self.map, self._auto_state, self.K,
                                            self.dist, self.config, self._auto_cfg, fids)
        self._push_auto_record(m, st, tss, rows, fids)

    def _process_autonomous(self, img, timestamp: float):
        B = max(int(self.auto_batch), 1)
        # the frame's number (its submission count) rides with it to its
        # step and its retire
        with profiling.span("lane.submit", self.n_frames):
            self._auto_imgs.append((img, timestamp, self.n_frames))
        if len(self._auto_imgs) >= B:
            imgs = torch.stack([im for im, _, _ in self._auto_imgs])
            tss = [t for _, t, _ in self._auto_imgs]
            fids = [f for _, _, f in self._auto_imgs]
            self._auto_imgs = []
            self._auto_dispatch(imgs, tss, fids)
        # retire a record once its rows have landed and a newer record is
        # out, or when more than async_depth frames are pending
        while (self.autonomous and self._auto_flags
               and ((len(self._auto_flags) >= 2 and self._record_ready(self._auto_flags[0]))
                    or self._pending_auto_frames() > max(self.async_depth, 1))):
            if self._retire_auto_record():
                # the record ended lost: fold every other dispatched record
                # (its effects are in the map already), then hand control and
                # the buffered, undispatched frames back to the host path
                while self._auto_flags:
                    self._retire_auto_record()
                pending = self._auto_imgs
                self._auto_imgs = []
                self.exit_autonomous(drain=False)
                pose = self._auto_state.T_cw
                for im, t, _ in pending:
                    self.n_frames -= 1  # counted at first submission
                    p = self.process_image(im, t)
                    pose = p if p is not None else pose
                return pose
        if self._atlas_check_pending and self.autonomous:
            self._atlas_check_pending = False
            self.drain_auto()
            if self.autonomous:
                self._atlas_merge_back()
        return self._auto_state.T_cw

    def _push_auto_record(self, m, st, tss, rows, fids):
        self.map = m
        self._auto_state = st
        self._auto_flags.append((tss, _HostCopy(rows), len(tss), fids))

    def _pending_auto_frames(self):
        return sum(rec[2] for rec in self._auto_flags)

    @staticmethod
    def _record_ready(rec):
        """Non-blocking: True once a record's outcome rows are on the host."""
        return rec[1].ready()

    def _retire_auto_record(self):
        """Fold one record (1..B frames) into the host mirrors: trajectory
        rows, keyframe metadata, state machine. Returns True when the record
        ends with a lost frame and the host must leave the autonomous lane."""
        tss, copy, n, fids = self._auto_flags.pop(0)
        rec = np.atleast_2d(copy.numpy()).copy()     # [B,10]: pose 7|kf|good|inl
        poses = rec[:, :7]
        made = rec[:, 7] > 0.5
        good = rec[:, 8] > 0.5
        ninl = rec[:, 9]
        for i in range(n):
            with profiling.span("lane.retire", fids[i]):
                ts = tss[i]
                # only tracked frames leave a row: the chain holds the last pose
                # on a bad frame
                if good[i]:
                    self.trajectory.append((ts, poses[i], OK))
                if made[i]:
                    s = self.n_kf_host
                    self.n_kf_host += 1
                    self.meta.kf_uuid[s] = self._new_uuids(1)[0]
                    self.meta.kf_creator[s] = self.meta.agent_id
                    self.last_kf_slot = s
                    self.kf_timestamps[s] = ts
                    self.ref_kf_tracked = int(ninl[i])
                    self.meta_dirty = True
                    if self.local_mapper is not None:
                        self.local_mapper._kf_count += 1
                    if self.atlas is not None and self.atlas.inactive:
                        self._atlas_check_pending = True
                if not good[i]:
                    self._lost_frames += 1
                    self.state = RECENTLY_LOST if self.state == OK else LOST
                else:
                    self._lost_frames = 0
                    self.state = OK
                    self._last_good_ts = ts
        # leave only when the record ENDS lost: the chain recovers from a
        # bad frame inside a batch by itself
        return not bool(good[-1])

    def drain_auto(self):
        """Retire every pending record (autonomous and pipelined) so the host
        mirrors are current, staying in the autonomous lane unless a frame
        was lost. Call before reading or exporting the map."""
        self.flush_pipeline()
        if not self.autonomous:
            return
        self._flush_auto_buffer()
        while self._auto_flags and self.autonomous:
            if self._retire_auto_record():
                self.exit_autonomous(drain=False)
        if self.autonomous:
            st = self._auto_state
            self.last_pose = st.T_cw
            self.velocity = st.velocity
            self.frames_since_kf = int(st.frames_since_kf)

    def _flush_auto_buffer(self):
        """Dispatch the frames buffered for a partial batch one at a time."""
        for img, ts, fid in self._auto_imgs:
            self._auto_dispatch(img[None], [ts], [fid])
        self._auto_imgs = []

    def exit_autonomous(self, drain: bool = True):
        """Leave the autonomous lane, folding the device state back into the
        host mirrors; with drain=True every pending record retires first."""
        if not self.autonomous:
            return
        self.autonomous = False
        if drain:
            self._flush_auto_buffer()
            while self._auto_flags:
                self._retire_auto_record()
        else:
            self._auto_flags = []
            self._auto_imgs = []
        st = self._auto_state
        self.last_pose = st.T_cw
        self.velocity = st.velocity
        self.frames_since_kf = int(st.frames_since_kf)
        # the device map is the source of truth for the keyframe count:
        # records dropped with drain=False may have made keyframes. Stamp
        # metadata for every slot the retire never covered
        dev_n = int(self.map.n_kf)
        ts_fallback = self._last_good_ts if self._last_good_ts is not None else self._cur_ts
        while self.n_kf_host < dev_n:
            s = self.n_kf_host
            self.n_kf_host += 1
            self.meta.kf_uuid[s] = self._new_uuids(1)[0]
            self.meta.kf_creator[s] = self.meta.agent_id
            self.last_kf_slot = s
            self.kf_timestamps[s] = ts_fallback
            self.meta_dirty = True
            if self.local_mapper is not None:
                self.local_mapper._kf_count += 1

    # -- initialization -----------------------------------------------------

    def _try_initialize_depth(self, frame: Frame):
        """`Tracking::StereoInitialization`: one frame with enough keypoints
        of known depth seeds the map at true scale, keyframe 0 at identity
        and one point per such keypoint."""
        n_depth = int(((frame.depth > 0) & frame.valid).sum())
        if n_depth < self.config.min_init_stereo_points:
            return None
        self.map, _ = bootstrap_from_depth(self.map, frame, self.K, self.config)
        self.n_kf_host = 1
        self.meta.kf_uuid[0] = self._new_uuids(1)[0]
        self.meta.kf_creator[0] = self.meta.agent_id
        self.meta_dirty = True
        self.flush_meta()
        self.last_pose = lie.se3_identity(device=self.device)
        self.velocity = lie.se3_identity(device=self.device)
        self.last_kf_slot = 0
        self.kf_timestamps[0] = self._cur_ts
        self.ref_kf_tracked = n_depth
        self.frames_since_kf = 0
        self.state = OK
        self._last_good_ts = self._cur_ts
        if self.inertial:
            # the map is metric from this frame; the IMU initialization later
            # estimates gravity and velocities at fixed scale
            self.kf_chain = [0]
            self.kf_vel = {0: np.zeros(3, np.float32)}
            self.kf_preint = {}
            self._imu_kf = []
            self._imu_frame = []
        if self.local_mapper is not None:
            self.local_mapper.on_initial_map(self)
        return self.last_pose

    def _try_initialize(self, frame: Frame):
        n_valid = int(frame.valid.sum())
        if self.init_frame is None or n_valid <= self.config.min_init_matches:
            if n_valid > self.config.min_init_matches:
                self.init_frame = frame
                self._init_ts = self._cur_ts
                self._imu_kf = []   # preintegration starts at the init frame
            return None
        f1, f2 = self.init_frame, frame
        idx, ok = matching.search_for_initialization(
            f1.xy, f1.desc, f1.angle, f1.valid, f2.xy, f2.desc, f2.angle, f2.valid)
        if int(ok.sum()) < self.config.min_init_matches:
            # too few matches: restart from this frame
            self.init_frame = frame
            self._init_ts = self._cur_ts
            self._imu_kf = []
            return None
        xn1 = cameras.pinhole_unproject(self.K, f1.xy)
        xn2 = cameras.pinhole_unproject(self.K, f2.xy[torch.clamp(idx, min=0)])
        noise_h, noise_e = self._ransac_noise(f1.capacity)
        res = two_view.reconstruct_two_views(noise_h, noise_e, xn1, xn2, ok, focal=self.K[0],
                                             min_triangulated=50)
        if not bool(res.ok):
            return None
        self._create_initial_map(f1, f2, idx, res)
        self.state = OK
        return self.last_pose

    def _create_initial_map(self, f1: Frame, f2: Frame, idx, res: two_view.TwoViewResult):
        """`Tracking::CreateInitialMapMonocular`: two keyframes, triangulated
        points, median-depth scale normalization (numpy's median: the mean of
        the two middle depths for an even count)."""
        dev = self.device
        good = res.good.cpu().numpy()
        pts = res.points.cpu().numpy()
        depths = pts[good, 2]
        med = float(np.median(depths)) if good.any() else 1.0
        pts = pts / med
        T21 = res.T21.cpu().numpy().copy()
        T21[4:7] /= med
        T1 = lie.se3_identity(device=dev)
        T2 = torch.as_tensor(T21, device=dev)

        n = f1.capacity
        gmask = torch.as_tensor(good, device=dev)
        m, slots = map_state.add_points(
            self.map, pos=torch.as_tensor(pts, device=dev), desc=f1.desc,
            normal=torch.zeros((n, 3), dtype=torch.float32, device=dev),
            min_dist=torch.zeros((n,), dtype=torch.float32, device=dev),
            max_dist=torch.full((n,), 1e9, dtype=torch.float32, device=dev),
            ref_kf=0, valid=gmask)
        obs1 = torch.where(gmask, slots, -1)
        # frame-2 feature idx[i] observes the same slot; rows without a valid
        # match all land in the sentinel slot n, which is sliced off
        write = gmask & (idx >= 0)
        tgt = torch.where(write, idx, n).to(torch.int64)
        obs2 = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
        obs2 = obs2.scatter(0, tgt, torch.where(write, slots, -1).to(torch.int32))[:n]
        m, _ = map_state.add_keyframe(m, T1, f1.xy, f1.level, f1.angle, f1.desc, f1.valid, obs1)
        m, _ = map_state.add_keyframe(m, T2, f2.xy, f2.level, f2.angle, f2.desc, f2.valid, obs2)
        fc = self.config.frontend
        m = map_state.update_point_stats(m, fc.n_levels, fc.scale_factor)
        self.map = m
        self.meta.kf_uuid[0:2] = self._new_uuids(2)
        self.meta.kf_creator[0:2] = self.meta.agent_id
        npts = int(m.n_pt)
        self.meta.pt_uuid[:npts] = self._new_uuids(npts)
        self.meta.pt_creator[:npts] = self.meta.agent_id

        self.last_pose = T2
        self.velocity = lie.se3_identity(device=dev)
        self.last_kf_slot = 1
        self.n_kf_host = 2
        if self.inertial:
            # the preintegration between the two bootstrap keyframes
            self.kf_chain = [0, 1]
            self.kf_vel = {0: np.zeros(3, np.float32), 1: np.zeros(3, np.float32)}
            if self._imu_kf:
                self.kf_preint = {1: self._cat_imu(self._imu_kf)}
            self._imu_kf = []
            self._imu_frame = []
            self._last_good_ts = self._cur_ts
        self.kf_timestamps[0] = self._init_ts
        self.kf_timestamps[1] = self._cur_ts
        self.ref_kf_tracked = int(good.sum())
        self.frames_since_kf = 0
        if self.local_mapper is not None:
            self.local_mapper.on_initial_map(self)

    # -- steady-state tracking ----------------------------------------------

    def _predict_pose(self):
        """The next frame's prediction: (T_pred, v_pred), from the IMU once
        it is initialized (v_pred the dead-reckoned velocity, numpy), else
        from the motion model (v_pred None)."""
        if self.inertial and self.imu_initialized:
            out = self._imu_predict()
            if out is not None:
                return out
        return lie.se3_mul(self.velocity, self.last_pose), None

    def _track(self, frame: Frame, timestamp: float):
        if (self.state in (RECENTLY_LOST, LOST) and self.relocalizer is not None
                and not (self.inertial and self.imu_initialized)):
            pose = self._try_relocalize(frame, timestamp)
            if pose is not None:
                return pose
        T_pred, v_pred = self._predict_pose()
        res = track_frame(self.map, frame, T_pred, self.K, self.config)
        # once the IMU is initialized the visual solve seeds the
        # pose-inertial one (PoseInertialOptimizationLastKeyFrame)
        if (self.inertial and self.imu_initialized and self._imu_kf
                and self.last_kf_slot is not None
                and int(res.n_inliers) >= self.config.min_track_inliers):
            res, v_pred = self._pose_inertial_refine(frame, res, v_pred)
        return self._track_resolve(frame, timestamp, T_pred, v_pred, res)

    def _pose_inertial_refine(self, frame: Frame, res: TrackResult, v_pred):
        """The 15-dof refinement against the last keyframe's state
        (`Optimizer.cc:4181`): pose, velocity and the running bias. Returns
        (result, v numpy)."""
        s = self.last_kf_slot
        pre = self._cat_imu(self._imu_kf)
        T_cb_inv = lie.se3_inv(self.T_cb)
        T_bw0 = lie.se3_mul(T_cb_inv, res.T_cw)
        T_bw_a = lie.se3_mul(T_cb_inv, self.map.kf_pose[s])
        v0 = self._mirror(self.vel_w if v_pred is None else v_pred)
        v_a = self._mirror(self.kf_vel.get(s, np.zeros(3, np.float32)))
        bg, ba = pre.bias_g, pre.bias_a
        valid = res.obs >= 0
        pts = self.map.pt_pos[torch.clamp(res.obs, min=0).to(torch.int64)]
        sigma2 = _const(self.config.frontend.sigma2, self.device)[frame.level.to(torch.int64)]
        T_bw, v, bg2, ba2, inl, _ = pose_opt.pose_inertial_optimization(
            T_bw0, v0, bg, ba, T_bw_a, v_a, bg, ba, pre, pts, frame.xy, sigma2, valid, self.K,
            self.T_cb, imu.gravity(self.device))
        out = torch.cat([v, bg2, ba2]).cpu().numpy()
        self.bias_g = out[3:6].copy()
        self.bias_a = out[6:9].copy()
        res = res._replace(T_cw=lie.se3_mul(self.T_cb, T_bw),
                           obs=torch.where(inl, res.obs, -1),
                           n_inliers=torch.sum(inl, dtype=torch.int32))
        return res, out[0:3].copy()

    def _try_relocalize(self, frame: Frame, timestamp: float):
        """`Tracking::Relocalization`: BoW candidates + PnP, then the
        two-stage projection search and pose refinement against the map
        (`track_frame`). Returns the pose or None."""
        ok, T, _ = self.relocalizer(self.map, frame)
        if not ok:
            return None
        res = track_frame(self.map, frame, T, self.K, self.config)
        if int(res.n_inliers) >= self.config.min_track_inliers:
            self.map = update_visibility(self.map, res.visible, res.found)
            T = res.T_cw
        self.state = OK
        self._lost_frames = 0
        self.velocity = lie.se3_identity(device=self.device)
        self.last_pose = T
        self._imu_frame = []
        self._last_good_ts = timestamp
        self.frames_since_kf += 1
        return T

    def _track_resolve(self, frame: Frame, timestamp: float, T_pred, v_pred,
                       res: TrackResult, vis=None):
        n_inl = int(res.n_inliers)
        if n_inl < self.config.min_track_inliers:
            if (self.inertial and self.imu_initialized and v_pred is not None
                    and self._last_good_ts is not None and timestamp - self._last_good_ts < 5.0):
                # RECENTLY_LOST with an IMU: dead reckoning carries the pose
                # for up to 5 s (`Tracking.cc:1784-1812`)
                self.state = RECENTLY_LOST
                self.last_pose = T_pred
                self.vel_w = v_pred
                self._imu_frame = []
                self.frames_since_kf += 1
                return T_pred
            if self.relocalizer is not None:
                pose = self._try_relocalize(frame, timestamp)
                if pose is not None:
                    return pose
            self.state = RECENTLY_LOST if self.state == OK else LOST
            self.velocity = lie.se3_identity(device=self.device)
            self._lost_frames += 1
            if self._atlas_due():
                self._new_map_in_atlas()
            return None
        self._lost_frames = 0
        self.state = OK
        self._last_good_ts = timestamp
        if vis is not None:
            self.map = self.map._replace(pt_visible=vis[0], pt_found=vis[1])
        else:
            self.map = update_visibility(self.map, res.visible, res.found)
        self.velocity = lie.se3_mul(res.T_cw, lie.se3_inv(self.last_pose))
        if self.inertial and v_pred is not None:
            self.vel_w = v_pred   # the IMU-propagated velocity at the new pose
        self.last_pose = res.T_cw
        self._imu_frame = []
        self.frames_since_kf += 1
        if self._need_new_keyframe(n_inl):
            self._create_keyframe(frame, res)
            # the mapper's BA, an IMU initialization or a merge-back may have
            # moved the keyframe or re-based the world: return its pose
            return self.last_pose
        return res.T_cw

    def apply_world_sim3(self, S):
        """Re-base the continuation by a world-level Sim3 (the gravity and
        scale alignment of the IMU initialization): the current pose
        composes like a keyframe pose, the motion model resets, the
        trajectory follows, and the pipelined VI lane learns of it."""
        S = torch.as_tensor(S, dtype=torch.float32).to(self.device)
        self._rebase_gen += 1
        self._pending_rebase_S = (S if self._pending_rebase_S is None
                                  else lie.sim3_mul(S, self._pending_rebase_S))
        self.last_pose = lie.sim3_fold(lie.sim3_mul(lie.sim3_from_se3(self.last_pose),
                                                    lie.sim3_inv(S)))
        self.velocity = lie.se3_identity(device=self.device)
        self.rebase_history(S)

    def rebase_history(self, S):
        """Re-base the recorded trajectory by a world-level Sim3 (the agent's
        frame changed after a merge or a scale alignment), so the history
        stays in one frame: T' = fold(sim3(T) S^-1), all rows in one batch."""
        if not self.trajectory:
            return
        S = torch.as_tensor(np.asarray(S.cpu() if isinstance(S, torch.Tensor) else S, np.float32),
                            device=self.device)
        T = torch.stack([torch.as_tensor(T, dtype=torch.float32, device=self.device)
                         for _, T, _ in self.trajectory])
        T2 = lie.sim3_fold(lie.sim3_mul(lie.sim3_from_se3(T), lie.sim3_inv(S)[None]))
        self.trajectory = [(ts, T2[i], st) for i, (ts, _, st) in enumerate(self.trajectory)]

    def _atlas_due(self) -> bool:
        """`Tracking::CreateMapInAtlas`'s trigger: persistent LOST (5 lost
        frames) with a mature map (10 keyframes)."""
        return (self.atlas is not None and self.state == LOST and self._lost_frames >= 5
                and int(self.map.n_kf) >= 10)

    def _new_map_in_atlas(self):
        """Stash the active map in the atlas and restart on a fresh submap
        (`Tracking::CreateMapInAtlas`)."""
        self.flush_meta()
        self.atlas.stash_active(self.map, self.meta, self.kf_timestamps)
        cfg = self.config
        self.map = map_state.create(cfg.kf_cap, cfg.pt_cap, cfg.frontend.capacity,
                                    device=self.device)
        self.meta = map_state.MapMeta.create(cfg.kf_cap, cfg.pt_cap, agent_id=self.meta.agent_id)
        self.map_epoch += 1
        self.state = NOT_INITIALIZED
        self.init_frame = None
        self.velocity = lie.se3_identity(device=self.device)
        self.last_pose = lie.se3_identity(device=self.device)
        self.kf_timestamps = {}
        self.frames_since_kf = 0
        self.ref_kf_tracked = 0
        self.last_kf_slot = -1
        self._lost_frames = 0
        self.n_kf_host = 0
        self._pipeline = []
        self.imu_initialized = False
        self.kf_chain = []
        self.kf_preint = {}
        self.kf_vel = {}
        self._imu_kf = []
        self._imu_frame = []
        if self.local_mapper is not None:
            self.local_mapper._kf_count = 0
        if self.relocalizer is not None and hasattr(self.relocalizer, "reset"):
            self.relocalizer.reset(cfg.kf_cap)

    def _need_new_keyframe(self, n_inliers: int):
        """`Tracking::NeedNewKeyFrame` gates; thRefRatio 0.9 for a
        monocular camera, 0.75 with a depth sensor; an initialized IMU adds
        a keyframe every 0.25 s."""
        if self.n_kf_host >= self.config.kf_cap - 1:
            return False
        ratio = 0.75 if self.config.depth_sensor else self.config.kf_ref_ratio
        c1 = self.frames_since_kf >= self.config.max_frames_between_kf
        # an initialized IMU inserts keyframes at >= 4 Hz (`Tracking.cc:2859`):
        # the inertial BA needs short preintegration spans
        if (self.inertial and self.imu_initialized and self._cur_ts is not None
                and self.last_kf_slot in self.kf_timestamps
                and self._cur_ts - self.kf_timestamps[self.last_kf_slot] >= 0.25):
            c1 = True
        c2 = n_inliers < ratio * max(self.ref_kf_tracked, 1)
        c3 = n_inliers > self.config.kf_min_inliers
        return (c1 or c2) and c3

    def _create_keyframe(self, frame: Frame, res: TrackResult):
        """Insert the frame as a keyframe; with a depth sensor it keeps its
        right-u channel, and its unmatched keypoints closer than th_depth
        become new points (`Tracking::CreateNewKeyFrame`)."""
        depth = self.config.depth_sensor
        m, _ = map_state.add_keyframe(self.map, res.T_cw, frame.xy, frame.level, frame.angle,
                                      frame.desc, frame.valid, res.obs,
                                      ur=frame.ur if depth else None)
        if depth and frame.depth is not None:
            fc = self.config.frontend
            m, _ = create_points_from_depth(m, self.n_kf_host, frame, self.K,
                                            float(np.float32(self.config.th_depth)),
                                            fc.n_levels, fc.scale_factor)
            self.meta_dirty = True
        self.map = m
        # keyframes are append-only: the slot is known on the host
        s = self.n_kf_host
        self.n_kf_host += 1
        self.meta.kf_uuid[s] = self._new_uuids(1)[0]
        self.meta.kf_creator[s] = self.meta.agent_id
        self.last_kf_slot = s
        self.kf_timestamps[s] = self._cur_ts
        self.frames_since_kf = 0
        self.ref_kf_tracked = int(res.n_inliers)
        if self.inertial:
            if self.kf_chain and self._imu_kf:
                self.kf_preint[s] = self._cat_imu(self._imu_kf)
            self.kf_chain.append(s)
            self.kf_vel[s] = np.asarray(self.vel_w, np.float32)
            self.kf_bias[s] = (self.bias_g.copy(), self.bias_a.copy())
            self._imu_kf = []
        if self.local_mapper is not None:
            self.local_mapper.on_new_keyframe(self, s)
        self._atlas_merge_back()

    def _atlas_merge_back(self):
        """Weld the active map into a stored one when place recognition and
        the Sim3 verification succeed (LoopClosing's active-to-stored
        merge). Called after every host-path keyframe and, drained, after
        keyframes of the autonomous lane."""
        if self.atlas is None or not self.atlas.inactive:
            return
        self.flush_meta()
        out = self.atlas.try_merge_back(self.map, self.meta, self.last_kf_slot)
        if out is None:
            return
        merged, meta, kf_map, S_ab, stored_ts = out
        self.map = merged
        self.meta = meta
        self.n_kf_host = int(merged.n_kf)
        self.map_epoch += 1
        S = torch.as_tensor(S_ab, dtype=torch.float32, device=self.device)
        self.last_pose = lie.sim3_fold(lie.sim3_mul(lie.sim3_from_se3(self.last_pose),
                                                    lie.sim3_inv(S)))
        self.velocity = lie.se3_identity(device=self.device)
        new_ts = dict(stored_ts)
        for slot, t in self.kf_timestamps.items():
            ns = int(kf_map[slot])
            if ns >= 0:
                new_ts[ns] = t
        self.kf_timestamps = new_ts
        ns = int(kf_map[self.last_kf_slot])
        # a capacity overflow dropped the query keyframe: take the newest slot
        self.last_kf_slot = ns if ns >= 0 else int(merged.n_kf) - 1
        if self.relocalizer is not None and hasattr(self.relocalizer, "reset"):
            self.relocalizer.reset(self.config.kf_cap)   # the slots changed
        if self.autonomous:
            # the renumbered slots invalidate the device continuation
            self._auto_state = self._auto_state._replace(T_cw=self.last_pose,
                                                         velocity=self.velocity)
