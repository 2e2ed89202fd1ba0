"""Per-frame monocular tracking: project the map, two Hamming searches by
projection, pose-only Gauss-Newton after each; then the keyframe decision
and, for a new keyframe, the mapper chain with windowed BA.

Port of the device step of `dvm_slam_tpu/tracking/tracker.py`
(`project_points`, `track_frame`, `make_and_track`, `update_visibility`,
`create_points_from_depth`, `autonomous_step`, `autonomous_step_batch`),
plus two helpers taken from the reference's host code: `bootstrap_from_depth`
(the map seeding of `MonocularTracker._try_initialize_depth`) and
`motion_model_step` (the pose chain of `autonomous_step`). The
`MonocularTracker` state machine and monocular two-view initialization wait
for a later slice; the packed outcome rows of the reference
(`autonomous_step_packed`) are a TPU transfer workaround and are not ported.

As in the reference, both stages project against the full point table;
frustum, distance-range and viewing-angle gates (`Frame::isInFrustum`) cut
it to the candidate set.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from ..frontend.extractor import Frame, FrontendConfig, make_frame
from ..geometry import cameras, lie
from ..mapping import local_mapping, map_state
from ..ops import matching
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
    camera_model: str = "pinhole"  # only "pinhole" is ported
    sensor: str = "monocular"
    baseline: float = 0.0
    th_depth_ratio: float = 40.0
    min_init_stereo_points: int = 200

    @property
    def max_frames_between_kf(self):
        return int(self.fps)

    @property
    def depth_sensor(self):
        return self.sensor in ("stereo", "rgbd")


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


def track_frame(m: map_state.MapState, frame: Frame, T_pred, K, config: TrackerConfig):
    """Two-stage match + pose-only BA (monocular). Returns TrackResult.

    The reference's `lax.cond` retry (too few stage-1 matches -> a 4x wider
    window) is a Python `if` here: one host sync per frame."""
    fc = config.frontend
    dev = m.pt_pos.device
    scales = _const(fc.scales, dev)
    sigma2 = _const(fc.sigma2, dev)
    level_of = lambda f: frame.level[f].to(torch.int64)  # noqa: E731

    # ---- stage 1: wide search at the predicted pose (TrackWithMotionModel)
    uv, vis, level, _ = project_points(m, T_pred, K, config)
    radii1 = 15.0 * scales[level.to(torch.int64)]
    feat1, ok1 = _match_and_assign(m, uv, vis, level, radii1, frame, matching.TH_HIGH, 0.9)
    if int(torch.sum(ok1)) < 20:
        feat1, ok1 = _match_and_assign(m, uv, vis, level, radii1 * 4.0, frame,
                                       matching.TH_HIGH, 0.9)
    f1 = torch.clamp(feat1, min=0)
    T1, inl1, _ = pose_opt.pose_optimization(
        T_pred, m.pt_pos, frame.xy[f1], sigma2[level_of(f1)], ok1, K)
    n1 = torch.sum(inl1, dtype=torch.int32)

    # ---- stage 2: tight search at the refined pose (TrackLocalMap)
    uv2, vis2, level2, view_cos2 = project_points(m, T1, K, config)
    base_r = torch.where(view_cos2 > 0.998, 2.5, 4.0)
    radii2 = base_r * scales[level2.to(torch.int64)]
    feat2, ok2 = _match_and_assign(m, uv2, vis2, level2, radii2, frame, matching.TH_HIGH, 0.8)
    # keep stage-1 inlier associations where stage 2 found nothing
    feat = torch.where(ok2, feat2, torch.where(inl1, feat1, -1))
    okc = matching.dedupe_matches(feat, feat >= 0, frame.capacity)
    fc2 = torch.clamp(feat, min=0)
    T2, inl2, _ = pose_opt.pose_optimization(
        T1, m.pt_pos, frame.xy[fc2], sigma2[level_of(fc2)], okc, K)
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
    if config.camera_model != "pinhole":
        raise NotImplementedError(f"camera model {config.camera_model!r} is not ported")
    frame = make_frame(img, K, dist, config.frontend)
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
    ba_pts, ba_iters, run_ba_every), as in the reference. Returns (map,
    state, AutoFlags)."""
    if config.camera_model != "pinhole":
        raise NotImplementedError(f"camera model {config.camera_model!r} is not ported")
    if config.depth_sensor:
        raise NotImplementedError("stereo / RGB-D keyframes need stereo BA rows, not ported")
    (n_neighbors, n_levels, scale_factor,
     ba_local, ba_fixed, ba_pts, ba_iters, run_ba_every) = mapper_cfg
    frame = make_frame(img, K, dist, config.frontend)
    res = track_frame(m, frame, lie.se3_mul(st.velocity, st.T_cw), K, config)
    good = res.n_inliers >= config.min_track_inliers
    T2, vel2 = motion_model_step(st.T_cw, res, config)
    m = m._replace(
        pt_visible=m.pt_visible + (res.visible & good).to(torch.int32),
        pt_found=m.pt_found + (res.found & good).to(torch.int32),
    )
    fsk = torch.where(good, st.frames_since_kf + 1, st.frames_since_kf)

    # the keyframe decision, in f32 as the reference computes it
    thr = torch.clamp(config.kf_ref_ratio * st.ref_tracked.to(torch.float32), min=1.0)
    need_kf = (
        good
        & ((fsk >= config.max_frames_between_kf) | (res.n_inliers < thr.to(torch.int32)))
        & (res.n_inliers > config.kf_min_inliers)
        & (m.n_kf < config.kf_cap - 1)
    )
    # the reference's lax.cond is a Python `if`: one host sync per frame
    if bool(need_kf):
        m, slot = map_state.add_keyframe(m, res.T_cw, frame.xy, frame.level, frame.angle,
                                         frame.desc, frame.valid, res.obs)
        run_ba = run_ba_every == 1 or (int(st.kf_count) + 1) % run_ba_every == 0
        m = local_mapping._mapper_chain(
            m, slot, K, n_neighbors=n_neighbors, n_levels=n_levels,
            scale_factor=scale_factor, run_ba_traced=run_ba, ba_local=ba_local,
            ba_fixed=ba_fixed, ba_pts=ba_pts, ba_iters=ba_iters,
            use_kernel=config.frontend.use_kernel)
    st2 = AutoState(
        T_cw=T2, velocity=vel2,
        frames_since_kf=torch.where(need_kf, 0, fsk).to(torch.int32),
        ref_tracked=torch.where(need_kf, res.n_inliers, st.ref_tracked).to(torch.int32),
        kf_count=st.kf_count + need_kf.to(torch.int32),
    )
    return m, st2, AutoFlags(n_inliers=res.n_inliers, made_kf=need_kf, good=good)


def autonomous_step_batch(imgs, m: map_state.MapState, st: AutoState, K, dist,
                          config: TrackerConfig, mapper_cfg: tuple):
    """`autonomous_step` over the frames `imgs` [B,H,W] in turn (the
    reference's `lax.scan`). Returns (map, state, outcomes [B,10] f32: pose 7
    | made_kf | good | n_inliers), the reference's layout."""
    rows = []
    for img in imgs:
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
