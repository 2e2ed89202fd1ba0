"""MapState: the struct-of-arrays SLAM map.

Port of `dvm_slam_tpu/mapping/map_state.py` (the scatter variant of
`point_observers` has no caller and is not ported): same fields, dtypes and shapes, so maps cross between the packages field by
field (`convert.py`). Like the reference, every op returns a new
`MapState`; a field it writes is cloned first, the others are shared.

Scatters follow the reference's sentinel pattern: a write that must be
dropped targets one extra slot past the end, which is sliced off. Where the
reference's `.at[i].set(v)` can repeat a real index, XLA applies the updates
in order and the last one wins; `index_put_` and `scatter_` leave the winner
undefined on CUDA, so such writes go through `scatter_set_last`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..geometry import lie
from ..utils import profiling


class MapState(NamedTuple):
    """K = keyframe capacity, P = point capacity, F = features per keyframe."""

    # --- keyframes ---
    kf_pose: torch.Tensor    # [K,7] SE3 world->camera (T_cw)
    kf_valid: torch.Tensor   # [K] bool
    kf_xy: torch.Tensor      # [K,F,2] undistorted keypoints (level-0 px)
    kf_level: torch.Tensor   # [K,F] int32
    kf_angle: torch.Tensor   # [K,F] float32
    kf_desc: torch.Tensor    # [K,F,256] uint8 {0,1}
    kf_feat_valid: torch.Tensor  # [K,F] bool
    kf_obs: torch.Tensor     # [K,F] int32 -> point slot, -1 if none
    kf_ur: torch.Tensor      # [K,F] float32 stereo right-u, -1 = monocular
    # --- map points ---
    pt_pos: torch.Tensor     # [P,3] world position
    pt_valid: torch.Tensor   # [P] bool
    pt_desc: torch.Tensor    # [P,256] uint8 representative descriptor
    pt_normal: torch.Tensor  # [P,3] mean viewing direction
    pt_min_dist: torch.Tensor  # [P] scale-invariance range
    pt_max_dist: torch.Tensor  # [P]
    pt_ref_kf: torch.Tensor  # [P] int32 reference keyframe slot
    pt_visible: torch.Tensor  # [P] int32 nVisible
    pt_found: torch.Tensor    # [P] int32 nFound
    pt_first_kf: torch.Tensor  # [P] int32 kf slot at creation
    # --- counters ---
    n_kf: torch.Tensor       # [] int32 next keyframe slot
    n_pt: torch.Tensor       # [] int32 next point slot

    @property
    def kf_capacity(self):
        return self.kf_pose.shape[0]

    @property
    def pt_capacity(self):
        return self.pt_pos.shape[0]

    @property
    def feat_capacity(self):
        return self.kf_xy.shape[1]


@dataclasses.dataclass
class MapMeta:
    """Host-side identity companion of a MapState, numpy only.

    kf_uuid/pt_uuid: [cap, 2] uint64 (random 128-bit, like the reference's
    boost uuids); creator: [cap] int32 agent id."""

    kf_uuid: np.ndarray
    pt_uuid: np.ndarray
    kf_creator: np.ndarray
    pt_creator: np.ndarray
    agent_id: int

    @staticmethod
    def create(kf_cap: int, pt_cap: int, agent_id: int):
        return MapMeta(
            kf_uuid=np.zeros((kf_cap, 2), np.uint64),
            pt_uuid=np.zeros((pt_cap, 2), np.uint64),
            kf_creator=np.full((kf_cap,), -1, np.int32),
            pt_creator=np.full((pt_cap,), -1, np.int32),
            agent_id=agent_id,
        )

    def new_uuids(self, n, rng: np.random.Generator):
        """n fresh [n, 2] uint64 uuids from the caller's generator (the
        reference draws from the global `np.random`)."""
        return rng.integers(0, 2 ** 63, size=(n, 2)).astype(np.uint64)


def create(kf_cap: int, pt_cap: int, feat_cap: int, device=None,
           dtype=torch.float32) -> MapState:
    def z(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    kf_pose = z((kf_cap, 7))
    kf_pose[:, 0] = 1.0
    i32 = torch.int32
    return MapState(
        kf_pose=kf_pose,
        kf_valid=z((kf_cap,), torch.bool),
        kf_xy=z((kf_cap, feat_cap, 2)),
        kf_level=z((kf_cap, feat_cap), i32),
        kf_angle=z((kf_cap, feat_cap)),
        kf_desc=z((kf_cap, feat_cap, 256), torch.uint8),
        kf_feat_valid=z((kf_cap, feat_cap), torch.bool),
        kf_obs=full((kf_cap, feat_cap), -1, i32),
        kf_ur=full((kf_cap, feat_cap), -1.0, dtype),
        pt_pos=z((pt_cap, 3)),
        pt_valid=z((pt_cap,), torch.bool),
        pt_desc=z((pt_cap, 256), torch.uint8),
        pt_normal=z((pt_cap, 3)),
        pt_min_dist=z((pt_cap,)),
        pt_max_dist=z((pt_cap,)),
        pt_ref_kf=full((pt_cap,), -1, i32),
        pt_visible=z((pt_cap,), i32),
        pt_found=z((pt_cap,), i32),
        pt_first_kf=full((pt_cap,), -1, i32),
        n_kf=z((), i32),
        n_pt=z((), i32),
    )


def stack_maps(maps) -> MapState:
    """Stack N maps of one capacity on a leading batch axis (one per agent)
    for batched device work (`local_ba_batched`, the multi-agent step).
    Raises where the maps' capacities differ."""
    caps = {(m.kf_capacity, m.pt_capacity, m.feat_capacity) for m in maps}
    if len(caps) != 1:
        raise ValueError(f"stack_maps takes maps of one capacity (kf, pt, feat), got "
                         f"{sorted(caps)}")
    return MapState(*(torch.stack(xs) for xs in zip(*maps)))


def unstack_maps(ms: MapState, n: int):
    """Inverse of `stack_maps`: split the batch axis back into N maps."""
    return [MapState(*(x[i] for x in ms)) for i in range(n)]


# --------------------------------------------------------------------------
# derived structures
# --------------------------------------------------------------------------

def scatter_set_last(dst, idx, vals):
    """`dst.at[idx].set(vals)` with XLA's order: where `idx` repeats, the
    last update wins. dst [N,...], idx [U] in [0, N), vals [U,...]. The
    winning update of each target is found with a deterministic
    `scatter_reduce("amax")` over update positions; only the winners, whose
    targets are then unique, are written."""
    n, u = dst.shape[0], idx.shape[0]
    idx = idx.to(torch.int64)
    pos = torch.full((n,), -1, dtype=torch.int64, device=dst.device)
    pos.scatter_reduce_(0, idx, torch.arange(u, device=dst.device), "amax")
    hit = (pos >= 0).reshape((n,) + (1,) * (dst.dim() - 1))
    return torch.where(hit, vals.to(dst.dtype)[pos.clamp(min=0)], dst)


def _raw_incidence(kf_obs, P: int):
    """[K,P] bool: row k holds point p at some feature, built by a scatter
    into a sentinel column P rather than the reference's [K,F,P] compare
    (164 MB per 16-row tile at F=1250, P=8192)."""
    obs = torch.where(kf_obs >= 0, kf_obs, P).to(torch.int64)
    M = torch.zeros((kf_obs.shape[0], P + 1), dtype=torch.bool, device=obs.device)
    M.scatter_(1, obs, True)
    return M[:, :P]


def incidence(m: MapState):
    """[K,P] bool observation incidence (KF k observes point p)."""
    M = _raw_incidence(m.kf_obs, m.pt_capacity)
    return M & m.kf_valid[:, None] & m.pt_valid[None, :]


def covisibility(m: MapState):
    """[K,K] int32 shared-observation counts, zero on the diagonal. The
    {0,1} f32 product is exact (counts < 2^24; TF32 is off)."""
    M = incidence(m).to(torch.float32)
    W = (M @ M.T).to(torch.int32)
    return W * (1 - torch.eye(W.shape[0], dtype=torch.int32, device=W.device))


def point_observers(m: MapState):
    """[P] int32 number of observing keyframes per point."""
    return torch.sum(incidence(m), dim=0, dtype=torch.int32)


def _first_occurrence(obs):
    """[...,F] bool: True where obs[...,f] is the FIRST feature in its row
    holding that value. After `fuse_duplicates` remaps observations, one
    row can reference a point through several features; counting structures
    count such a (KF, point) pair once."""
    F = obs.shape[-1]
    eq = (obs[..., None, :] == obs[..., :, None]).to(torch.uint8)   # [...,F,F]
    return torch.argmax(eq, dim=-1) == torch.arange(F, device=obs.device)


def covis_row(m: MapState, center):
    """[K] int32 covisibility row of keyframe `center`: the number of
    distinct valid points of `center` each other valid keyframe observes.
    Bit-equal to the reference's `covis_row` (and to `covisibility(m)
    [center]`), computed through the scatter-built incidence instead of the
    reference's [K,F,F] tiled compare: the center's point set is a [P] flag,
    and row k counts the distinct points it shares with it."""
    P = m.pt_capacity
    obs_c = m.kf_obs[center]
    flag = torch.zeros((P + 1,), dtype=torch.bool, device=obs_c.device)
    flag[torch.where(obs_c >= 0, obs_c, P).to(torch.int64)] = True
    flag = flag[:P] & m.pt_valid
    cov = torch.sum(_raw_incidence(m.kf_obs, P) & flag[None, :], dim=1, dtype=torch.int32)
    K = m.kf_capacity
    other = torch.arange(K, device=cov.device) != center
    return torch.where(m.kf_valid & other, cov, 0)


# --------------------------------------------------------------------------
# mutation ops
# --------------------------------------------------------------------------

def _set_row(arr, i, value):
    out = arr.clone()
    out.index_copy_(0, i.reshape(1).to(torch.int64), value.to(arr.dtype)[None])
    return out


@profiling.traced("mapping.add_keyframe")
def add_keyframe(m: MapState, pose, xy, level, angle, desc, feat_valid, obs,
                 ur=None):
    """Append a keyframe at slot n_kf. obs: [F] int32 point slots (-1 none);
    ur: optional [F] stereo right-u (-1 mono). Returns (map, slot)."""
    i = m.n_kf
    if ur is None:
        ur = torch.full(xy.shape[:1], -1.0, dtype=m.kf_ur.dtype, device=xy.device)
    m = m._replace(
        kf_pose=_set_row(m.kf_pose, i, pose),
        kf_valid=_set_row(m.kf_valid, i, torch.ones((), dtype=torch.bool, device=i.device)),
        kf_xy=_set_row(m.kf_xy, i, xy),
        kf_level=_set_row(m.kf_level, i, level),
        kf_angle=_set_row(m.kf_angle, i, angle),
        kf_desc=_set_row(m.kf_desc, i, desc),
        kf_feat_valid=_set_row(m.kf_feat_valid, i, feat_valid),
        kf_obs=_set_row(m.kf_obs, i, obs),
        kf_ur=_set_row(m.kf_ur, i, ur),
        n_kf=m.n_kf + 1,
    )
    return m, i


def add_points(m: MapState, pos, desc, normal, min_dist, max_dist, ref_kf, valid):
    """Append up to N points at slots [n_pt, n_pt+N): only rows with
    valid=True are activated, consumed contiguously so row r lands at slot
    n_pt + cumsum(valid)[r]-1. Returns (map, slot [N], -1 where dropped)."""
    n = pos.shape[0]
    P = m.pt_capacity
    dev = pos.device
    rank = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(valid, m.n_pt + rank, P)
    w = valid & (slot < P)
    slot_c = torch.where(w, slot, P).to(torch.int64)  # dropped rows -> pad row

    def scat(arr, vals):
        pad = torch.zeros((1,) + arr.shape[1:], dtype=arr.dtype, device=dev)
        big = torch.cat([arr, pad])
        big.index_copy_(0, slot_c, vals.to(arr.dtype))
        return big[:-1]

    ref = torch.as_tensor(ref_kf, dtype=torch.int32, device=dev).expand(n)
    ones = torch.ones((n,), dtype=torch.int32, device=dev)
    m = m._replace(
        pt_pos=scat(m.pt_pos, pos),
        pt_valid=scat(m.pt_valid, w),
        pt_desc=scat(m.pt_desc, desc),
        pt_normal=scat(m.pt_normal, normal),
        pt_min_dist=scat(m.pt_min_dist, min_dist),
        pt_max_dist=scat(m.pt_max_dist, max_dist),
        pt_ref_kf=scat(m.pt_ref_kf, ref),
        pt_first_kf=scat(m.pt_first_kf, ref),
        pt_visible=scat(m.pt_visible, ones),
        pt_found=scat(m.pt_found, ones),
        n_pt=torch.clamp(m.n_pt + torch.sum(w, dtype=torch.int32), max=P),
    )
    return m, torch.where(w, slot, -1)


def check_invariants(m: MapState) -> list:
    """Runtime consistency checks (`Map::CheckEssentialGraph` role): a list
    of violation strings, empty when the map is healthy. Host-side, numpy."""
    errs = []
    n_kf, n_pt = int(m.n_kf), int(m.n_pt)
    kf_valid = m.kf_valid.cpu().numpy()
    pt_valid = m.pt_valid.cpu().numpy()
    obs = m.kf_obs.cpu().numpy()
    if kf_valid[n_kf:].any():
        errs.append("kf_valid set beyond n_kf")
    if pt_valid[n_pt:].any():
        errs.append("pt_valid set beyond n_pt")
    live = obs[kf_valid]
    live = live[live >= 0]
    if live.size and live.max() >= m.pt_capacity:
        errs.append("kf_obs points past pt capacity")
    if live.size:
        dead = ~pt_valid[live]
        if dead.any():
            errs.append(f"{int(dead.sum())} observations reference invalid points")
    ref = m.pt_ref_kf.cpu().numpy()[pt_valid]
    if ref.size and (ref >= 0).any():
        kc = m.kf_capacity
        bad = ref[(ref >= 0) & ((ref >= kc) | ~kf_valid[np.clip(ref, 0, kc - 1)])]
        if bad.size:
            errs.append(f"{bad.size} points reference invalid ref keyframes")
    pos = m.pt_pos.cpu().numpy()[pt_valid]
    if pos.size and not np.isfinite(pos).all():
        errs.append("non-finite point positions")
    poses = m.kf_pose.cpu().numpy()[kf_valid]
    if poses.size and not np.isfinite(poses).all():
        errs.append("non-finite keyframe poses")
    return errs


def predict_scale(dist, max_dist, n_levels: int, scale_factor: float):
    """`MapPoint::PredictScale`: level = ceil(log(max_dist/dist)/log(sf))."""
    ratio = torch.clamp(max_dist, min=1e-9) / torch.clamp(dist, min=1e-9)
    log_sf = float(np.float32(np.log(scale_factor)))  # the reference divides in f32
    lv = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / log_sf)
    return torch.clamp(lv, 0, n_levels - 1).to(torch.int32)


def update_point_stats(m: MapState, n_levels: int, scale_factor: float,
                       with_desc: bool = True):
    """Recompute normals, distance ranges and (with_desc) representative
    descriptors of all valid points in one batched pass
    (`MapPoint::UpdateNormalAndDepth` + `ComputeDistinctiveDescriptors`).

    The descriptor is the per-bit majority vote of the observing keyframes'
    descriptors, counted in int32, so it is exact. `with_desc=False` refreshes
    the geometry only (the post-BA refresh of the reference)."""
    K, F = m.kf_obs.shape
    P = m.pt_capacity
    dev = m.pt_pos.device
    M = incidence(m)                                   # [K,P]
    counts = torch.clamp(torch.sum(M, dim=0, dtype=torch.int32), min=1)
    centers = lie.se3_t(lie.se3_inv(m.kf_pose))        # [K,3] camera centers

    diff = m.pt_pos[None, :, :] - centers[:, None, :]  # [K,P,3]
    dist = torch.linalg.norm(diff, dim=-1)             # [K,P]
    dirs = diff / torch.clamp(dist[..., None], min=1e-9)
    normal = torch.einsum("kp,kpd->pd", M.to(dirs.dtype), dirs) / counts[:, None]

    # scale-invariance distances from the reference keyframe observation
    ref = torch.clamp(m.pt_ref_kf, min=0).to(torch.int64)
    p_idx = torch.arange(P, device=dev)
    ref_dist = dist[ref, p_idx]
    # level of the (first) feature of the ref keyframe observing each point
    hit = (m.kf_obs[ref] == p_idx[:, None].to(torch.int32)).to(torch.uint8)  # [P,F]
    feat_idx = torch.argmax(hit, dim=-1)
    lv = m.kf_level[ref, feat_idx]
    sf = torch.pow(torch.full((), scale_factor, dtype=m.pt_pos.dtype, device=dev),
                   lv.to(m.pt_pos.dtype))
    max_d = ref_dist * sf
    min_d = max_d / (scale_factor ** (n_levels - 1))

    keep = m.pt_valid
    out = m._replace(
        pt_normal=torch.where(keep[:, None], normal, m.pt_normal),
        pt_max_dist=torch.where(keep, max_d, m.pt_max_dist),
        pt_min_dist=torch.where(keep, min_d, m.pt_min_dist),
    )
    if not with_desc:
        return out

    # feature index per (k, p): the reference's in-order `.at[k, obs].set(f)`
    # keeps the LAST feature of a row that holds p twice (after fusion), and
    # f rises along the row, so that is the largest f: a deterministic amax.
    # Dropped slots (obs < 0) all land in the sentinel column P.
    obs = torch.where(m.kf_obs >= 0, m.kf_obs, P).to(torch.int64)
    feats = torch.arange(F, dtype=torch.int32, device=dev).expand(K, F)
    feat_of = torch.zeros((K, P + 1), dtype=torch.int32, device=dev)
    feat_of.scatter_reduce_(1, obs, feats, "amax")
    # each observing keyframe adds that feature's descriptor bits to its
    # point's vote: an int32 index_add_ over observations (exact in any
    # order), a block of keyframes at a time. The reference's [K,P,256]
    # gather would take 8.6 GB at kf 1024, pt 32768.
    pt_ok = torch.cat([m.pt_valid, torch.zeros((1,), dtype=torch.bool, device=dev)])
    voter = ((torch.gather(feat_of, 1, obs) == feats) & (obs < P) & m.kf_valid[:, None]
             & pt_ok[obs])
    tgt = torch.where(voter, obs, P)
    votes = torch.zeros((P + 1, m.kf_desc.shape[-1]), dtype=torch.int32, device=dev)
    block = max(1, (1 << 26) // (F * m.kf_desc.shape[-1]))
    for k0 in range(0, K, block):
        votes.index_add_(0, tgt[k0:k0 + block].reshape(-1),
                         m.kf_desc[k0:k0 + block].reshape(-1, m.kf_desc.shape[-1]).to(torch.int32))
    desc = (votes[:P] * 2 > counts[:, None]).to(torch.uint8)
    return out._replace(pt_desc=torch.where(keep[:, None], desc, m.pt_desc))
