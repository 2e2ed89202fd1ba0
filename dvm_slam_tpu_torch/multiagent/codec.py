"""Map wire codec: flat-array submap packets.

Replaces the reference's boost binary archives of pruned `Map` objects
(`Atlas::SerializeMap`, `Atlas.cc:325-346`; pruning in
`OrbSlam3Wrapper::sendNewKeyFrames`, `orb_slam3_wrapper.cpp:252-298`): a
submap is a set of numpy arrays (keyframes with their feature tables and
uuid-labelled observations, plus the map points they observe), serialized as
a little-endian blob and zlib-compressed.

Port of `dvm_slam_tpu/multiagent/codec.py`: `pack_arrays`,
`unpack_arrays`, `MapPacket` and the bit packing are copies, so
`MapPacket.to_bytes()` is byte-identical between the packages for the same
map and a packet from either loads in the other; `extract_submap` reads
the port's `MapState` (tensors on any device) and `materialize` builds one
on a given device.

Blob layout (all little-endian):
  magic  u32 = 0x44564D31 ("DVM1")
  n_arrays u32
  per array: name_len u8, name bytes, dtype_code u8, ndim u8, dims u32[ndim],
             payload bytes (C order)
  ... then the whole thing zlib-compressed with a u64 raw-size prefix.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import NamedTuple

import numpy as np
import torch

MAGIC = 0x44564D31

_DTYPES = {
    0: np.dtype("<u1"), 1: np.dtype("<i4"), 2: np.dtype("<f4"),
    3: np.dtype("<u8"), 4: np.dtype("<i8"), 5: np.dtype("bool"),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}


def pack_arrays(arrays: dict) -> bytes:
    buf = io.BytesIO()
    buf.write(struct.pack("<II", MAGIC, len(arrays)))
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        dt = np.dtype(arr.dtype).newbyteorder("<") if arr.dtype != bool else np.dtype("bool")
        code = _DTYPE_CODES[np.dtype(dt)]
        nb = name.encode()
        buf.write(struct.pack("<B", len(nb)))
        buf.write(nb)
        buf.write(struct.pack("<BB", code, arr.ndim))
        for d in arr.shape:
            buf.write(struct.pack("<I", d))
        buf.write(arr.astype(dt, copy=False).tobytes())
    raw = buf.getvalue()
    return struct.pack("<Q", len(raw)) + zlib.compress(raw, 6)


def unpack_arrays(blob: bytes) -> dict:
    if len(blob) < 12:
        raise ValueError("corrupt packet: too short")
    (rawlen,) = struct.unpack_from("<Q", blob, 0)
    # rawlen is attacker-controlled: bound it before decompressing (mirrors
    # native/mapcodec.cpp dvm_unpack_raw) so a hostile prefix can't demand an
    # unbounded allocation (decompression bomb).
    if rawlen < 8 or rawlen > (len(blob) - 8) * 1024 or rawlen > (1 << 32):
        raise ValueError("corrupt packet: bogus raw length")
    d = zlib.decompressobj()
    try:
        raw = d.decompress(blob[8:], rawlen)
        # over-long streams leave unprocessed compressed input in
        # unconsumed_tail (d.decompress(b"", 1) alone would NOT re-feed it,
        # silently truncating); re-feeding surfaces any extra bytes
        extra = d.decompress(d.unconsumed_tail, 1) if d.unconsumed_tail else b""
    except zlib.error as e:
        raise ValueError(f"corrupt packet: {e}") from None
    if len(raw) != rawlen or extra or d.decompress(b"", 1):
        raise ValueError("corrupt packet: length mismatch")
    # hostile/corrupt/version-skewed input must surface as ValueError (the
    # one documented failure type callers handle), not leak struct.error /
    # KeyError / UnicodeDecodeError from the parse internals
    try:
        off = 0
        magic, n = struct.unpack_from("<II", raw, off)
        if magic != MAGIC:
            raise ValueError("corrupt packet: bad magic")
        off += 8
        out = {}
        for _ in range(n):
            (nlen,) = struct.unpack_from("<B", raw, off)
            off += 1
            name = raw[off:off + nlen].decode()
            off += nlen
            code, ndim = struct.unpack_from("<BB", raw, off)
            off += 2
            dims = struct.unpack_from(f"<{ndim}I", raw, off)
            off += 4 * ndim
            if code not in _DTYPES:
                raise ValueError(f"corrupt packet: unknown dtype {code}")
            dt = _DTYPES[code]
            count = int(np.prod(dims)) if ndim else 1
            arr = np.frombuffer(raw, dtype=dt, count=count,
                                offset=off).reshape(dims)
            off += arr.nbytes
            out[name] = arr.copy()
        return out
    except (struct.error, UnicodeDecodeError, OverflowError) as e:
        raise ValueError(f"corrupt packet: {e}") from None


class MapPacket(NamedTuple):
    """Decoded submap: keyframes + the points they observe, uuid-labelled."""

    kf_uuid: np.ndarray     # [k,2] u64
    kf_creator: np.ndarray  # [k] i32
    kf_pose: np.ndarray     # [k,7] f32
    kf_xy: np.ndarray       # [k,F,2] f32
    kf_level: np.ndarray    # [k,F] u8
    kf_angle: np.ndarray    # [k,F] f32
    kf_desc: np.ndarray     # [k,F,32] u8 packed
    kf_feat_valid: np.ndarray  # [k,F] bool
    kf_obs: np.ndarray      # [k,F] i4 -> index into packet points, -1
    kf_ur: np.ndarray       # [k,F] f32 stereo right-u, -1 = mono obs
    pt_uuid: np.ndarray     # [p,2] u64
    pt_creator: np.ndarray  # [p] i32
    pt_pos: np.ndarray      # [p,3] f32
    pt_desc: np.ndarray     # [p,32] u8 packed
    pt_normal: np.ndarray   # [p,3] f32
    pt_min_dist: np.ndarray  # [p] f32
    pt_max_dist: np.ndarray  # [p] f32
    pt_ref_kf: np.ndarray   # [p] i4 -> index into packet kfs, -1

    def to_bytes(self) -> bytes:
        return pack_arrays(self._asdict())

    @staticmethod
    def from_bytes(blob: bytes) -> "MapPacket":
        d = unpack_arrays(blob)
        # wire compat: packets from mono-only senders lack kf_ur; packets
        # from NEWER senders may carry extra arrays — ignore those instead
        # of crashing on an unexpected ctor kwarg
        if "kf_ur" not in d and "kf_obs" in d:
            d["kf_ur"] = np.full(d["kf_obs"].shape, -1.0, np.float32)
        missing = [f for f in MapPacket._fields if f not in d]
        if missing:
            raise ValueError(f"corrupt packet: missing arrays {missing}")
        return MapPacket(**{f: d[f] for f in MapPacket._fields})

    @property
    def n_kf(self):
        return self.kf_uuid.shape[0]

    @property
    def n_pt(self):
        return self.pt_uuid.shape[0]


def _pack_bits(bits):
    """[...,256] {0,1} -> [...,32] u8."""
    b = np.asarray(bits, np.uint8).reshape(*bits.shape[:-1], 32, 8)
    return (b << np.arange(8, dtype=np.uint8)).sum(-1).astype(np.uint8)


def _unpack_bits(packed):
    b = (np.asarray(packed, np.uint8)[..., None] >> np.arange(8, dtype=np.uint8)) & 1
    return b.reshape(*packed.shape[:-1], 256).astype(np.uint8)


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def extract_submap(m, meta, kf_mask) -> MapPacket:
    """Build a packet from the keyframes selected by kf_mask [K] plus every
    point any of them observes (prune semantics of `sendNewKeyFrames` /
    `deepCopyMap`, `orb_slam3_wrapper.cpp:252-298,1013-1055`)."""
    kf_mask = _host(kf_mask).astype(bool)
    kf_idx = np.nonzero(kf_mask)[0]
    sel = torch.as_tensor(kf_idx, device=m.kf_obs.device)
    obs = _host(m.kf_obs[sel])                                # [k,F]
    pt_valid = _host(m.pt_valid)
    pt_sel = np.unique(obs[obs >= 0])
    pt_sel = pt_sel[pt_valid[pt_sel]]
    pt_inv = np.full(pt_valid.shape[0] + 1, -1, np.int32)
    pt_inv[pt_sel] = np.arange(len(pt_sel), dtype=np.int32)

    kf_inv = np.full(m.kf_capacity, -1, np.int32)
    kf_inv[kf_idx] = np.arange(len(kf_idx), dtype=np.int32)

    obs_local = np.where(obs >= 0, pt_inv[np.clip(obs, 0, None)], -1).astype(np.int32)
    psel = torch.as_tensor(pt_sel, device=m.pt_pos.device)
    ref = _host(m.pt_ref_kf[psel])
    ref_local = np.where(ref >= 0, kf_inv[np.clip(ref, 0, None)], -1).astype(np.int32)

    return MapPacket(
        kf_uuid=meta.kf_uuid[kf_idx].astype(np.uint64),
        kf_creator=meta.kf_creator[kf_idx].astype(np.int32),
        kf_pose=_host(m.kf_pose[sel]).astype(np.float32),
        kf_xy=_host(m.kf_xy[sel]).astype(np.float32),
        kf_level=_host(m.kf_level[sel]).astype(np.uint8),
        kf_angle=_host(m.kf_angle[sel]).astype(np.float32),
        kf_desc=_pack_bits(_host(m.kf_desc[sel])),
        kf_feat_valid=_host(m.kf_feat_valid[sel]),
        kf_obs=obs_local,
        kf_ur=_host(m.kf_ur[sel]).astype(np.float32),
        pt_uuid=meta.pt_uuid[pt_sel].astype(np.uint64),
        pt_creator=meta.pt_creator[pt_sel].astype(np.int32),
        pt_pos=_host(m.pt_pos[psel]).astype(np.float32),
        pt_desc=_pack_bits(_host(m.pt_desc[psel])),
        pt_normal=_host(m.pt_normal[psel]).astype(np.float32),
        pt_min_dist=_host(m.pt_min_dist[psel]).astype(np.float32),
        pt_max_dist=_host(m.pt_max_dist[psel]).astype(np.float32),
        pt_ref_kf=ref_local,
    )


def materialize(packet: MapPacket, feat_cap: int, device=None):
    """Packet -> (MapState sized to the packet on `device`, MapMeta): a
    self-contained foreign map fragment for `merge.merge_maps` (uuid relink,
    `Map.cc:420+`). A peer with a smaller feature budget is padded to
    `feat_cap`; a larger one raises ValueError."""
    from ..mapping import map_state

    k, p = packet.n_kf, max(packet.n_pt, 1)
    F = packet.kf_xy.shape[1]
    if F > feat_cap:
        raise ValueError(f"packet feature capacity {F} exceeds local {feat_cap}")

    def padf(a, fill):
        """Pad the feature axis to the local capacity (`splice_map` needs
        matching [*, feat_cap, ...] shapes)."""
        if F == feat_cap:
            return a
        shape = (a.shape[0], feat_cap - F) + a.shape[2:]
        return np.concatenate([a, np.full(shape, fill, a.dtype)], axis=1)

    def t(a, dtype=None):
        out = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return out if dtype is None else out.to(dtype)

    m = map_state.create(max(k, 1), p, feat_cap, device=device)
    i32 = torch.int32
    if k:
        m = m._replace(
            kf_pose=t(packet.kf_pose),
            kf_valid=torch.ones((k,), dtype=torch.bool, device=device),
            kf_xy=t(padf(packet.kf_xy, 0)),
            kf_level=t(padf(packet.kf_level.astype(np.int32), 0), m.kf_level.dtype),
            kf_angle=t(padf(packet.kf_angle, 0)),
            kf_desc=t(padf(_unpack_bits(packet.kf_desc), 0), m.kf_desc.dtype),
            kf_feat_valid=t(padf(packet.kf_feat_valid, False)),
            kf_obs=t(padf(packet.kf_obs, -1), i32),
            kf_ur=t(padf(packet.kf_ur, -1.0)),
            n_kf=torch.tensor(k, dtype=i32, device=device),
        )
    if packet.n_pt:
        m = m._replace(
            pt_pos=t(packet.pt_pos),
            pt_valid=torch.ones((packet.n_pt,), dtype=torch.bool, device=device),
            pt_desc=t(_unpack_bits(packet.pt_desc), m.pt_desc.dtype),
            pt_normal=t(packet.pt_normal),
            pt_min_dist=t(packet.pt_min_dist),
            pt_max_dist=t(packet.pt_max_dist),
            pt_ref_kf=t(packet.pt_ref_kf, i32),
            pt_first_kf=t(packet.pt_ref_kf, i32),
            n_pt=torch.tensor(packet.n_pt, dtype=i32, device=device),
        )
    meta = map_state.MapMeta.create(max(k, 1), p, agent_id=-1)
    if k:
        meta.kf_uuid[:k] = packet.kf_uuid
        meta.kf_creator[:k] = packet.kf_creator
    if packet.n_pt:
        meta.pt_uuid[:packet.n_pt] = packet.pt_uuid
        meta.pt_creator[:packet.n_pt] = packet.pt_creator
    return m, meta
