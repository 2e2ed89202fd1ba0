"""Exchange of state between the JAX package and the port.

The port carries no weights; what crosses is the map and its metadata,
frames, the tracker's state and the settings.
Both packages use the same field names, dtypes and shapes, so a JAX
`MapState` or `Frame` given as a dict of numpy arrays (`x._asdict()` with
each leaf passed through `np.asarray`) becomes the port's NamedTuple of
tensors and back, and a `TrackerConfig` crosses as the dict of
`dataclasses.asdict`. The JAX front end's `use_pallas` maps to the port's
`use_kernel`. `autonomous_step`'s `mapper_cfg` is a plain tuple of Python
numbers in both packages and crosses as it is. `SystemSettings` crosses as
`dataclasses.asdict`, `MapMeta` as a dict of numpy arrays, and the host
state of a `MonocularTracker` as the dict `tracker_host_state_to_numpy`
reads from either package's tracker. Place recognition crosses too: a
`Vocabulary` as the dict of its numpy fields, a `BowDatabase` and a
`Sim3Result` as dicts of numpy arrays, and a stored atlas map (`StoredMap`:
map, meta, database, covisibility, keyframe timestamps) as a dict of those.
The agents' batch axis (`parallel/multi_agent.py`) crosses the same way:
a `MeshProtocolState` as a dict of numpy arrays, and MapStates or protocol
states stacked on a leading agent axis (the reference's `stack_agents`)
field by field with that axis, through the same functions. The inertial
types cross the same way: a `Preintegrated` (one or stacked on a leading
axis), a `ViWindow` and an `ImuState` as dicts of numpy arrays, an
`ImuCalib` as its four floats; the tracker's host state carries its
inertial members (the keyframe chain, its preintegrations, velocities and
biases, the pending IMU chunks) when the tracker has them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .frontend.extractor import Frame, FrontendConfig
from .geometry.imu import ImuCalib, Preintegrated
from .io import config
from .mapping.atlas import StoredMap
from .mapping.inertial import ImuState
from .mapping.map_state import MapMeta, MapState
from .parallel.multi_agent import MeshProtocolState
from .placerec.database import BowDatabase
from .placerec.vocabulary import Vocabulary
from .mapping.vi_ba import ViWindow
from .tracking.tracker import AutoState, TrackerConfig


def _to_tensors(cls, arrays: dict, device):
    return cls(**{k: None if v is None else torch.from_numpy(np.array(v)).to(device)
                  for k, v in arrays.items()})


def _to_numpy(nt) -> dict:
    return {k: None if v is None else v.detach().cpu().numpy() for k, v in nt._asdict().items()}


def map_state_from_numpy(arrays: dict, device=None) -> MapState:
    return _to_tensors(MapState, arrays, device)


def map_state_to_numpy(m: MapState) -> dict:
    return _to_numpy(m)


def protocol_state_from_numpy(arrays: dict, device=None) -> MeshProtocolState:
    return _to_tensors(MeshProtocolState, arrays, device)


def protocol_state_to_numpy(st: MeshProtocolState) -> dict:
    return _to_numpy(st)


def frame_from_numpy(arrays: dict, device=None) -> Frame:
    return _to_tensors(Frame, arrays, device)


def frame_to_numpy(f: Frame) -> dict:
    return _to_numpy(f)


def auto_state_from_numpy(arrays: dict, device=None) -> AutoState:
    return _to_tensors(AutoState, arrays, device)


def auto_state_to_numpy(st: AutoState) -> dict:
    return _to_numpy(st)


def preintegrated_from_numpy(arrays: dict, device=None) -> Preintegrated:
    return _to_tensors(Preintegrated, arrays, device)


def preintegrated_to_numpy(p) -> dict:
    """A `Preintegrated` of either package as a dict of numpy arrays."""
    return {k: _np(v) for k, v in p._asdict().items()}


def imu_calib_from_numpy(arrays: dict) -> ImuCalib:
    return ImuCalib(**{k: float(np.float32(v)) for k, v in arrays.items()})


def imu_calib_to_numpy(c) -> dict:
    return {k: np.float32(_np(v)) for k, v in c._asdict().items()}


def vi_window_from_numpy(arrays: dict, device=None) -> ViWindow:
    return _to_tensors(ViWindow, arrays, device)


def vi_window_to_numpy(w) -> dict:
    return {k: _np(v) for k, v in w._asdict().items()}


def imu_state_from_numpy(arrays: dict, device=None) -> ImuState:
    return _to_tensors(ImuState, arrays, device)


def imu_state_to_numpy(s) -> dict:
    return {k: _np(v) for k, v in s._asdict().items()}


def tracker_config_from_dict(d: dict) -> TrackerConfig:
    fe = dict(d["frontend"])
    fe["use_kernel"] = fe.pop("use_pallas", fe.get("use_kernel"))
    return TrackerConfig(**{**d, "frontend": FrontendConfig(**fe)})


def tracker_config_to_dict(cfg: TrackerConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d["frontend"]["use_pallas"] = d["frontend"].pop("use_kernel")
    return d


def map_meta_from_numpy(arrays: dict) -> MapMeta:
    return MapMeta(**{k: v if k == "agent_id" else np.array(v) for k, v in arrays.items()})


def map_meta_to_numpy(meta) -> dict:
    return {k: getattr(meta, k) if k == "agent_id" else np.array(getattr(meta, k))
            for k in ("kf_uuid", "pt_uuid", "kf_creator", "pt_creator", "agent_id")}


def system_settings_from_dict(d: dict) -> config.SystemSettings:
    """The port's `SystemSettings` from the JAX package's `dataclasses.asdict`."""
    return config.SystemSettings(**{
        **d, "camera": config.CameraSettings(**d["camera"]),
        "orb": config.OrbSettings(**d["orb"]), "imu": config.ImuSettings(**d["imu"])})


_HOST_STATE = ("last_pose", "velocity", "frames_since_kf", "ref_kf_tracked", "state",
               "n_kf_host", "last_kf_slot", "kf_timestamps")
_VI_HOST_STATE = ("imu_initialized", "vel_w", "bias_g", "bias_a", "kf_chain", "kf_preint",
                  "kf_vel", "kf_bias", "_imu_kf", "_imu_frame", "_imu_seq", "_last_good_ts")


def _chunks(chunks):
    return [tuple(np.array(c, np.float32) for c in ch) for ch in chunks]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tracker_host_state_to_numpy(t) -> dict:
    """The host state of a `MonocularTracker` of either package: poses as
    numpy [7], counters as ints, the state name, keyframe timestamps."""
    d = {
        "last_pose": _np(t.last_pose), "velocity": _np(t.velocity),
        "frames_since_kf": int(t.frames_since_kf), "ref_kf_tracked": int(t.ref_kf_tracked),
        "state": t.state, "n_kf_host": int(t.n_kf_host), "last_kf_slot": int(t.last_kf_slot),
        "kf_timestamps": dict(t.kf_timestamps),
    }
    if getattr(t, "inertial", False):
        d.update(
            imu_initialized=bool(t.imu_initialized), vel_w=np.array(_np(t.vel_w), np.float32),
            bias_g=np.array(_np(t.bias_g), np.float32),
            bias_a=np.array(_np(t.bias_a), np.float32), kf_chain=[int(s) for s in t.kf_chain],
            kf_preint={int(s): preintegrated_to_numpy(p) for s, p in t.kf_preint.items()},
            kf_vel={int(s): np.array(_np(v), np.float32) for s, v in t.kf_vel.items()},
            kf_bias={int(s): (np.array(_np(bg), np.float32), np.array(_np(ba), np.float32))
                     for s, (bg, ba) in t.kf_bias.items()},
            _imu_kf=_chunks(t._imu_kf), _imu_frame=_chunks(t._imu_frame),
            _imu_seq=int(t._imu_seq), _last_good_ts=t._last_good_ts)
    return d


def tracker_host_state_from_numpy(t, d: dict):
    """Write a host state (`tracker_host_state_to_numpy`) into the port's
    tracker `t`; poses go to the tracker's device."""
    for k in _HOST_STATE:
        v = d[k]
        if k in ("last_pose", "velocity"):
            v = torch.as_tensor(np.asarray(v, np.float32), device=t.device)
        elif k == "kf_timestamps":
            v = dict(v)
        setattr(t, k, v)
    if "imu_initialized" not in d:
        return
    for k in _VI_HOST_STATE:
        v = d[k]
        if k == "kf_preint":
            v = {int(s): preintegrated_from_numpy(p, t.device) for s, p in v.items()}
        elif k in ("vel_w", "bias_g", "bias_a"):
            v = np.array(v, np.float32)
        elif k == "kf_vel":
            v = {int(s): np.array(x, np.float32) for s, x in v.items()}
        elif k == "kf_bias":
            v = {int(s): (np.array(bg, np.float32), np.array(ba, np.float32))
                 for s, (bg, ba) in v.items()}
        elif k in ("_imu_kf", "_imu_frame"):
            v = _chunks(v)
        elif k == "kf_chain":
            v = list(v)
        setattr(t, k, v)


def vocabulary_to_numpy(voc) -> dict:
    """The fields of either package's `Vocabulary`, as numpy."""
    return {"levels": [np.array(lv) for lv in voc.levels], "idf": np.array(voc.idf),
            "branch": int(voc.branch), "depth": int(voc.depth)}


def vocabulary_from_numpy(d: dict) -> Vocabulary:
    return Vocabulary(levels=[np.array(lv) for lv in d["levels"]], idf=np.array(d["idf"]),
                      branch=int(d["branch"]), depth=int(d["depth"]))


def bow_database_from_numpy(arrays: dict, device=None) -> BowDatabase:
    return _to_tensors(BowDatabase, arrays, device)


def bow_database_to_numpy(db) -> dict:
    return {k: _np(v) for k, v in db._asdict().items()}


def sim3_result_to_numpy(res) -> dict:
    """A `Sim3Result` of either package: ok as bool, counts as ints, S_ab
    as numpy [8]."""
    return {"ok": bool(_np(res.ok)), "S_ab": _np(res.S_ab), "n_inliers": int(_np(res.n_inliers)),
            "n_proj": int(_np(res.n_proj))}


def stored_map_to_numpy(sm) -> dict:
    """A stored atlas map of either package as numpy dicts."""
    return {"m": {k: _np(v) for k, v in sm.m._asdict().items()},
            "meta": map_meta_to_numpy(sm.meta),
            "db": bow_database_to_numpy(sm.db),
            "covis": None if sm.covis is None else _np(sm.covis),
            "kf_timestamps": dict(sm.kf_timestamps)}


def stored_map_from_numpy(d: dict, device=None) -> StoredMap:
    return StoredMap(
        m=map_state_from_numpy(d["m"], device), meta=map_meta_from_numpy(d["meta"]),
        db=bow_database_from_numpy(d["db"], device), kf_timestamps=dict(d["kf_timestamps"]),
        covis=None if d["covis"] is None else torch.from_numpy(np.array(d["covis"])).to(device))
