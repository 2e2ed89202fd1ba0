"""Exchange of state between the JAX package and the port.

The port carries no weights; what crosses is the map, frames, the
autonomous tracker state and configs.
Both packages use the same field names, dtypes and shapes, so a JAX
`MapState` or `Frame` given as a dict of numpy arrays (`x._asdict()` with
each leaf passed through `np.asarray`) becomes the port's NamedTuple of
tensors and back, and a `TrackerConfig` crosses as the dict of
`dataclasses.asdict`. The JAX front end's `use_pallas` maps to the port's
`use_kernel`. `autonomous_step`'s `mapper_cfg` is a plain tuple of Python
numbers in both packages and crosses as it is.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .frontend.extractor import Frame, FrontendConfig
from .mapping.map_state import MapState
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


def frame_from_numpy(arrays: dict, device=None) -> Frame:
    return _to_tensors(Frame, arrays, device)


def frame_to_numpy(f: Frame) -> dict:
    return _to_numpy(f)


def auto_state_from_numpy(arrays: dict, device=None) -> AutoState:
    return _to_tensors(AutoState, arrays, device)


def auto_state_to_numpy(st: AutoState) -> dict:
    return _to_numpy(st)


def tracker_config_from_dict(d: dict) -> TrackerConfig:
    fe = dict(d["frontend"])
    fe["use_kernel"] = fe.pop("use_pallas", fe.get("use_kernel"))
    return TrackerConfig(**{**d, "frontend": FrontendConfig(**fe)})


def tracker_config_to_dict(cfg: TrackerConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d["frontend"]["use_pallas"] = d["frontend"].pop("use_kernel")
    return d
