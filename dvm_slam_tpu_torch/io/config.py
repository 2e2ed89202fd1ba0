"""Typed YAML settings (the reference's `Settings` class).

Port of `dvm_slam_tpu/io/config.py`: loads this framework's native YAML
layout or the reference's OpenCV-FileStorage key naming (`Camera1.fx`,
`ORBextractor.nFeatures`, ...), so a reference user's config drops in. The
dataclasses and their fields are the JAX package's, so settings cross
between the packages as `dataclasses.asdict` (`convert.py`).

`yaml` is imported inside `load_settings` only: building settings in code
needs no YAML parser.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CameraSettings:
    model: str = "pinhole"           # "pinhole" | "kb8"
    fx: float = 458.654
    fy: float = 457.296
    cx: float = 367.215
    cy: float = 248.375
    dist: tuple = (0.0, 0.0, 0.0, 0.0)   # radtan k1 k2 p1 p2 (+k3) or kb8 k1..k4
    width: int = 752
    height: int = 480
    new_width: Optional[int] = None      # optional resize
    new_height: Optional[int] = None
    fps: float = 20.0
    rgb: bool = True
    # stereo / RGB-D (`Settings::readCamera2` bf + ThDepth)
    baseline: float = 0.0            # meters (stereo) / virtual (RGB-D)
    th_depth: float = 40.0           # close-point gate = th_depth * baseline
    depth_map_factor: float = 1.0    # RGB-D raw units -> meters

    @property
    def out_width(self):
        return self.new_width or self.width

    @property
    def out_height(self):
        return self.new_height or self.height

    def K(self):
        sx = self.out_width / self.width
        sy = self.out_height / self.height
        return np.asarray([self.fx * sx, self.fy * sy, self.cx * sx, self.cy * sy],
                          np.float32)

    def params(self):
        """Full parameter vector for the camera model."""
        if self.model == "kb8":
            return np.concatenate([self.K(), np.asarray(self.dist[:4], np.float32)])
        return self.K()


@dataclasses.dataclass
class OrbSettings:
    n_features: int = 1250
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0


@dataclasses.dataclass
class ImuSettings:
    """`Settings::readIMU` fields (IMU.NoiseGyro/NoiseAcc/GyroWalk/AccWalk/
    Frequency) and the body-camera extrinsic Tbc."""
    noise_gyro: float = 1.7e-4
    noise_acc: float = 2e-3
    gyro_walk: float = 1.9e-5
    acc_walk: float = 3e-3
    frequency: float = 200.0
    # camera-from-body SE3 [qw qx qy qz tx ty tz]; identity = camera==body
    T_cb: tuple = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)

    def calib(self):
        from ..geometry.imu import ImuCalib

        return ImuCalib.create(self.noise_gyro, self.noise_acc, self.gyro_walk, self.acc_walk,
                               self.frequency)


@dataclasses.dataclass
class SystemSettings:
    camera: CameraSettings = dataclasses.field(default_factory=CameraSettings)
    orb: OrbSettings = dataclasses.field(default_factory=OrbSettings)
    imu: ImuSettings = dataclasses.field(default_factory=ImuSettings)
    save_atlas_to_file: Optional[str] = None
    load_atlas_from_file: Optional[str] = None
    kf_capacity: int = 512
    pt_capacity: int = 16384
    viewer: dict = dataclasses.field(default_factory=dict)
    # the tracking/mapping overlap of the reference's threads: after
    # initialization the tracker runs `autonomous_step` on `auto_batch`
    # frames at a time, bookkeeping retires up to `async_depth` frames late
    autonomous: bool = True
    auto_batch: int = 4
    async_depth: int = 8

    def frontend_config(self, use_kernel=None):
        from ..frontend.extractor import FrontendConfig

        return FrontendConfig(
            height=self.camera.out_height, width=self.camera.out_width,
            n_features=self.orb.n_features, n_levels=self.orb.n_levels,
            scale_factor=self.orb.scale_factor,
            ini_th=self.orb.ini_th_fast, min_th=self.orb.min_th_fast,
            use_kernel=use_kernel,
        )

    def tracker_config(self, use_kernel=None):
        from ..tracking.tracker import TrackerConfig

        return TrackerConfig(
            frontend=self.frontend_config(use_kernel),
            kf_cap=self.kf_capacity, pt_cap=self.pt_capacity,
            fps=self.camera.fps,
            camera_model=self.camera.model,
            baseline=self.camera.baseline,
            th_depth_ratio=self.camera.th_depth,
        )


def _get(d, *keys, default=None):
    for k in keys:
        if k in d:
            return d[k]
    return default


def load_settings(path: str) -> SystemSettings:
    import yaml

    with open(path) as f:
        text = f.read()
    # OpenCV FileStorage yaml begins with %YAML:1.0, which pyyaml rejects
    text = text.replace("%YAML:1.0", "").replace("!!opencv-matrix", "")
    raw = yaml.safe_load(text) or {}
    return settings_from_dict(raw)


def settings_from_dict(raw: dict) -> SystemSettings:
    s = SystemSettings()
    if "camera" in raw:  # native layout
        s.camera = CameraSettings(**raw["camera"])
        if "orb" in raw:
            s.orb = OrbSettings(**raw["orb"])
        s.save_atlas_to_file = raw.get("save_atlas_to_file")
        s.load_atlas_from_file = raw.get("load_atlas_from_file")
        s.kf_capacity = raw.get("kf_capacity", s.kf_capacity)
        s.pt_capacity = raw.get("pt_capacity", s.pt_capacity)
        s.viewer = raw.get("viewer", {})
        return s

    # reference-style flat keys ("Camera1.fx", "ORBextractor.nFeatures", ...)
    flat = raw
    cam_type = str(_get(flat, "Camera.type", "File.type", default="PinHole"))
    model = "kb8" if "kannala" in cam_type.lower() or "fisheye" in cam_type.lower() else "pinhole"
    cam = CameraSettings(
        model=model,
        fx=float(_get(flat, "Camera1.fx", "Camera.fx", default=458.654)),
        fy=float(_get(flat, "Camera1.fy", "Camera.fy", default=457.296)),
        cx=float(_get(flat, "Camera1.cx", "Camera.cx", default=367.215)),
        cy=float(_get(flat, "Camera1.cy", "Camera.cy", default=248.375)),
        width=int(_get(flat, "Camera.width", default=752)),
        height=int(_get(flat, "Camera.height", default=480)),
        fps=float(_get(flat, "Camera.fps", default=20.0)),
        rgb=bool(_get(flat, "Camera.RGB", default=1)),
    )
    # `Camera.bf` is fx * baseline in the reference; store the baseline
    bf = _get(flat, "Camera.bf", "Stereo.b", default=None)
    if bf is not None:
        b = float(bf)
        cam.baseline = b / cam.fx if b > 1e-2 * cam.fx else b
    cam.th_depth = float(_get(flat, "Stereo.ThDepth", "ThDepth", default=40.0))
    dmf = _get(flat, "RGBD.DepthMapFactor", "DepthMapFactor", default=None)
    if dmf is not None and float(dmf) != 0.0:
        cam.depth_map_factor = 1.0 / float(dmf)
    if model == "kb8":
        cam.dist = tuple(float(_get(flat, f"Camera1.k{i}", default=0.0)) for i in (1, 2, 3, 4))
    else:
        cam.dist = (
            float(_get(flat, "Camera1.k1", "Camera.k1", default=0.0)),
            float(_get(flat, "Camera1.k2", "Camera.k2", default=0.0)),
            float(_get(flat, "Camera1.p1", "Camera.p1", default=0.0)),
            float(_get(flat, "Camera1.p2", "Camera.p2", default=0.0)),
            float(_get(flat, "Camera1.k3", "Camera.k3", default=0.0)),
        )
    nw = _get(flat, "Camera.newWidth", default=None)
    nh = _get(flat, "Camera.newHeight", default=None)
    cam.new_width = int(nw) if nw else None
    cam.new_height = int(nh) if nh else None
    s.camera = cam
    s.orb = OrbSettings(
        n_features=int(_get(flat, "ORBextractor.nFeatures", default=1250)),
        scale_factor=float(_get(flat, "ORBextractor.scaleFactor", default=1.2)),
        n_levels=int(_get(flat, "ORBextractor.nLevels", default=8)),
        ini_th_fast=float(_get(flat, "ORBextractor.iniThFAST", default=20)),
        min_th_fast=float(_get(flat, "ORBextractor.minThFAST", default=7)),
    )
    s.save_atlas_to_file = _get(flat, "System.SaveAtlasToFile", default=None)
    s.load_atlas_from_file = _get(flat, "System.LoadAtlasFromFile", default=None)
    imu = ImuSettings(
        noise_gyro=float(_get(flat, "IMU.NoiseGyro", default=1.7e-4)),
        noise_acc=float(_get(flat, "IMU.NoiseAcc", default=2e-3)),
        gyro_walk=float(_get(flat, "IMU.GyroWalk", default=1.9e-5)),
        acc_walk=float(_get(flat, "IMU.AccWalk", default=3e-3)),
        frequency=float(_get(flat, "IMU.Frequency", default=200.0)),
    )
    tbc = _get(flat, "IMU.T_b_c1", "Tbc", default=None)
    if tbc is not None and isinstance(tbc, dict) and "data" in tbc:
        import torch

        from ..geometry import lie

        M = torch.as_tensor(np.asarray(tbc["data"], np.float32).reshape(4, 4))
        # T_b_c: camera -> body; store camera-from-body, its inverse
        T_bc = torch.cat([lie.quat_from_matrix(M[:3, :3]), M[:3, 3]])
        imu.T_cb = tuple(float(x) for x in lie.se3_inv(T_bc))
    s.imu = imu
    return s
