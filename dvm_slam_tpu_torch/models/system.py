"""System facade: the `ORB_SLAM3::System` API for single-agent use.

Port of `dvm_slam_tpu/models/system.py`:

    sys = System(settings, device="cuda")                 # monocular
    for ts, img in sequence:
        T_cw = sys.track_monocular(img, ts)
    sys.save_trajectory_tum("traj.txt")

`System(settings, sensor="stereo").track_stereo(img_l, img_r, ts)` takes a
rectified pair and `System(settings, sensor="rgbd").track_rgbd(img, depth,
ts)` an image and its registered depth in sensor units (scaled by
`camera.depth_map_factor`); both need `camera.baseline` (the reference's
`Camera.bf` / fx). A KB8 fisheye comes through `camera.model: kb8`. The
IMU modes (`sensor="imu-monocular"|"imu-stereo"|"imu-rgbd"`) take the IMU
samples since the previous frame with each frame: `track_monocular_inertial
(img, ts, acc, gyro, dts)`, `track_stereo_inertial` and `track_rgbd_inertial`
(`settings.imu`: noise, walk, rate and the camera-from-body `T_cb`); they
track on the pipelined VI lane and `is_imu_initialized` says when gravity,
velocities and (monocular) the metric scale are known.

With `vocabulary_file` (e.g. `data/voc_default.npz`) the tracker gets
relocalization and the multi-map atlas: a new map on persistent LOST and the
merge-back into a stored map on a later keyframe.

`serialize_map` gives the map packet of the multi-agent wire, and
`save_atlas`/`load_atlas` a checkpoint in the JAX package's format. With
`use_viewer` every 10th monocular frame redraws `io.viz.LiveViewer`: a live
matplotlib window where a display exists, PNG frames under `viewer_frames/`
otherwise.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Optional

import numpy as np
import torch

from ..geometry import lie
from ..io import config as config_mod
from ..io import trajectory as traj_mod
from ..loopclosing import merge as merge_mod
from ..mapping import atlas as atlas_mod
from ..mapping import local_mapping, map_state
from ..multiagent import codec, wirecodec
from ..ops import pyramid
from ..placerec import vocabulary
from ..tracking import relocalization
from ..tracking import tracker as trk
from ..utils import profiling

MONOCULAR = "monocular"
IMU_MONOCULAR = "imu-monocular"
STEREO = "stereo"
RGBD = "rgbd"
IMU_STEREO = "imu-stereo"
IMU_RGBD = "imu-rgbd"
_SENSORS = (MONOCULAR, IMU_MONOCULAR, STEREO, RGBD, IMU_STEREO, IMU_RGBD)


class System:
    """One SLAM agent on `device` with a monocular, stereo or RGB-D camera,
    with or without an IMU.
    `use_kernel` picks the hand-written kernels (None: on CUDA tensors;
    False: the plain versions), as `FrontendConfig.use_kernel` does."""

    def __init__(self, settings: "config_mod.SystemSettings | str",
                 sensor: str = MONOCULAR, agent_id: int = 0,
                 vocabulary_file: Optional[str] = None, use_viewer: bool = False,
                 device="cuda", use_kernel: Optional[bool] = None):
        if sensor not in _SENSORS:
            raise NotImplementedError(f"unknown sensor mode {sensor!r}; supported: {_SENSORS}")
        if isinstance(settings, str):
            settings = config_mod.load_settings(settings)
        self.settings = settings
        self.sensor = sensor
        self.agent_id = agent_id
        self.device = torch.device(device)
        cfg = settings.tracker_config(use_kernel)
        if sensor in (STEREO, RGBD, IMU_STEREO, IMU_RGBD):
            if settings.camera.baseline <= 0.0:
                raise ValueError("a stereo or RGB-D sensor needs camera.baseline (or the "
                                 "reference's Camera.bf) in the settings")
            cfg = dataclasses.replace(cfg, sensor=STEREO if sensor in (STEREO, IMU_STEREO)
                                      else RGBD)
        self.mapper = local_mapping.LocalMapper()
        inertial = sensor in (IMU_MONOCULAR, IMU_STEREO, IMU_RGBD)
        self.tracker = trk.MonocularTracker(
            cfg, settings.camera.K(),
            np.asarray(settings.camera.dist, np.float32), local_mapper=self.mapper,
            rng_seed=agent_id, inertial=inertial,
            imu_calib=settings.imu.calib() if inertial else None,
            T_cb=np.asarray(settings.imu.T_cb, np.float32) if inertial else None,
            device=self.device)
        self.tracker.meta.agent_id = agent_id
        self.use_viewer = use_viewer
        self.viewer = None
        self._viewer_every = 10
        if use_viewer:
            # `Viewer`/`MapDrawer`/`FrameDrawer` role: live window when a
            # display exists, PNG frame dumps otherwise (io.viz.LiveViewer)
            from ..io.viz import LiveViewer

            interactive = bool(os.environ.get("DISPLAY"))
            self.viewer = LiveViewer(out_dir=None if interactive else "viewer_frames",
                                     interactive=interactive)
        self.voc = vocabulary.load(vocabulary_file) if vocabulary_file else None
        if self.voc is not None:
            # relocalization and the multi-submap atlas (a new map on
            # persistent LOST, merge-back); a monocular map's scale is free,
            # a depth sensor's or an IMU's is fixed
            fc = settings.frontend_config(use_kernel)
            self.tracker.relocalizer = relocalization.RelocalizationService(
                self.voc, settings.camera.K(), fc.sigma2, kf_cap=settings.kf_capacity,
                device=self.device)
            self.tracker.atlas = atlas_mod.Atlas(self.voc, settings.camera.K(), fc,
                                                 agent_id=agent_id,
                                                 fix_scale=cfg.depth_sensor or inertial,
                                                 device=self.device)
        if settings.load_atlas_from_file:
            self.load_atlas(settings.load_atlas_from_file)
        # the tracking/mapping overlap: the tracker enters the autonomous
        # lane by itself once initialization is OK (monocular frames); stereo
        # and RGB-D frames take the pipelined lane, async_depth frames deep,
        # and inertial frames the pipelined VI lane
        if settings.autonomous:
            self.tracker.async_depth = int(settings.async_depth)
            if not inertial:
                self.tracker.auto_mode = True
                self.tracker.auto_batch = int(settings.auto_batch)

    # -- tracking -------------------------------------------------------

    def track_monocular(self, img, timestamp: float):
        """`System::TrackMonocular`: grayscale (or RGB, averaged) image in,
        world->camera SE3 [7] out (None before initialization). The span
        carries the number the tracker gives the frame."""
        with profiling.span("entry.track_monocular", self.tracker.n_frames + 1):
            img = self._prep(img)
            pose = self.tracker.process_image(img, timestamp)
            self._maybe_draw(img)
        return pose

    def _maybe_draw(self, img=None):
        if self.viewer is None:
            return
        if self.tracker.n_frames % self._viewer_every:
            return
        self.viewer.update(self.tracker.map, trajectory=self.tracker.trajectory[-200:], img=img)

    def track_stereo(self, img_left, img_right, timestamp: float):
        """`System::TrackStereo`: a rectified grayscale (or RGB) pair in,
        world->camera SE3 [7] out."""
        return self.tracker.process_stereo_pair(self._prep(img_left), self._prep(img_right),
                                                timestamp)

    def track_rgbd(self, img, depth_map, timestamp: float):
        """`System::TrackRGBD`: grayscale (or RGB) image and the registered
        depth in sensor units, scaled by `camera.depth_map_factor`. As in
        the reference, a resize applies to the image only."""
        depth = torch.as_tensor(np.asarray(depth_map, np.float32)).to(self.device)
        return self.tracker.process_rgbd(self._prep(img),
                                         depth * self.settings.camera.depth_map_factor,
                                         timestamp)

    def track_monocular_inertial(self, img, timestamp: float, acc, gyro, dts):
        """`System::TrackMonocular` with the IMU samples since the previous
        frame (IMU_MONOCULAR): acc [M,3] m/s^2, gyro [M,3] rad/s, dts [M] s."""
        self.tracker.grab_imu(acc, gyro, dts)
        return self.track_monocular(img, timestamp)

    def track_stereo_inertial(self, img_left, img_right, timestamp: float, acc, gyro, dts):
        """`System::TrackStereo` with the IMU samples (IMU_STEREO): the map is
        metric from the stereo depth, the IMU initialization estimates
        gravity, velocities and biases at fixed scale."""
        self.tracker.grab_imu(acc, gyro, dts)
        return self.track_stereo(img_left, img_right, timestamp)

    def track_rgbd_inertial(self, img, depth_map, timestamp: float, acc, gyro, dts):
        """`System::TrackRGBD` with the IMU samples (IMU_RGBD)."""
        self.tracker.grab_imu(acc, gyro, dts)
        return self.track_rgbd(img, depth_map, timestamp)

    def is_imu_initialized(self):
        return self.tracker.imu_initialized

    def _prep(self, img):
        """The image on the device as f32 gray; a resize to the settings'
        output size is the reference's linear resize."""
        img = torch.as_tensor(np.asarray(img) if not isinstance(img, torch.Tensor) else img)
        img = img.to(self.device)
        if img.ndim == 3:
            img = img.to(torch.float64).mean(-1)
        c = self.settings.camera
        if ((c.new_width, c.new_height) != (None, None)
                and tuple(img.shape) != (c.out_height, c.out_width)):
            img = pyramid.resize(img.to(torch.float32), c.out_height, c.out_width)
        return img.to(torch.float32)

    def get_tracking_state(self):
        return self.tracker.state

    def get_agent_id(self):
        return self.agent_id

    @property
    def map(self):
        return self.tracker.map

    # -- map exchange and checkpoint --------------------------------------

    def serialize_map(self, own_only: bool = False) -> bytes:
        """The active map as a `MapPacket` blob (`System.cc:1382-1426`), the
        keyframes this agent created only with `own_only`."""
        self.tracker.drain_auto()
        self.tracker.flush_meta()
        n = int(self.map.n_kf)
        mask = self.map.kf_valid.cpu().numpy().copy()
        mask[n:] = False
        if own_only:
            mask &= self.tracker.meta.kf_creator == self.agent_id
        return codec.extract_submap(self.map, self.tracker.meta, mask).to_bytes()

    def save_atlas(self, path: str):
        """Atlas checkpoint (`System::SaveAtlas`): the map packet, the
        tracker continuation and identity, in the typed `wirecodec` (data,
        never code), behind an md5 line that detects corruption (it does not
        authenticate). The format is the JAX package's: a checkpoint of
        either package loads in the other."""
        t = self.tracker
        state = {
            "map": self.serialize_map(own_only=False),
            "last_pose": t.last_pose.cpu().numpy(),
            "velocity": t.velocity.cpu().numpy(),
            "state": t.state,
            "kf_timestamps": t.kf_timestamps,
            "agent_id": self.agent_id,
            "trajectory": [(ts, np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p), st)
                           for ts, p, st in t.trajectory],
        }
        payload = wirecodec.dumps(state)
        with open(path, "wb") as f:
            f.write(hashlib.md5(payload).hexdigest().encode() + b"\n")
            f.write(payload)

    def load_atlas(self, path: str):
        """Restore a `save_atlas` checkpoint: the packet is spliced into the
        (empty) tracker map, so the settings' capacities hold."""
        with open(path, "rb") as f:
            digest = f.readline().strip()
            payload = f.read()
        if hashlib.md5(payload).hexdigest().encode() != digest:
            raise IOError(f"atlas checksum mismatch: {path}")
        state = wirecodec.loads(payload)
        fc = self.settings.frontend_config()
        mB, metaB = codec.materialize(codec.MapPacket.from_bytes(state["map"]), fc.capacity,
                                      device=self.device)
        t = self.tracker
        merged, meta, kf_map, _ = merge_mod.merge_maps(
            t.map, t.meta, mB, metaB, lie.sim3_identity(device=self.device))
        merged = map_state.update_point_stats(merged, fc.n_levels, fc.scale_factor)
        t.map = merged
        t.meta = meta
        t.n_kf_host = int(merged.n_kf)
        t.map_epoch += 1
        t.last_pose = torch.as_tensor(np.asarray(state["last_pose"], np.float32),
                                      device=self.device)
        t.velocity = torch.as_tensor(np.asarray(state["velocity"], np.float32),
                                     device=self.device)
        t.state = state["state"]
        t.kf_timestamps = {(int(kf_map[k]) if int(kf_map[k]) >= 0 else k): v
                           for k, v in state["kf_timestamps"].items()}
        t.trajectory = state["trajectory"]
        t.last_kf_slot = int(merged.n_kf) - 1
        t.ref_kf_tracked = 30

    # -- trajectory export -----------------------------------------------

    def save_trajectory_tum(self, path: str):
        self.tracker.drain_auto()
        traj_mod.save_tum(path, self.tracker.trajectory)

    def save_trajectory_euroc(self, path: str):
        self.tracker.drain_auto()
        traj_mod.save_euroc(path, self.tracker.trajectory)

    def save_trajectory_kitti(self, path: str):
        self.tracker.drain_auto()
        traj_mod.save_kitti(path, self.tracker.trajectory)

    def save_keyframe_trajectory_tum(self, path: str):
        """`System::SaveKeyFrameTrajectoryTUM`: keyframe poses only."""
        self.tracker.drain_auto()
        m = self.map
        n_kf = int(m.n_kf)
        kf_valid = m.kf_valid.cpu().numpy()
        rows = [(ts, m.kf_pose[slot], "KF")
                for slot, ts in sorted(self.tracker.kf_timestamps.items(), key=lambda kv: kv[1])
                if slot < n_kf and kf_valid[slot]]
        traj_mod.save_tum(path, rows)

    def shutdown(self):
        if self.settings.save_atlas_to_file:
            self.save_atlas(self.settings.save_atlas_to_file)
