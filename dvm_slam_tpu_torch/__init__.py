"""dvm_slam_tpu_torch — the PyTorch/CUDA port of `dvm_slam_tpu`.

The JAX package stays the reference; this package mirrors its layout so each
counterpart is found by path and name:

  geometry/   SO3/SE3 Lie groups, pinhole + radial-tangential cameras,
              two-view DLT triangulation
  ops/        pyramid, FAST + grid top-k, ORB orientation + steered BRIEF
              (plain PyTorch twin beside the hand-written CUDA kernel in
              `ops/orb_kernel.py` + `csrc/orb_describe.cu`), Hamming and
              epipolar matching, RGB-D keypoint depth, BA's adjoint scatter
              and point gather (plain versions in `ops/scatter.py`, CUDA
              kernels in `ops/scatter_kernel.py` + `csrc/onehot_scatter.cu`)
  frontend/   `Frame` construction (`make_frame`, `make_frame_rgbd`)
  mapping/    struct-of-arrays `MapState`, the per-keyframe mapper chain
              (cull, triangulate, fuse, windowed BA), global BA, the atlas
  tracking/   pose-only Gauss-Newton, two-stage tracking by projection, the
              full per-frame step `autonomous_step`, relocalization
  placerec/   BoW vocabulary and keyframe database
  loopclosing/ Sim3 solver, map merging, loop detection, essential graph
  multiagent/ `SlamAgent`, the map codec, typed wire and transports
  models/     the `System` facade (and its viewer)
  io/         synthetic textured-plane world, settings, trajectories, the
              dataset loaders over the port's own PNG reader (`png.py`),
              frame recording, the kinematic robot sim, viz exports and the
              matplotlib viewer
  control/    velocity driver, follow-the-leader and NMPC controllers
  tools/      the operator console, `plot_run`, `train_vocab`
  utils/      leveled logging, `StageTimer`

Port-only glue: `device.py` (precision policy), `convert.py` (numpy-dict
exchange of map, frame and config with the JAX package) and `_build.py`
(nvcc build of the CUDA sources at first use).

Importing this package never imports JAX.
"""

__version__ = "0.1.0"

from . import device  # noqa: F401  (sets the f32 precision policy)
