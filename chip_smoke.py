#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`dvm_slam_tpu_torch`) on one NVIDIA
card.

Drives the port's main paths at EuRoC geometry (480x752, 1250 features, 8
levels, kf_cap 128, pt_cap 8192) on a rendered synthetic sequence: slice 1,
ORB extraction plus two-stage map tracking (`make_and_track`), slice 2,
the full SLAM step `autonomous_step` (track, keyframe decision, and for a new
keyframe the mapper chain: cull, triangulate, fuse, point stats, windowed BA
with `LocalMapper(5, ba_local=12, ba_fixed=8, ba_pts=4096, ba_iters=6)`),
slice 3, the `System` facade from the first frame (monocular two-view
initialization, the tracker's state machine, the saved trajectory), and
slice 6, the same facade with the shipped vocabulary (`System(...,
vocabulary_file="data/voc_default.npz")`): relocalization after a blackout,
and the multi-map atlas (a new map on persistent LOST, merged back into the
stored one on a revisit), and slice 7, two decentralized `SlamAgent`s that
merge their maps, and the `System` checkpoint, and slice 8, agents as a
batch axis on the card (`parallel/multi_agent.py`: the batched BA, the
per-frame agent step, the protocol round) and three agents merging through
the native map codec, and slice 9, the other cameras through their `System`
entry points: a stereo rig at KITTI width, an RGB-D camera at TUM width
and a KB8 fisheye at TUM-VI width, and slice 10, the inertial modes (a
monocular camera, a stereo rig and an RGB-D camera, each with an IMU) and
the inertial merge, and slice 11, the operator console's two-agent run on
the one real sequence in the repository.
Three hand-written kernels: K1 (fused ORB orientation + steered BRIEF,
`csrc/orb_describe.cu`), K2 (BA adjoint scatter) and K3 (BA point gather,
both `csrc/onehot_scatter.cu`). Phases, in order; any failure raises and the
run exits non-zero:

1. require a CUDA card; print its name and power limit;
2. build the kernels from the checkout's sources with nvcc, both sources at
   once; K1's build seconds and ptxas report;
3. K1, one launch for a whole frame, against its plain twin: on all 8
   levels of frame 0 at the keypoints `detect_level` chose, and on an
   adversarial frame (levels of odd sizes down to 31 rows, keypoints at the
   corners, the detection border, half pixels and outside the image, the
   invalid slots `detect_level` leaves, a level with no valid keypoint and a
   level with no slot): 0 differing descriptor bits, angles within 1e-6;
4. slice 1 with the kernel: depth bootstrap from frame 0, then 29 frames
   of motion-model tracking; every frame >= 15 inliers and a translation
   error under 3x the JAX package's CPU reference run of the same frames;
   K1 launched once per extracted frame;
5. slice 1 with `use_kernel=False` over its first N_PLAIN1 tracked frames:
   identical inliers, poses to 1e-4;
6. slice 1 timing: make_and_track latency per frame over phase 4's
   frames (phase 15 times the twin);
7. K2/K3's build seconds and ptxas report;
8. K2 and K3 at BA's shapes (G=30, F=512, P=4096) and windows L = 8, 20,
   32, on five adversarial index sets (random; a row's features all in one
   column tile; rows of -1; indices -1, 0, P-1, P, P+1; long runs of one
   index), K2 fed the [L,G,F] view `bundle_adjust` passes: K2 to 1e-5 (1 +
   max|ref|) of its plain version and bit-identical to itself on a second
   run and to the ascending-f sum `onehot_adjoint_ordered`; K3
   bit-identical to its plain version;
9. slice 2 through the kernels: depth bootstrap from frame 0, then
   `autonomous_step` on frames 1..59. Every frame good; keyframes made
   within 1 of the JAX CPU reference; K2/K3 launched 12/13 times per BA; the
   map's invariants no worse than the reference's; valid points within 5%
   of the reference's while the keyframe flags agree and within 10% at the
   end; the max translation error under 3x the reference's; K1 once per
   frame;
10. slice 2 with `use_kernel=False` for K1, K2 and K3 over its first
    N_PLAIN2 steps (six keyframe BAs): identical keyframe flags, inliers
    within 2 per frame, poses to 1e-3;
11. timing: `autonomous_step` ms per frame with and without a keyframe
    (phase 9's frames, each synchronised), `local_ba` ms per call on the
    final map;
12. slice 3 through the kernels, the port's normal entry point: every frame
    of the slice-2 scene from frame 0 through `System(...,
    vocabulary_file=VOCAB).track_monocular` (the vocabulary changes nothing
    before a loss; phase 16 continues this System) at
    `configs/euroc.yaml`'s settings without lens distortion (resized to
    600x350, kf_capacity 512, pt_capacity 16384, autonomous lane with
    auto_batch 4 and async_depth 8, the default `LocalMapper()`): monocular
    two-view init, then tracking, keyframes and windowed BA; the trajectory
    saved as TUM into `build/`, read back and aligned to ground truth. Held to
    the JAX CPU reference of the same run: init at the same frame pair (+-1),
    the same two-view model, initial good points within 5%, final state OK,
    frames with a pose at least the reference's minus 2, keyframes within 2,
    the host keyframe mirror equal to the map, ATE under 3x the reference's;
    K2/K3 launched once per LM step of every BA, K1 once per frame;
13. slice 3 with `use_kernel=False`: the same draws (the tracker's CPU
    generator), so the same init frames, initial keyframe poses to 1e-4,
    identical keyframe frames and trajectory rows, poses to 1e-3;
14. timing: `track_monocular` ms per call by kind (before init, the init
    call, buffered, dispatched with and without a keyframe) over phase 12's
    calls, each synchronised;
15. the kernel table, at the System path's shapes (K1: one call for the 8
    levels of a 600x350 frame, and one for a KITTI stereo pair's 16 levels;
    K2/K3: L = 32, and L = 8 and 20 beside it): the
    launches counted in phase 12, the wrapper-included µs (CUDA events
    around back-to-back calls: 200 for K1; for K2/K3 five rounds of 40, in
    turns with the library call, medians), the device-only µs (100 calls captured
    in a CUDA graph and replayed; `torch.profiler`'s kernel rows beside it),
    the bound (bytes over 3.35 TB/s or operations over 67 TFLOP/s, the
    larger), the one PyTorch call that computes the same function (K2: a
    zero fill and `scatter_add_`; K3: `torch.gather`; K1: none), timed here
    only, and the plain version; then the order in which the kernels are
    redesigned: first those slower than their library call, by the factor,
    then the rest by the time lost above the bound per System run;
16. relocalization: phase 12's System (and phase 13's, the plain path) goes
    on with N_BLACK16 black frames and a revisit of frames REVISIT16, the
    timestamps continuing. Held to the JAX CPU reference of the same run
    (`JAX_REF6`): a RECENTLY_LOST/LOST state after the blackout, the first
    successful `_try_relocalize` within one call of the reference's with at
    least 30 inliers, the relocalized camera center within 3x the
    reference's distance (at least RELOC_DIST_FLOOR) from the pre-blackout
    estimate of the same view, a pose for every later call, K1 once per
    call; the plain path relocalizing at the same call, poses to 1e-3.
    Timing lines: ms per `_try_relocalize` call, success and failure;
17. the atlas: a fresh System at camera.fps FPS17 (a keyframe at least every
    5 frames, the knob of the reference's `tests/test_atlas.py`) on the
    dense 36-patch world (DENSE_WORLD; on the default world at this fps the
    reference loses its first map at frame 41), frames
    0..59, N_BLACK17 black frames, a revisit of frames REVISIT17. The
    blackout is long enough for the lost frames to reach the pipelined
    lane after the autonomous hand-back, whose retire stashes the map on
    persistent LOST (the port's repair; the JAX reference is run with the
    same repair). Held to the reference: one stash within one batch (4
    calls) of its call with its stored keyframe count +-2, a second init
    within the reference's spread over agents 0-5, the merge-back within
    MERGE_CALLS calls of its call with S_ab of positive scale, the ATE over
    the rows in the stored map's frame under 3x the reference's, the welding
    BA's K2/K3 launched once per LM step at L = WELD_L, K1 once per call;
    the plain path stashing and merging at the same calls, S_ab to 1e-3.
    Timing lines: ms per `_new_map_in_atlas`, per `try_merge_back` (rejected
    and merged) and per `_try_relocalize`, kernels then plain.
    In phases 16-17 records of the autonomous lane retire as soon as the
    next one is dispatched (`_record_ready` true, as on the CPU), so the
    hand-back to the host path lands on the same call in every run.
18. the decentralized runtime: two `SlamAgent`s (`multiagent/agent.py`) on
    one `LoopbackTransport` at the EuRoC tracker settings with camera.fps
    FPS18, the console's mapper (BA windows of 8 local + 8 fixed rows) and
    the vocabulary, on the dense world along an 80-frame trajectory (agent
    1 frames 0..51, agent 2 frames 28..79, interleaved; then flush() and
    N_IDLE18 protocol rounds): BoW advertisement, merge detection, the pull
    of agent 1's map, Sim3 verification, splice, fuse, the welding BA
    (L = WELD_L), the essential graph, the asynchronous global BA,
    keyframe sharing both ways, the frame-tree re-parenting. Held to the
    JAX CPU reference of the same run over five sets of tracker draws
    (`JAX_REF7`; the init, and with it the maps' scales, depend on the
    draws) and to ground truth: both peers merged, the merge within
    MERGE_STEPS steps of the reference's, S_ab's scale within SCALE_RTOL of
    the reference's spread and of the scale ground truth implies for the
    two maps just before the splice, each map holding the other agent's
    keyframes, agent 2 under robot1/origin, the global BA folded in, the
    host mirrors in sync, agent 2's keyframe ATE under 3x the reference's
    and 0.2 m; K1-K3
    launched, K2/K3 at L = 16 and L = 20; the plain path merging at the
    same step with the same log kinds, S_ab to 1e-3. Prints
    `process_image` ms by kind (median, p90, max), `merge_latency_s`, the
    global BA's dispatch-to-fold seconds and the bytes per channel;
19. the checkpoint: `save_atlas` of phase 12's System into `build/`,
    `load_atlas` into a fresh System on the card: every array of the saved
    map's packet comes back (the point statistics `load_atlas` recomputes
    aside), the tracker state too, and a second save and load changes no
    MapState field;
20. agents as a batch axis, BA: `local_ba_batched` over four EuRoC-capacity
    maps (phase 12's System map, phase 17's, phase 18's two agents') at
    `LocalMapper()`'s shape (L = 32, 4096 points, 8 iterations): each map
    within 1e-4 (poses), 1e-3 (points) and 1e-4 relative (chi2) of its own
    `local_ba`, K2/K3 launched once per LM step for the whole batch, the
    batched plain path within 1e-4, one LM step's folded K2 rows and offset
    K3 table bit-identical to four separate launches; the batched call's ms
    against four solo calls;
21. agents as a batch axis, the per-frame step: `build_multi_agent_step`
    for four agents whose maps are seeded from the rendered depth of
    frames STARTS21, STEPS21 steps at the System's BA shape, each step held
    against the port's one-agent sequence on the same inputs (`extract` ->
    `track_frame` -> `local_ba` -> `bow_vector`): one K1 launch per step
    for the four frames, inliers identical, poses 1e-4, scores symmetric
    with 1 on the diagonal and within 1e-5, `extract_batch` bit-identical
    to four `extract` calls; step ms against four sequential agent steps;
22. the protocol round: `build_protocol_step` for four agents at EuRoC
    capacity (kf 512, pt 16384, F 1250) on `protocol_maps` (agents 0-2 on
    one world, agent 1 in a Sim3-transformed frame, agent 3 on a disjoint
    world), PROTO_ROUNDS rounds with window 4 and refresh_every 2, fusion,
    the welding BA, the essential graph and the global BA on, the step's
    own draws: per round the merge matrix, n_kf and the integer state equal
    to the JAX CPU reference (`JAX_REF8`), S_peer within S_ATOL8 (or the
    true Sim3 after a refit that read globally adjusted merged maps, fault
    t), every map's invariants clean, K2/K3 launched at L = 12 in rounds
    that spliced and not otherwise; ms per stage; then the first N_PLAIN22
    rounds (the merges, the first refits and the first drop) again on their
    own inputs, without the global BA (no kernel; not reproducible on
    merged maps), through the kernels and the plain versions: integers
    identical, poses within 1e-3;
23. three agents: `tests/test_three_agents.py`'s layout at the EuRoC
    tracker settings on the dense world (kernel path only; phase 18 holds
    `SlamAgent`'s plain path), the wire through the native map codec
    built from `native/mapcodec.cpp` on the card: every pair merged, one
    implicitly, agent 1 at `world` and the others under agent 1's frame,
    every map holding all three creators' keyframes, each agent's ATE
    under 3x the JAX CPU reference's spread over tracker draws and 0.25 m,
    every map packet's native bytes equal to `codec.pack_arrays`'s; pack and
    unpack ms of both codecs, `process_image` ms by kind, bytes per
    channel;
24. stereo: `System(sensor="stereo").track_stereo` on N_FRAMES9 rectified
    pairs rendered at `configs/kitti.yaml`'s settings (1241x376, 2000
    features, kf 1024, pt 32768) with ORB-SLAM3's KITTI Camera.bf, first
    one K1 launch for frame 0's pair (both views' 16 levels) against its
    twin as in phase 3; then through the kernels and the plain versions,
    held to the JAX CPU reference (`JAX_REF9`): init on frame 0, a pose for
    every frame, keyframes +-1, matches with depth per frame within
    STEREO_RTOL, the metric (SE3-aligned) ATE under 3x the reference's, the
    map inside the reference's capacities (`REF9_CAPS`), one K1 launch per
    pair, K2/K3 once per LM step of every keyframe BA; the plain path over
    the first N_PLAIN9 calls, held call by call: the same keyframes,
    matches and rows, poses to 1e-3;
25. RGB-D: `System(sensor="rgbd").track_rgbd` on N_FRAMES9 frames at
    `configs/tum.yaml`'s settings (640x480, 1000 features) with TUM1's
    Camera.bf and DepthMapFactor, the depth fed as uint16 sensor units, on
    a world whose planes lie inside th_depth: held as phase 24, plus close
    points created at keyframes after the first;
26. KB8: `System.track_monocular` on N_FRAMES9 fisheye frames at
    `configs/tum_vi.yaml`'s settings (512x512, KB8), warped from pinhole
    renders of the dense world (`warp_to_fisheye`): two-view init within
    the reference's spread over agents 0-5, good points within 5%, a pose
    for every later frame, keyframes +-1, the ATE (Sim3) under 3x the
    reference's, K1-K3 launches as in phase 12; the plain path as in phase
    13, over the first N_PLAIN9 calls;
27. IMU-monocular: `System(sensor="imu-monocular").track_monocular_inertial`
    on N_FRAMES10[27] frames at `configs/euroc.yaml`'s settings without
    distortion (752x480 resized to 600x350) with the IMU at 200 Hz
    (`ImuSettings()`, ORB-SLAM3's EuRoC noise), black frames BLANK10[27]
    after the IMU initializes; the pipelined VI lane retires a record as
    soon as the next one is dispatched (fault s). Held to the JAX CPU
    reference (`JAX_REF10`): the two-view init one that the reference makes
    under the draws of agents 0-5 (fault o), and against the reference's
    runs that initialized on that pair: the IMU initialized with the chain
    within one keyframe, keyframes +-2, the path-length ratio against ground
    truth after the IMU-init call within 3x their distance from 1 (or 1%);
    the ratio in RATIO_BOUNDS, a pose for every black frame, final state
    OK, at least 15 frames after the span, every chain keyframe's
    preintegration dT within 1e-3 s of the IMU samples of its frames (the
    timestamp gap where the camera rate divides the IMU's), K1 once per call, K2/K3 once per LM step of every visual
    BA before the IMU init and never after; the plain path with the same
    init, IMU-init call and keyframes, poses to 1e-3. Prints ms per call by
    kind (before init, init, before the IMU init, the IMU-init call, the VI
    lane, a keyframe with the VI BA);
28. IMU-stereo: `track_stereo_inertial` at 752x480 with EuRoC's stereo
    baseline: init on frame 0, the IMU initialized at fixed scale with the
    chain within one keyframe of the reference's, the live trajectory's
    ratio in RATIO_BOUNDS, keyframes +-1, one K1 launch per pair, K2/K3 as
    in phase 27; the plain path as in phase 27;
29. IMU-RGB-D: `track_rgbd_inertial` at phase 25's settings and world with
    the IMU at 200 Hz, held as phase 28;
30. MergeInertialBA (kernel path only): phase 28's kernel System as
    system 1, a second IMU-stereo System over frames SEGMENT30.. of the
    same scene, system 1 wrapped in a port `SlamAgent` welding system 2's
    map in through the codec (`tests/test_vi_pipeline.py::
    TestMergeInertialBA`'s layout): merged, at least 3 of the last 6 chain
    keyframes with a velocity within 0.6 m/s of ground truth and the worst
    within 3x the reference's, |bias_g| < 0.2, |bias_a| < 1.0, the global
    BA folded in;
31. the operator console on real imagery: `tools.console.run_dataset` on
    `tests/fixtures/mini_euroc` (120 frames at 240x180, the PNGs read by
    the port's own decoder) with two agents, overlap 0.5, settings as a
    `SystemSettings` and the fixture's ground truth, held to
    `tests/test_dataset_integration.py`'s bounds and to `JAX_REF11`: at
    least 30 paired frames and a Sim3-aligned ATE under 0.15 m and 3x the
    reference's per agent, the keyframes after every call through the
    reference's merge call within 1 of its, its merge within 4 calls, every
    recorded file, `evaluate`'s ATE equal to one computed from the written
    trajectories, K1 once per agent frame and per vocabulary frame, K2/K3
    launched; the plain path over the first N_PLAIN31 calls of each agent
    with the same keyframes and poses to 1e-3.

Run from the root of a checkout: `python3 chip_smoke.py`. The last line is
`{"ok": true, "device": {...}}`; the line before it the card's name and power
limit, and before that one JSON line describing the kernels (times of phase
15; launches summed over phases 12, 16, 17, 18 and 20-31, each counted
around its main path's calls only). `python3 chip_smoke.py --kernels-only`
runs phases 1-3, 7, 8 and 15
(launch counts not taken) and prints no result line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

H, W = 480, 752
K_EUROC = (458.654, 457.296, 367.215, 248.375)
N_FEATURES, N_LEVELS = 1250, 8
TEX_SIZE = 2048
N_FRAMES = 30   # slice 1: frame 0 bootstraps the map, frames 1..29 are tracked
N_FRAMES2 = 60  # slice 2: frame 0 bootstraps the map, frames 1..59 run the full step
N_PLAIN1 = 10   # the plain path's tracked frames in phase 5
N_PLAIN2 = 23   # the plain path's steps in phase 10 (six keyframe BAs)
# autonomous_step's mapper_cfg: (n_neighbors, n_levels, scale_factor,
# ba_local, ba_fixed, ba_pts, ba_iters, run_ba_every) of bench.py's LocalMapper
MAPPER = (5, N_LEVELS, 1.2, 12, 8, 4096, 6, 1)
BA_STEPS = MAPPER[6] + 5 + 1   # LM steps per BA: iters + stage-2 iters + 1
BA_SHAPES = dict(L=MAPPER[3] + MAPPER[4], G=30, F=512, P=MAPPER[5])
L_SYSTEM = 32   # BA window rows of System's default LocalMapper(ba_local=16, ba_fixed=16)

# The JAX package's CPU reference run of these frames (same world, geometry
# and bootstrap; `python tests/test_torch_slice.py`): per-frame inliers and
# the largest translation error against ground truth, in meters.
JAX_REF_INLIERS = [755, 703, 679, 646, 605, 580, 528, 499, 483, 435, 420, 374, 378, 369, 338,
                   313, 308, 296, 276, 260, 247, 244, 231, 219, 211, 204, 187, 185, 192]
JAX_REF_MAX_ERR_M = 0.020346
ERR_BOUND_M = 3.0 * JAX_REF_MAX_ERR_M

# The JAX package's CPU reference run of slice 2 (same world, geometry,
# bootstrap and mapper; `python tests/test_torch_slice.py --slice2`): per-frame
# inliers, keyframe flags and valid map points after each of frames 1..59,
# the final keyframe count (the bootstrap keyframe included), the largest
# translation error in meters, and the map's invariant report.
JAX_REF2_INLIERS = [755, 689, 658, 622, 596, 556, 602, 583, 560, 505, 457, 495, 467, 435, 399,
                    487, 448, 443, 416, 397, 384, 379, 356, 498, 466, 445, 431, 415, 396, 387,
                    386, 367, 381, 370, 383, 385, 368, 392, 385, 408, 393, 416, 397, 428, 419,
                    413, 411, 399, 374, 356, 369, 347, 337, 327, 327, 321, 284, 308, 304]
JAX_REF2_MADE_KF = [1, 0, 1, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0,
                    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1,
                    0, 0, 0, 0, 0, 0, 1, 0, 0]
JAX_REF2_N_KF = 10
JAX_REF2_VALID_POINTS = [1207, 1207, 822, 822, 822, 960, 960, 960, 960, 960, 955, 955, 955, 955,
                         1049, 1049, 1049, 1049, 1049, 1049, 1049, 1049, 1163, 1163, 1163, 1163, 1163, 1163,
                         1163, 1163, 1163, 1163, 1163, 1163, 1163, 1163, 1163, 1163, 1163, 1163, 1163, 1163,
                         1141, 1141, 1141, 1141, 1141, 1141, 1141, 1033, 1033, 1033, 1033, 1033, 1033, 1033,
                         966, 966, 966]
JAX_REF2_MAX_ERR_M = 0.014282
JAX_REF2_INVARIANTS = ["388 observations reference invalid points"]
ERR_BOUND2_M = 3.0 * JAX_REF2_MAX_ERR_M
# Valid map points: within 5% of the reference after every frame while the
# two runs make the same keyframes, within 10% at the end. Once the keyframe
# flags part (f32 BA on the card and on the CPU part by ~5e-3 in one step from
# the same state), the maps grow from different keyframes.
VALID_RTOL, VALID_RTOL_END = 0.05, 0.10

# Slice 3: `configs/euroc.yaml` as a dict (the card's Python has no YAML
# parser), with no lens distortion: the renderer draws none.
EUROC_SETTINGS = {
    "camera": {"model": "pinhole", "fx": 458.654, "fy": 457.296, "cx": 367.215,
               "cy": 248.375, "dist": (0.0, 0.0, 0.0, 0.0), "width": 752, "height": 480,
               "new_width": 600, "new_height": 350, "fps": 20.0, "rgb": True},
    "orb": {"n_features": 1250, "scale_factor": 1.2, "n_levels": 8, "ini_th_fast": 20.0,
            "min_th_fast": 7.0},
    "kf_capacity": 512, "pt_capacity": 16384,
}
FPS3 = 20.0                # frame i is stamped i / FPS3
INIT_BA_ITERS = 16         # `LocalMapper.on_initial_map`'s BA
# The JAX package's CPU reference of slice 3 (`python tests/test_torch_slice.py
# --slice3`): every frame through `System.track_monocular` from frame 0 as
# agent 0. The frame pair of the two-view init, its model, its good points,
# the frames with a pose in the saved trajectory, the frames that made
# keyframes (the two of the init included) and the Sim3-aligned ATE in
# meters. Then the init alone under the draws of agents 0-5: (frame pair,
# homography, good points). On this mostly planar scene the eight-point
# system is near-degenerate and SH/(SH+SF) sits at 0.44-0.50, so which call
# succeeds, and with which model, depends on the draws and on the f32 solver
# (ROADMAP fault o); the card's init is held to this spread.
JAX_REF3_INIT_PAIR = (0, 1)
JAX_REF3_USED_H = False
JAX_REF3_INIT_GOOD = 633
JAX_REF3_N_TRACKED = 59
JAX_REF3_KF_FRAMES = [0, 1, 2, 7, 11, 17, 30, 50, 54]
JAX_REF3_ATE_M = 0.006159775424748659
JAX_REF3_INIT_BY_SEED = [((0, 1), False, 633), ((6, 8), False, 622), ((6, 7), False, 631),
                         ((0, 2), False, 574), ((0, 2), False, 574), ((0, 4), False, 504)]
INIT_GOOD_RTOL = 0.05
ATE_BOUND3_M = 3.0 * JAX_REF3_ATE_M

# Slice 6: `System(..., vocabulary_file=VOCAB)` (relocalization and the
# multi-map atlas). Phase 16 continues phase 12's run (frames 0..59) with
# N_BLACK16 black frames and a revisit of frames REVISIT16; phase 17 runs
# camera.fps FPS17 from frame 0: frames 0..59, N_BLACK17 black frames, a
# revisit of frames REVISIT17. Call i is stamped i / FPS3.
VOCAB = os.path.join("data", "voc_default.npz")
N_BLACK16, REVISIT16 = 4, (30, 42)
N_BLACK17, REVISIT17 = 20, (10, 60)
N_PLAIN17 = 20             # the plain path's calls in phase 17, held call by call
FPS17 = 5.0
# phase 17's world, the dense 36-patch layout: on the default 8-patch world
# at camera.fps 5 the JAX reference loses its first map at frame 41
DENSE_WORLD = dict(n_patches=36, depth_range=(0.30, 0.92), patch_half=(0.03, 0.09))
WELD_L = 20                # the merge-back's welding BA window: 12 local + 8 fixed rows
WELD_ITERS = 6
RELOC_DIST_FLOOR = 0.005   # map units: the least bound on the relocalized camera center
MERGE_CALLS = 4            # the merge call, card against the JAX CPU reference
# The JAX package's CPU reference of phases 16-17 (`python
# tests/test_torch_slice.py --slice6`: its `System` with the vocabulary, agent
# 0, the same calls, the lane drained after call 59 in phase 16 as phase
# 12's saving of the trajectory drains it; autonomous records retired as
# soon as the next one is dispatched, and the pipelined retire's stash on
# persistent LOST added, as in the port). Phase 16: the first successful
# relocalization's call, relocalizer inliers and camera-center distance
# from the pre-blackout estimate of the same view (map units). Phase 17: the stash (call, stored
# keyframes), the init pairs (first call, call), the merge call, S_ab, the
# ATE over the rows in the stored map's frame (m), and the second init's
# frame pairs under the draws of agents 0-5 (the init alone on the revisit
# frames).
JAX_REF6 = {
    "phase16": {"reloc_call": 68, "reloc_inliers": 70, "reloc_dist": 0.002279845532029867},
    "phase17": {"stash": (76, 14), "init_pairs": [(0, 3), (80, 82)], "merge_call": 90,
                "S_ab": [0.9994258284568787, 0.0024862438440322876, 0.033788323402404785,
                         -0.0002579046704340726, 0.6404571533203125, 0.04416660964488983,
                         0.11109279096126556, 0.9072625637054443],
                "ate": 0.004693987779319286,
                "init_spread": [(10, 12), (10, 11), (10, 12), (10, 13), (10, 12), (10, 11)]},
}

# Slice 7: two `SlamAgent`s on one loopback bus (phase 18) at the EuRoC
# tracker settings with camera.fps FPS18 (a keyframe at least every 4
# frames, the knob of the reference's `tests/test_multiagent.py:118`), the
# console's mapper (`tools/console.py::build_agents`) and the vocabulary, on
# the dense world along a trajectory of 80 frames: agent 1 takes frames
# 0..51, agent 2 frames 28..79, one each per step stamped step / 10; then
# flush() and N_IDLE18 protocol iterations (`tests/test_multiagent.py:139-161`).
FPS18 = 4.0
SEGMENTS18 = {1: (0, 52), 2: (28, 80)}
N_STEPS18, N_IDLE18 = 52, 6
N_PLAIN18 = 16             # the plain path's steps in phase 18, held call by call
TRAJ18 = dict(lateral=2.2, forward=0.6, yaw=0.08)
CONSOLE_MAPPER = dict(n_neighbors=4, ba_local=8, ba_fixed=8, ba_pts=2048, ba_iters=6)
KF_BA_L = CONSOLE_MAPPER["ba_local"] + CONSOLE_MAPPER["ba_fixed"]   # keyframe BA rows (16)
MERGE_STEPS = 4            # the merge step, card against the JAX CPU reference
SCALE_RTOL = 0.05          # S_ab's scale against the reference's spread and ground truth
ATE18_BOUND_M = 0.2        # tests/test_multiagent.py:203
# The JAX package's CPU reference of phase 18 (`python tests/test_torch_slice.py
# --slice7`): the merges (merging agent, step, S_ab), per agent the log kinds
# and keyframes by creator, and agent 2's keyframe ATE (m) over its keyframes.
# Agent 1, the lead node, found the candidates and pushed its map; agent 2
# merged it, folded the global BA and aligned its scale in the idle rounds.
JAX_REF7 = {
    "merges": [{"agent": 2, "step": 47,
                "S_ab": [0.999310314655304, -0.0029089543968439102, -0.037020787596702576,
                         0.00021261196525301784, -1.0186160802841187, 0.04289642348885536,
                         -0.18600599467754364, 1.0282059907913208]}],
    "1": {"log_kinds": ["merge_candidates"], "by_creator": {1: 15, 2: 11}},
    "2": {"log_kinds": ["gba_applied", "merge_latency_s", "merged", "scale_aligned"],
          "by_creator": {1: 12, 2: 15}},
    "ate2": 0.001999935135245323, "ate2_n": 15,
    # the same run with the trackers' draws from PRNGKey(agent id + offset)
    # (`--slice7 --seed-offset N`): the merging agent, its step, S_ab's
    # scale, the scale ground truth implies for the two maps just before the
    # splice, agent 2's keyframe ATE. At offset 20 one map's two-view init
    # took a wrong solution and the merge is off by 62% in scale; at offset
    # 30 agent 1 was lost at step 29 and nothing merged (fault o).
    "spread": [
        {"offset": 0, "agent": 2, "step": 47, "scale": 1.0282059907913208,
         "scale_gt": 1.029950538908306, "ate2": 0.001999935135245323},
        {"offset": 10, "agent": 2, "step": 48, "scale": 1.1842399835586548,
         "scale_gt": 1.1818301975948902, "ate2": 0.00175901735201478},
        {"offset": 20, "agent": 2, "step": 45, "scale": 2.583160638809204,
         "scale_gt": 6.874547716161577, "ate2": 0.015409080311655998},
        {"offset": 30, "agent": None, "step": None, "scale": None, "scale_gt": None,
         "ate2": 0.3509232997894287},
        {"offset": 40, "agent": 2, "step": 49, "scale": 7.185351848602295,
         "scale_gt": 7.231428543454881, "ate2": 0.0018510018708184361},
    ],
    # (step, sender, channel) and (step, agent, "bows in", own keyframes,
    # candidates found); keyframes on the host after each step
    "events": [(45, 1, "new_key_frame_bows"), (45, 2, "bows in", 11, []),
               (46, 2, "new_key_frame_bows"), (47, 1, "map_to_attempt_merge"),
               (47, 1, "bows in", 12, [11]), (47, 2, "successfully_merged"),
               (47, 2, "new_key_frames")],
    "kf_steps": {1: [0, 0, 0, 0, 0, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 7,
                     7, 7, 7, 8, 8, 8, 8, 9, 9, 9, 9, 10, 10, 10, 10, 11, 11, 11, 11, 12, 12, 12,
                     24, 24, 24, 26],
                 2: [0, 0, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 6, 6, 6, 6,
                     7, 7, 7, 7, 8, 8, 8, 8, 9, 9, 9, 9, 10, 10, 10, 10, 11, 11, 11, 11, 12, 26,
                     26, 26, 26, 26]},
}
# Slice 8: agents as a batch axis. Phase 22's protocol rounds: four agents at
# EuRoC capacity (kf 512, pt 16384, F 1250) on maps built from numpy seeds
# (`protocol_maps`), PROTO_ROUNDS rounds of `build_protocol_step` with
# window 4 and refresh_every 2; agent 1 lives in the frame PROTO_G (rotation
# vector, translation, scale).
PROTO_AGENTS, PROTO_ROUNDS, PROTO_WINDOW, PROTO_REFRESH = 4, 6, 4, 2
N_PLAIN22 = 4              # the rounds phase 22's plain path replays
PROTO_CAPS = (512, 16384, 1250)
PROTO_N_KF, PROTO_OBS, PROTO_WORLD, PROTO_SEED = 16, 1000, 3000, 8
PROTO_K = (365.0, 365.0, 300.0, 175.0)      # a 600x350 camera
PROTO_G = (0.1, -0.2, 0.3, 0.5, -0.3, 0.8, 1.4)
PROTO_JUMPER, PROTO_JUMP, PROTO_JUMP_ROUND = 2, 6, 3
PROTO_INT_FIELDS = ("S_ok", "merged", "last_seen", "dropped", "refresh_interval", "next_refresh")
# S_peer's translation and scale against the JAX CPU reference (fits on maps
# no global BA moved; a refit after one is held to the true Sim3, fault t)
S_ATOL8 = 1e-3
# Phase 23: `tests/test_three_agents.py`'s layout (chained overlaps, agents on
# SEGMENTS23 of a 110-frame trajectory, then flush() and N_IDLE23 rounds) at
# the EuRoC tracker settings with camera.fps FPS18, the console's mapper and
# the vocabulary, on the dense world; the wire through the native codec.
SEGMENTS23 = {1: (0, 46), 2: (28, 78), 3: (62, 110)}
N_IDLE23 = 8
TRAJ23 = dict(lateral=2.6, forward=0.7, yaw=0.08)
ATE23_BOUND_M = 0.25       # tests/test_three_agents.py:113
# phase 21: four agents' maps seeded from the depth of these frames, then
# STEPS21 steps of `build_multi_agent_step`
STARTS21, STEPS21 = (0, 15, 30, 45), 4
# The JAX package's CPU reference of phase 22 (`python tests/test_torch_slice.py
# --slice8 --protocol`: `build_protocol_step` on a 4-device CPU mesh, the same
# maps, windows and draws): per round the draws' sum (the same generator on
# both sides), the merge matrix, n_kf, the integer state and S_peer's
# translation and scale [A,A,4]. Agent 3's random-descriptor world scores as
# a BoW merge in rounds 1-2 and never passes the Sim3 gate.
JAX_REF8 = {
    "rounds": [{'noise_sum': 2312054.5072198426,
      'M': [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
      'n_kf': [16, 16, 16, 16],
      'S_ok': [[0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]],
      'merged': [[0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]],
      'last_seen': [[-1, -1, -1, -1], [-1, -1, -1, -1], [-1, -1, -1, -1], [-1, -1, -1, -1]],
      'dropped': [[0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]],
      'refresh_interval': [[2, 2, 2, 2], [2, 2, 2, 2], [2, 2, 2, 2], [2, 2, 2, 2]],
      'next_refresh': [[1, 1, 1, 1], [1, 1, 1, 1], [1, 1, 1, 1], [1, 1, 1, 1]],
      'S_peer_ts': [[[0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 1.0],
                     [0.0, 0.0, 0.0, 1.0]],
                    [[0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 1.0],
                     [0.0, 0.0, 0.0, 1.0]],
                    [[0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 1.0],
                     [0.0, 0.0, 0.0, 1.0]],
                    [[0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 1.0],
                     [0.0, 0.0, 0.0, 1.0]]]},
     {'noise_sum': 2308114.705980111,
      'M': [[1, 1, 1, 1], [1, 1, 1, 1], [1, 1, 1, 1], [1, 1, 1, 1]],
      'n_kf': [20, 20, 20, 16],
      'S_ok': [[0, 1, 1, 0], [1, 0, 1, 0], [1, 1, 0, 0], [0, 0, 0, 0]],
      'merged': [[0, 1, 1, 1], [1, 0, 1, 1], [1, 1, 0, 1], [1, 1, 1, 0]],
      'last_seen': [[-1, 1, 1, -1], [1, -1, 1, -1], [1, 1, -1, -1], [-1, -1, -1, -1]],
      'dropped': [[0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]],
      'refresh_interval': [[2, 2, 2, 2], [2, 2, 2, 2], [2, 2, 2, 2], [2, 2, 2, 2]],
      'next_refresh': [[1, 1, 1, 1], [1, 1, 1, 1], [1, 1, 1, 1], [1, 1, 1, 1]],
      'S_peer_ts': [[[0.0, 0.0, 0.0, 1.0], [-0.3866374, 0.3002494, -0.5149183, 0.7141849],
                     [-0.01031303, 0.0005155876, 0.003998756, 0.999404], [0.0, 0.0, 0.0, 1.0]],
                    [[0.5323172, -0.3604383, 0.8113728, 1.399256], [0.0, 0.0, 0.0, 1.0],
                     [0.4779928, -0.2877851, 0.8016043, 1.40018], [0.0, 0.0, 0.0, 1.0]],
                    [[-0.009656072, 0.02044954, -0.004946709, 1.00059],
                     [-0.3877351, 0.2752258, -0.5226259, 0.7145283], [0.0, 0.0, 0.0, 1.0],
                     [0.0, 0.0, 0.0, 1.0]],
                    [[0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 1.0],
                     [0.0, 0.0, 0.0, 1.0]]]},
     {'noise_sum': 2309279.5541217946,
      'M': [[1, 1, 1, 1], [1, 1, 1, 1], [1, 1, 1, 1], [1, 1, 1, 1]],
      'n_kf': [22, 22, 22, 16],
      'S_ok': [[0, 1, 1, 0], [1, 0, 1, 0], [1, 1, 0, 0], [0, 0, 0, 0]],
      'merged': [[0, 1, 1, 1], [1, 0, 1, 1], [1, 1, 0, 1], [1, 1, 1, 0]],
      'last_seen': [[-1, 2, 2, -1], [2, -1, 2, -1], [2, 2, -1, -1], [-1, -1, -1, -1]],
      'dropped': [[0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]],
      'refresh_interval': [[2, 4, 4, 2], [4, 2, 4, 2], [4, 4, 2, 2], [2, 2, 2, 2]],
      'next_refresh': [[1, 6, 6, 1], [6, 1, 6, 1], [6, 6, 1, 1], [1, 1, 1, 1]],
      'S_peer_ts': [[[0.0, 0.0, 0.0, 1.0], [-0.3867309, 0.279797, -0.5205369, 0.7170812],
                     [-0.01038197, -0.003152296, 0.003682137, 1.004045], [0.0, 0.0, 0.0, 1.0]],
                    [[0.4820857, -0.3171268, 0.7834072, 1.391966], [0.0, 0.0, 0.0, 1.0],
                     [0.4615339, -0.3043779, 0.7852621, 1.404187], [0.0, 0.0, 0.0, 1.0]],
                    [[-0.00909856, -0.002914786, -0.006502151, 0.9971985],
                     [-0.3830239, 0.2644142, -0.5158157, 0.7125254], [0.0, 0.0, 0.0, 1.0],
                     [0.0, 0.0, 0.0, 1.0]],
                    [[0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 1.0],
                     [0.0, 0.0, 0.0, 1.0]]]},
     {'noise_sum': 2305061.377648009,
      'M': [[1, 1, 1, 0], [1, 1, 1, 0], [1, 1, 1, 0], [0, 0, 0, 1]],
      'n_kf': [27, 27, 24, 16],
      'S_ok': [[0, 1, 1, 0], [1, 0, 1, 0], [1, 1, 0, 0], [0, 0, 0, 0]],
      'merged': [[0, 1, 1, 0], [1, 0, 1, 0], [1, 1, 0, 0], [0, 0, 0, 0]],
      'last_seen': [[-1, 3, 9, -1], [3, -1, 9, -1], [3, 3, -1, -1], [-1, -1, -1, -1]],
      'dropped': [[0, 0, 3, 0], [0, 0, 3, 0], [0, 0, 0, 0], [0, 0, 0, 0]],
      'refresh_interval': [[2, 4, 4, 2], [4, 2, 4, 2], [4, 4, 2, 2], [2, 2, 2, 2]],
      'next_refresh': [[1, 6, 6, 1], [6, 1, 6, 1], [6, 6, 1, 1], [1, 1, 1, 1]],
      'S_peer_ts': [[[0.0, 0.0, 0.0, 1.0], [-0.3867309, 0.279797, -0.5205369, 0.7170812],
                     [-0.01038197, -0.003152296, 0.003682137, 1.004045], [0.0, 0.0, 0.0, 1.0]],
                    [[0.4820857, -0.3171268, 0.7834072, 1.391966], [0.0, 0.0, 0.0, 1.0],
                     [0.4615339, -0.3043779, 0.7852621, 1.404187], [0.0, 0.0, 0.0, 1.0]],
                    [[-0.00909856, -0.002914786, -0.006502151, 0.9971985],
                     [-0.3830239, 0.2644142, -0.5158157, 0.7125254], [0.0, 0.0, 0.0, 1.0],
                     [0.0, 0.0, 0.0, 1.0]],
                    [[0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 1.0],
                     [0.0, 0.0, 0.0, 1.0]]]},
     {'noise_sum': 2307469.867820363,
      'M': [[1, 1, 1, 0], [1, 1, 1, 0], [1, 1, 1, 0], [0, 0, 0, 1]],
      'n_kf': [29, 29, 26, 16],
      'S_ok': [[0, 1, 1, 0], [1, 0, 1, 0], [1, 1, 0, 0], [0, 0, 0, 0]],
      'merged': [[0, 1, 1, 0], [1, 0, 1, 0], [1, 1, 0, 0], [0, 0, 0, 0]],
      'last_seen': [[-1, 4, 10, -1], [4, -1, 10, -1], [4, 4, -1, -1], [-1, -1, -1, -1]],
      'dropped': [[0, 0, 3, 0], [0, 0, 3, 0], [0, 0, 0, 0], [0, 0, 0, 0]],
      'refresh_interval': [[2, 4, 4, 2], [4, 2, 4, 2], [4, 4, 2, 2], [2, 2, 2, 2]],
      'next_refresh': [[1, 6, 6, 1], [6, 1, 6, 1], [6, 6, 1, 1], [1, 1, 1, 1]],
      'S_peer_ts': [[[0.0, 0.0, 0.0, 1.0], [-0.3867309, 0.279797, -0.5205369, 0.7170812],
                     [-0.01038197, -0.003152296, 0.003682137, 1.004045], [0.0, 0.0, 0.0, 1.0]],
                    [[0.4820857, -0.3171268, 0.7834072, 1.391966], [0.0, 0.0, 0.0, 1.0],
                     [0.4615339, -0.3043779, 0.7852621, 1.404187], [0.0, 0.0, 0.0, 1.0]],
                    [[-0.00909856, -0.002914786, -0.006502151, 0.9971985],
                     [-0.3830239, 0.2644142, -0.5158157, 0.7125254], [0.0, 0.0, 0.0, 1.0],
                     [0.0, 0.0, 0.0, 1.0]],
                    [[0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 1.0],
                     [0.0, 0.0, 0.0, 1.0]]]},
     {'noise_sum': 2308471.972966413,
      'M': [[1, 1, 1, 0], [1, 1, 1, 0], [1, 1, 1, 0], [0, 0, 0, 1]],
      'n_kf': [31, 31, 28, 16],
      'S_ok': [[0, 1, 1, 0], [1, 0, 1, 0], [1, 1, 0, 0], [0, 0, 0, 0]],
      'merged': [[0, 1, 1, 0], [1, 0, 1, 0], [1, 1, 0, 0], [0, 0, 0, 0]],
      'last_seen': [[-1, 5, 11, -1], [5, -1, 11, -1], [5, 5, -1, -1], [-1, -1, -1, -1]],
      'dropped': [[0, 0, 3, 0], [0, 0, 3, 0], [0, 0, 0, 0], [0, 0, 0, 0]],
      'refresh_interval': [[2, 4, 4, 2], [4, 2, 4, 2], [4, 4, 2, 2], [2, 2, 2, 2]],
      'next_refresh': [[1, 6, 6, 1], [6, 1, 6, 1], [6, 6, 1, 1], [1, 1, 1, 1]],
      'S_peer_ts': [[[0.0, 0.0, 0.0, 1.0], [-0.3867309, 0.279797, -0.5205369, 0.7170812],
                     [-0.01038197, -0.003152296, 0.003682137, 1.004045], [0.0, 0.0, 0.0, 1.0]],
                    [[0.4820857, -0.3171268, 0.7834072, 1.391966], [0.0, 0.0, 0.0, 1.0],
                     [0.4615339, -0.3043779, 0.7852621, 1.404187], [0.0, 0.0, 0.0, 1.0]],
                    [[-0.00909856, -0.002914786, -0.006502151, 0.9971985],
                     [-0.3830239, 0.2644142, -0.5158157, 0.7125254], [0.0, 0.0, 0.0, 1.0],
                     [0.0, 0.0, 0.0, 1.0]],
                    [[0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 1.0],
                     [0.0, 0.0, 0.0, 1.0]]]}],
    # phase 23's layout through three JAX `SlamAgent`s (`--slice8
    # --seed-offset N`, tracker draws from PRNGKey(agent id + N)): per agent
    # the merged peers, the parent frame, the creators in its map, the ATE
    # over its tracked trajectory (m) and its poses. At offset 0 agent 1 was
    # lost at its init and merged with nobody; at offsets 10 and 20 one
    # agent's init took a wrong two-view solution (ATE 0.71 and 0.22 m,
    # fault o).
    "agents": [{'offset': 0,
      'merge_steps': {'3': [['merged', 2, 51]]},
      '1': {'merged': {'2': False, '3': False},
            'parent': 'world',
            'creators': [1],
            'ate': 0.2790575325489044,
            'n_poses': 34},
      '2': {'merged': {'1': False, '3': True},
            'parent': 'world',
            'creators': [2, 3],
            'ate': 0.006936934776604176,
            'n_poses': 46},
      '3': {'merged': {'1': False, '2': True},
            'parent': 'robot2/origin',
            'creators': [2, 3],
            'ate': 0.0066430456936359406,
            'n_poses': 44}},
     {'offset': 10,
      'merge_steps': {'3': [['merged', 2, 43], ['implicit_merge', 1, 50]],
                      '2': [['merged', 1, 50]],
                      '1': [['implicit_merge', 3, 51]]},
      '1': {'merged': {'2': True, '3': True},
            'parent': 'world',
            'creators': [1, 2],
            'ate': 0.003230250207707286,
            'n_poses': 42},
      '2': {'merged': {'1': True, '3': True},
            'parent': 'robot1/origin',
            'creators': [1, 2, 3],
            'ate': 0.00723015982657671,
            'n_poses': 47},
      '3': {'merged': {'1': True, '2': True},
            'parent': 'robot1/origin',
            'creators': [2, 3],
            'ate': 0.7077903151512146,
            'n_poses': 42}},
     {'offset': 20,
      'merge_steps': {'2': [['merged', 1, 50]],
                      '3': [['merged', 2, 50], ['merged', 1, 50]],
                      '1': [['implicit_merge', 3, 51]]},
      '1': {'merged': {'2': True, '3': True},
            'parent': 'world',
            'creators': [1, 2, 3],
            'ate': 0.2214011549949646,
            'n_poses': 41},
      '2': {'merged': {'1': True, '3': True},
            'parent': 'robot1/origin',
            'creators': [1, 2, 3],
            'ate': 0.006751787383109331,
            'n_poses': 46},
      '3': {'merged': {'1': True, '2': True},
            'parent': 'robot1/origin',
            'creators': [1, 2, 3],
            'ate': 0.011026601307094097,
            'n_poses': 43}},
     {'offset': 30,
      'merge_steps': {'2': [['merged', 1, 50]],
                      '3': [['merged', 2, 50]],
                      '1': [['implicit_merge', 3, 51]]},
      '1': {'merged': {'2': True, '3': True},
            'parent': 'world',
            'creators': [1, 2, 3],
            'ate': 0.004050608724355698,
            'n_poses': 41},
      '2': {'merged': {'1': True, '3': True},
            'parent': 'robot1/origin',
            'creators': [1, 2, 3],
            'ate': 0.006173980422317982,
            'n_poses': 45},
      '3': {'merged': {'1': True, '2': True},
            'parent': 'robot2/origin',
            'creators': [1, 2, 3],
            'ate': 0.0036523034796118736,
            'n_poses': 41}},
     {'offset': 40,
      'merge_steps': {'2': [['merged', 1, 50]],
                      '3': [['merged', 2, 50]],
                      '1': [['implicit_merge', 3, 51]]},
      '1': {'merged': {'2': True, '3': True},
            'parent': 'world',
            'creators': [1, 2, 3],
            'ate': 0.004156986717134714,
            'n_poses': 41},
      '2': {'merged': {'1': True, '3': True},
            'parent': 'robot1/origin',
            'creators': [1, 2, 3],
            'ate': 0.007814760319888592,
            'n_poses': 46},
      '3': {'merged': {'1': True, '2': True},
            'parent': 'robot2/origin',
            'creators': [1, 2, 3],
            'ate': 0.0059066335670650005,
            'n_poses': 39}}],
}
# phase 19: the point statistics `load_atlas` recomputes (`update_point_stats`)
RECOMPUTED = ("pt_desc", "pt_normal", "pt_min_dist", "pt_max_dist")

# Slice 9: the depth sensors and the fisheye camera, each through its
# `System` entry point at a shipped configuration's full width (as dicts:
# the card's Python has no YAML parser). Phase 24: `configs/kitti.yaml` with
# ORB-SLAM3's `Examples/Stereo/KITTI00-02.yaml` Camera.bf; phase 25:
# `configs/tum.yaml` with `Examples/RGB-D/TUM1.yaml`'s Camera.bf and
# DepthMapFactor, the depth fed as uint16 sensor units; phase 26:
# `configs/tum_vi.yaml` (KB8) as it is. Frame i is stamped i / camera.fps.
KITTI_BF = 386.1448
TUM_BF = 40.0
TUM_DEPTH_FACTOR = 5000.0
KITTI_SETTINGS = {
    "camera": {"model": "pinhole", "fx": 718.856, "fy": 718.856, "cx": 607.1928,
               "cy": 185.2157, "dist": (0.0, 0.0, 0.0, 0.0), "width": 1241, "height": 376,
               "fps": 10.0, "rgb": False, "baseline": KITTI_BF / 718.856},
    "orb": {"n_features": 2000, "scale_factor": 1.2, "n_levels": 8, "ini_th_fast": 20.0,
            "min_th_fast": 7.0},
    "kf_capacity": 1024, "pt_capacity": 32768,
}
TUM_SETTINGS = {
    "camera": {"model": "pinhole", "fx": 535.4, "fy": 539.2, "cx": 320.1, "cy": 247.6,
               "dist": (0.0, 0.0, 0.0, 0.0), "width": 640, "height": 480, "fps": 30.0,
               "rgb": True, "baseline": TUM_BF / 535.4,
               "depth_map_factor": 1.0 / TUM_DEPTH_FACTOR},
    "orb": {"n_features": 1000, "scale_factor": 1.2, "n_levels": 8, "ini_th_fast": 20.0,
            "min_th_fast": 7.0},
    "kf_capacity": 512, "pt_capacity": 16384,
}
TUM_VI_SETTINGS = {
    "camera": {"model": "kb8", "fx": 190.97847715128717, "fy": 190.9733070521226,
               "cx": 254.93170605935475, "cy": 256.8974428996504,
               "dist": (0.0034823894022493434, 0.0007150348452162257, -0.0020532361418706202,
                        0.00020293673591811182),
               "width": 512, "height": 512, "fps": 20.0, "rgb": False},
    "orb": {"n_features": 1000, "scale_factor": 1.2, "n_levels": 8, "ini_th_fast": 20.0,
            "min_th_fast": 7.0},
    "kf_capacity": 512, "pt_capacity": 16384,
}
N_FRAMES9 = 40
N_PLAIN9 = 8               # the plain path's calls in phases 24-26, held call by call
# The JAX CPU reference of phase 24 runs at smaller capacities: its point
# statistics hold a [kf_capacity, pt_capacity, 256] descriptor gather, 35 GB
# of host memory at KITTI's 1024 x 32768. Capacities change no output while
# the map stays inside them; the card runs KITTI's and is held to stay
# inside these.
REF9_CAPS = {24: (128, 16384)}
# the worlds (PlaneWorld(seed=7, tex_size=TEX_SIZE, ...)) and trajectories
# (smooth_trajectory(N_FRAMES9, ...)): phase 25's nearer world keeps the
# scene inside th_depth (40 x 0.0747 m), so keyframes create close points
WORLD9 = {24: dict(plane_z=6.0, extent=36.0), 25: dict(plane_z=2.5, extent=15.0),
          26: dict(plane_z=6.0, extent=36.0, **DENSE_WORLD)}
TRAJ9 = {24: dict(lateral=2.0, forward=0.8, yaw=0.08),
         25: dict(lateral=0.8, forward=0.3, yaw=0.08),
         26: dict(lateral=2.0, forward=0.6, yaw=0.08)}
# phase 26's fisheye frames are warped from pinhole renders covering the
# lens out to this angle; pixels beyond it are black, as outside a real
# fisheye's image circle
FISHEYE_THETA_MAX = float(np.deg2rad(60.0))
STEREO_RTOL = 0.02         # stereo matches per frame against the JAX CPU reference
# The JAX package's CPU references of phases 24-26 (`python
# tests/test_torch_slice.py --slice9 [stereo|rgbd|kb8]`: its System on the
# same frames, with the port's repair of the pipelined retire, fault v):
# the init (frame pair; the first frame with a pose), the frames that made
# keyframes, n_kf, n_pt, valid points, per call the stereo (or depth)
# matches of the frame, per depth-created batch (keyframe slot, points), the
# stored observations with a right u, the ATE against ground truth (m;
# SE3-aligned on the first pose, and Sim3-aligned), the frames with a pose,
# and for KB8 the two-view init under the draws of agents 0-5 (frame pair,
# homography, good points; fault o).
JAX_REF9 = {'stereo': {'init_pair': [0, 0],
            'first_pose': 0,
            'final_state': 'OK',
            'kf_frames': [0, 1, 11, 17, 27, 34, 38],
            'n_kf': 7,
            'n_pt': 2786,
            'n_valid_points': 520,
            'stereo_matches': [705, 688, 615, 579, 554, 597, 564, 527, 528, 511, 538, 483, 479,
                               465, 437, 437, 472, 446, 452, 450, 458, 410, 413, 419, 410, 369,
                               332, 332, 375, 352, 414, 461, 415, 412, 406, 400, 406, 386, 351,
                               351],
            'close_points': [[0, 705], [1, 373], [2, 282], [3, 286], [4, 160], [5, 239],
                             [6, 234]],
            'stereo_obs': 2750,
            'ate_metric_m': 0.010802111393767036,
            'ate_sim3_m': 0.00840417668223381,
            'n_tracked': 40},
 'rgbd': {'init_pair': [0, 0],
          'first_pose': 0,
          'final_state': 'OK',
          'kf_frames': [0, 1, 5, 9, 12],
          'n_kf': 5,
          'n_pt': 2635,
          'n_valid_points': 975,
          'stereo_matches': [817, 801, 771, 851, 863, 851, 821, 822, 778, 730, 693, 733, 714,
                             690, 680, 686, 670, 681, 654, 650, 623, 610, 590, 595, 627, 612,
                             579, 560, 578, 572, 549, 565, 553, 525, 505, 451, 476, 504, 462,
                             499],
          'close_points': [[0, 831], [1, 252], [2, 472], [3, 490], [4, 558]],
          'stereo_obs': 3214,
          'ate_metric_m': 0.0040932992565872245,
          'ate_sim3_m': 0.003575177164748311,
          'n_tracked': 40},
 'kb8': {'init_pair': [0, 2],
         'first_pose': 2,
         'final_state': 'OK',
         'kf_frames': [0, 2, 3, 7, 12, 32, 37],
         'n_kf': 7,
         'n_pt': 1676,
         'n_valid_points': 676,
         'ate_metric_m': 0.5975856893570254,
         'ate_sim3_m': 0.00709697138518095,
         'n_tracked': 38,
         'used_homography': True,
         'n_init_good': 336,
         'init_by_seed': [[[0, 2], True, 336], [[0, 2], True, 333], [[0, 4], False, 237],
                          [[0, 1], False, 445], [[0, 1], False, 439], [[0, 1], False, 442]]}}

# K1 against its twin: the same floats in the same order, so identical bits;
# the angle may differ where atan2f and PyTorch's atan2 round differently
ANGLE_ATOL = 1e-6
POSE_ATOL = 1e-4
POSE_ATOL2 = 1e-3          # slice 2, kernels against plain versions
K2_RTOL = 1e-5             # K2 against the plain product: 1e-5 (1 + max|ref|)
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "orb_describe": ("dvm_slam_tpu_torch/csrc/orb_describe.cu",
                     "dvm_slam_tpu/ops/pallas_orb.py:55"),
    "onehot_adjoint": ("dvm_slam_tpu_torch/csrc/onehot_scatter.cu",
                       "dvm_slam_tpu/ops/pallas_scatter.py:36"),
    "onehot_gather": ("dvm_slam_tpu_torch/csrc/onehot_scatter.cu",
                      "dvm_slam_tpu/ops/pallas_scatter.py:90"),
}
# Phase 15's bounds: the H100 SXM data sheet's memory rate and f32 rate
# outside the tensor cores. K1's operations per keypoint: the moments over
# the 31x31 window (mask, x and y products, two sums), the 512 steered
# pattern points (four products, two sums) and 256 compares.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
K1_OPS_PER_KEYPOINT = 5 * 31 * 31 + 6 * 512 + 256
TABLE_LS = (8, 20, L_SYSTEM)   # BA windows: the init BA, slice 2, System's keyframe BA


def settings9(phase: int, module):
    """Phase 24-26's settings through `module.settings_from_dict` (the port's
    `io.config`, or the JAX package's for its reference run)."""
    d = {24: KITTI_SETTINGS, 25: TUM_SETTINGS, 26: TUM_VI_SETTINGS}[phase]
    return module.settings_from_dict({k: dict(v) if isinstance(v, dict) else v
                                      for k, v in d.items()})


def depth_to_sensor(depth):
    """Metric depth [h,w] -> uint16 TUM sensor units (m x 5000)."""
    return np.clip(np.round(np.asarray(depth, np.float64) * TUM_DEPTH_FACTOR), 0,
                   65535).astype(np.uint16)


def fisheye_source(params):
    """The pinhole camera (K, size) whose renders phase 26 warps into the
    fisheye: the fisheye's focal lengths, square, covering FISHEYE_THETA_MAX."""
    half = int(np.ceil(max(params[0], params[1]) * np.tan(FISHEYE_THETA_MAX))) + 2
    return (float(params[0]), float(params[1]), float(half), float(half)), 2 * half + 1


def fisheye_field(params, h: int, w: int):
    """For every fisheye pixel its source pixel in the `fisheye_source`
    render (x, y [h,w] f32) and whether its ray lies inside the image
    circle: the KB8 polynomial inverted by Newton in float64."""
    fx, fy, cx, cy = (float(v) for v in params[:4])
    k = [float(v) for v in params[4:8]]
    v, u = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64),
                       indexing="ij")
    mx, my = (u - cx) / fx, (v - cy) / fy
    d = np.hypot(mx, my)
    theta = d.copy()
    for _ in range(30):
        t2 = theta * theta
        f = theta * (1 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3])))) - d
        fp = 1 + t2 * (3 * k[0] + t2 * (5 * k[1] + t2 * (7 * k[2] + 9 * t2 * k[3])))
        theta = theta - f / fp
    inside = theta <= FISHEYE_THETA_MAX
    scale = np.where(d > 1e-12, np.tan(np.minimum(theta, FISHEYE_THETA_MAX)) / np.maximum(d, 1e-12),
                     1.0)
    Ks, _ = fisheye_source(params)
    return ((Ks[0] * mx * scale + Ks[2]).astype(np.float32),
            (Ks[1] * my * scale + Ks[3]).astype(np.float32), inside)


def warp_to_fisheye(img, field):
    """Bilinear resampling of a `fisheye_source` render [S,S] into the
    fisheye image; black outside the image circle. numpy f32, so the card's
    and the reference's frames come from the same arithmetic."""
    img = np.asarray(img, np.float32)
    fx_, fy_, inside = field
    S = img.shape[0]
    x = np.clip(fx_, 0, S - 1.001)
    y = np.clip(fy_, 0, S - 1.001)
    x0, y0 = x.astype(np.int32), y.astype(np.int32)
    ax, ay = x - x0, y - y0
    out = (img[y0, x0] * (1 - ax) * (1 - ay) + img[y0, x0 + 1] * ax * (1 - ay)
           + img[y0 + 1, x0] * (1 - ax) * ay + img[y0 + 1, x0 + 1] * ax * ay)
    return np.where(inside, out, np.float32(0.0)).astype(np.float32)


def _se3_matrix(T):
    """[qw qx qy qz tx ty tz] world->camera -> 4x4 float64."""
    w, x, y, z = (float(v) for v in T[:4])
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    M = np.eye(4)
    M[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                 [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                 [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    M[:3, 3] = np.asarray(T[4:7], np.float64)
    return M


def metric_ate(est, gt) -> float:
    """ATE (RMSE of camera centers, m) after aligning the first estimated
    pose to the first true one by SE3 only: a metric sensor's scale error
    shows directly (`tests/test_stereo.py:_metric_ate`)."""
    A = _se3_matrix(gt[0]) @ np.linalg.inv(_se3_matrix(est[0]))
    errs = [np.linalg.norm(np.linalg.inv(A @ _se3_matrix(e))[:3, 3]
                           - np.linalg.inv(_se3_matrix(g))[:3, 3]) for e, g in zip(est, gt)]
    return float(np.sqrt(np.mean(np.square(errs))))


def card_line() -> str:
    """`name, power.limit` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def print_ptxas(rec):
    for line in rec["ptxas"].splitlines():
        if "registers" in line or "smem" in line or "spill" in line or "Compiling" in line:
            print(f"    ptxas: {line.strip()}")


def check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"smoke check failed: {what}")


def configs(use_kernel):
    from dvm_slam_tpu_torch.frontend.extractor import FrontendConfig
    from dvm_slam_tpu_torch.tracking.tracker import TrackerConfig

    fc = FrontendConfig(height=H, width=W, n_features=N_FEATURES, n_levels=N_LEVELS,
                        use_kernel=use_kernel)
    return TrackerConfig(frontend=fc, kf_cap=128, pt_cap=8192, fps=20.0)


def scene(device, **world_kw):
    """Frames, frame 0's depth and ground-truth poses of the benchmark scene
    (`world_kw`: the world's layout, e.g. DENSE_WORLD)."""
    from dvm_slam_tpu_torch.io import synthetic

    world = synthetic.PlaneWorld(seed=7, tex_size=TEX_SIZE, plane_z=6.0, extent=36.0,
                                 device=device, **world_kw)
    poses = synthetic.smooth_trajectory(60, lateral=2.5, forward=0.8, yaw=0.1)[:N_FRAMES2]
    imgs = [world.render(p, K_EUROC, H, W) for p in poses]
    depth0 = world.render_depth(poses[0], K_EUROC, H, W)
    return imgs, depth0, poses


def center_err(T_cw, T_gt) -> float:
    import torch

    from dvm_slam_tpu_torch.geometry import lie

    c = lie.se3_t(lie.se3_inv(T_cw.detach().cpu()))
    g = lie.se3_t(lie.se3_inv(torch.as_tensor(T_gt)))
    return float(torch.linalg.norm(c - g))


def run_slice(imgs, depth0, cfg, device):
    """Bootstrap from frame 0 (RGB-D), then track frames 1.. with the motion
    model. Returns (map, n_created, [(n_inliers, T_cw, T_pred, ms)]), ms
    the host clock around each frame's synchronised `make_and_track`."""
    import torch

    from dvm_slam_tpu_torch.frontend.extractor import make_frame_rgbd
    from dvm_slam_tpu_torch.geometry import lie
    from dvm_slam_tpu_torch.mapping import map_state
    from dvm_slam_tpu_torch.tracking import tracker

    K = torch.tensor(K_EUROC, dtype=torch.float32, device=device)
    dist = torch.zeros(4, device=device)
    f0 = make_frame_rgbd(imgs[0], depth0, K, dist, cfg.frontend, K_EUROC[0] * cfg.baseline)
    m = map_state.create(cfg.kf_cap, cfg.pt_cap, cfg.frontend.capacity, device=device)
    m, n_created = tracker.bootstrap_from_depth(m, f0, K, cfg)
    T, vel, out = lie.se3_identity(device=device), lie.se3_identity(device=device), []
    for img in imgs[1:]:
        T_pred = lie.se3_mul(vel, T)
        t0 = time.perf_counter()
        _, res, pv, pf = tracker.make_and_track(img, m, T_pred, K, dist, cfg)
        if device.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        m = m._replace(pt_visible=pv, pt_found=pf)
        T, vel = tracker.motion_model_step(T, res, cfg)
        out.append((int(res.n_inliers), T.clone(), T_pred, ms))
    return m, int(n_created), out


def run_slice2(imgs, depth0, cfg, device, timed: bool = False):
    """Bootstrap from frame 0 (RGB-D), then `autonomous_step` on frames 1..
    Returns (map, n_created, [(n_inliers, made_kf, good, T_cw, ms, valid
    points)]); ms is the frame's latency (host clock around a synchronised
    step) when `timed`, else None."""
    import torch

    from dvm_slam_tpu_torch.frontend.extractor import make_frame_rgbd
    from dvm_slam_tpu_torch.geometry import lie
    from dvm_slam_tpu_torch.mapping import map_state
    from dvm_slam_tpu_torch.tracking import tracker

    K = torch.tensor(K_EUROC, dtype=torch.float32, device=device)
    dist = torch.zeros(4, device=device)
    f0 = make_frame_rgbd(imgs[0], depth0, K, dist, cfg.frontend, K_EUROC[0] * cfg.baseline)
    m = map_state.create(cfg.kf_cap, cfg.pt_cap, cfg.frontend.capacity, device=device)
    m, n_created = tracker.bootstrap_from_depth(m, f0, K, cfg)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    st = tracker.AutoState(T_cw=lie.se3_identity(device=device),
                           velocity=lie.se3_identity(device=device), frames_since_kf=zero,
                           ref_tracked=n_created.to(torch.int32), kf_count=zero)
    out = []
    for img in imgs[1:]:
        t0 = time.perf_counter()
        m, st, fl = tracker.autonomous_step(img, m, st, K, dist, cfg, MAPPER)
        if timed:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 if timed else None
        out.append((int(fl.n_inliers), bool(fl.made_kf), bool(fl.good), st.T_cw.clone(), ms,
                    int(m.pt_valid.sum())))
    return m, int(n_created), out


def euroc_settings(fps=None):
    from dvm_slam_tpu_torch.io import config

    d = {k: dict(v) if isinstance(v, dict) else v for k, v in EUROC_SETTINGS.items()}
    if fps is not None:
        d["camera"]["fps"] = fps
    return config.settings_from_dict(d)


def run_slice3(imgs, device, use_kernel, timed: bool = False, vocabulary=None):
    """Every frame through the port's `System.track_monocular(img, i / FPS3)`
    at the EuRoC settings, from frame 0: two-view init, then the autonomous
    lane. Returns a dict: the System, the two-view results, the init frame
    pair, the initial map (poses of keyframes 0-1 and the points) and per
    call (kind, ms); ms is the host clock around a synchronised call when
    `timed`, else None. `vocabulary`: the file `System` loads (relocalization
    and the atlas; nothing they do shows before a loss)."""
    import torch

    from dvm_slam_tpu_torch.geometry import two_view
    from dvm_slam_tpu_torch.models.system import System
    from dvm_slam_tpu_torch.tracking import tracker as trk

    settings = euroc_settings()
    inits = []
    original = two_view.reconstruct_two_views

    def recording(*args, **kwargs):
        res = original(*args, **kwargs)
        inits.append(res)
        return res

    two_view.reconstruct_two_views = recording
    try:
        sysm = System(settings, device=device, use_kernel=use_kernel, vocabulary_file=vocabulary)
        t = sysm.tracker
        calls, init_pair, init_map = [], None, None
        for i, img in enumerate(imgs):
            was, n_kf0 = t.state, int(t.map.n_kf) if timed else 0
            t0 = time.perf_counter()
            sysm.track_monocular(img, i / FPS3)
            if timed:
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 if timed else None
            if was == trk.NOT_INITIALIZED and t.state == trk.OK:
                init_pair = (int(round(t._init_ts * FPS3)), i)
                n = int(t.map.n_pt)
                init_map = (t.map.kf_pose[:2].clone(), n, t.map.pt_pos[:n].clone())
                kind = "init"
            elif t.state == trk.NOT_INITIALIZED:
                kind = "before init"
            elif not t.autonomous:
                kind = "host path"
            elif t._auto_imgs:
                kind = "buffered"
            elif timed and int(t.map.n_kf) > n_kf0:
                kind = "dispatch, keyframe"
            else:
                kind = "dispatch"
            calls.append((kind, ms))
    finally:
        two_view.reconstruct_two_views = original
    return dict(system=sysm, inits=inits, init_pair=init_pair, init_map=init_map, calls=calls)


def slice3_outcome(run, poses, out_path):
    """Save the run's trajectory (TUM), read it back and align it to ground
    truth by timestamp. Returns (tracked frames, keyframe frames, ATE m)."""
    from dvm_slam_tpu_torch.eval import metrics
    from dvm_slam_tpu_torch.io import trajectory

    sysm = run["system"]
    sysm.save_trajectory_tum(out_path)
    rows = trajectory.load_tum(out_path)
    frames = [int(round(ts * FPS3)) for ts, _ in rows]
    ate, _, _ = metrics.ate_rmse(np.stack([T for _, T in rows]),
                                 np.stack([np.asarray(poses[i]) for i in frames]))
    kf_frames = sorted(int(round(ts * FPS3)) for ts in sysm.tracker.kf_timestamps.values())
    return frames, kf_frames, ate


def slice6_sequence(n_black, revisit):
    """(frame or None for a black frame, timestamp) per call: frames 0..59,
    the blackout, the revisit."""
    frames = list(range(60)) + [None] * n_black + list(range(*revisit))
    return [(f, i / FPS3) for i, f in enumerate(frames)]


class CountingRelocalizer:
    """The tracker's relocalizer, keeping the inlier count of its last call."""

    def __init__(self, inner):
        self.inner, self.last = inner, 0

    def __call__(self, m, frame):
        ok, T, n = self.inner(m, frame)
        self.last = int(n)
        return ok, T, n

    def reset(self, kf_cap):
        self.inner.reset(kf_cap)


def instrument(sysm, log, timed_sync):
    """Record the slice-6 events of `sysm`'s tracker into `log`: per call
    (state, pose given, n_kf, stored maps), relocalization attempts (call,
    ok, inliers, pose), stashes (call, n_kf), merge-back attempts (call,
    query, merged, S_ab, merged n_kf, trajectory rows before the merge, K2
    and K3 launches, BA window rows) and two-view inits, with the ms of each
    (`timed_sync` synchronises around them). Records of the autonomous lane
    retire as soon as the next one is dispatched (`_record_ready` true, as on
    the CPU), so a hand-back lands on the same call in every run."""
    from dvm_slam_tpu_torch.ops import scatter

    t = sysm.tracker
    t._record_ready = lambda rec: True
    t.relocalizer = CountingRelocalizer(t.relocalizer)
    for k in ("calls", "reloc", "stash", "merge", "init_pairs"):
        log.setdefault(k, [])
    log.setdefault("cur", 0)

    def timed(fn):
        timed_sync()
        t0 = time.perf_counter()
        out = fn()
        timed_sync()
        return out, (time.perf_counter() - t0) * 1e3

    try_reloc = t._try_relocalize

    def reloc(frame, ts):
        pose, ms = timed(lambda: try_reloc(frame, ts))
        log["reloc"].append((log["cur"], pose is not None, t.relocalizer.last,
                             None if pose is None else pose.detach().cpu().numpy(), ms))
        return pose

    stash = t._new_map_in_atlas

    def new_map():
        n_kf = int(t.map.n_kf)
        _, ms = timed(stash)
        log["stash"].append((log["cur"], n_kf, ms))

    merge = t.atlas.try_merge_back
    shapes = []
    adjoint = scatter.onehot_adjoint

    def adjoint_rows(v, pidx, P, use_kernel=None):
        shapes.append(int(pidx.shape[0]))
        return adjoint(v, pidx, P, use_kernel=use_kernel)

    def merge_back(m, meta, q):
        k0 = counts_now()
        shapes.clear()
        scatter.onehot_adjoint = adjoint_rows
        try:
            out, ms = timed(lambda: merge(m, meta, q))
        finally:
            scatter.onehot_adjoint = adjoint
        log["merge"].append(dict(
            call=log["cur"], query=int(q), merged=out is not None,
            S_ab=None if out is None else np.asarray(out[3]), n_kf=None if out is None
            else int(out[0].n_kf), rows=len(t.trajectory), ms=ms,
            k2=counts_now()["onehot_adjoint"] - k0["onehot_adjoint"],
            k3=counts_now()["onehot_gather"] - k0["onehot_gather"],
            ba_rows=sorted(set(shapes))))
        return out

    t._try_relocalize, t._new_map_in_atlas, t.atlas.try_merge_back = reloc, new_map, merge_back


def drive6(sysm, imgs, seq, start, log):
    """Calls `start..` of `seq` through `sysm.track_monocular`, recording
    into the `log` that `instrument` set up; returns the poses returned."""
    from dvm_slam_tpu_torch.tracking import tracker as trk

    t = sysm.tracker
    black = np.zeros(tuple(imgs[0].shape), np.float32)
    poses = {}
    for i in range(start, len(seq)):
        f, ts = seq[i]
        log["cur"] = i
        was = t.state
        pose = sysm.track_monocular(black if f is None else imgs[f], ts)
        if was == trk.NOT_INITIALIZED and t.state == trk.OK:
            log["init_pairs"].append((int(round(t._init_ts * FPS3)), i))
        log["calls"].append((i, t.state, pose is not None, int(t.map.n_kf), len(t.atlas.inactive)))
        if pose is not None:
            poses[i] = np.asarray(pose.detach().cpu() if hasattr(pose, "detach") else pose,
                                  np.float32)
    return poses


def rows_np(tracker):
    """The trajectory as (timestamp, T_cw numpy [7]) rows."""
    return [(float(ts), np.asarray(T.detach().cpu() if hasattr(T, "detach") else T, np.float32))
            for ts, T, _ in tracker.trajectory]


def stored_frame_ate(rows, merge_rows, seq, poses):
    """Sim3-aligned ATE over the rows in the stored map's frame: the frames
    before the stash (calls 0..59) and the rows after the merge."""
    from dvm_slam_tpu_torch.eval import metrics

    keep = [r for r in rows[:merge_rows] if int(round(r[0] * FPS3)) < 60] + list(rows[merge_rows:])
    keep = [r for r in keep if seq[int(round(r[0] * FPS3))][0] is not None]
    est = np.stack([T for _, T in keep])
    gt = np.stack([np.asarray(poses[seq[int(round(ts * FPS3))][0]]) for ts, _ in keep])
    return metrics.ate_rmse(est, gt)[0], len(keep)


def camera_center(T):
    import torch

    from dvm_slam_tpu_torch.geometry import lie

    return lie.se3_t(lie.se3_inv(torch.as_tensor(np.asarray(T, np.float32)))).numpy()


def ba_inputs(device, L=BA_SHAPES["L"]):
    """K2/K3 inputs at BA's shapes (L window rows) from numpy seed 0: indices
    in [-1, P) with repeats, one row all -1."""
    import torch

    G, F, P = BA_SHAPES["G"], BA_SHAPES["F"], BA_SHAPES["P"]
    rng = np.random.RandomState(0)
    vals = rng.randn(L, G, F).astype(np.float32)
    pidx = rng.randint(-1, P, (L, F)).astype(np.int32)
    pidx[1, 100:160] = 17              # one point at many features of a row
    pidx[L - 1] = -1                   # a row with no observation
    pts = rng.randn(3, P).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(vals), t(pidx), t(pts), P


def adversarial_indices(L, F, P):
    """The index sets K2 and K3 are held to, name -> pidx [L,F] int32: random
    in [-1, P); every feature of a row in one 128-column tile (row 0: all at
    one point); every other row all -1; only -1, 0, P-1, P and P+1; runs of
    64 equal indices."""
    rng = np.random.RandomState(L)
    rand = rng.randint(-1, P, (L, F))
    one_tile = rng.randint(256, 384, (L, F))
    one_tile[0] = 300
    empty = rand.copy()
    empty[::2] = -1
    at_p = rng.choice([-1, 0, P - 1, P, P + 1], (L, F))
    runs = np.repeat(rng.randint(-1, P, (L, -(-F // 64))), 64, axis=1)[:, :F]
    sets = {"random": rand, "one tile": one_tile, "rows of -1": empty, "index = P": at_p,
            "duplicate runs": runs}
    return {k: v.astype(np.int32) for k, v in sets.items()}


def check_ba_kernels(dev):
    """Phase 8: K2 and K3 at BA's shapes (G=30, F=512, P=4096) and the three
    windows L = 8, 20, 32, on every adversarial index set, K2's input the
    [L,G,F] view that `bundle_adjust` passes. K2 within 1e-5 (1 + max|ref|)
    of its plain version, bit-identical to itself on a second run and to the
    ascending-f sum (`onehot_adjoint_ordered`); K3 bit-identical to its plain
    version. Returns the largest errors (K2, K3) against the plain versions."""
    import torch

    from dvm_slam_tpu_torch.ops import scatter, scatter_kernel

    G, F, P = BA_SHAPES["G"], BA_SHAPES["F"], BA_SHAPES["P"]
    k2_err = k3_err = 0.0
    for L in TABLE_LS:
        rng = np.random.RandomState(100 + L)
        vals = torch.from_numpy(rng.randn(L, G, F).astype(np.float32)).to(dev)
        pts = torch.from_numpy(rng.randn(3, P).astype(np.float32)).to(dev)
        v = k2_input(vals)
        for name, idx in adversarial_indices(L, F, P).items():
            pidx = torch.from_numpy(idx).to(dev)
            a1 = scatter_kernel.onehot_adjoint(v, pidx, P)
            a2 = scatter_kernel.onehot_adjoint(v, pidx, P)
            ap = scatter.onehot_adjoint_plain(v, pidx, P)
            ao = scatter.onehot_adjoint_ordered(v, pidx, P)
            g = scatter_kernel.onehot_gather(pts, pidx)
            gp = scatter.onehot_gather_plain(pts, pidx)
            torch.cuda.synchronize()
            e2, b2 = float((a1 - ap).abs().max()), K2_RTOL * (1.0 + float(ap.abs().max()))
            e3 = float((g - gp).abs().max())
            rerun, ordered, same3 = torch.equal(a1, a2), torch.equal(a1, ao), torch.equal(g, gp)
            print(f"[8] L={L} {name}: K2 max abs err {e2:.3e} (bound {b2:.3e}), equal on a "
                  f"second run {rerun}, equal to the ascending-f sum {ordered}; K3 "
                  f"bit-identical {same3}")
            check(e2 <= b2, f"K2 error {e2} > {b2} at L={L}, {name}")
            check(rerun and ordered, f"K2 not deterministic in ascending f at L={L}, {name}")
            check(same3, f"K3 differs from its plain version at L={L}, {name}")
            k2_err, k3_err = max(k2_err, e2), max(k3_err, e3)
    return k2_err, k3_err


def frame_inputs(img, fc):
    """K1's inputs for one frame as `extract` makes them: (raw levels,
    blurred levels, keypoints [F,2] in level px, level offsets)."""
    import torch

    from dvm_slam_tpu_torch.ops import fast, pyramid

    levels = pyramid.build_pyramid(img, fc.n_levels, fc.scale_factor)
    raws, blurs, xys = [], [], []
    for im, budget in zip(levels, fc.level_budgets):
        xy, _, _ = fast.detect_level(im, fc.ini_th, fc.min_th, fc.cell, budget)
        raws.append(im.contiguous())
        blurs.append(pyramid.gaussian_blur(im).contiguous())
        xys.append(xy)
    return raws, blurs, torch.cat(xys), fc.level_offsets


# The adversarial frame's levels: odd sizes, the last one the least K1 takes
ADV_SHAPES = ((351, 601), (293, 501), (243, 417), (203, 347), (169, 289), (141, 241),
              (117, 201), (31, 37))
ADV_NO_VALID, ADV_EMPTY = 3, 5   # a level with only invalid slots, a level with none


def adversarial_frame(dev):
    """K1's hardest frame, from numpy seed 11: 8 levels of noise of odd
    sizes; on each, the slots `detect_level` fills, invalid ones included
    (those may lie in the padding past the image), then the corners, the
    detection border (15, 16, W-17, W-16), half pixels (rounded to even) and
    points outside the image, where the moment centre and the BRIEF samples
    are clamped. Level ADV_NO_VALID holds only the invalid slots that
    `detect_level` leaves on a flat image; level ADV_EMPTY holds no slot."""
    import torch

    from dvm_slam_tpu_torch.ops import fast, pyramid

    rng = np.random.RandomState(11)
    raws, blurs, xys = [], [], []
    for lv, (h, w) in enumerate(ADV_SHAPES):
        im = torch.from_numpy((rng.rand(h, w) * 255).astype(np.float32)).to(dev)
        if lv == ADV_NO_VALID:
            xy, _, valid = fast.detect_level(torch.full_like(im, 100.0), 20.0, 7.0, 35, 64)
            check(not bool(valid.any()), "a flat level has a valid keypoint")
        elif lv == ADV_EMPTY:
            xy = torch.zeros((0, 2), device=dev)
        else:
            det, _, _ = fast.detect_level(im, 20.0, 7.0, 35, 96)
            edge = torch.tensor(
                [[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1], [15, 15], [16, 16],
                 [w - 16, h - 16], [w - 17, h - 17], [15.5, 16.5], [16.5, 15.5],
                 [w - 16.5, h - 15.5], [w / 2 + 0.5, h / 2 - 0.5], [-3.2, -0.5],
                 [w + 20, h + 7], [w + 40.0, -30.0]], dtype=torch.float32, device=dev)
            xy = torch.cat([det, edge])
        raws.append(im)
        blurs.append(pyramid.gaussian_blur(im).contiguous())
        xys.append(xy)
    offsets = tuple(int(o) for o in np.cumsum([0] + [x.shape[0] for x in xys]))
    return raws, blurs, torch.cat(xys), offsets


def check_k1(name, raws, blurs, xy, offsets, tag=3):
    """Phase 3 (and phase 24's stereo pair): one K1 launch for the frame
    against the twin, level by level: 0 differing descriptor bits, angles
    within ANGLE_ATOL. Returns the largest angle difference."""
    import torch

    from dvm_slam_tpu_torch.ops import orb_descriptor, orb_kernel

    before = counts_now()["orb_describe"]
    ang_k, desc_k = orb_kernel.orient_and_describe_levels(raws, blurs, xy, offsets)
    ang_t, desc_t = orb_descriptor.orient_and_describe_levels(raws, blurs, xy, offsets)
    torch.cuda.synchronize()
    check(counts_now()["orb_describe"] == before + 1,
          f"{name}: {counts_now()['orb_describe'] - before} K1 launches for one frame")
    for lv, (a, b) in enumerate(zip(offsets[:-1], offsets[1:])):
        err = float((ang_k[a:b] - ang_t[a:b]).abs().max()) if b > a else 0.0
        diff = int((desc_k[a:b] != desc_t[a:b]).sum())
        print(f"[{tag}] {name} level {lv} {tuple(raws[lv].shape)} N={b - a}: angle max err "
              f"{err:.3e}, {diff} differing bits")
    worst = float((ang_k - ang_t).abs().max())
    n_diff = int((desc_k != desc_t).sum())
    print(f"[{tag}] {name}, one launch for {len(raws)} levels: angle max abs err {worst:.3e} (atol "
          f"{ANGLE_ATOL}), differing bits {n_diff}/{desc_k.numel()}")
    check(bool(torch.isfinite(ang_k).all()), f"{name}: non-finite K1 angle")
    check(worst <= ANGLE_ATOL, f"{name}: K1 angle error {worst} > {ANGLE_ATOL}")
    check(n_diff == 0, f"{name}: {n_diff} K1 descriptor bits differ from the twin's")
    return worst


def time_ms(fn, reps: int) -> float:
    """Mean ms per call on the card, CUDA events around `reps` calls."""
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(fns, reps: int, rounds: int = 5):
    """Median ms per call of each of `fns`, timed in turns: each of `rounds`
    rounds times `reps` back-to-back calls of every function between CUDA
    events, so a drift of the host's speed lands on all of them alike."""
    import torch

    for fn in fns:
        for _ in range(3):
            fn()
    times = [[] for _ in fns]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(rounds):
        for fn, t in zip(fns, times):
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            t.append(start.elapsed_time(end) / reps)
    return [float(np.median(t)) for t in times]


def device_us(fn, n: int = 100, replays: int = 5) -> float:
    """Device-only µs per call: `n` calls captured in one CUDA graph, the
    graph replayed `replays` times between CUDA events. No host work is
    timed, only the launches back to back on the device."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / (n * replays)


def profiler_us(fn, kernel: str, n: int = 50):
    """Mean device µs per launch of the CUDA kernel whose name contains
    `kernel`, from `torch.profiler`'s kernel rows over `n` calls; None where
    the profiler shows no such row."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if kernel in e.key]
    except RuntimeError as e:  # a sandbox without CUPTI: the events above stand
        print(f"    profiler unavailable: {e}")
        return None
    count = sum(e.count for e in rows)
    return sum(e.self_device_time_total for e in rows) / count if count else None


def bound_us(nbytes: float, nops: float):
    """(µs, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over the memory rate and the operations over the
    f32 rate (H100 SXM data sheet)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e6, nops / F32_OPS_PER_S * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def system_levels(img_full):
    """K1's inputs for one frame at the System's size (the frame resized to
    600x350 as `track_monocular` does)."""
    import torch

    from dvm_slam_tpu_torch.frontend.extractor import FrontendConfig
    from dvm_slam_tpu_torch.ops import pyramid

    cam, orb = EUROC_SETTINGS["camera"], EUROC_SETTINGS["orb"]
    h, w = cam["new_height"], cam["new_width"]
    img = pyramid.resize(img_full.to(torch.float32), h, w)
    fc = FrontendConfig(height=h, width=w, n_features=orb["n_features"],
                        n_levels=orb["n_levels"], scale_factor=orb["scale_factor"])
    return frame_inputs(img, fc)


def k2_input(vals):
    """K2's input as `bundle_adjust` passes it: the values [L,G,F] stored
    feature-major ([L,F,G]) and handed over as an [L,G,F] view."""
    return vals.permute(0, 2, 1).contiguous().permute(0, 2, 1)


def kernel_table(dev, card, img_full, counts):
    """Step 0 of every kernel redesign: per kernel at the System path's
    shapes, its launches on that path (`counts`, None when not run), the
    wrapper-included µs, the device-only µs (CUDA graph; `torch.profiler`
    beside it), the bound, the one PyTorch call computing the same function
    (`library`, timed here only) and the plain version. Returns
    {name: row} with the L = 32 rows for K2 and K3."""
    import torch

    from dvm_slam_tpu_torch.ops import orb_descriptor, orb_kernel, scatter, scatter_kernel

    rows = {}
    # K1: one call for the 8 levels of one System frame
    raws, blurs, xy, offsets = system_levels(img_full)
    n = xy.shape[0]
    fn = lambda: orb_kernel.orient_and_describe_levels(raws, blurs, xy, offsets)  # noqa: E731
    wrap, dv = time_ms(fn, 200) * 1e3, device_us(fn)
    prof = profiler_us(fn, "orb_describe")
    plain = time_ms(lambda: orb_descriptor.orient_and_describe_levels(raws, blurs, xy, offsets),
                    20) * 1e3
    # each level's raw and blurred image, the keypoints, the angles and the
    # descriptors once, and the pattern once per call
    nbytes = (4 * (2 * sum(r.numel() for r in raws) + 2 * n + n) + n * orb_descriptor.DESC_BITS
              + orb_descriptor.PATTERN.nbytes)
    nops = n * K1_OPS_PER_KEYPOINT
    b, by = bound_us(nbytes, nops)
    rows["orb_describe"] = dict(wrap=wrap, dev=dv, prof=prof, bound=b, by=by, lib=None,
                                lib_dev=None, plain=plain, per_row=1)
    print(f"[15] K1 per frame (one call, 8 levels at 600x350, N={n}): wrapper {wrap:.2f} us, "
          f"device {dv:.2f} us (profiler {prof}), bound {b:.3f} us ({by}: {nbytes / 1e6:.3f} MB, "
          f"{nops / 1e6:.2f} Mop), no single PyTorch call, twin {plain:.2f} us on {card}")
    # K1 per stereo pair: one call for both views' 16 levels at KITTI width
    raws, blurs, xy, offsets = stereo_pair_inputs(dev)
    n = xy.shape[0]
    fn = lambda: orb_kernel.orient_and_describe_levels(raws, blurs, xy, offsets)  # noqa: E731
    wrap2, dv2 = time_ms(fn, 200) * 1e3, device_us(fn)
    plain2 = time_ms(lambda: orb_descriptor.orient_and_describe_levels(raws, blurs, xy, offsets),
                     20) * 1e3
    nbytes = (4 * (2 * sum(r.numel() for r in raws) + 2 * n + n) + n * orb_descriptor.DESC_BITS
              + orb_descriptor.PATTERN.nbytes)
    b2, by2 = bound_us(nbytes, n * K1_OPS_PER_KEYPOINT)
    rows["orb_describe"]["stereo"] = dict(wrap=wrap2, dev=dv2, bound=b2, by=by2, plain=plain2)
    print(f"[15] K1 per stereo pair (one call, 2 x 8 levels at 1241x376, N={n}): wrapper "
          f"{wrap2:.2f} us, device {dv2:.2f} us, bound {b2:.3f} us ({by2}: {nbytes / 1e6:.3f} MB), "
          f"twin {plain2:.2f} us on {card}")

    # K2 and K3 at System's window (L = 32) and the slice-2 and init windows
    for L in TABLE_LS:
        vals, pidx, pts_pl, P = ba_inputs(dev, L)
        G, F = vals.shape[1], vals.shape[2]
        v = k2_input(vals)
        ok = (pidx >= 0) & (pidx < P)
        col = torch.where(ok, pidx, P).to(torch.int64)
        idx2 = col[:, None, :].expand(L, G, F).contiguous()
        idx3 = col[:, None, :].expand(L, 3, F).contiguous()
        pts_pad = torch.cat([pts_pl, torch.zeros((3, 1), device=dev)], 1)
        lib2 = lambda: torch.zeros((L, G, P + 1), device=dev).scatter_add_(2, idx2, v)  # noqa: E731
        lib3 = lambda: torch.gather(pts_pad.expand(L, 3, P + 1), 2, idx3)  # noqa: E731
        k2 = lambda: scatter_kernel.onehot_adjoint(v, pidx, P)  # noqa: E731
        k3 = lambda: scatter_kernel.onehot_gather(pts_pl, pidx)  # noqa: E731
        # the yardsticks compute the same function
        ref2 = scatter.onehot_adjoint_plain(v, pidx, P)
        d_lib2 = float((lib2()[..., :P] - ref2).abs().max())
        same3 = torch.equal(lib3(), scatter.onehot_gather_plain(pts_pl, pidx))
        n_hit = int(ok.sum())
        for name, fn, lib, plain, nbytes, nops, kname in (
                ("onehot_adjoint", k2, lib2, lambda: scatter.onehot_adjoint_plain(v, pidx, P),
                 4 * (L * G * F + L * F + L * G * P), G * n_hit, "onehot_adjoint_kernel"),
                ("onehot_gather", k3, lib3, lambda: scatter.onehot_gather_plain(pts_pl, pidx),
                 4 * (3 * P + L * F + L * 3 * F), 0, "onehot_gather_kernel")):
            wrap, lib_ms = paired_ms([fn, lib], 40)
            row = dict(wrap=wrap * 1e3, dev=device_us(fn), prof=profiler_us(fn, kname),
                       lib=lib_ms * 1e3, lib_dev=device_us(lib),
                       plain=time_ms(plain, 50) * 1e3, per_row=1)
            row["bound"], row["by"] = bound_us(nbytes, nops)
            print(f"[15] {name} L={L}: wrapper {row['wrap']:.2f} us, device {row['dev']:.2f} us "
                  f"(profiler {row['prof']}), bound {row['bound']:.3f} us ({row['by']}: "
                  f"{nbytes / 1e6:.3f} MB), library {row['lib']:.2f} us (device "
                  f"{row['lib_dev']:.2f} us), plain {row['plain']:.2f} us on {card}")
            if L == L_SYSTEM:
                rows[name] = row
        print(f"[15] yardsticks at L={L}: zero fill + scatter_add_ within {d_lib2:.3e} of K2's "
              f"plain version; torch.gather bit-identical to K3's: {same3}")
        check(d_lib2 <= K2_RTOL * (1.0 + float(ref2.abs().max())) and same3,
              f"a library yardstick computes another function at L={L}")

    # the redesign rule: first the kernels slower than their library call
    # (largest factor first), then the rest by time lost per System run
    for name, row in rows.items():
        row["launches"] = None if counts is None else counts[name]
    losers = sorted((n for n, r in rows.items() if r["lib"] is not None and r["wrap"] > r["lib"]),
                    key=lambda n: -rows[n]["wrap"] / rows[n]["lib"])
    rest = [n for n in rows if n not in losers]
    if counts is not None:
        rest.sort(key=lambda n: -(rows[n]["launches"] / rows[n]["per_row"])
                  * (rows[n]["wrap"] - rows[n]["bound"]))
    for n in losers:
        print(f"[15] rule: {n} loses to its library call by "
              f"{rows[n]['wrap'] / rows[n]['lib']:.2f}x")
    for n in rest:
        lost = (None if counts is None else
                rows[n]["launches"] / rows[n]["per_row"] * (rows[n]["wrap"] - rows[n]["bound"]))
        print(f"[15] rule: {n} loses {lost} us per System run above its bound")
    print(f"[15] rule order: {losers + rest}")
    return rows


def print_ms(phase, name, what, ms, card):
    if ms:
        ms = np.asarray(ms)
        print(f"[{phase}] {name}: {what}: median {np.median(ms):.2f} ms, max {ms.max():.2f} ms "
              f"(n={len(ms)}) on {card}")
    else:
        print(f"[{phase}] {name}: {what}: no call")


def check_phase16(runs, seq, counts, card):
    """Phase 16 against the JAX CPU reference of the same run: the lost
    state after the blackout, the first successful relocalization within 1
    call of the reference's with >= 30 inliers, the relocalized camera
    center within 3x the reference's distance (at least RELOC_DIST_FLOOR)
    from the pre-blackout estimate of the same view, a pose for every later
    call; K1 once per call; the plain path relocalizing at the same call
    with poses to 1e-3."""
    from dvm_slam_tpu_torch.tracking import relocalization, tracker as trk

    ref = JAX_REF6["phase16"]
    out = {}
    for name, (log, poses, rows) in runs.items():
        ok = [r for r in log["reloc"] if r[1]]
        check(bool(ok), f"{name}: no relocalization")
        call, _, n_inl, T_rel, _ = ok[0]
        view = seq[call][0]
        pre = [T for ts, T in rows if abs(ts - view / FPS3) < 1e-9]
        check(len(pre) == 1, f"{name}: no pre-blackout row of frame {view}")
        dist = float(np.linalg.norm(camera_center(T_rel) - camera_center(pre[0])))
        lost = [c for c in log["calls"] if c[0] < call and c[1] in (trk.RECENTLY_LOST, trk.LOST)]
        later = [c for c in log["calls"] if c[0] > call]
        out[name] = (call, T_rel, poses)
        states = [c[1] for c in log["calls"][:call - 59]]
        attempts = [(r[0], r[1], r[2]) for r in log["reloc"]]
        print(f"[16] {name}: states after the blackout {states}; "
              f"relocalization attempts {attempts}; first success "
              f"at call {call} (frame {view}; JAX CPU ref call {ref['reloc_call']}) with {n_inl} "
              f"inliers (ref {ref['reloc_inliers']}); camera center {dist:.5f} from the "
              f"pre-blackout estimate (ref {ref['reloc_dist']:.5f}); later calls with a pose "
              f"{sum(c[2] for c in later)}/{len(later)}")
        print_ms(16, name, "_try_relocalize, success", [r[4] for r in log["reloc"] if r[1]], card)
        print_ms(16, name, "_try_relocalize, failure", [r[4] for r in log["reloc"] if not r[1]],
                 card)
        check(bool(lost), f"{name}: never RECENTLY_LOST/LOST after the blackout")
        check(abs(call - ref["reloc_call"]) <= 1,
              f"{name}: relocalized at call {call}, JAX CPU ref {ref['reloc_call']}")
        check(n_inl >= relocalization.MIN_RELOC_INLIERS, f"{name}: {n_inl} relocalization inliers")
        check(dist <= max(3.0 * ref["reloc_dist"], RELOC_DIST_FLOOR),
              f"{name}: relocalized {dist} from the pre-blackout estimate")
        check(all(c[2] for c in later), f"{name}: a call after the relocalization gave no pose")
    print(f"[16] launches: {counts}")
    check(counts["orb_describe"] == len(seq) - 60,
          f"K1 launched {counts['orb_describe']} times for {len(seq) - 60} calls")
    (ck, Tk, pk), (cp, Tp, pp) = out["kernels"], out["plain"]
    d = float(np.abs(Tk - Tp).max())
    common = sorted(set(pk) & set(pp))
    dp = max(float(np.abs(pk[i] - pp[i]).max()) for i in common) if common else 0.0
    print(f"[16] plain path: relocalized at call {cp} (kernels {ck}); relocalized poses differ by "
          f"{d:.3e}, later poses by {dp:.3e}")
    check(cp == ck, "the paths relocalize at different calls")
    check(d <= POSE_ATOL2 and dp <= POSE_ATOL2 and set(pk) == set(pp),
          f"kernel and plain poses differ by {max(d, dp)}")


def check_phase17(runs, seq, counts, poses_gt, card):
    """Phase 17 against the JAX CPU reference of the same run: one stash
    within one batch (4 calls) of the reference's with its stored keyframe
    count +-2; a second init within the reference's spread; the merge-back
    (no stored map left, more keyframes than stored) within MERGE_CALLS of
    the reference's call, S_ab of positive scale; the ATE over the rows in
    the stored map's frame under 3x the reference's; the welding BA's K2/K3
    launched once per LM step at L = WELD_L; K1 once per call; the plain
    path's first N_PLAIN17 calls with the kernel path's states, keyframes
    and inits, poses to 1e-3."""
    ref = JAX_REF6["phase17"]
    name = "kernels"
    log, poses, rows, sysm = runs[name]
    t = sysm.tracker
    merged = [m for m in log["merge"] if m["merged"]]
    print(f"[17] {name}: stashes (call, n_kf) {[s[:2] for s in log['stash']]} (JAX CPU ref "
          f"{ref['stash']}); inits {log['init_pairs']} (ref {ref['init_pairs']}); merge-back "
          f"attempts at calls {[m['call'] for m in log['merge']]}, merged at "
          f"{[m['call'] for m in merged]} (ref {ref['merge_call']}); final n_kf "
          f"{int(t.map.n_kf)}, stored maps {len(t.atlas.inactive)}, state {t.state}")
    print_ms(17, name, "_new_map_in_atlas", [s[2] for s in log["stash"]], card)
    print_ms(17, name, "try_merge_back, rejected", [m["ms"] for m in log["merge"]
                                                   if not m["merged"]], card)
    print_ms(17, name, "try_merge_back, merged", [m["ms"] for m in merged], card)
    print_ms(17, name, "_try_relocalize, failure", [r[4] for r in log["reloc"] if not r[1]],
             card)
    check(len(log["stash"]) == 1, f"{name}: {len(log['stash'])} stashes")
    s_call, s_kf = log["stash"][0][:2]
    check(abs(s_call - ref["stash"][0]) <= 4,
          f"{name}: stashed at call {s_call}, JAX CPU ref {ref['stash'][0]}")
    check(abs(s_kf - ref["stash"][1]) <= 2,
          f"{name}: stashed {s_kf} keyframes, JAX CPU ref {ref['stash'][1]}")
    second = [p for p in log["init_pairs"] if p[1] > s_call]
    check(bool(second), f"{name}: no second map")
    first_f, second_f = (seq[c][0] for c in second[0])
    spread = ref["init_spread"]
    print(f"[17] {name}: second map initialized on frames ({first_f}, {second_f}); JAX CPU ref "
          f"spread over agents 0-5 {spread}")
    late = first_f > max(p[0] for p in spread) + 1 or second_f > max(p[1] for p in spread) + 1
    check(not late,
          f"{name}: second init at frames ({first_f}, {second_f}), later than the ref spread")
    check(len(merged) == 1 and not t.atlas.inactive and merged[0]["n_kf"] > s_kf,
          f"{name}: no merge-back")
    m = merged[0]
    check(abs(m["call"] - ref["merge_call"]) <= MERGE_CALLS,
          f"{name}: merged at call {m['call']}, JAX CPU ref {ref['merge_call']}")
    check(m["S_ab"][7] > 0, f"{name}: S_ab scale {m['S_ab'][7]}")
    ate, n_rows = stored_frame_ate(rows, m["rows"], seq, poses_gt)
    print(f"[17] {name}: S_ab {np.round(m['S_ab'], 5).tolist()} (ref "
          f"{np.round(ref['S_ab'], 5).tolist()}); welding BA K2/K3 launches {m['k2']}/{m['k3']}"
          f" at window rows {m['ba_rows']}; ATE over {n_rows} rows in the stored map's frame "
          f"{ate:.6f} m (bound 3x the ref's {ref['ate']:.6f} m)")
    check(ate < 3.0 * ref["ate"], f"{name}: ATE {ate} >= 3x {ref['ate']}")
    check(m["ba_rows"] == [WELD_L], f"{name}: welding BA window rows {m['ba_rows']}")
    check(m["k2"] == WELD_ITERS + 6 and m["k3"] == WELD_ITERS + 7,
          f"welding BA launched K2/K3 {m['k2']}/{m['k3']} times")
    print(f"[17] launches: {counts}")
    check(counts["orb_describe"] == len(seq),
          f"K1 launched {counts['orb_describe']} times for {len(seq)} calls")
    (log_k, poses_k, _, _), (log_p, poses_p, _, _) = runs["kernels"], runs["plain"]
    n = len(log_p["calls"])
    check_prefix(17, f"the first {n} calls", [c[1:] for c in log_k["calls"][:n]],
                 [c[1:] for c in log_p["calls"]],
                 [poses_k.get(i) for i in range(n)], [poses_p.get(i) for i in range(n)])
    check(log_p["init_pairs"] == [p for p in log_k["init_pairs"] if p[1] < n],
          f"[17] the paths initialize at different calls: {log_k['init_pairs']}, "
          f"{log_p['init_pairs']}")


def check_prefix(phase: int, what: str, states_k, states_p, poses_k, poses_p):
    """The plain path's prefix against the kernel path's run, call by call:
    identical per-call states (state, keyframes, whether a pose came back)
    and the poses within POSE_ATOL2."""
    same = states_k == states_p and [T is None for T in poses_k] == [T is None for T in poses_p]
    d = max((float(np.abs(np.asarray(a) - np.asarray(b)).max())
             for a, b in zip(poses_k, poses_p) if a is not None and b is not None), default=0.0)
    print(f"[{phase}] plain path over {what}: states and keyframes identical {same}; poses "
          f"differ by {d:.3e} ({sum(T is not None for T in poses_p)} poses)")
    check(same, f"[{phase}] the plain path's calls differ from the kernel path's")
    check(d <= POSE_ATOL2, f"[{phase}] poses differ by {d} between the paths")


def scene18(device, n_frames=80, traj_kw=TRAJ18):
    """Phase 18's frames (phase 23's: 110 frames along TRAJ23): the dense
    world along a trajectory, rendered at the EuRoC settings' output size
    with their K."""
    from dvm_slam_tpu_torch.io import synthetic

    settings = euroc_settings(FPS18)
    cam = settings.camera
    world = synthetic.PlaneWorld(seed=7, tex_size=TEX_SIZE, plane_z=6.0, extent=36.0,
                                 device=device, **DENSE_WORLD)
    traj = synthetic.smooth_trajectory(n_frames, **traj_kw)
    K = tuple(float(v) for v in cam.K())
    return [world.render(p, K, cam.out_height, cam.out_width) for p in traj], traj


def run_agents(device, use_kernel, imgs, traj, vocab, timed_sync, n_steps=N_STEPS18):
    """Phase 18: two `SlamAgent`s on one `LoopbackTransport`, each step one
    `process_image` per agent, then flush() and the idle protocol
    iterations (a prefix of `n_steps` < N_STEPS18 steps stops there).
    Autonomous records retire as soon as the next one is
    dispatched (`_record_ready` true, as on the CPU). Returns (agents, bus,
    record): the merges (agent, step, S_ab, the scale ground truth `traj`
    implies for S_ab), the keyframe batches received, the BA window rows K2
    saw, per call (agent, step, kind, ms), and per agent the keyframe count
    and the pose returned after each step."""
    from dvm_slam_tpu_torch.mapping.local_mapping import LocalMapper
    from dvm_slam_tpu_torch.multiagent.agent import SlamAgent
    from dvm_slam_tpu_torch.multiagent.transport import LoopbackTransport
    from dvm_slam_tpu_torch.ops import scatter
    from dvm_slam_tpu_torch.placerec import vocabulary
    from dvm_slam_tpu_torch.tracking import tracker as trk

    settings = euroc_settings(FPS18)
    cfg, K = settings.tracker_config(use_kernel), settings.camera.K()
    voc = vocabulary.load(vocab)
    bus = LoopbackTransport()
    agents = {aid: SlamAgent(aid, cfg, K, np.zeros(4, np.float32), voc, bus, [1, 2],
                             mapper=LocalMapper(**CONSOLE_MAPPER), device=device)
              for aid in (1, 2)}
    rec = dict(merges=[], splices=[], calls=[], ba_rows=set(), events=[])
    cur = [0]
    publish = bus.publish

    def publishing(sender, target, channel, msg):
        rec["events"].append((cur[0], sender, channel))
        return publish(sender, target, channel, msg)

    bus.publish = publishing
    for a in agents.values():
        a.tracker._record_ready = lambda r: True
        do_merge, receive = a._do_merge, a._receive_new_key_frames
        receive_bows = a._receive_new_key_frame_bows

        def bows_in(m, a=a, receive_bows=receive_bows):
            n_log = len(a.log)
            receive_bows(m)
            found = [e[2] for e in a.log[n_log:] if e[0] == "merge_candidates"]
            rec["events"].append((cur[0], a.agent_id, "bows in", len(a._own_kf_slots()), found))

        def merging(peer_id, mB, metaB, S_ab, weld_kf, a=a, do_merge=do_merge):
            # both maps against ground truth just before the splice: with
            # X_w = S_i X_i, S_ab = S_a^-1 S_b has the scale s_b / s_a
            sides = [kf_alignment(x, traj) for x in (a, agents[peer_id])]
            rec["merges"].append(dict(agent=a.agent_id, step=cur[0], S_ab=S_ab.cpu().numpy(),
                                      sides=sides, scale_gt=sides[1][1] / sides[0][1]))
            return do_merge(peer_id, mB, metaB, S_ab, weld_kf)

        def receiving(m, a=a, receive=receive):
            rec["splices"].append((a.agent_id, cur[0]))
            return receive(m)

        a._do_merge, a._receive_new_key_frames = merging, receiving
        a._receive_new_key_frame_bows = bows_in
    adjoint = scatter.onehot_adjoint

    def adjoint_rows(v, pidx, P, use_kernel=None):
        rec["ba_rows"].add(int(pidx.shape[0]))
        return adjoint(v, pidx, P, use_kernel=use_kernel)

    scatter.onehot_adjoint = adjoint_rows
    try:
        for step in range(n_steps + N_IDLE18 if n_steps == N_STEPS18 else n_steps):
            cur[0] = step
            if step == N_STEPS18:
                for a in agents.values():
                    a.flush()
            for aid, (lo, _) in SEGMENTS18.items():
                a = agents[aid]
                if step >= N_STEPS18:
                    a.run_once(step * 0.1)
                    continue
                t = a.tracker
                was, n_kf0, n_m, n_s = t.state, int(t.map.n_kf), len(rec["merges"]), len(rec["splices"])
                timed_sync()
                t0 = time.perf_counter()
                pose = a.process_image(imgs[lo + step], step * 0.1)
                timed_sync()
                ms = (time.perf_counter() - t0) * 1e3
                if len(rec["merges"]) > n_m:
                    kind = "merge"
                elif len(rec["splices"]) > n_s:
                    kind = "keyframes received"
                elif was == trk.NOT_INITIALIZED:
                    kind = "init" if t.state == trk.OK else "before init"
                elif not t.autonomous:
                    kind = "host path"
                elif t._auto_imgs:
                    kind = "buffered"
                else:
                    kind = "dispatch, keyframe" if int(t.map.n_kf) > n_kf0 else "dispatch"
                rec["calls"].append((aid, step, kind, ms))
                rec.setdefault("kf_steps", {1: [], 2: []})[aid].append(t.n_kf_host)
                rec.setdefault("poses", {1: [], 2: []})[aid].append(
                    None if pose is None else pose.detach().cpu().numpy())
    finally:
        scatter.onehot_adjoint = adjoint
    return agents, bus, rec


# --------------------------------------------------------------------------
# slice 8: agents as a batch axis (phases 20-23)
# --------------------------------------------------------------------------

def _rodrigues(w):
    """Rotation matrix of the rotation vector w (numpy, f64)."""
    th = float(np.linalg.norm(w))
    if th < 1e-12:
        return np.eye(3)
    k = np.asarray(w) / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _quat(R):
    """Unit quaternion (w, x, y, z) of a rotation matrix (numpy, f64)."""
    w = np.sqrt(max(1e-12, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    return np.array([w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
                     (R[1, 0] - R[0, 1]) / (4 * w)])


def protocol_maps(kf_cap=PROTO_CAPS[0], pt_cap=PROTO_CAPS[1], feat_cap=PROTO_CAPS[2],
                  n_kf=PROTO_N_KF, n_obs=PROTO_OBS, n_world=PROTO_WORLD, seed=PROTO_SEED):
    """Phase 22's maps as numpy dicts of `MapState` fields, after
    `tests/test_parallel.py::_agent_map` at EuRoC capacity: agents 0-2 look
    at one world of `n_world` points with random descriptors, agent 3 at a
    disjoint one 40 m away; each holds `n_kf` own keyframes along a 3 m
    track, each keyframe observing up to `n_obs` of its world's points (0.3 px
    of noise, 4 of 256 descriptor bits flipped, a random pyramid level), and
    a map point per observed world point (1 cm of noise). Agent 1 lives in
    the frame PROTO_G (x_b = s R x + t): its points and keyframe poses are
    mapped there, as `TestSim3OnMesh` does. Returns (maps, K [4])."""
    rng = np.random.RandomState(seed)
    fx, fy, cx, cy = PROTO_K
    w_img, h_img = 2 * cx, 2 * cy
    worlds = []
    for off in (0.0, 40.0):
        X = np.c_[rng.uniform(-6, 6, n_world) + off, rng.uniform(-3, 3, n_world),
                  rng.uniform(6, 10, n_world)]
        worlds.append((X, (rng.rand(n_world, 256) > 0.5).astype(np.uint8)))
    R_g = _rodrigues(PROTO_G[:3])
    t_g, s_g = np.asarray(PROTO_G[3:6]), PROTO_G[6]
    maps = []
    for a in range(PROTO_AGENTS):
        X, D = worlds[1 if a == 3 else 0]
        off = 40.0 if a == 3 else 0.0
        m = dict(kf_pose=np.tile(np.r_[1.0, np.zeros(6)], (kf_cap, 1)).astype(np.float32),
                 kf_valid=np.zeros(kf_cap, bool),
                 kf_xy=np.zeros((kf_cap, feat_cap, 2), np.float32),
                 kf_level=np.zeros((kf_cap, feat_cap), np.int32),
                 kf_angle=np.zeros((kf_cap, feat_cap), np.float32),
                 kf_desc=np.zeros((kf_cap, feat_cap, 256), np.uint8),
                 kf_feat_valid=np.zeros((kf_cap, feat_cap), bool),
                 kf_obs=np.full((kf_cap, feat_cap), -1, np.int32),
                 kf_ur=np.full((kf_cap, feat_cap), -1.0, np.float32))
        slot_of = np.full(n_world, -1, np.int64)
        first, count, centers = [], [], []
        for k in range(n_kf):
            c = np.array([off - 1.5 + 3.0 * k / (n_kf - 1) + 0.1 * a, 0.05 * a, 0.0])
            R_cw = _rodrigues([0.0, 0.02 * (k - n_kf / 2), 0.0]).T
            t_cw = -R_cw @ c
            pc = X @ R_cw.T + t_cw
            uv = np.c_[fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy]
            vis = np.flatnonzero((pc[:, 2] > 0.5) & (uv[:, 0] > 10) & (uv[:, 0] < w_img - 10)
                                 & (uv[:, 1] > 10) & (uv[:, 1] < h_img - 10))
            vis = rng.permutation(vis)[:n_obs]
            for wi in vis:
                if slot_of[wi] < 0:
                    slot_of[wi] = len(first)
                    first.append(k)
                    count.append(0)
                    centers.append(c)
                count[slot_of[wi]] += 1
            nf = len(vis)
            desc = D[vis].copy()
            flips = rng.randint(0, 256, (nf, 4))
            desc[np.arange(nf)[:, None], flips] ^= 1
            if a == 1:      # the pose in frame b, the scale folded into t
                R_cw, t_cw = R_cw @ R_g.T, -R_cw @ R_g.T @ t_g + s_g * t_cw
            m["kf_pose"][k] = np.r_[_quat(R_cw), t_cw]
            m["kf_valid"][k] = True
            m["kf_xy"][k, :nf] = uv[vis] + rng.randn(nf, 2) * 0.3
            m["kf_level"][k, :nf] = rng.randint(0, N_LEVELS, nf)
            m["kf_angle"][k, :nf] = rng.uniform(-np.pi, np.pi, nf)
            m["kf_desc"][k, :nf] = desc
            m["kf_feat_valid"][k, :nf] = True
            m["kf_obs"][k, :nf] = slot_of[vis]
        n_pt = len(first)
        world_of = np.argsort(np.where(slot_of >= 0, slot_of, n_world + 1))[:n_pt]
        P = X[world_of] + rng.randn(n_pt, 3) * 0.01
        if a == 1:
            P = s_g * P @ R_g.T + t_g
        ray = X[world_of] - np.asarray(centers)
        dist = np.linalg.norm(ray, axis=1)
        pad = lambda v, fill, dt: np.concatenate(  # noqa: E731
            [np.asarray(v, dt), np.full((pt_cap - n_pt,) + np.shape(v)[1:], fill, dt)])
        m.update(pt_pos=pad(P, 0.0, np.float32), pt_valid=pad(np.ones(n_pt), 0, bool),
                 pt_desc=pad(D[world_of], 0, np.uint8),
                 pt_normal=pad(ray / dist[:, None], 0.0, np.float32),
                 pt_min_dist=pad(dist * 0.5, 0.0, np.float32),
                 pt_max_dist=pad(dist * 2.0, 0.0, np.float32),
                 pt_ref_kf=pad(first, -1, np.int32), pt_visible=pad(count, 0, np.int32),
                 pt_found=pad(count, 0, np.int32), pt_first_kf=pad(first, -1, np.int32),
                 n_kf=np.int32(n_kf), n_pt=np.int32(n_pt))
        maps.append(m)
    return maps, np.asarray(PROTO_K, np.float32)


def protocol_windows(r):
    """Round r's own-keyframe windows [A, PROTO_WINDOW] (slot = id, oldest
    first, -1 empty): each agent reveals one keyframe a round and re-offers
    the three before it; agent PROTO_JUMPER jumps ahead by PROTO_JUMP
    keyframes from round PROTO_JUMP_ROUND on, so its peers count the
    keyframes the window slid past (`dropped`)."""
    out = np.full((PROTO_AGENTS, PROTO_WINDOW), -1, np.int32)
    for a in range(PROTO_AGENTS):
        newest = r + (PROTO_JUMP if a == PROTO_JUMPER and r >= PROTO_JUMP_ROUND else 0)
        ids = np.arange(newest - PROTO_WINDOW + 1, newest + 1)
        out[a] = np.where(ids >= 0, ids, -1)
    return out


def counts_now():
    from dvm_slam_tpu_torch.utils import profiling

    return {"orb_describe": profiling.counter("k1.launches"),
            "onehot_adjoint": profiling.counter("k2.launches"),
            "onehot_gather": profiling.counter("k3.launches")}


def zero_counts():
    from dvm_slam_tpu_torch.utils import profiling

    profiling.reset()


def map_diff(a, b, fields=("kf_pose", "pt_pos")):
    """Largest absolute difference per float field of two MapStates."""
    return {f: float((getattr(a, f) - getattr(b, f)).abs().max()) for f in fields}


def phase20(maps, dev, card):
    """`local_ba_batched` over four EuRoC-capacity maps at `LocalMapper()`'s
    shape against each map's own `local_ba`, its plain path, the folded
    K2/K3 launches of one LM step against four separate launches, and the
    time of the batched call against the four solo calls. Returns the
    launch counts of the batched call."""
    import torch

    from dvm_slam_tpu_torch.mapping import local_mapping, map_state
    from dvm_slam_tpu_torch.ops import scatter, scatter_kernel

    K = torch.tensor(euroc_settings().camera.K(), device=dev)
    stacked = map_state.stack_maps(maps)
    centers = torch.clamp(stacked.n_kf - 1, min=0)
    kw = dict(n_local=16, n_fixed=16, n_pts=4096, iters=8, n_levels=N_LEVELS, scale_factor=1.2)
    seen = {}
    adj, gat = scatter.onehot_adjoint_batched, scatter.onehot_gather_batched

    def adj_rec(vals, pidx, n_cols, use_kernel=None):
        seen.setdefault("adjoint", (vals.clone(), pidx.clone(), n_cols))
        return adj(vals, pidx, n_cols, use_kernel)

    def gat_rec(pts, pidx, use_kernel=None):
        seen.setdefault("gather", (pts.clone(), pidx.clone()))
        return gat(pts, pidx, use_kernel)

    scatter.onehot_adjoint_batched, scatter.onehot_gather_batched = adj_rec, gat_rec
    zero_counts()
    try:
        out, chi2 = local_mapping.local_ba_batched(stacked, centers, K, **kw)
        torch.cuda.synchronize()
    finally:
        scatter.onehot_adjoint_batched, scatter.onehot_gather_batched = adj, gat
    counts = counts_now()
    steps = kw["iters"] + 5 + 1
    print(f"[20] local_ba_batched over {len(maps)} maps (n_kf {stacked.n_kf.tolist()}, centers "
          f"{centers.tolist()}), L = 32: launches {counts}")
    check(counts["onehot_adjoint"] == steps and counts["onehot_gather"] == steps + 1,
          f"K2/K3 launched {counts} times for one batched BA of {steps} LM steps")
    worst = {"kf_pose": 0.0, "pt_pos": 0.0, "chi2": 0.0}
    gen = torch.Generator()
    gen.manual_seed(20)
    for b, m in enumerate(maps):
        solo, c = local_mapping.local_ba(m, centers[b], K, **kw)
        d = map_diff(map_state.unstack_maps(out, len(maps))[b], solo)
        rel = abs(float(chi2[b]) - float(c)) / max(abs(float(c)), 1e-12)
        # the solve's own sensitivity: the solo call on points moved by 1e-6
        nudged = m._replace(pt_pos=m.pt_pos + 1e-6 * torch.randn(m.pt_pos.shape, generator=gen)
                            .to(dev))
        spread = map_diff(local_mapping.local_ba(nudged, centers[b], K, **kw)[0], solo)
        print(f"[20] map {b}: against its own local_ba poses {d['kf_pose']:.3e}, points "
              f"{d['pt_pos']:.3e}, chi2 {float(chi2[b]):.6f} vs {float(c):.6f} ({rel:.2e} rel); "
              f"the solo call under a 1e-6 move of its points: poses {spread['kf_pose']:.3e}, "
              f"points {spread['pt_pos']:.3e}")
        check(torch.equal(out.kf_obs[b], solo.kf_obs), f"map {b}: observation tables differ")
        worst = {"kf_pose": max(worst["kf_pose"], d["kf_pose"]),
                 "pt_pos": max(worst["pt_pos"], d["pt_pos"]), "chi2": max(worst["chi2"], rel)}
    check(worst["kf_pose"] <= POSE_ATOL and worst["pt_pos"] <= 1e-3 and worst["chi2"] <= 1e-4,
          f"batched BA differs from the solo ones: {worst}")
    before = counts_now()
    plain, chi2p = local_mapping.local_ba_batched(stacked, centers, K, use_kernel=False, **kw)
    check(counts_now() == before, "the plain path launched a kernel")
    dp = map_diff(out, plain)
    print(f"[20] plain batched path against the kernel path: {dp}")
    check(max(dp.values()) <= 1e-4, f"batched plain path differs: {dp}")
    vals, pidx, P = seen["adjoint"]
    folded = scatter_kernel.onehot_adjoint(vals.reshape(-1, *vals.shape[2:]),
                                           pidx.reshape(-1, pidx.shape[-1]), P)
    sep = torch.stack([scatter_kernel.onehot_adjoint(vals[b], pidx[b].contiguous(), P)
                       for b in range(vals.shape[0])])
    pts, gidx = seen["gather"]
    g_fold = scatter.onehot_gather_batched(pts, gidx, use_kernel=True)
    g_sep = torch.stack([scatter_kernel.onehot_gather(pts[b].contiguous(), gidx[b].contiguous())
                         for b in range(pts.shape[0])])
    same = (torch.equal(folded.reshape(sep.shape), sep), torch.equal(g_fold, g_sep))
    print(f"[20] one LM step's folded K2 [{vals.shape[0]}x{vals.shape[1]} rows] and offset K3 "
          f"bit-identical to {vals.shape[0]} separate launches: {same}")
    check(all(same), "folded K2/K3 launches differ from separate ones")
    t_b, t_s = paired_ms([lambda: local_mapping.local_ba_batched(stacked, centers, K, **kw),
                          lambda: [local_mapping.local_ba(m, centers[b], K, **kw)
                                   for b, m in enumerate(maps)]], 1)
    print(f"[20] local_ba_batched {t_b:.2f} ms against four local_ba calls {t_s:.2f} ms "
          f"(median of 5, CUDA events) on {card}")
    return counts


def protocol_maps_on(dev):
    from dvm_slam_tpu_torch import convert
    from dvm_slam_tpu_torch.parallel import multi_agent as ma

    maps_np, K = protocol_maps()
    return ma.stack_agents([convert.map_state_from_numpy(m, dev) for m in maps_np]), K


def phase21(imgs, dev, card, voc):
    """`build_multi_agent_step`, A = 4: agent a's map seeded from the
    rendered depth of frame STARTS21[a] (as slice 1 seeds frame 0), then
    STEPS21 steps, agent a at its own next frame each step. Each step is
    held against the port's one-agent sequence on the same inputs."""
    import torch

    from dvm_slam_tpu_torch.frontend.extractor import extract, extract_batch, make_frame_rgbd
    from dvm_slam_tpu_torch.geometry import lie
    from dvm_slam_tpu_torch.io import synthetic
    from dvm_slam_tpu_torch.mapping import local_mapping, map_state
    from dvm_slam_tpu_torch.parallel import multi_agent as ma
    from dvm_slam_tpu_torch.placerec import vocabulary
    from dvm_slam_tpu_torch.tracking import tracker

    cfg = configs(None)
    fc = cfg.frontend
    A = len(STARTS21)
    K1 = torch.tensor(K_EUROC, dtype=torch.float32, device=dev)
    K = K1.expand(A, 4).contiguous()
    world = synthetic.PlaneWorld(seed=7, tex_size=TEX_SIZE, plane_z=6.0, extent=36.0, device=dev)
    poses = synthetic.smooth_trajectory(60, lateral=2.5, forward=0.8, yaw=0.1)
    maps = []
    for f in STARTS21:
        fr = make_frame_rgbd(imgs[f], world.render_depth(poses[f], K_EUROC, H, W), K1,
                             torch.zeros(4, device=dev), fc, K_EUROC[0] * cfg.baseline)
        m = map_state.create(cfg.kf_cap, cfg.pt_cap, fc.capacity, device=dev)
        maps.append(tracker.bootstrap_from_depth(m, fr, K1, cfg)[0])
    maps = ma.stack_agents(maps)
    ba = dict(ba_local=16, ba_fixed=16, ba_pts=4096, ba_iters=8)
    step = ma.build_multi_agent_step(A, cfg, voc, device=dev, **ba)
    levels, idf = voc.device_arrays(dev)
    T = vel = lie.se3_identity((A,), device=dev)
    worst, k1, ms_b, ms_s = {"pose": 0.0, "scores": 0.0}, [], [], []
    counts = dict.fromkeys(KERNELS, 0)      # the step's own launches, not the comparisons'
    for s in range(STEPS21):
        frame_imgs = torch.stack([imgs[f + 1 + s] for f in STARTS21])
        T_pred = lie.se3_mul(vel, T)
        before = counts_now()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T_new, inl, scores, maps_next = step(maps, frame_imgs, T_pred, K)
        torch.cuda.synchronize()
        ms_b.append((time.perf_counter() - t0) * 1e3)
        after = counts_now()
        for k in counts:
            counts[k] += after[k] - before[k]
        k1.append(after["orb_describe"] - before["orb_describe"])
        # the same inputs through the one-agent sequence
        t0 = time.perf_counter()
        seq = []
        for a, m in enumerate(map_state.unstack_maps(maps, A)):
            fr = extract(frame_imgs[a], fc)
            res = tracker.track_frame(m, fr, T_pred[a], K1, cfg)
            m_ba, _ = local_mapping.local_ba(m, torch.clamp(m.n_kf - 1, min=0), K1,
                                             n_local=16, n_fixed=16, n_pts=4096, iters=8,
                                             n_levels=N_LEVELS, scale_factor=1.2)
            bow = vocabulary.bow_vector(levels, idf, fr.desc, fr.valid, voc.branch, voc.n_words)
            seq.append((fr, res, m_ba, bow))
        torch.cuda.synchronize()
        ms_s.append((time.perf_counter() - t0) * 1e3)
        bows = torch.stack([q[3] for q in seq])
        sc_seq = 1.0 - 0.5 * torch.sum(torch.abs(bows[:, None] - bows[None]), -1)
        batch_frames = extract_batch(frame_imgs, fc)
        same_desc = all(torch.equal(bf.desc, q[0].desc) and torch.equal(bf.angle, q[0].angle)
                        for bf, q in zip(batch_frames, seq))
        check(same_desc, f"step {s}: extract_batch differs from four extract calls")
        check(inl.tolist() == [int(q[1].n_inliers) for q in seq], f"step {s}: inliers differ")
        dpose = float(max((T_new[a] - q[1].T_cw).abs().max() for a, q in enumerate(seq)))
        dsc = float((scores - sc_seq).abs().max())
        dmap = max(map_diff(map_state.unstack_maps(maps_next, A)[a], q[2])["kf_pose"]
                   for a, q in enumerate(seq))
        worst = {"pose": max(worst["pose"], dpose, dmap), "scores": max(worst["scores"], dsc)}
        check(torch.allclose(scores, scores.T) and bool((scores.diagonal() - 1).abs().max() < 1e-5),
              f"step {s}: scores not symmetric with 1 on the diagonal")
        print(f"[21] step {s}: inliers {inl.tolist()}, poses vs sequential {dpose:.2e}, "
              f"scores vs sequential {dsc:.2e}, K1 launches {k1[-1]}")
        chain = [tracker.motion_model_step(T[a], q[1]._replace(T_cw=T_new[a], n_inliers=inl[a]),
                                           cfg) for a, q in enumerate(seq)]
        T, vel = torch.stack([c[0] for c in chain]), torch.stack([c[1] for c in chain])
        maps = maps_next
    check(k1 == [1] * STEPS21, f"K1 launches per step {k1}, expected one for all {A} frames")
    check(worst["pose"] <= POSE_ATOL and worst["scores"] <= 1e-5,
          f"the batched step differs from the sequential agents: {worst}")
    print(f"[21] {STEPS21} steps of {A} agents: step {np.median(ms_b):.2f} ms (median) against "
          f"four sequential agent steps {np.median(ms_s):.2f} ms on {card}; launches {counts}")
    return counts


def run_protocol(dev, voc):
    """Phase 22's rounds through the kernels: `build_protocol_step` on
    `protocol_maps` with the step's own draws (`multi_agent.protocol_noise`,
    generator seeded `multi_agent.SEED`, as the JAX CPU reference replays
    them). Returns one record per round: the merge matrix and state on the
    host, n_kf, the invariant reports, ms per stage, the round's launches,
    the BA windows (batch, rows) K2 served, and the round's inputs."""
    import torch

    from dvm_slam_tpu_torch.mapping import map_state
    from dvm_slam_tpu_torch.ops import scatter
    from dvm_slam_tpu_torch.parallel import multi_agent as ma

    maps, K = protocol_maps_on(dev)
    A = PROTO_AGENTS
    cfg = euroc_settings().tracker_config(None)
    states = ma.stack_agents([ma.create_protocol_state(PROTO_CAPS[0], voc.n_words, A,
                                                       refresh_base=PROTO_REFRESH, device=dev)
                              for _ in range(A)])
    step = ma.build_protocol_step(A, cfg, voc, window=PROTO_WINDOW, refresh_every=PROTO_REFRESH,
                                  device=dev)
    gen = torch.Generator()
    gen.manual_seed(ma.SEED)
    Kb = torch.tensor(np.tile(K, (A, 1)), device=dev)
    adj = scatter.onehot_adjoint_batched
    rows = []

    def adj_rows(vals, pidx, n_cols, use_kernel=None):
        rows.append(tuple(pidx.shape[:2]))
        return adj(vals, pidx, n_cols, use_kernel)

    scatter.onehot_adjoint_batched = adj_rows
    out = []
    try:
        for r in range(PROTO_ROUNDS):
            noise = ma.protocol_noise(gen, A, 200, PROTO_CAPS[2], dev)
            win = torch.from_numpy(protocol_windows(r))
            prof, n_rows = {}, len(rows)
            inputs = (maps, states, Kb, win, noise)
            before = counts_now()
            maps, states, M = step(maps, states, Kb, win, win, noise, profile=prof)
            torch.cuda.synchronize()
            after = counts_now()
            out.append(dict(
                M=M.int().tolist(), noise_sum=float(noise.double().sum()),
                **{f: getattr(states, f).int().tolist() for f in PROTO_INT_FIELDS},
                n_kf=maps.n_kf.tolist(), S_peer=states.S_peer.cpu().numpy(),
                invariants=[map_state.check_invariants(m) for m in map_state.unstack_maps(maps, A)],
                ms={k: v * 1e3 for k, v in prof.items()},
                launches={k: after[k] - before[k] for k in after}, rows=rows[n_rows:],
                inputs=inputs))
    finally:
        scatter.onehot_adjoint_batched = adj
    return out


def protocol_plain(dev, voc, rounds):
    """Phase 22's plain path: every round again on that round's own inputs
    through the kernels and through the plain versions, the global BA left
    out of both: it calls no kernel, and on merged maps its f32 result is
    not reproducible (atomic scatters feed a chaotic solve, fault t: a
    refresh refit after it moved by 2e-2 between two card runs of the same
    path). Returns per round the two outcomes' largest pose difference and
    whether every integer agreed."""
    import torch

    from dvm_slam_tpu_torch.parallel import multi_agent as ma

    steps = {uk: ma.build_protocol_step(PROTO_AGENTS, euroc_settings().tracker_config(uk), voc,
                                        window=PROTO_WINDOW, refresh_every=PROTO_REFRESH,
                                        global_ba_after=False, device=dev)
             for uk in (None, False)}
    out = []
    for r, rec in enumerate(rounds):
        maps, states, Kb, win, noise = rec["inputs"]
        (mk, sk, Mk), (mp, sp, Mp) = (steps[uk](maps, states, Kb, win, win, noise)
                                      for uk in (None, False))
        same = (torch.equal(Mk, Mp) and torch.equal(mk.n_kf, mp.n_kf)
                and all(torch.equal(getattr(sk, f), getattr(sp, f)) for f in PROTO_INT_FIELDS))
        out.append((float((mk.kf_pose - mp.kf_pose).abs().max()), same))
    return out


def protocol_truth():
    """[A,A,4] translation and scale of the Sim3 from agent a's world to
    agent me's in `protocol_maps` (agent 1's world is PROTO_G of the others';
    agent 3's pairs are never verified)."""
    R = _rodrigues(PROTO_G[:3])
    t, s = np.asarray(PROTO_G[3:6]), PROTO_G[6]
    G, G_inv = np.r_[t, s], np.r_[-R.T @ t / s, 1.0 / s]
    out = np.tile(np.r_[0.0, 0.0, 0.0, 1.0], (PROTO_AGENTS, PROTO_AGENTS, 1))
    for me in range(PROTO_AGENTS):
        for a in range(PROTO_AGENTS):
            if (me == 1) != (a == 1):
                out[me, a] = G if me == 1 else G_inv
    return out


def check_phase22(rounds, plain, card):
    """Phase 22 against JAX_REF8 and kernel against plain path. S_peer
    (translation, scale) is held to the reference within S_ATOL8 where its
    last fit read maps no global BA had moved; a refit after a global BA on
    merged maps reads a chaotic map (fault t), so there it is held to the
    Sim3 between the agents' true frames, within 3x the reference's own
    error against it (and S_ATOL8)."""
    ref = JAX_REF8["rounds"]
    truth = protocol_truth()
    steps = 4 + 5 + 1               # the welding BA's LM steps (4 iterations)
    refit_after_gba = np.zeros((PROTO_AGENTS, PROTO_AGENTS), bool)
    gba_ran, prev = False, None
    for r, (got, want) in enumerate(zip(rounds, ref)):
        print(f"[22] round {r}: M {got['M']}, n_kf {got['n_kf']}, S_ok {got['S_ok']}, "
              f"last_seen {got['last_seen']}, dropped {got['dropped']}, refresh_interval "
              f"{got['refresh_interval']}, next_refresh {got['next_refresh']}; K2 windows "
              f"{got['rows']}, launches {got['launches']}")
        stages = ", ".join(f"{k} {v:.2f}" for k, v in got["ms"].items())
        print(f"[22] round {r} ms by stage: {stages} on {card}")
        check(abs(got["noise_sum"] - want["noise_sum"]) <= 1e-6 * abs(want["noise_sum"]),
              f"round {r}: the draws differ from the reference's")
        for f in ("M", "n_kf") + PROTO_INT_FIELDS:
            check(got[f] == want[f], f"round {r}: {f} {got[f]}, JAX CPU reference {want[f]}")
        S_ref = np.asarray(want["S_peer_ts"])
        if prev is not None and gba_ran:
            refit_after_gba |= np.abs(S_ref - prev).max(-1) > 0
        S = got["S_peer"][..., 4:]
        d_ref = np.abs(S - S_ref).max(-1)
        ok = np.asarray(want["S_ok"], bool)
        first = ok & ~refit_after_gba
        late = ok & refit_after_gba
        d_first = float(d_ref[first].max()) if first.any() else 0.0
        print(f"[22] round {r}: S_peer (t, s) against the reference {float(d_ref.max()):.2e}; "
              f"fits on maps no global BA moved {d_first:.2e} (bound {S_ATOL8})")
        check(d_first <= S_ATOL8, f"round {r}: S_peer differs from the reference by {d_first}")
        if late.any():
            e_card = float(np.abs(S - truth).max(-1)[late].max())
            e_ref = float(np.abs(S_ref - truth).max(-1)[late].max())
            bound = max(S_ATOL8, 3.0 * e_ref)
            print(f"[22] round {r}: refits after a global BA {np.argwhere(late).tolist()}: "
                  f"against the true Sim3 {e_card:.2e} (the reference's {e_ref:.2e}; bound "
                  f"{bound:.2e})")
            check(e_card <= bound, f"round {r}: a refit is {e_card} off the true Sim3")
        check(all(not v for v in got["invariants"]), f"round {r}: invariants {got['invariants']}")
        before = [PROTO_N_KF] * PROTO_AGENTS if r == 0 else rounds[r - 1]["n_kf"]
        spliced = got["n_kf"] != before
        want_l = (steps, steps + 1) if spliced else (0, 0)
        check((got["launches"]["onehot_adjoint"], got["launches"]["onehot_gather"]) == want_l
              and all(L == 12 for _, L in got["rows"]),
              f"round {r}: K2/K3 launched {got['launches']} at {got['rows']}, expected "
              f"{want_l} at L = 12")
        gba_ran |= spliced
        prev = S_ref
    for r, (d, same) in enumerate(plain):
        print(f"[22] round {r} on its own inputs without the global BA, kernels against plain "
              f"versions: integers identical {same}, poses differ by {d:.2e}")
        check(same and d <= POSE_ATOL2, f"round {r}: the plain path differs (poses by {d})")


def run_three_agents(dev, imgs, traj, vocab, timed_sync):
    """Phase 23: three `SlamAgent`s on one `LoopbackTransport` in
    `tests/test_three_agents.py`'s layout at the EuRoC tracker settings,
    every map packet through the native codec and held to the Python
    pack's bytes. Returns (agents, bus, record)."""
    from dvm_slam_tpu_torch.mapping.local_mapping import LocalMapper
    from dvm_slam_tpu_torch.multiagent import codec, native_codec
    from dvm_slam_tpu_torch.multiagent.agent import SlamAgent
    from dvm_slam_tpu_torch.multiagent.transport import LoopbackTransport
    from dvm_slam_tpu_torch.placerec import vocabulary
    from dvm_slam_tpu_torch.tracking import tracker as trk

    check(native_codec.available(), f"the native codec did not build: {native_codec.build_error()}")
    settings = euroc_settings(FPS18)
    cfg, K = settings.tracker_config(None), settings.camera.K()
    voc = vocabulary.load(vocab)
    bus = LoopbackTransport()
    agents = {aid: SlamAgent(aid, cfg, K, np.zeros(4, np.float32), voc, bus, [1, 2, 3],
                             mapper=LocalMapper(**CONSOLE_MAPPER), device=dev)
              for aid in (1, 2, 3)}
    for a in agents.values():
        a.tracker._record_ready = lambda r: True
    rec = dict(calls=[], packets=[], merges={})
    check(native_codec.use_native_in_codec(), "use_native_in_codec found no library")
    native = codec.pack_arrays

    def checked(arrays):
        t0 = time.perf_counter()
        blob = native(arrays)
        t1 = time.perf_counter()
        ref = codec.pack_arrays_python(arrays)
        t2 = time.perf_counter()
        check(blob == ref, "a native map packet differs from codec.pack_arrays's bytes")
        rec["packets"].append((len(blob), (t1 - t0) * 1e3, (t2 - t1) * 1e3, blob))
        return blob

    codec.pack_arrays = checked
    steps = max(hi - lo for lo, hi in SEGMENTS23.values())
    try:
        for step in range(steps + N_IDLE23):
            if step == steps:
                for a in agents.values():
                    a.flush()
            for aid, (lo, hi) in SEGMENTS23.items():
                a = agents[aid]
                n_log = len(a.log)
                if step >= steps:
                    a.run_once(step * 0.1)
                elif lo + step < hi:
                    t = a.tracker
                    was, n_kf0 = t.state, int(t.map.n_kf)
                    timed_sync()
                    t0 = time.perf_counter()
                    a.process_image(imgs[lo + step], step * 0.1)
                    timed_sync()
                    ms = (time.perf_counter() - t0) * 1e3
                    merged = any(e[0] == "merged" for e in a.log[n_log:])
                    if merged:
                        kind = "merge"
                    elif was == trk.NOT_INITIALIZED:
                        kind = "init" if t.state == trk.OK else "before init"
                    elif not t.autonomous:
                        kind = "host path"
                    elif t._auto_imgs:
                        kind = "buffered"
                    else:
                        kind = "dispatch, keyframe" if int(t.map.n_kf) > n_kf0 else "dispatch"
                    rec["calls"].append((aid, step, kind, ms))
                for e in a.log[n_log:]:
                    if e[0] in ("merged", "implicit_merge"):
                        rec["merges"].setdefault(aid, []).append((e[0], int(e[1]), step))
    finally:
        codec.pack_arrays = native
        native_codec.restore_codec()
    return agents, bus, rec


def check_phase23(agents, bus, rec, traj, card):
    from dvm_slam_tpu_torch.eval import metrics
    from dvm_slam_tpu_torch.multiagent import codec, native_codec

    ref = JAX_REF8["agents"]
    for aid, a in agents.items():
        n = int(a.map.n_kf)
        valid = a.map.kf_valid[:n].cpu().numpy()
        creators = sorted({int(c) for c in a.meta.kf_creator[:n][valid]})
        est, gt = [], []
        for ts, T, _ in a.tracker.trajectory:
            i = SEGMENTS23[aid][0] + int(round(ts / 0.1))
            if i < len(traj):
                est.append(np.asarray(T.cpu() if hasattr(T, "cpu") else T, np.float32))
                gt.append(np.asarray(traj[i]))
        ate = float(metrics.ate_rmse(np.stack(est), np.stack(gt))[0])
        ref_ates = [r[str(aid)]["ate"] for r in ref]
        bound = min(3.0 * max(ref_ates), ATE23_BOUND_M)
        merged = {p.agent_id: p.successfully_merged for p in a.peers}
        print(f"[23] agent {aid}: merged {merged}, parent {a.frames.parent_frame}, creators "
              f"{creators}, n_kf {n}, merges {rec['merges'].get(aid)}, log kinds "
              f"{sorted({e[0] for e in a.log})}; ATE {ate:.6f} m over {len(est)} poses (JAX CPU "
              f"ref over draws {ref_ates}; bound {bound:.6f} m)")
        check(all(merged.values()), f"agent {aid} not merged with every peer: {merged}")
        check(creators == [1, 2, 3], f"agent {aid}'s map holds creators {creators}")
        check(ate < bound, f"agent {aid}'s ATE {ate} m >= {bound} m")
        check(a.check_invariants(), f"agent {aid}: host mirrors out of sync")
    check(agents[1].frames.parent_frame == "world"
          and agents[2].frames.parent_frame == "robot1/origin"
          and agents[3].frames.parent_frame in ("robot1/origin", "robot2/origin"),
          "the frame tree did not converge on agent 1")
    check(any(k == "implicit_merge" for m in rec["merges"].values() for k, _, _ in m),
          "no implicit merge was logged")
    pk = rec["packets"]
    check(len(pk) > 0, "no map packet went through the native codec")
    big = max(pk, key=lambda p: p[0])[3]
    t_nat = time_host_ms(lambda: native_codec.unpack_arrays(big), 5)
    t_py = time_host_ms(lambda: codec.unpack_arrays(big), 5)
    print(f"[23] native codec: {len(pk)} map packets byte-identical to codec.pack_arrays's; pack "
          f"ms median native {np.median([p[1] for p in pk]):.3f}, python "
          f"{np.median([p[2] for p in pk]):.3f}; unpack of the largest ({len(big)} bytes) native "
          f"{t_nat:.3f} ms, python {t_py:.3f} ms (host clock, median of 5)")
    groups = {}
    for aid, step, kind, ms in rec["calls"]:
        groups.setdefault(kind, []).append(ms)
    for kind, ms in sorted(groups.items()):
        ms = np.asarray(ms)
        p50, p90 = np.percentile(ms, [50, 90])
        print(f"[23] process_image, {kind}: median {p50:.2f} ms, p90 {p90:.2f} ms, max "
              f"{ms.max():.2f} ms (n={len(ms)}) on {card}")
    print(f"[23] bytes per channel: {bus.bandwidth_report()['bytes_by_channel']}")


# --------------------------------------------------------------------------
# slice 9: the depth sensors and the fisheye camera (phases 24-26)
# --------------------------------------------------------------------------

SENSOR9 = {24: "stereo", 25: "rgbd", 26: "monocular"}
MODE9 = {24: "stereo", 25: "rgbd", 26: "kb8"}


def scene9(phase: int, device, n_frames: int = N_FRAMES9):
    """Phase `phase`'s inputs, rendered on the card by the port's world, and
    the ground-truth poses: per frame the stereo pair (24), the image and its
    uint16 depth on the host (25), or the fisheye image (26)."""
    import torch

    from dvm_slam_tpu_torch.io import config, synthetic

    cam = settings9(phase, config).camera
    world = synthetic.PlaneWorld(seed=7, tex_size=TEX_SIZE, device=device, **WORLD9[phase])
    poses = synthetic.smooth_trajectory(n_frames, **TRAJ9[phase])
    K = tuple(float(v) for v in cam.K())
    h, w = cam.out_height, cam.out_width
    if phase == 26:
        Ks, S = fisheye_source(cam.params())
        field = fisheye_field(cam.params(), h, w)
    frames = []
    for p in poses:
        if phase == 24:
            frames.append(world.render_stereo(p, K, h, w, cam.baseline))
        elif phase == 25:
            frames.append((world.render(p, K, h, w),
                           depth_to_sensor(world.render_depth(p, K, h, w).cpu().numpy())))
        else:
            fish = warp_to_fisheye(world.render(p, Ks, S, S).cpu().numpy(), field)
            frames.append((torch.from_numpy(fish).to(device),))
    return frames, poses


def stereo_pair_inputs(device):
    """K1's inputs for phase 24's first pair as `make_frame_stereo` makes
    them: both views' levels in one 16-entry table."""
    from dvm_slam_tpu_torch.io import config

    frames, _ = scene9(24, device, 1)
    fc = settings9(24, config).frontend_config()
    rl, bl, xl, off = frame_inputs(frames[0][0], fc)
    rr, br, xr, _ = frame_inputs(frames[0][1], fc)
    import torch

    F = fc.capacity
    return rl + rr, bl + br, torch.cat([xl, xr]), list(off) + [F + o for o in off[1:]]


def run_sensor(phase: int, frames, device, use_kernel, out_dir):
    """Phase `phase`'s frames through a fresh port System from frame 0
    (`track_stereo`, `track_rgbd` or, for KB8, `track_monocular`), each call
    synchronised and timed; then `save_trajectory_tum` and its rows read
    back. Returns a dict of the run's outcomes."""
    import torch

    from dvm_slam_tpu_torch.geometry import two_view
    from dvm_slam_tpu_torch.io import config, trajectory
    from dvm_slam_tpu_torch.models.system import System
    from dvm_slam_tpu_torch.tracking import tracker as trk

    settings = settings9(phase, config)
    fps = settings.camera.fps
    log = {"stereo_matches": [], "close_points": [], "inits": []}
    saved = (trk.make_frame_stereo, trk.make_frame_rgbd, trk.create_points_from_depth,
             two_view.reconstruct_two_views)

    def counted(fn):
        def wrapped(*args, **kwargs):
            f = fn(*args, **kwargs)
            log["stereo_matches"].append(int((f.ur >= 0).sum()))
            return f
        return wrapped

    def close_points(m, slot, *args, **kwargs):
        m2, n = saved[2](m, slot, *args, **kwargs)
        log["close_points"].append((int(slot), int(n)))
        return m2, n

    def recording(*args, **kwargs):
        res = saved[3](*args, **kwargs)
        log["inits"].append(res)
        return res

    trk.make_frame_stereo, trk.make_frame_rgbd = counted(saved[0]), counted(saved[1])
    trk.create_points_from_depth, two_view.reconstruct_two_views = close_points, recording
    try:
        sysm = System(settings, sensor=SENSOR9[phase], device=device, use_kernel=use_kernel)
        t = sysm.tracker
        init_pair, init_map, ms = None, None, []
        for i, fr in enumerate(frames):
            was = t.state
            t0 = time.perf_counter()
            if phase == 24:
                sysm.track_stereo(fr[0], fr[1], i / fps)
            elif phase == 25:
                sysm.track_rgbd(fr[0], fr[1], i / fps)
            else:
                sysm.track_monocular(fr[0], i / fps)
            if device.type == "cuda":
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if was == trk.NOT_INITIALIZED and t.state == trk.OK and init_pair is None:
                init_pair = (int(round(t._init_ts * fps)) if phase == 26 else i, i)
                n = int(t.map.n_pt)
                init_map = (t.map.kf_pose[:2].clone(), n, t.map.pt_pos[:n].clone())
        path = os.path.join(out_dir, f"phase{phase}_{'plain' if use_kernel is False else 'kernels'}"
                                     f"_tum.txt")
        sysm.save_trajectory_tum(path)
    finally:
        (trk.make_frame_stereo, trk.make_frame_rgbd, trk.create_points_from_depth,
         two_view.reconstruct_two_views) = saved
    rows = trajectory.load_tum(path)
    m = sysm.map
    n_kf = int(m.n_kf)
    ur, obs = m.kf_ur[:n_kf], m.kf_obs[:n_kf]
    return dict(system=sysm, init_pair=init_pair, init_map=init_map, ms=ms, log=log,
                frames=[int(round(ts * fps)) for ts, _ in rows],
                poses=np.stack([T for _, T in rows]),
                kf_frames=sorted(int(round(ts * fps)) for ts in t.kf_timestamps.values()),
                n_kf=n_kf, n_pt=int(m.n_pt), n_valid=int(m.pt_valid.sum()),
                stereo_obs=int(((ur >= 0) & (obs >= 0)).sum()), state=t.state,
                finite=bool(torch.isfinite(m.kf_pose[:n_kf]).all())
                and bool(torch.isfinite(m.pt_pos).all()))


def check_phase9(phase: int, runs, poses_gt, counts, card):
    """Phases 24-26 held to the JAX CPU reference (`JAX_REF9`) and the
    kernel path to the plain path."""
    from dvm_slam_tpu_torch.eval import metrics

    ref = JAX_REF9[MODE9[phase]]
    k, p = runs["kernels"], runs["plain"]
    n = len(k["ms"])
    gt = np.stack([np.asarray(poses_gt[i]) for i in k["frames"]])
    ate_m = metric_ate(k["poses"], gt)
    ate_s = float(metrics.ate_rmse(k["poses"], gt)[0])
    tag = f"[{phase}]"
    print(f"{tag} {MODE9[phase]}: init {k['init_pair']} (JAX CPU ref {tuple(ref['init_pair'])}); "
          f"final state {k['state']}; frames with a pose {len(k['frames'])} (ref "
          f"{ref['n_tracked']}); keyframes at frames {k['kf_frames']} (ref {ref['kf_frames']}); "
          f"n_kf {k['n_kf']}, n_pt {k['n_pt']} (ref {ref['n_kf']}, {ref['n_pt']}), valid points "
          f"{k['n_valid']} (ref {ref['n_valid_points']})")
    print(f"{tag} ATE SE3-aligned (metric) {ate_m:.6f} m (ref {ref['ate_metric_m']:.6f}), "
          f"Sim3-aligned {ate_s:.6f} m (ref {ref['ate_sim3_m']:.6f})")
    for name, run in (("kernels", k), ("plain", p)):
        t = np.asarray(run["ms"][1:])
        print(f"{tag} System call with {name}: frame 0 {run['ms'][0]:.2f} ms, later calls median "
              f"{np.median(t):.2f} ms, p90 {np.percentile(t, 90):.2f} ms, max {t.max():.2f} ms "
              f"(n={len(t)}) on {card}")
    print(f"{tag} launches {counts}")
    check(k["state"] == "OK" and k["finite"], f"{tag} final state {k['state']}, or a non-finite map")
    check(counts["orb_describe"] == n, f"{tag} {counts['orb_describe']} K1 launches for {n} calls")
    check(abs(k["n_kf"] - ref["n_kf"]) <= 1, f"{tag} {k['n_kf']} keyframes, ref {ref['n_kf']}")
    steps = k["system"].mapper.ba_iters + 6    # LM steps of one keyframe BA
    if phase in (24, 25):
        sm, rsm = k["log"]["stereo_matches"], ref["stereo_matches"]
        worst = max(abs(a - b) / b for a, b in zip(sm, rsm))
        print(f"{tag} matches with depth per frame {sm}; largest difference from the ref's "
              f"{worst:.2%} (bound {STEREO_RTOL:.0%}); close points per keyframe "
              f"{k['log']['close_points']} (ref {ref['close_points']}); stored observations "
              f"with a right u {k['stereo_obs']} (ref {ref['stereo_obs']})")
        n_ba = k["n_kf"] - 1      # the depth init has one keyframe and no BA
        check(k["init_pair"] == (0, 0) and k["frames"] == list(range(n)),
              f"{tag} init {k['init_pair']}, frames with a pose {k['frames']}")
        check(len(sm) == n and worst <= STEREO_RTOL, f"{tag} matches with depth off the ref's")
        check(ate_m < 3 * ref["ate_metric_m"], f"{tag} metric ATE {ate_m} >= 3x the ref's")
        check(k["stereo_obs"] > 0.5 * ref["stereo_obs"], f"{tag} few stored right-u observations")
        check(counts["onehot_adjoint"] == steps * n_ba and counts["onehot_gather"]
              == (steps + 1) * n_ba, f"{tag} K2/K3 launches {counts} for {n_ba} BAs")
        check(n_ba >= 1, f"{tag} no keyframe BA ran")
        if phase in REF9_CAPS:
            caps = REF9_CAPS[phase]
            check(k["n_kf"] < caps[0] and k["n_pt"] < caps[1],
                  f"{tag} the map outgrew the reference's capacities {caps}")
        if phase == 25:
            later = sum(c for s, c in k["log"]["close_points"] if s > 0)
            check(later > 0, f"{tag} no close points created at keyframes after the first")
        check(p["log"]["stereo_matches"] == sm[:len(p["ms"])],
              f"{tag} the plain path's stereo matches differ")
    else:
        ip = k["init_pair"]
        seeds = ref["init_by_seed"]
        init = k["log"]["inits"][-1] if k["log"]["inits"] else None
        n_good = int(init.good.sum()) if init is not None else 0
        ref_good = [g for _, _, g in seeds]
        print(f"{tag} init at {ip}, homography {bool(init.used_homography) if init else None}, "
              f"good points {n_good}; JAX CPU ref over agents 0-5: {seeds}")
        check(ip is not None and ip[0] <= max(s[0][0] for s in seeds) + 1
              and ip[1] <= max(s[0][1] for s in seeds) + 1,
              f"{tag} init at {ip}, later than the ref's spread")
        check((1 - INIT_GOOD_RTOL) * min(ref_good) <= n_good
              <= (1 + INIT_GOOD_RTOL) * max(ref_good), f"{tag} {n_good} initial good points")
        check(k["frames"] == list(range(ip[1], n)), f"{tag} frames with a pose {k['frames']}")
        check(ate_s < 3 * ref["ate_sim3_m"], f"{tag} ATE {ate_s} >= 3x the ref's")
        want2 = (INIT_BA_ITERS + 6) + (k["n_kf"] - 2) * steps
        check(counts["onehot_adjoint"] == want2
              and counts["onehot_gather"] == want2 + 1 + (k["n_kf"] - 2),
              f"{tag} K2/K3 launches {counts}")
        (P_k, n_k, X_k), (P_p, n_p, X_p) = k["init_map"], p["init_map"]
        d_init = float((P_k - P_p).abs().max())
        print(f"{tag} plain path: init {p['init_pair']}, initial poses differ by {d_init:.3e}")
        check(p["init_pair"] == ip and n_p == n_k and d_init <= POSE_ATOL,
              f"{tag} the plain path initialized otherwise")
    # the plain path ran the first N_PLAIN9 calls: its rows and keyframes
    # against the kernel run's over the same frames
    n_p = len(p["ms"])
    rows_k = [j for j, f in enumerate(k["frames"]) if f < n_p]
    same = k["frames"][:len(rows_k)] == p["frames"]
    d_pose = float(np.abs(k["poses"][rows_k] - p["poses"]).max()) if same else float("inf")
    kf_k = [f for f in k["kf_frames"] if f < n_p]
    print(f"{tag} plain path over the first {n_p} calls: keyframes at {p['kf_frames']} "
          f"(kernels {kf_k}); rows identical {same}, poses differ by {d_pose:.3e}")
    check(p["kf_frames"] == kf_k, f"{tag} keyframes differ between the paths")
    check(d_pose <= POSE_ATOL2, f"{tag} poses differ by {d_pose} between the paths")


# Slice 10: the inertial sensor modes, each through its `System` entry
# point. The IMU is `ImuSettings()` at its defaults (200 Hz; the noise and
# walk of ORB-SLAM3's `Examples/Monocular-Inertial/EuRoC.yaml`), T_cb the
# identity (the synthetic rig's body is its camera), the samples exact
# (`vi_trajectory`). Phase 27: `configs/euroc.yaml` without distortion
# (752x480 rendered, resized to 600x350, 1250 features, kf 512, pt 16384,
# fps 20) with a black span after the IMU initializes; phase 28: the same
# at 752x480 with ORB-SLAM3's `Examples/Stereo/EuRoC.yaml` baseline
# (Camera.bf 47.906 / Camera.fx 435.205 = 0.1101 m) on `render_stereo`
# pairs; phase 29: phase 25's TUM settings and world, the depth as uint16
# sensor units. Frame i is stamped i / camera.fps.
MODE10 = {27: "imu-monocular", 28: "imu-stereo", 29: "imu-rgbd"}
EUROC_STEREO_BASELINE = 47.906 / 435.205
N_FRAMES10 = {27: 76, 28: 72, 29: 96}
BLANK10 = {27: (48, 54)}   # phase 27's black span, after the IMU init on the card and the reference
TRAJ10 = {27: dict(lateral=2.0, forward=0.5, yaw=0.08, z_amp=0.3),
          28: dict(lateral=2.0, forward=0.5, yaw=0.08, z_amp=0.3),
          29: dict(lateral=0.8, forward=0.3, yaw=0.08, z_amp=0.1)}
# the worlds: phases 27-28 on the JAX tests' VI world (seed 3, extent 30,
# `tests/test_vi_pipeline.py:173`); on seed 7's layouts the reference's
# monocular VI run breaks (a NaN BA on the default layout, fault l; a
# mirrored two-view solution and negative scales on the dense one, fault o)
WORLD10 = {27: dict(seed=3, plane_z=6.0, extent=30.0), 28: dict(seed=3, plane_z=6.0, extent=30.0),
           29: dict(seed=7, **WORLD9[25])}
SEGMENT30 = 36             # phase 30: system 2 takes frames SEGMENT30.. of phase 28's
# the plain paths of phases 27-29 take their first N_PLAIN10 calls (past the
# IMU init, and in phase 27 past the black span), held call by call
N_PLAIN10 = {27: 58, 28: 46, 29: 87}
RATIO_BOUNDS = (0.8, 1.25)  # tests/test_vi_pipeline.py:225,282
# The JAX package's CPU references of phases 27-30 (`python
# tests/test_torch_slice.py --slice10 [imu-mono|imu-stereo|imu-rgbd|merge]`:
# its System on the same frames, the pipelined VI lane retiring at the next
# dispatch): per mode the init pair (and for the monocular camera the whole
# run under the draws of agents 0-5, `by_seed`: init pair, IMU init, n_kf,
# ratio; `--slice10 imu-mono --seed N`), the call that initialized the IMU and
# the chain length then, the frames that made keyframes, the final state,
# the frames with a pose, the path-length ratio against ground truth (the
# monocular camera's over the saved trajectory after the IMU-init call
# outside the black span, the others' over the live poses); for the merge
# each checked chain keyframe's velocity error (m/s) and the biases.
JAX_REF10 = {'imu-monocular': {'by_seed': {0: {'imu_init': (27, 8),
                                   'init_pair': (0, 1),
                                   'n_kf': 17,
                                   'ratio': 0.9980011084032867},
                               1: {'imu_init': (42, 8),
                                   'init_pair': (0, 2),
                                   'n_kf': 14,
                                   'ratio': 0.9980801353872202},
                               2: {'imu_init': (27, 8),
                                   'init_pair': (0, 1),
                                   'n_kf': 17,
                                   'ratio': 1.0005575023434605},
                               3: {'imu_init': (32, 8),
                                   'init_pair': (0, 1),
                                   'n_kf': 16,
                                   'ratio': 0.9955299620221371},
                               4: {'imu_init': (27, 8),
                                   'init_pair': (0, 1),
                                   'n_kf': 17,
                                   'ratio': 1.0024770342076834},
                               5: {'imu_init': (45, 6),
                                   'init_pair': (0, 6),
                                   'n_kf': 11,
                                   'ratio': 0.9921544809996631}},
                   'final_state': 'OK',
                   'imu_init': (27, 8),
                   'init_pair': (0, 1),
                   'kf_frames': [0, 1, 2, 5, 6, 14, 18, 26, 31, 36, 42, 47, 54, 58, 63, 68, 73],
                   'n_kf': 17,
                   'ratio': 0.9980011084032867,
                   'tracked_frames': [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
                                      18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,
                                      32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45,
                                      46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59,
                                      60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73,
                                      74, 75]},
 'imu-rgbd': {'final_state': 'OK',
              'imu_init': (85, 6),
              'init_pair': (0, 0),
              'kf_frames': [0, 2, 14, 28, 58, 84, 92],
              'n_kf': 7,
              'ratio': 1.0018669736100858,
              'tracked_frames': [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
                                 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33,
                                 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49,
                                 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65,
                                 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81,
                                 82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94, 95]},
 'imu-stereo': {'final_state': 'OK',
                'imu_init': (43, 5),
                'init_pair': (0, 0),
                'kf_frames': [0, 2, 11, 22, 42, 47, 52, 57, 62, 67],
                'n_kf': 10,
                'ratio': 1.0002018420933325,
                'tracked_frames': [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
                                   18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
                                   33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47,
                                   48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62,
                                   63, 64, 65, 66, 67, 68, 69, 70, 71]},
 'merge': {'bias_a': 0.011208871379494667,
           'bias_g': 0.0022686549928039312,
           'gba_applied': True,
           'merged': True,
           'vel_err': {42: 0.00759275583550334,
                       47: 0.008579082787036896,
                       52: 0.0068838102743029594,
                       57: 0.008005303330719471,
                       62: 0.009963414631783962,
                       67: 0.015336157754063606}}}


def settings10(phase: int, module):
    """Phase 27-29's settings through `module.settings_from_dict`, with the
    IMU at its defaults."""
    d = {k: dict(v) if isinstance(v, dict) else v
         for k, v in (TUM_SETTINGS if phase == 29 else EUROC_SETTINGS).items()}
    if phase == 28:
        del d["camera"]["new_width"], d["camera"]["new_height"]
        d["camera"]["baseline"] = EUROC_STEREO_BASELINE
    s = module.settings_from_dict(d)
    s.imu = module.ImuSettings()
    return s


def scene10(phase: int, device):
    """Phase `phase`'s inputs rendered on the card by the port's world at the
    camera's full size, the IMU chunks and the ground truth: (frames,
    chunks, poses, velocities)."""
    from dvm_slam_tpu_torch.io import config, synthetic

    cam = settings10(phase, config).camera
    world = synthetic.PlaneWorld(tex_size=TEX_SIZE, device=device, **WORLD10[phase])
    poses, chunks, vels = synthetic.vi_trajectory(N_FRAMES10[phase], fps=cam.fps,
                                                  imu_rate=settings10(phase, config).imu.frequency,
                                                  **TRAJ10[phase])
    K = (cam.fx, cam.fy, cam.cx, cam.cy)
    h, w = cam.height, cam.width
    lo, hi = BLANK10.get(phase, (0, 0))
    frames = []
    for i, p in enumerate(poses):
        if phase == 27:
            frames.append((world.render(p, K, h, w) * (0.0 if lo <= i < hi else 1.0),))
        elif phase == 28:
            frames.append(world.render_stereo(p, K, h, w, cam.baseline))
        else:
            frames.append((world.render(p, K, h, w),
                           depth_to_sensor(world.render_depth(p, K, h, w).cpu().numpy())))
    return frames, chunks, poses, vels


def path_ratio(est, gt) -> float:
    """Path length of the estimated camera centers over the true ones'."""
    c = lambda T: np.linalg.inv(_se3_matrix(T))[:3, 3]  # noqa: E731
    e = np.stack([c(T) for T in est])
    g = np.stack([c(T) for T in gt])
    return float(np.linalg.norm(np.diff(e, axis=0), axis=1).sum()
                 / np.linalg.norm(np.diff(g, axis=0), axis=1).sum())


def cuda_launches(fn):
    """Run fn() under `torch.profiler` and count the kernels it launched on
    the card (device-side events). Returns (fn's result, launches)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
    n = sum(e.count for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type))
    return out, n


def run_vi(phase: int, frames, chunks, device, use_kernel, out_dir, sysm=None, first=0,
           n_profiled: int = 0):
    """Phase `phase`'s frames (from `first`) through a port System's
    `track_*_inertial`, each call synchronised and timed, the pipelined VI
    lane retiring a record as soon as the next one is dispatched (fault s).
    The `n_profiled` calls after the one following the IMU init run under
    `torch.profiler` instead, counting their kernel launches. Returns a dict
    of the run's outcomes."""
    import torch

    from dvm_slam_tpu_torch.geometry import two_view
    from dvm_slam_tpu_torch.io import config, trajectory
    from dvm_slam_tpu_torch.mapping import local_mapping
    from dvm_slam_tpu_torch.models.system import System
    from dvm_slam_tpu_torch.tracking import tracker as trk

    settings = settings10(phase, config)
    fps = settings.camera.fps
    log = {"inits": [], "visual_ba": [], "imu_init_counts": None}
    saved = (two_view.reconstruct_two_views, local_mapping.local_ba)

    def recording(*args, **kwargs):
        res = saved[0](*args, **kwargs)
        log["inits"].append(res)
        return res

    def counting_ba(*args, **kwargs):
        log["visual_ba"].append(kwargs.get("iters", 6))
        return saved[1](*args, **kwargs)

    two_view.reconstruct_two_views, local_mapping.local_ba = recording, counting_ba
    try:
        if sysm is None:
            sysm = System(settings, sensor=MODE10[phase], device=device, use_kernel=use_kernel)
        t = sysm.tracker
        t._record_ready = lambda rec: True
        init_pair, imu_init, calls, live, profiled = None, None, [], {}, []

        def one(i):
            fr = frames[i]
            ts = (i - first) / fps
            if phase == 27:
                return sysm.track_monocular_inertial(fr[0], ts, *chunks[i])
            if phase == 28:
                return sysm.track_stereo_inertial(fr[0], fr[1], ts, *chunks[i])
            return sysm.track_rgbd_inertial(fr[0], fr[1], ts, *chunks[i])

        for i in range(first, len(frames)):
            was, n_kf0, imu0 = t.state, t.n_kf_host, t.imu_initialized
            prof = imu_init is not None and imu_init[0] + 2 <= i < imu_init[0] + 2 + n_profiled
            t0 = time.perf_counter()
            if prof:
                p, n_launch = cuda_launches(lambda: one(i))
            else:
                p = one(i)
            if device.type == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if p is not None:
                live[i] = p.detach().cpu().numpy()
            if was == trk.NOT_INITIALIZED and t.state == trk.OK and init_pair is None:
                init_pair = (int(round(t._init_ts * fps)) + first if phase == 27 else i, i)
                kind = "init"
            elif t.state == trk.NOT_INITIALIZED:
                kind = "before init"
            elif t.imu_initialized and not imu0:
                imu_init = (i, len(t.kf_chain))
                log["imu_init_counts"] = counts_now()
                kind = "IMU init"
            elif not t.imu_initialized:
                kind = "before IMU init"
            elif t.n_kf_host > n_kf0:
                kind = "keyframe, VI BA"
            else:
                kind = "VI lane"
            if prof:
                profiled.append((kind, n_launch))
            else:
                calls.append((kind, ms))
        t.flush_pipeline()
        tag = "plain" if use_kernel is False else "kernels"
        path = os.path.join(out_dir, f"phase{phase}_{tag}_tum.txt")
        sysm.save_trajectory_tum(path)
    finally:
        two_view.reconstruct_two_views, local_mapping.local_ba = saved
    rows = trajectory.load_tum(path)
    m = sysm.map
    n_kf = int(m.n_kf)
    kf_ts = t.kf_timestamps
    # each chain keyframe's window against the IMU samples of the frames
    # since the previous chain keyframe (the chunks cover (t_{i-1}, t_i])
    kf_f = {sl: int(round(kf_ts[sl] * fps)) + first for sl in t.kf_chain}
    gaps = [abs(float(t.kf_preint[c].dT)
                - float(sum(chunks[i][2].sum() for i in range(kf_f[p] + 1, kf_f[c] + 1))))
            for p, c in zip(t.kf_chain[:-1], t.kf_chain[1:]) if c in t.kf_preint]
    return dict(system=sysm, init_pair=init_pair, imu_init=imu_init, calls=calls, log=log,
                profiled=profiled, n_calls=len(frames) - first, refines=t.n_vi_refines,
                live=live, frames=[int(round(ts * fps)) + first for ts, _ in rows],
                poses=np.stack([T for _, T in rows]),
                kf_frames=sorted(int(round(v * fps)) + first for v in kf_ts.values()),
                n_kf=n_kf, state=t.state, imu_initialized=t.imu_initialized,
                preint_gap=max(gaps) if gaps else None, n_preint=len(gaps),
                finite=bool(torch.isfinite(m.kf_pose[:n_kf]).all())
                and bool(torch.isfinite(m.pt_pos).all()))


def vi_ratio(phase: int, run, poses_gt) -> float:
    """The path-length ratio the phase is held to: over the saved trajectory
    after the IMU-init call outside the black span (monocular), or over the
    live poses (stereo, RGB-D: metric from the first frame)."""
    if phase == 27:
        lo, hi = BLANK10[27]
        start = run["imu_init"][0] + 1
        keep = [k for k, f in enumerate(run["frames"]) if f >= start and not lo <= f < hi]
        est = run["poses"][keep]
        gt = [poses_gt[run["frames"][k]] for k in keep]
    else:
        idx = sorted(run["live"])
        est = [run["live"][i] for i in idx]
        gt = [poses_gt[i] for i in idx]
    return path_ratio(est, gt)


def check_phase10(phase: int, runs, poses_gt, counts, card):
    """Phases 27-29 held to the JAX CPU reference (`JAX_REF10`) and the
    kernel path to the plain path."""
    ref = JAX_REF10[MODE10[phase]]
    k, p = runs["kernels"], runs["plain"]
    tag = f"[{phase}]"
    n = k["n_calls"]
    check(k["imu_init"] is not None, f"{tag} the IMU never initialized (init {k['init_pair']}, "
                                     f"keyframes at {k['kf_frames']})")
    ratio = vi_ratio(phase, k, poses_gt)
    print(f"{tag} {MODE10[phase]}: init {k['init_pair']} (JAX CPU ref {tuple(ref['init_pair'])}); "
          f"IMU initialized at call {k['imu_init']} (call, chain keyframes; ref "
          f"{tuple(ref['imu_init'])}); final state {k['state']}; keyframes at frames "
          f"{k['kf_frames']} (ref {ref['kf_frames']}); frames with a pose {len(k['frames'])} "
          f"(ref {len(ref['tracked_frames'])}); path-length ratio {ratio:.6f} (ref "
          f"{ref['ratio']:.6f}); largest |preint dT - the window's sample time| {k['preint_gap']} s over "
          f"{k['n_preint']} windows")
    groups = {}
    for kind, ms in k["calls"]:
        groups.setdefault(kind, []).append(ms)
    for kind, ms in groups.items():
        ms = np.asarray(ms)
        print(f"{tag} track_{'monocular' if phase == 27 else MODE10[phase][4:]}_inertial with "
              f"kernels, {kind} calls: median {np.median(ms):.2f} ms, p90 "
              f"{np.percentile(ms, 90):.2f} ms, max {ms.max():.2f} ms (n={len(ms)}) on {card}")
    print(f"{tag} launches {counts}; at the IMU init {k['log']['imu_init_counts']}; visual BAs "
          f"{k['log']['visual_ba']}; pose-inertial refinements on the VI lane {k['refines']}; "
          f"CUDA kernel launches per profiled call {k['profiled']}")
    check(k["state"] == "OK" and k["finite"], f"{tag} final state {k['state']}, or a non-finite map")
    check(counts["orb_describe"] == n, f"{tag} {counts['orb_describe']} K1 launches for {n} calls")
    want2 = sum(it + 6 for it in k["log"]["visual_ba"])
    want3 = sum(it + 7 for it in k["log"]["visual_ba"])
    check(counts["onehot_adjoint"] == want2 and counts["onehot_gather"] == want3,
          f"{tag} K2/K3 launches {counts}, want {want2}/{want3} for {k['log']['visual_ba']}")
    check(len(k["log"]["visual_ba"]) >= 1, f"{tag} no visual BA ran before the IMU init")
    at_init = k["log"]["imu_init_counts"]
    check(at_init["onehot_adjoint"] == counts["onehot_adjoint"]
          and at_init["onehot_gather"] == counts["onehot_gather"],
          f"{tag} K2/K3 launched after the IMU init: {at_init} -> {counts}")
    check(k["preint_gap"] is not None and k["preint_gap"] < 1e-3,
          f"{tag} a keyframe's preintegration spans {k['preint_gap']} s off its samples")
    check(RATIO_BOUNDS[0] < ratio < RATIO_BOUNDS[1], f"{tag} path-length ratio {ratio}")
    if phase == 27:
        # the two-view init depends on the draws (fault o), and with it the
        # keyframes and the IMU-init call: hold the run to the reference's
        # runs under the draws of agents 0-5 that initialized on the same pair
        ip = k["init_pair"]
        runs = list(ref["by_seed"].values())
        same = [r for r in runs if tuple(r["init_pair"]) == ip]
        print(f"{tag} JAX CPU ref over agents 0-5 (init pair, IMU init, keyframes, ratio): "
              f"{[(r['init_pair'], r['imu_init'], r['n_kf'], round(r['ratio'], 6)) for r in runs]}")
        check(bool(same), f"{tag} init at {ip}, a pair the ref makes under none of the draws")
        check(min(abs(k["imu_init"][1] - r["imu_init"][1]) for r in same) <= 1,
              f"{tag} IMU init with {k['imu_init'][1]} chain keyframes, ref {same}")
        check(min(abs(k["n_kf"] - r["n_kf"]) for r in same) <= 2,
              f"{tag} {k['n_kf']} keyframes, ref {same}")
        worst = max(max(abs(r["ratio"] - 1.0) for r in same), 0.01)
        check(abs(ratio - 1.0) <= 3 * worst, f"{tag} ratio {ratio} off 1 by more than 3x {worst}")
        lo, hi = BLANK10[27]
        check(all(i in k["live"] for i in range(lo, hi)), f"{tag} a black frame has no pose")
        after = [f for f in k["frames"] if f > k["imu_init"][0] and not lo <= f < hi]
        check(len(after) >= 15, f"{tag} {len(after)} frames after the IMU init outside the span")
    else:
        check(abs(k["imu_init"][1] - ref["imu_init"][1]) <= 1,
              f"{tag} IMU init with {k['imu_init'][1]} chain keyframes, ref {ref['imu_init'][1]}")
        check(k["init_pair"] == (0, 0), f"{tag} init {k['init_pair']}")
        check(abs(k["n_kf"] - ref["n_kf"]) <= 1, f"{tag} {k['n_kf']} keyframes, ref {ref['n_kf']}")
        check(sorted(k["live"]) == list(range(n)), f"{tag} a frame without a pose")
    # the plain path took the first N_PLAIN10 calls: its poses (as each call
    # returned them: the saved rows of the longer kernel run are re-based
    # again by later scale refinements) and keyframes against the kernel
    # run's over the same frames
    n_p = p["n_calls"]
    same = sorted(p["live"]) == [i for i in sorted(k["live"]) if i < n_p]
    d_pose = (max(float(np.abs(k["live"][i] - p["live"][i]).max()) for i in p["live"])
              if same else float("inf"))
    kf_k = [f for f in k["kf_frames"] if f < n_p]
    print(f"{tag} plain path over the first {n_p} calls: init {p['init_pair']}, IMU init "
          f"{p['imu_init']}, keyframes at {p['kf_frames']} (kernels {kf_k}); the same frames "
          f"with a pose {same}, poses differ by {d_pose:.3e}")
    check(p["init_pair"] == k["init_pair"] and p["imu_init"] == k["imu_init"],
          f"{tag} the plain path initialized otherwise")
    check(p["kf_frames"] == kf_k, f"{tag} keyframes differ between the paths")
    check(d_pose <= POSE_ATOL2, f"{tag} poses differ by {d_pose} between the paths")


def run_merge10(sys1, frames, chunks, device, vocab, out_dir):
    """Phase 30: phase 28's kernel System as system 1 (frames 0..), a second
    IMU-stereo System over frames SEGMENT30.., and system 1 wrapped in a
    port `SlamAgent` that welds system 2's map in through the codec
    (`_do_merge` with the identity Sim3: one metric world), as
    `tests/test_vi_pipeline.py::TestMergeInertialBA`. Returns the agent and
    the merge's seconds."""
    import torch

    from dvm_slam_tpu_torch.geometry import lie
    from dvm_slam_tpu_torch.multiagent import agent as agent_mod
    from dvm_slam_tpu_torch.multiagent import codec, transport
    from dvm_slam_tpu_torch.placerec import vocabulary

    run2 = run_vi(28, frames, chunks, device, None, out_dir, first=SEGMENT30)
    sys2 = run2["system"]
    t1 = sys1.tracker
    t1.flush_pipeline()
    mask = sys2.map.kf_valid.cpu().numpy().copy()
    mask[int(sys2.map.n_kf):] = False
    blob = codec.extract_submap(sys2.map, sys2.tracker.meta, mask).to_bytes()
    cfg = t1.config
    a = agent_mod.SlamAgent(1, cfg, sys1.settings.camera.K(), np.zeros(4, np.float32),
                            vocabulary.load(vocab), transport.LoopbackTransport(), [1, 2],
                            autonomous=False, device=device)
    a.tracker = t1
    t1.meta.agent_id = 1
    mB, metaB = codec.materialize(codec.MapPacket.from_bytes(blob), cfg.frontend.capacity,
                                  device=device)
    t0 = time.perf_counter()
    a._do_merge(2, mB, metaB, lie.sim3_identity(device=device), t1.kf_chain[-1])
    if device.type == "cuda":
        torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    a.flush_gba()
    return a, merge_s, run2


def check_phase30(agent, merge_s, vels, counts, card):
    """Phase 30 held to ground truth and the JAX CPU reference."""
    ref = JAX_REF10["merge"]
    t = agent.tracker
    fps = t.config.fps
    errs = {}
    for s in t.kf_chain[-6:]:
        i = int(round(t.kf_timestamps[s] * fps))
        if 0 <= i < len(vels):
            errs[i] = float(np.linalg.norm(np.asarray(t.kf_vel[s]) - vels[i]))
    bg, ba = float(np.linalg.norm(t.bias_g)), float(np.linalg.norm(t.bias_a))
    worst_ref = max(ref["vel_err"].values())
    print(f"[30] merged {('merged', 2) in agent.log}; merge {merge_s:.2f} s on {card}; chain "
          f"velocity errors by frame {errs} m/s (JAX CPU ref {ref['vel_err']}); |bias_g| "
          f"{bg:.6f} (ref {ref['bias_g']:.6f}), |bias_a| {ba:.6f} (ref {ref['bias_a']:.6f}); "
          f"launches {counts}; log kinds {sorted({e[0] for e in agent.log})}")
    check(("merged", 2) in agent.log, "[30] the inertial merge did not happen")
    check(len(errs) >= 3 and max(errs.values()) < 0.6, f"[30] chain velocities off: {errs}")
    check(max(errs.values()) <= 3 * max(worst_ref, 0.01),
          f"[30] velocity error above 3x the reference's {worst_ref}")
    check(bg < 0.2 and ba < 1.0, f"[30] biases |bg| {bg}, |ba| {ba}")
    check(any(e[0] == "gba_applied" for e in agent.log), "[30] the global BA was not folded in")


def time_host_ms(fn, reps: int) -> float:
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def kf_alignment(agent, traj):
    """An agent's map against ground truth (`tests/test_multiagent.py:
    187-203`): the keyframe slots its tracker stamped, frame lo + ts * 10 of
    its segment, aligned by a Sim3 (X_w = S X_map). Returns (ATE m, S's
    scale, keyframes)."""
    from dvm_slam_tpu_torch.eval import metrics

    m, lo = agent.map, SEGMENTS18[agent.agent_id][0]
    n = int(m.n_kf)
    valid = m.kf_valid.cpu().numpy()
    pose = m.kf_pose.cpu().numpy()
    est, gt = [], []
    for slot, ts in agent.tracker.kf_timestamps.items():
        i = lo + int(round(ts * 10))
        if slot < n and valid[slot] and i < len(traj):
            est.append(pose[slot])
            gt.append(np.asarray(traj[i]))
    ate, _, S = metrics.ate_rmse(np.stack(est), np.stack(gt))
    return float(ate), float(S[7]), len(est)


def check_phase18(runs, counts, traj, card):
    """Phase 18 against the JAX CPU reference of the same run, over its
    spread of tracker draws (`JAX_REF7["spread"]`, fault o), and against
    ground truth: both peers merged, agent 2 merging within MERGE_STEPS of
    the spread's steps with S_ab's scale within SCALE_RTOL of the spread's
    scales and of the scale that ground truth implies for the two maps
    just before the splice, keyframes of the other agent in each map, agent
    2 under robot1/origin and agent 1 under world, the global BA folded in,
    the host mirrors in sync, agent 2's keyframe ATE under 3x the spread's
    largest and ATE18_BOUND_M; K1-K3 launched, K2/K3 at the keyframe BA's
    and the welding BA's windows; the plain path's first N_PLAIN18 steps
    with the kernel path's keyframes and poses-or-none, poses to 1e-3."""
    ref = JAX_REF7
    print(f"[18] JAX CPU ref over tracker seed offsets (offset, merging agent, step, S_ab scale, "
          f"its ground-truth scale, agent 2's keyframe ATE m): "
          f"{[(r['offset'], r['agent'], r['step'], r['scale'], r['scale_gt'], r['ate2']) for r in ref['spread']]}")
    spread = [r for r in ref["spread"] if r["step"] is not None]
    steps = [r["step"] for r in spread]
    scales = [r["scale"] for r in spread]
    ate_ref = max(r["ate2"] for r in spread)
    name = "kernels"
    agents, bus, rec = runs[name]
    a1, a2 = agents[1], agents[2]
    merges = rec["merges"]
    kinds = {aid: sorted({e[0] for e in a.log}) for aid, a in agents.items()}
    by_creator = {}
    for aid, a in agents.items():
        n = int(a.map.n_kf)
        valid = a.map.kf_valid[:n].cpu().numpy()
        by_creator[aid] = {c: int((a.meta.kf_creator[:n][valid] == c).sum()) for c in (1, 2)}
    ate, _, n_ate = kf_alignment(a2, traj)
    latency = [e[1] for a in agents.values() for e in a.log if e[0] == "merge_latency_s"]
    folds = [e[1] for a in agents.values() for e in a.log if e[0] == "gba_applied"]
    print(f"[18] {name}: merges (agent, step, S_ab scale) "
          f"{[(m['agent'], m['step'], round(float(m['S_ab'][7]), 5)) for m in merges]} "
          f"(JAX CPU ref, offset 0: {[(m['agent'], m['step'], round(m['S_ab'][7], 5)) for m in ref['merges']]}); "
          f"keyframes by creator {by_creator} (ref {ref['1']['by_creator']}, "
          f"{ref['2']['by_creator']}); parents {a1.frames.parent_frame}, "
          f"{a2.frames.parent_frame}; keyframe batches received {len(rec['splices'])}")
    print(f"[18] {name}: log kinds {kinds} (ref {ref['1']['log_kinds']}, {ref['2']['log_kinds']})")
    print(f"[18] {name}: protocol events (step, agent, channel | bows in: own keyframes, "
          f"candidates) {rec['events']} (ref {ref['events']})")
    print(f"[18] {name}: keyframes on the host after each step {rec['kf_steps']} (ref "
          f"{ref['kf_steps']})")
    print(f"[18] {name}: agent 2's keyframe ATE {ate:.6f} m over {n_ate} keyframes (ref "
          f"{ref['ate2']:.6f} m over {ref['ate2_n']}); BA window rows {sorted(rec['ba_rows'])}; "
          f"merge_latency_s {latency}; global BA dispatch to fold s {folds} on {card}")
    groups = {}
    for _, _, kind, ms in rec["calls"]:
        groups.setdefault(kind, []).append(ms)
    for kind, ms in sorted(groups.items()):
        ms = np.asarray(ms)
        p50, p90 = np.percentile(ms, [50, 90])
        print(f"[18] {name}: process_image, {kind} calls: median {p50:.2f} ms, p90 {p90:.2f} ms,"
              f" max {ms.max():.2f} ms (n={len(ms)}) on {card}")
    print(f"[18] {name}: bandwidth {bus.bandwidth_report()}")
    check(a1.peers[2].successfully_merged and a2.peers[1].successfully_merged,
          f"{name}: the peers did not both merge")
    check(len(merges) >= 1 and merges[0]["agent"] == 2,
          f"{name}: merges {[(m['agent'], m['step']) for m in merges]}")
    check(min(steps) - MERGE_STEPS <= merges[0]["step"] <= max(steps) + MERGE_STEPS,
          f"{name}: merged at step {merges[0]['step']}, JAX CPU ref steps {steps}")
    scale, scale_gt = float(merges[0]["S_ab"][7]), merges[0]["scale_gt"]
    print(f"[18] {name}: S_ab scale {scale:.5f}, ground truth implies {scale_gt:.5f} "
          f"(off by {scale / scale_gt - 1:+.2%}); the maps just before the splice against "
          f"ground truth (ATE m, Sim3 scale, keyframes): merging agent "
          f"{merges[0]['sides'][0]}, its peer {merges[0]['sides'][1]}")
    check((1 - SCALE_RTOL) * min(scales) <= scale <= (1 + SCALE_RTOL) * max(scales),
          f"{name}: S_ab scale {scale}, JAX CPU ref scales {scales}")
    check(abs(scale / scale_gt - 1) <= SCALE_RTOL,
          f"{name}: S_ab scale {scale}, ground truth implies {scale_gt}")
    check(by_creator[1][2] > 0 and by_creator[2][1] > 0,
          f"{name}: keyframes not shared both ways {by_creator}")
    check(a2.frames.parent_frame == "robot1/origin" and a1.frames.parent_frame == "world",
          f"{name}: frame tree {a1.frames.parent_frame}, {a2.frames.parent_frame}")
    check(bool(folds), f"{name}: the global BA never folded in")
    check(a1.check_invariants() and a2.check_invariants(), f"{name}: invariants")
    check(ate < min(3.0 * ate_ref, ATE18_BOUND_M),
          f"{name}: agent 2's keyframe ATE {ate} m, JAX CPU ref up to {ate_ref} m")
    check({KF_BA_L, WELD_L} <= rec["ba_rows"],
          f"K2 saw BA windows {sorted(rec['ba_rows'])}, not {KF_BA_L} and {WELD_L}")
    print(f"[18] launches: {counts}")
    check(all(counts[k] > 0 for k in KERNELS), f"a kernel never launched in phase 18: {counts}")
    rk, rp = runs["kernels"][2], runs["plain"][2]
    n = len(rp["kf_steps"][1])
    check_prefix(18, f"the first {n} steps", [rk["kf_steps"][a][:n] for a in (1, 2)],
                 [rp["kf_steps"][a] for a in (1, 2)],
                 [T for a in (1, 2) for T in rk["poses"][a][:n]],
                 [T for a in (1, 2) for T in rp["poses"][a]])
    check(not rp["merges"] and all(m["step"] >= n for m in rk["merges"]),
          "[18] a merge within the plain path's prefix")


def check_phase19(sysm, out_dir, device):
    """Phase 19: `save_atlas` of phase 12's System, `load_atlas` into a fresh
    System on the card. The loaded map carries every array of the saved
    map's packet (the point statistics aside, which `load_atlas`
    recomputes), the tracker state comes back, and a second save and load is
    a fixed point: every MapState field equal."""
    import torch

    from dvm_slam_tpu_torch.models.system import System
    from dvm_slam_tpu_torch.multiagent import codec

    paths = [os.path.join(out_dir, f"phase19_{i}.atlas") for i in range(2)]
    t0 = time.perf_counter()
    sysm.save_atlas(paths[0])
    t_save = time.perf_counter() - t0
    saved = codec.MapPacket.from_bytes(sysm.serialize_map())
    loaded, t_load = [], []
    for i in range(2):
        s = System(euroc_settings(), device=device)
        t0 = time.perf_counter()
        s.load_atlas(paths[i])
        torch.cuda.synchronize()
        t_load.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            s.save_atlas(paths[1])
        loaded.append(s)
    a, b = loaded
    got = codec.MapPacket.from_bytes(a.serialize_map())
    differ = [f for f in codec.MapPacket._fields if f not in RECOMPUTED
              and not np.array_equal(getattr(got, f), getattr(saved, f))]
    fixed = [f for f in a.map._fields if not torch.equal(getattr(a.map, f), getattr(b.map, f))]
    ta, t = a.tracker, sysm.tracker
    print(f"[19] checkpoint {os.path.getsize(paths[0])} bytes, {saved.n_kf} keyframes, {saved.n_pt} "
          f"points; save {t_save * 1e3:.2f} ms, loads {np.round(t_load, 2).tolist()} ms; packet "
          f"arrays that "
          f"differ after the load {differ}; MapState fields that differ after a second round "
          f"trip {fixed}")
    check(not differ, f"the loaded map's packet differs in {differ}")
    check(not fixed, f"a second save/load changes {fixed}")
    check(ta.state == t.state and ta.n_kf_host == saved.n_kf
          and torch.equal(ta.last_pose, t.last_pose.to(ta.last_pose.device))
          and len(ta.trajectory) == len(t.trajectory),
          "the tracker state did not come back")


# --------------------------------------------------------------------------
# slice 11: the console on real imagery (phase 31)
# --------------------------------------------------------------------------

# `tests/fixtures/mini_euroc`: 120 frames of 240x180 real photographic
# texture in the EuRoC layout, its ground truth and settings, run through the
# port's `tools.console.run_dataset` with `tests/test_dataset_integration.py`'s
# arguments (:34-39)
MINI_EUROC = os.path.join("tests", "fixtures", "mini_euroc")
# `tests/fixtures/mini_euroc/settings.yaml` transcribed (the card's Python has
# no YAML parser); `tests/test_torch_console.py` holds `settings_from_dict` of
# it equal to `load_settings` of the file
MINI_EUROC_SETTINGS = {
    "Camera.type": "PinHole", "Camera1.fx": 200.0, "Camera1.fy": 200.0, "Camera1.cx": 120.0,
    "Camera1.cy": 90.0, "Camera1.k1": 0.0, "Camera1.k2": 0.0, "Camera1.p1": 0.0,
    "Camera1.p2": 0.0, "Camera.width": 240, "Camera.height": 180, "Camera.fps": 5,
    "ORBextractor.nFeatures": 600, "ORBextractor.scaleFactor": 1.2, "ORBextractor.nLevels": 8,
    "ORBextractor.iniThFAST": 20, "ORBextractor.minThFAST": 7,
}
N_AGENTS31, OVERLAP31 = 2, 0.5
N_VOCAB31 = 8              # the vocabulary's sample frames (`console.run_dataset`)
MIN_FRAMES31 = 30          # tests/test_dataset_integration.py:45
ATE31_BOUND_M = 0.15       # :48
KF31_ATOL = 1              # keyframes per call through the merge call, against JAX_REF11
MERGE31_STEPS = 4          # the merge's call against JAX_REF11's (phase 18's rule)
ATE31_FILE_ATOL_M = 1e-4   # evaluate's ATE against the smoke's own from the written files
N_PLAIN31 = 8              # the plain path's steps per agent, held call by call
RUN31_FILES = ("robot{aid}_trajectory.txt", "robot{aid}_state.json", "robot{aid}_map.ply")
RUN31_SHARED = ("bandwidth.json", "gt.bin", "evaluation.json")
# The JAX package's CPU reference of phase 31 (`python tests/test_torch_slice.py
# --slice11`): each agent's Sim3-aligned ATE and paired frames, keyframes,
# merges and the call each merge happened on, and each scale alignment
JAX_REF11 = {
    # agent 2's final ATE is NaN: fault aa (the global BA leaves non-finite
    # points in its merged map, the scale alignment reads s = 0 from them and
    # the re-base turns every pose into NaN); its ATE just before that
    # alignment is `pre_scale`'s `ate_before`
    'agents': {'1': {'ate_rmse_m': 0.09401985257863998, 'frames': 79, 'n_keyframes': 29,
                     'merged_with': [2], 'loop_triggers': 0},
               '2': {'ate_rmse_m': float('nan'), 'frames': 71, 'n_keyframes': 27,
                     'merged_with': [1], 'loop_triggers': 0}},
    'merges': [{'agent': 2, 'peer': 1, 'step': 49, 'streaming': True}],
    'kf_steps': {'1': [0, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 6, 6, 6, 6, 6, 6, 6, 6,
        7, 7, 7, 7, 8, 8, 8, 8, 9, 9, 9, 9, 10, 10, 10, 10, 10, 10, 10, 10, 11, 11, 11, 11, 12, 23,
        23, 23, 23, 23, 23, 23, 23, 24, 24, 24, 24, 25, 25, 25, 25, 26, 26, 26, 26, 27, 27, 27, 27,
        28, 28, 28, 28, 28, 28], '2': [0, 2, 2, 2, 2, 2, 2, 2, 2, 4, 4, 4, 4, 5, 5, 5, 5, 6, 6, 6, 6,
        6, 6, 6, 6, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9, 10, 10, 10, 10, 11, 11, 11, 11, 12, 12, 12,
        12, 26, 27, 27, 27, 27, 27, 27, 27, 27, 27, 27, 27, 27, 27, 27, 27, 27, 27, 27, 27, 27, 27,
        27, 27, 27, 27, 27, 27, 27, 27, 27]},
    'bandwidth_bytes': {'get_current_map': 226013, 'new_key_frames': 152928},
    'pre_scale': [{'agent': 2, 's': 0.0, 'nonfinite_points': 55, 'ate_before':
        0.052222009748220444, 'frames_before': 50}],
    'after_merge': [{'agent': 2, 'nonfinite_points': 0}],
}


def ref_ate31(aid: str) -> float:
    """The JAX CPU reference's ATE of agent `aid`: its final one where it is
    finite, else its ATE just before the scale alignment that broke it
    (fault aa)."""
    ate = JAX_REF11["agents"][aid]["ate_rmse_m"]
    if np.isfinite(ate):
        return ate
    return next(r["ate_before"] for r in JAX_REF11["pre_scale"] if str(r["agent"]) == aid)


def umeyama_ate(est_c, gt_c) -> float:
    """RMSE (m) of camera centers `est_c` [N,3] after the least-squares
    Sim3 that maps them onto `gt_c` (Umeyama 1991), in float64."""
    est_c, gt_c = np.asarray(est_c, np.float64), np.asarray(gt_c, np.float64)
    mu_e, mu_g = est_c.mean(0), gt_c.mean(0)
    E, G = est_c - mu_e, gt_c - mu_g
    U, D, Vt = np.linalg.svd(G.T @ E / len(E))
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U) * np.linalg.det(Vt))])
    R = U @ S @ Vt
    s = np.trace(np.diag(D) @ S) / np.mean(np.sum(E * E, axis=1))
    err = s * E @ R.T + mu_g - gt_c
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1))))


def file_ate31(run_dir):
    """Each agent's paired frames and Sim3 ATE computed here from what the
    run wrote, independently of `gt.bin` and `evaluate`: the camera centers
    of `robot{aid}_trajectory.txt` (stamps relative to the agent's first
    frame), each paired with the fixture's `gt_tum.txt` row nearest in time
    within 0.05 s, as the console pairs them."""
    from dvm_slam_tpu_torch.io import datasets

    here = os.path.dirname(os.path.abspath(__file__))
    parts = datasets.load_euroc(os.path.join(here, MINI_EUROC)).split_for_agents(
        N_AGENTS31, overlap=OVERLAP31)
    gt = np.loadtxt(os.path.join(here, MINI_EUROC, "gt_tum.txt"), ndmin=2)
    out = {}
    for ai, part in enumerate(parts):
        aid = ai + 1
        rows = np.loadtxt(os.path.join(run_dir, f"robot{aid}_trajectory.txt"), ndmin=2)
        est, ref = [], []
        for row in rows:
            ts = row[0] + part.stamps[0]
            i = int(np.argmin(np.abs(gt[:, 0] - ts)))
            if abs(gt[i, 0] - ts) < 0.05:
                est.append(row[1:4])
                ref.append(gt[i, 1:4])
        out[str(aid)] = (len(est), umeyama_ate(est, ref) if len(est) >= 3 else float("nan"))
    return out


def mini_euroc_settings():
    from dvm_slam_tpu_torch.io import config

    return config.settings_from_dict(dict(MINI_EUROC_SETTINGS))


def instrument31(agents, rec, timed_sync):
    """Phase 31's instrumentation of the console's agents: asynchronous
    results land on the next call (fault s), as in the JAX CPU reference;
    per agent and call the keyframe count, the pose returned and the ms by
    kind; the merges with the call they happened on."""
    from dvm_slam_tpu_torch.tracking import tracker as trk

    rec["agents"] = agents
    for aid, a in agents.items():
        a.tracker._record_ready = lambda r: True
        a._gba_ready = lambda: True
        rec["steps"][aid] = []
        process, do_merge = a.process_image, a._do_merge

        def processing(img, ts, a=a, aid=aid, process=process):
            t = a.tracker
            was, n_kf0, n_m = t.state, int(t.map.n_kf), len(rec["merges"])
            timed_sync()
            t0 = time.perf_counter()
            pose = process(img, ts)
            timed_sync()
            ms = (time.perf_counter() - t0) * 1e3
            if len(rec["merges"]) > n_m:
                kind = "merge"
            elif was == trk.NOT_INITIALIZED:
                kind = "init" if t.state == trk.OK else "before init"
            elif not t.autonomous:
                kind = "host path"
            elif t._auto_imgs:
                kind = "buffered"
            else:
                kind = "dispatch, keyframe" if int(t.map.n_kf) > n_kf0 else "dispatch"
            rec["calls"].append((aid, kind, ms))
            rec["steps"][aid].append((t.n_kf_host, None if pose is None else
                                      np.asarray(pose.detach().cpu(), np.float32)))
            return pose

        def merging(peer_id, mB, metaB, S_ab, weld_kf, a=a, aid=aid, do_merge=do_merge):
            rec["merges"].append((aid, int(peer_id), len(rec["steps"][aid])))
            return do_merge(peer_id, mB, metaB, S_ab, weld_kf)

        a.process_image, a._do_merge = processing, merging
    return agents


def run_console(dev, out_dir, timed_sync):
    """Phase 31: `console.run_dataset` on mini_euroc through the kernels,
    instrumented (`instrument31`); returns (report, record, run dir)."""
    from dvm_slam_tpu_torch.io import png
    from dvm_slam_tpu_torch.tools import console

    here = os.path.dirname(os.path.abspath(__file__))
    run_dir = os.path.join(out_dir, "console31")
    rec = dict(steps={}, calls=[], merges=[], decode_ms=[], vocab_s=None, voc=None)
    build, train, read = console.build_agents, console.train_vocabulary_from_frames, png.read_gray

    def reading(path):
        t0 = time.perf_counter()
        img = read(path)
        rec["decode_ms"].append((time.perf_counter() - t0) * 1e3)
        return img

    def training(*args, **kw):
        t0 = time.perf_counter()
        rec["voc"] = train(*args, **kw)
        timed_sync()
        rec["vocab_s"] = time.perf_counter() - t0
        return rec["voc"]

    png.read_gray = reading
    console.train_vocabulary_from_frames = training
    console.build_agents = lambda *a, **k: instrument31(build(*a, **k), rec, timed_sync)
    try:
        rep = console.run_dataset(os.path.join(here, MINI_EUROC), fmt="euroc",
                                  settings_path=mini_euroc_settings(), n_agents=N_AGENTS31,
                                  out_dir=run_dir, overlap=OVERLAP31,
                                  gt_path=os.path.join(here, MINI_EUROC, "gt_tum.txt"),
                                  device=dev)
    finally:
        png.read_gray = read
        console.train_vocabulary_from_frames = train
        console.build_agents = build
    return rep, rec, run_dir


def console_plain_prefix(dev, voc, n_steps):
    """The first `n_steps` calls of each agent of phase 31's run through the
    plain versions: the console's loader, split and agents, the kernel run's
    vocabulary. Returns the record `instrument31` keeps."""
    from dvm_slam_tpu_torch.io import datasets
    from dvm_slam_tpu_torch.multiagent import transport
    from dvm_slam_tpu_torch.tools import console

    settings = mini_euroc_settings()
    seq = datasets.load_euroc(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                           MINI_EUROC))
    parts = seq.split_for_agents(N_AGENTS31, overlap=OVERLAP31)
    rec = dict(steps={}, calls=[], merges=[])
    agents = instrument31(console.build_agents(N_AGENTS31, settings.tracker_config(False),
                                               settings.camera.K(), voc,
                                               transport.LoopbackTransport(), device=dev),
                          rec, lambda: None)
    for step in range(n_steps):
        for ai, (aid, a) in enumerate(sorted(agents.items())):
            ts, img = parts[ai][step]
            a.process_image(img, ts - parts[ai].stamps[0])
    return rec


def check_phase31(rep, rec, plain, counts, run_dir, card):
    """Phase 31 against the reference's bounds (`tests/test_dataset_
    integration.py:43-60`) and the JAX CPU reference of the same call
    (`JAX_REF11`): each agent with at least MIN_FRAMES31 paired frames and a
    Sim3-aligned ATE under ATE31_BOUND_M and 3x the reference's; each
    agent's keyframe count after every call through the reference's merge
    call within KF31_ATOL of the reference's, and the reference's merge
    (agent, peer) within MERGE31_STEPS calls of its call; a merge in some
    agent's state; every artifact of the recording written, and
    `evaluate`'s paired frames and ATE equal to those computed here from the
    written trajectories and the fixture's ground truth (`file_ate31`); K1
    once per extracted frame and per vocabulary frame, K2/K3 launched; the
    plain path's first N_PLAIN31 calls of each agent with the kernel path's
    keyframe counts, poses to 1e-3."""
    from dvm_slam_tpu_torch.tools import console

    ref = JAX_REF11
    agents = rep.get("agents", {})
    states = {}
    for aid in range(1, N_AGENTS31 + 1):
        with open(os.path.join(run_dir, f"robot{aid}_state.json")) as f:
            states[aid] = json.load(f)
    print(f"[31] mini_euroc, {N_AGENTS31} agents, overlap {OVERLAP31}: per agent (paired frames, "
          f"ATE m, keyframes, merged with) "
          f"{[(a, v['frames'], round(v['ate_rmse_m'], 6), states[int(a)]['n_keyframes'], states[int(a)]['merged_with']) for a, v in sorted(agents.items())]} "
          f"(JAX CPU ref {[(a, v['frames'], round(v['ate_rmse_m'], 6), v['n_keyframes'], v['merged_with']) for a, v in sorted(ref['agents'].items())]})")
    print(f"[31] JAX CPU ref scale alignments (agent, s, non-finite points read, ATE m before "
          f"it): {[(r['agent'], r['s'], r['nonfinite_points'], r['ate_before']) for r in ref['pre_scale']]}"
          f" (fault aa); bound per agent {ATE31_BOUND_M} m and 3x "
          f"{ {a: round(ref_ate31(a), 6) for a in sorted(ref['agents'])} }")
    print(f"[31] merges (agent, peer, call) {rec['merges']} (JAX CPU ref "
          f"{[(m['agent'], m['peer'], m['step']) for m in ref['merges']]}); keyframes after "
          f"each call {dict((a, [s[0] for s in v]) for a, v in rec['steps'].items())} (ref "
          f"{ref['kf_steps']})")
    d = np.asarray(rec["decode_ms"])
    print(f"[31] PNG decode: median {np.median(d):.2f} ms per frame, max {d.max():.2f} ms "
          f"(n={len(d)}, 240x180 8-bit gray, host); vocabulary from {N_VOCAB31} frames trained "
          f"in {rec['vocab_s']:.2f} s on {card}")
    groups = {}
    for _, kind, ms in rec["calls"]:
        groups.setdefault(kind, []).append(ms)
    for kind, ms in sorted(groups.items()):
        ms = np.asarray(ms)
        print(f"[31] process_image, {kind} calls: median {np.median(ms):.2f} ms, p90 "
              f"{np.percentile(ms, 90):.2f} ms, max {ms.max():.2f} ms (n={len(ms)}) on {card}")
    bw = rep.get("bandwidth", {})
    latency = [e[1] for a in rec["agents"].values() for e in a.log if e[0] == "merge_latency_s"]
    print(f"[31] merge_latency_s {latency} on {card}; bytes by channel "
          f"{bw.get('bytes_by_channel')} (JAX CPU ref {ref['bandwidth_bytes']}); messages "
          f"{bw.get('msgs_by_channel')}")
    n_frames = sum(len(v) for v in rec["steps"].values())
    print(f"[31] launches {counts}; K1 expected {n_frames} agent frames + {N_VOCAB31} "
          f"vocabulary frames")
    check(set(agents) == {str(a) for a in range(1, N_AGENTS31 + 1)}, f"[31] agents {sorted(agents)}")
    for aid, v in agents.items():
        ate_ref = ref_ate31(aid)
        check(v["frames"] >= MIN_FRAMES31, f"[31] agent {aid}: {v['frames']} paired frames")
        check(v["ate_rmse_m"] < min(ATE31_BOUND_M, 3.0 * ate_ref),
              f"[31] agent {aid}: ATE {v['ate_rmse_m']} m, bound {ATE31_BOUND_M} m and 3x the "
              f"JAX CPU ref's {ate_ref} m")
    ref_merge = ref["merges"][0]
    merge = next((m for m in rec["merges"] if m[0] == ref_merge["agent"]), None)
    check(merge is not None and merge[1] == ref_merge["peer"]
          and abs(merge[2] - ref_merge["step"]) <= MERGE31_STEPS,
          f"[31] merges {rec['merges']}: agent {ref_merge['agent']} should merge agent "
          f"{ref_merge['peer']}'s map within {MERGE31_STEPS} calls of call {ref_merge['step']}")
    n_pre = ref_merge["step"] + 1
    kf_dev = {aid: max(abs(a - b) for a, b in zip([s[0] for s in rec["steps"][aid][:n_pre]],
                                                  ref["kf_steps"][str(aid)][:n_pre]))
              for aid in rec["steps"]}
    print(f"[31] keyframes after each of calls 0-{n_pre - 1} (through the reference's merge "
          f"call) against JAX_REF11's: largest difference per agent {kf_dev} (bound {KF31_ATOL})")
    check(all(len(rec["steps"][aid]) >= n_pre for aid in rec["steps"])
          and max(kf_dev.values()) <= KF31_ATOL,
          f"[31] keyframes before the merge differ from JAX_REF11's by {kf_dev}")
    check(any(s["merged_with"] for s in states.values()),
          f"[31] no agent merged: {[s['merged_with'] for s in states.values()]}")
    missing = [f for f in [p.format(aid=a) for a in range(1, N_AGENTS31 + 1) for p in RUN31_FILES]
               + list(RUN31_SHARED) if not os.path.exists(os.path.join(run_dir, f))]
    check(not missing, f"[31] run artifacts missing: {missing}")
    ev, own = console.evaluate(run_dir)["agents"], file_ate31(run_dir)
    print(f"[31] evaluate(run_dir) per agent (frames, ATE m) "
          f"{ {a: (v['frames'], v['ate_rmse_m']) for a, v in sorted(ev.items())} }; from the "
          f"written trajectories and gt_tum.txt {own}")
    check(set(ev) == set(own) and all(
        ev[a]["frames"] == own[a][0] and abs(ev[a]["ate_rmse_m"] - own[a][1]) <= ATE31_FILE_ATOL_M
        for a in ev), f"[31] evaluate {ev} against the written trajectories {own}")
    check(counts["orb_describe"] == n_frames + N_VOCAB31,
          f"[31] {counts['orb_describe']} K1 launches for {n_frames} + {N_VOCAB31} frames")
    check(counts["onehot_adjoint"] > 0 and counts["onehot_gather"] > 0,
          f"[31] K2/K3 never launched: {counts}")
    n = len(plain["steps"][1])
    aids = sorted(plain["steps"])
    check_prefix(31, f"the first {n} calls of each agent",
                 [[s[0] for s in rec["steps"][a][:n]] for a in aids],
                 [[s[0] for s in plain["steps"][a]] for a in aids],
                 [s[1] for a in aids for s in rec["steps"][a][:n]],
                 [s[1] for a in aids for s in plain["steps"][a]])


def main(kernels_only: bool = False) -> int:
    import torch

    # ---- 1. the card --------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on a card",
              file=sys.stderr)
        return 1
    from dvm_slam_tpu_torch.geometry import lie
    from dvm_slam_tpu_torch.mapping import local_mapping, map_state
    from dvm_slam_tpu_torch.ops import orb_kernel, scatter_kernel
    from dvm_slam_tpu_torch.tracking import tracker

    t_start = time.perf_counter()
    phase_t = [t_start]

    def phase_done(n):
        now = time.perf_counter()
        print(f"[{n}] phase took {now - phase_t[0]:.2f} s")
        phase_t[0] = now

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    phase_done(1)

    # ---- 2. build the kernels, one nvcc per source, started together ----
    with ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(orb_kernel.build), pool.submit(scatter_kernel.build)]
        rec, rec23 = (b.result() for b in builds)
    print(f"[2] K1 built in {rec['seconds']:.2f} s -> {rec['path']}")
    print_ptxas(rec)

    cfg_k = configs(None)
    imgs_all, depth0, poses_all = scene(dev)
    imgs, poses = imgs_all[:N_FRAMES], poses_all[:N_FRAMES]
    phase_done(2)

    # ---- 3. K1, one launch per frame, against its twin -------------------
    worst_ang = max(check_k1("frame 0", *frame_inputs(imgs[0], cfg_k.frontend)),
                    check_k1("adversarial frame", *adversarial_frame(dev)))
    phase_done(3)
    if kernels_only:  # phases 7, 8 and 15 only: the kernels, without the slices
        print(f"[7] K2/K3 built in {rec23['seconds']:.2f} s -> {rec23['path']}")
        print_ptxas(rec23)
        check_ba_kernels(dev)
        phase_done(8)
        kernel_table(dev, card, imgs_all[0], None)
        phase_done(15)
        print(f"total {time.perf_counter() - t_start:.2f} s")
        return 0

    # ---- 4. the slice through the kernel -------------------------------
    zero_counts()
    t0 = time.perf_counter()
    m, n_created, run_k = run_slice(imgs, depth0, cfg_k, dev)
    wall = time.perf_counter() - t0
    launches = counts_now()["orb_describe"]
    print(f"[4] bootstrap created {n_created} points; {len(run_k)} frames tracked in {wall:.2f} s "
          f"(first call included)")
    errs = [center_err(T, gt) for (_, T, _, _), gt in zip(run_k, poses[1:])]
    for i, ((n, _, _, _), e, ref) in enumerate(zip(run_k, errs, JAX_REF_INLIERS), start=1):
        print(f"[4] frame {i:2d}: inliers {n:4d} (JAX CPU ref {ref:4d}), trans err {e:.5f} m")
    print(f"[4] K1 launches: {launches} for {N_FRAMES} extracted frames of {N_LEVELS} levels")
    check(launches == N_FRAMES, f"{launches} K1 launches, expected one per frame ({N_FRAMES})")
    check(all(n >= cfg_k.min_track_inliers for n, _, _, _ in run_k),
          f"a frame fell below {cfg_k.min_track_inliers} inliers")
    check(max(errs) < ERR_BOUND_M, f"translation error {max(errs):.5f} m >= {ERR_BOUND_M:.5f} m")
    check(all(np.isfinite(T.cpu().numpy()).all() for _, T, _, _ in run_k), "non-finite pose")
    print(f"[4] max trans err {max(errs):.5f} m (bound {ERR_BOUND_M:.5f} m = 3x the JAX CPU "
          f"reference's {JAX_REF_MAX_ERR_M} m)")
    phase_done(4)

    # ---- 5. the same slice through the twin ----------------------------
    cfg_t = configs(False)
    _, n_created_t, run_t = run_slice(imgs[:N_PLAIN1 + 1], depth0, cfg_t, dev)
    check(counts_now()["orb_describe"] == launches, "the twin path launched K1")
    check(n_created_t == n_created, f"twin bootstrap created {n_created_t} != {n_created}")
    inl_k, inl_t = [r[0] for r in run_k], [r[0] for r in run_t]
    pose_diff = max(float((a[1] - b[1]).abs().max()) for a, b in zip(run_k, run_t))
    print(f"[5] twin path over the first {len(run_t)} frames: inliers identical: "
          f"{inl_k[:len(inl_t)] == inl_t}; max pose diff {pose_diff:.3e}")
    check(inl_k[:len(inl_t)] == inl_t, f"inliers differ: kernel {inl_k} twin {inl_t}")
    check(pose_diff <= POSE_ATOL, f"poses differ by {pose_diff}")
    phase_done(5)

    # ---- 6. timing: phase 4's frames, each synchronised --------------------
    ms = np.asarray([r[3] for r in run_k])
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    print(f"[6] make_and_track with K1: median {med:.2f} ms/frame "
          f"(IQR {q1:.2f}-{q3:.2f}, max {ms.max():.2f}, n={len(ms)}) = "
          f"{len(ms) / ms.sum() * 1e3:.2f} frames/s on {card}")

    # outputs of the final state are finite and shaped as the map says
    check(m.pt_pos.shape == (8192, 3) and bool(torch.isfinite(m.pt_pos).all()), "map points")
    check(lie.se3_t(run_k[-1][1]).shape == (3,), "pose shape")
    phase_done(6)

    # ---- 7. K2/K3 build (started with K1's in phase 2) ------------------
    print(f"[7] K2/K3 built in {rec23['seconds']:.2f} s -> {rec23['path']}")
    print_ptxas(rec23)
    phase_done(7)

    # ---- 8. K2 and K3 against their plain versions at BA's shapes --------
    k2_err, k3_err = check_ba_kernels(dev)
    phase_done(8)

    # ---- 9. slice 2 through the kernels -----------------------------------
    cfg2_k, cfg2_p = configs(None), configs(False)
    imgs2, poses2 = imgs_all[:N_FRAMES2], poses_all[:N_FRAMES2]
    zero_counts()
    t0 = time.perf_counter()
    m2, n2, run2 = run_slice2(imgs2, depth0, cfg2_k, dev, timed=True)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    counts = counts_now()
    made = [r[1] for r in run2]
    n_ba = sum(made)
    errs2 = [center_err(r[3], gt) for r, gt in zip(run2, poses2[1:])]
    for i, (r, e, ref_n, ref_kf, ref_v) in enumerate(zip(
            run2, errs2, JAX_REF2_INLIERS, JAX_REF2_MADE_KF, JAX_REF2_VALID_POINTS), start=1):
        print(f"[9] frame {i:2d}: inliers {r[0]:4d} (JAX CPU ref {ref_n:4d}), kf {int(r[1])} "
              f"(ref {ref_kf}), valid points {r[5]:4d} (ref {ref_v:4d}), trans err {e:.5f} m")
    n_valid = int(m2.pt_valid.sum())
    parted = next((i for i, (a, b) in enumerate(zip(made, JAX_REF2_MADE_KF)) if a != b), len(made))
    shared_dev = max((abs(r[5] - v) / v for r, v in zip(run2[:parted], JAX_REF2_VALID_POINTS)),
                     default=0.0)
    inv = map_state.check_invariants(m2)
    print(f"[9] bootstrap {n2} points; {len(run2)} frames in {wall2:.2f} s (first calls "
          f"included); keyframes made {n_ba} (JAX CPU ref {sum(JAX_REF2_MADE_KF)}), n_kf "
          f"{int(m2.n_kf)} (ref {JAX_REF2_N_KF}); valid points {n_valid} (ref "
          f"{JAX_REF2_VALID_POINTS[-1]}); max trans err {max(errs2):.5f} m (bound "
          f"{ERR_BOUND2_M:.5f} m = 3x the ref's {JAX_REF2_MAX_ERR_M} m)")
    print(f"[9] keyframe flags equal to the ref's through frame {parted}; valid points within "
          f"{shared_dev:.2%} of the ref's there")
    print(f"[9] launches: {counts}; BAs {n_ba}")
    print(f"[9] invariants: {inv} (JAX CPU ref: {JAX_REF2_INVARIANTS})")
    check(all(r[2] for r in run2), "a frame was not tracked (good=False)")
    check(abs(n_ba - sum(JAX_REF2_MADE_KF)) <= 1,
          f"{n_ba} keyframes made, JAX CPU ref {sum(JAX_REF2_MADE_KF)}")
    check(counts["onehot_adjoint"] == BA_STEPS * n_ba,
          f"K2 launched {counts['onehot_adjoint']} times for {n_ba} BAs")
    check(counts["onehot_gather"] == (BA_STEPS + 1) * n_ba,
          f"K3 launched {counts['onehot_gather']} times for {n_ba} BAs")
    check(counts["orb_describe"] == N_FRAMES2,
          f"K1 launched {counts['orb_describe']} times for {N_FRAMES2} frames")
    ref_kinds = {e.split(" ", 1)[1] if e[0].isdigit() else e for e in JAX_REF2_INVARIANTS}
    kinds = {e.split(" ", 1)[1] if e[0].isdigit() else e for e in inv}
    check(kinds <= ref_kinds, f"map invariants broken beyond the JAX CPU ref's: {inv}")
    check(shared_dev <= VALID_RTOL,
          f"valid points off the JAX CPU ref's by {shared_dev:.2%} while keyframes agree")
    check(abs(n_valid - JAX_REF2_VALID_POINTS[-1]) <= VALID_RTOL_END * JAX_REF2_VALID_POINTS[-1],
          f"{n_valid} valid points at the end, JAX CPU ref {JAX_REF2_VALID_POINTS[-1]}")
    check(max(errs2) < ERR_BOUND2_M, f"translation error {max(errs2):.5f} m >= {ERR_BOUND2_M}")
    check(bool(torch.isfinite(m2.kf_pose).all()) and bool(torch.isfinite(m2.pt_pos).all()),
          "non-finite map")
    phase_done(9)

    # ---- 10. slice 2 through the plain versions ----------------------------
    m2p, n2p, run2p = run_slice2(imgs2[:N_PLAIN2 + 1], depth0, cfg2_p, dev)
    check(counts_now() == counts,
          "the plain path launched a kernel")
    d_inl = [a[0] - b[0] for a, b in zip(run2, run2p)]
    d_pose = [float((a[3] - b[3]).abs().max()) for a, b in zip(run2, run2p)]
    made_p = [r[1] for r in run2p]
    print(f"[10] plain path over the first {len(run2p)} steps: made_kf identical "
          f"{made[:len(made_p)] == made_p} ({sum(made_p)} keyframes); largest inlier difference "
          f"{max(map(abs, d_inl))}; largest pose difference {max(d_pose):.3e}; n_kf "
          f"{int(m2p.n_kf)}, valid points {int(m2p.pt_valid.sum())}")
    check(n2p == n2, f"plain bootstrap created {n2p} != {n2}")
    check(made[:len(made_p)] == made_p, "keyframe flags differ between kernel and plain paths")
    check(max(map(abs, d_inl)) <= 2, f"inliers differ by up to {max(map(abs, d_inl))}")
    check(max(d_pose) <= POSE_ATOL2, f"poses differ by {max(d_pose)}")
    phase_done(10)

    # ---- 11. timing ---------------------------------------------------------
    def split(run):
        kf = np.asarray([r[4] for r in run if r[1]])
        no = np.asarray([r[4] for r in run if not r[1]])
        return kf, no

    # phase 9's run, each frame synchronised and timed
    for what, ms in zip(("with a keyframe", "without"), split(run2)):
        p50, p90 = np.percentile(ms, [50, 90])
        print(f"[11] autonomous_step with kernels, frames {what}: median {p50:.2f} ms, "
              f"p90 {p90:.2f} ms, max {ms.max():.2f} ms (n={len(ms)}) on {card}")
    K = torch.tensor(K_EUROC, dtype=torch.float32, device=dev)
    center = torch.as_tensor(int(m2.n_kf) - 1, dtype=torch.int32, device=dev)
    ba_ms = {}
    for name, uk in (("kernels", None), ("plain", False)):
        ba_ms[name] = time_ms(lambda: local_mapping.local_ba(
            m2, center, K, n_local=MAPPER[3], n_fixed=MAPPER[4], n_pts=MAPPER[5],
            iters=MAPPER[6], n_levels=N_LEVELS, scale_factor=MAPPER[2], use_kernel=uk), 10)
        print(f"[11] local_ba with {name}: {ba_ms[name]:.2f} ms per call (10 calls, CUDA "
              f"events) on {card}")
    phase_done(11)

    # ---- 12. slice 3: System.track_monocular from frame 0 through the kernels
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(out_dir, exist_ok=True)
    vocab = os.path.join(os.path.dirname(os.path.abspath(__file__)), VOCAB)
    zero_counts()
    t0 = time.perf_counter()
    run3 = run_slice3(imgs_all, dev, None, vocabulary=vocab, timed=True)
    frames3, kf3, ate3 = slice3_outcome(run3, poses_all,
                                        os.path.join(out_dir, "slice3_kernels_tum.txt"))
    torch.cuda.synchronize()
    wall3 = time.perf_counter() - t0
    counts3 = counts_now()
    sys3 = run3["system"]
    t3, m3 = sys3.tracker, sys3.map
    n_kf3 = int(m3.n_kf)
    init3 = run3["inits"][-1] if run3["inits"] else None
    used_h = bool(init3.used_homography) if init3 is not None else None
    n_good = int(init3.good.sum()) if init3 is not None else 0
    ba_iters = sys3.mapper.ba_iters
    n_kf_ba = n_kf3 - 2       # every keyframe after the two of the init runs one BA
    want_k2 = (INIT_BA_ITERS + 6) + n_kf_ba * (ba_iters + 6)
    want_k3 = (INIT_BA_ITERS + 7) + n_kf_ba * (ba_iters + 7)
    print(f"[12] System at 600x350 (resized from {H}x{W}), K {sys3.settings.camera.K().tolist()}; "
          f"{len(imgs_all)} frames in {wall3:.2f} s (first calls included)")
    print(f"[12] init at frames {run3['init_pair']} (JAX CPU ref {JAX_REF3_INIT_PAIR}), "
          f"{len(run3['inits'])} two-view calls, homography {used_h} (ref {JAX_REF3_USED_H}), "
          f"good points {n_good} (ref {JAX_REF3_INIT_GOOD})")
    print(f"[12] final state {t3.state}; frames with a pose {len(frames3)} (ref "
          f"{JAX_REF3_N_TRACKED}); keyframes at frames {kf3} (ref {JAX_REF3_KF_FRAMES}); "
          f"n_kf {n_kf3}, n_kf_host {t3.n_kf_host}; valid points {int(m3.pt_valid.sum())}")
    print(f"[12] ATE (Sim3-aligned) {ate3:.6f} m (bound {ATE_BOUND3_M:.6f} m = 3x the ref's "
          f"{JAX_REF3_ATE_M} m)")
    print(f"[12] launches: {counts3}; expected K2 {want_k2}, K3 {want_k3} (init BA of "
          f"{INIT_BA_ITERS} iterations + {n_kf_ba} keyframe BAs of {ba_iters})")
    ip = run3["init_pair"]
    ref_first = [p[0] for p, _, _ in JAX_REF3_INIT_BY_SEED]
    ref_second = [p[1] for p, _, _ in JAX_REF3_INIT_BY_SEED]
    ref_good = [g for _, _, g in JAX_REF3_INIT_BY_SEED]
    print(f"[12] JAX CPU ref over agents 0-5: init pairs "
          f"{[p for p, _, _ in JAX_REF3_INIT_BY_SEED]}, homography "
          f"{[h for _, h, _ in JAX_REF3_INIT_BY_SEED]}, good points {ref_good}")
    check(ip is not None and ip[0] <= max(ref_first) + 1 and ip[1] <= max(ref_second) + 1,
          f"init at frames {ip}, later than the JAX CPU ref's spread")
    check((1 - INIT_GOOD_RTOL) * min(ref_good) <= n_good <= (1 + INIT_GOOD_RTOL) * max(ref_good),
          f"{n_good} initial good points, JAX CPU ref {min(ref_good)}-{max(ref_good)}")
    check(t3.state == tracker.OK, f"final state {t3.state}")
    # the reference gives a pose to every frame after its init
    n_after = len(imgs_all) - ip[1]
    check(len(frames3) >= n_after - 2, f"{len(frames3)} frames with a pose of {n_after}")
    check(abs(n_kf3 - len(JAX_REF3_KF_FRAMES)) <= 2, f"{n_kf3} keyframes")
    check(t3.n_kf_host == n_kf3 and set(t3.kf_timestamps) == set(range(n_kf3)),
          "host keyframe mirror differs from the map")
    check(ate3 < ATE_BOUND3_M, f"ATE {ate3} m >= {ATE_BOUND3_M} m")
    check(counts3["onehot_adjoint"] == want_k2, f"K2 launched {counts3['onehot_adjoint']} times")
    check(counts3["onehot_gather"] == want_k3, f"K3 launched {counts3['onehot_gather']} times")
    check(counts3["orb_describe"] == len(imgs_all),
          f"K1 launched {counts3['orb_describe']} times for {len(imgs_all)} frames")
    check(bool(torch.isfinite(m3.kf_pose[:n_kf3]).all())
          and bool(torch.isfinite(m3.pt_pos).all()), "non-finite map")
    phase_done(12)

    # ---- 13. slice 3 through the plain versions ---------------------------------
    run3p = run_slice3(imgs_all, dev, False, vocabulary=vocab)
    frames3p, kf3p, ate3p = slice3_outcome(run3p, poses_all,
                                           os.path.join(out_dir, "slice3_plain_tum.txt"))
    check(counts_now() == counts3,
          "the plain path launched a kernel")
    (P_k, n_k, X_k), (P_p, n_p, X_p) = run3["init_map"], run3p["init_map"]
    d_init = float((P_k - P_p).abs().max())
    d_pts = float((X_k - X_p).abs().max()) if n_k == n_p else float("inf")

    def traj_np(run):
        return np.stack([np.asarray(T.cpu() if hasattr(T, "cpu") else T, np.float32)
                         for _, T, _ in run["system"].tracker.trajectory])

    same_rows = frames3 == frames3p
    d_traj = float(np.abs(traj_np(run3) - traj_np(run3p)).max()) if same_rows else float("inf")
    print(f"[13] plain path: init at {run3p['init_pair']}; initial keyframe poses differ by "
          f"{d_init:.3e}, points by {d_pts:.3e} ({n_p} vs {n_k}); keyframes at {kf3p}; "
          f"trajectory rows identical {same_rows}, poses differ by {d_traj:.3e}; ATE {ate3p:.6f} m")
    check(run3p["init_pair"] == run3["init_pair"], "the paths initialize at different frames")
    check(n_p == n_k and d_init <= POSE_ATOL, f"initial maps differ (poses by {d_init})")
    check(kf3p == kf3, f"keyframe frames differ: kernels {kf3}, plain {kf3p}")
    check(same_rows and d_traj <= POSE_ATOL2, f"trajectories differ (poses by {d_traj})")
    phase_done(13)

    # ---- 14. timing -----------------------------------------------------------------
    groups = {}
    for kind, ms in run3["calls"]:   # phase 12's calls, each synchronised and timed
        groups.setdefault(kind, []).append(ms)
    for kind, ms in sorted(groups.items()):
        ms = np.asarray(ms)
        p50, p90 = np.percentile(ms, [50, 90])
        print(f"[14] track_monocular with kernels, {kind} calls: median {p50:.2f} ms, p90 "
              f"{p90:.2f} ms, max {ms.max():.2f} ms (n={len(ms)}) on {card}")
    phase_done(14)

    # ---- 15. every kernel at the System path's shapes: its launches there,
    # wrapper-included and device-only time, bound, library call, plain version
    table = kernel_table(dev, card, imgs_all[0], counts3)
    phase_done(15)

    # ---- 16. relocalization: phase 12's and 13's Systems go on through a
    # blackout and a revisit
    seq16 = slice6_sequence(N_BLACK16, REVISIT16)
    runs16 = {}
    for name, run in (("kernels", run3), ("plain", run3p)):
        log = {}
        instrument(run["system"], log, torch.cuda.synchronize)
        before = counts_now()
        if name == "kernels":
            zero_counts()
        poses = drive6(run["system"], imgs_all, seq16, 60, log)
        run["system"].tracker.drain_auto()
        torch.cuda.synchronize()
        if name == "kernels":
            counts16 = counts_now()
        else:
            check(counts_now() == before, "the plain path launched a kernel")
        runs16[name] = (log, poses, rows_np(run["system"].tracker))
    counts6 = {"phase 12": counts3, "phase 16": counts16}
    check_phase16(runs16, seq16, counts16, card)
    phase_done(16)

    # ---- 17. the atlas: a new map on persistent LOST, merge-back on revisit
    from dvm_slam_tpu_torch.models.system import System

    seq17 = slice6_sequence(N_BLACK17, REVISIT17)
    imgs17, _, _ = scene(dev, **DENSE_WORLD)
    runs17 = {}
    for name, uk in (("kernels", None), ("plain", False)):
        sysm = System(euroc_settings(FPS17), device=dev, use_kernel=uk, vocabulary_file=vocab)
        log = {}
        instrument(sysm, log, torch.cuda.synchronize)
        before = counts_now()
        if name == "kernels":
            zero_counts()
        t0 = time.perf_counter()
        # the plain path takes the first N_PLAIN17 calls, held call by call
        poses = drive6(sysm, imgs17, seq17 if uk is None else seq17[:N_PLAIN17], 0, log)
        sysm.tracker.drain_auto()
        torch.cuda.synchronize()
        print(f"[17] {name}: {len(log['calls'])} calls in {time.perf_counter() - t0:.2f} s")
        if name == "kernels":
            counts17 = counts_now()
        else:
            check(counts_now() == before, "the plain path launched a kernel")
        runs17[name] = (log, poses, rows_np(sysm.tracker), sysm)
    counts6["phase 17"] = counts17
    check_phase17(runs17, seq17, counts17, poses_all, card)
    phase_done(17)

    # ---- 18. two SlamAgents merge: BoW advertisement, merge, essential graph,
    # global BA, keyframe sharing, frame tree
    imgs18, traj18 = scene18(dev)
    runs18 = {}
    for name, uk in (("kernels", None), ("plain", False)):
        before = counts_now()
        if name == "kernels":
            zero_counts()
        t0 = time.perf_counter()
        # the plain path takes the first N_PLAIN18 steps, held call by call
        n = N_STEPS18 if uk is None else N_PLAIN18
        runs18[name] = run_agents(dev, uk, imgs18, traj18, vocab, torch.cuda.synchronize, n)
        torch.cuda.synchronize()
        print(f"[18] {name}: {2 * n} frames and {N_IDLE18 if uk is None else 0} idle rounds in "
              f"{time.perf_counter() - t0:.2f} s")
        if name == "kernels":
            counts18 = counts_now()
        else:
            check(counts_now() == before, "the plain path launched a kernel")
    counts6["phase 18"] = counts18
    check_phase18(runs18, counts18, traj18, card)
    phase_done(18)

    # ---- 19. the atlas checkpoint of phase 12's System, reloaded on the card
    check_phase19(run3["system"], out_dir, dev)
    phase_done(19)

    # ---- 20. local_ba_batched over four EuRoC-capacity maps
    maps20 = [run3["system"].map, runs17["kernels"][3].map,
              runs18["kernels"][0][1].map, runs18["kernels"][0][2].map]
    counts6["phase 20"] = phase20(maps20, dev, card)
    del maps20
    phase_done(20)

    # ---- 21. build_multi_agent_step: four agents as a batch axis
    from dvm_slam_tpu_torch.placerec import vocabulary as vocmod

    voc = vocmod.load(vocab)
    counts6["phase 21"] = phase21(imgs_all, dev, card, voc)
    phase_done(21)

    # ---- 22. build_protocol_step at EuRoC capacity against JAX_REF8
    t0 = time.perf_counter()
    rounds22 = run_protocol(dev, voc)
    print(f"[22] {PROTO_ROUNDS} rounds in {time.perf_counter() - t0:.2f} s")
    counts6["phase 22"] = {k: sum(r["launches"][k] for r in rounds22) for k in KERNELS}
    check_phase22(rounds22, protocol_plain(dev, voc, rounds22[:N_PLAIN22]), card)
    del rounds22
    phase_done(22)

    # ---- 23. three SlamAgents merge implicitly, the wire through the native codec
    imgs23, traj23 = scene18(dev, 110, TRAJ23)
    zero_counts()
    t0 = time.perf_counter()
    agents23, bus23, rec23 = run_three_agents(dev, imgs23, traj23, vocab, torch.cuda.synchronize)
    torch.cuda.synchronize()
    counts6["phase 23"] = counts_now()
    print(f"[23] {sum(hi - lo for lo, hi in SEGMENTS23.values())} frames and {N_IDLE23} idle "
          f"rounds in {time.perf_counter() - t0:.2f} s; launches {counts6['phase 23']}")
    check_phase23(agents23, bus23, rec23, traj23, card)
    phase_done(23)

    # ---- 24-26. stereo at KITTI width, RGB-D at TUM width, KB8 at TUM-VI width,
    # each through its System entry point, kernels then plain versions
    for phase in (24, 25, 26):
        frames9, poses9 = scene9(phase, dev)
        if phase == 24:
            worst_ang = max(worst_ang, check_k1("stereo pair", *stereo_pair_inputs(dev), tag=24))
        runs9 = {}
        for name, uk in (("kernels", None), ("plain", False)):
            before = counts_now()
            if name == "kernels":
                zero_counts()
            t0 = time.perf_counter()
            # the plain path takes the first N_PLAIN9 calls, held call by call
            runs9[name] = run_sensor(phase, frames9 if uk is None else frames9[:N_PLAIN9], dev,
                                     uk, out_dir)
            print(f"[{phase}] {name}: {len(runs9[name]['ms'])} calls in "
                  f"{time.perf_counter() - t0:.2f} s")
            if name == "kernels":
                counts9 = counts_now()
            else:
                check(counts_now() == before, f"[{phase}] the plain path launched a kernel")
        counts6[f"phase {phase}"] = counts9
        check_phase9(phase, runs9, poses9, counts9, card)
        del runs9, frames9
        phase_done(phase)

    # ---- 27-29. the inertial modes through their System entry points,
    # kernels then plain versions; phase 28's kernel System is phase 30's
    # system 1
    for phase in (27, 28, 29):
        frames10, chunks10, poses10, vels10 = scene10(phase, dev)
        runs10 = {}
        for name, uk in (("kernels", None), ("plain", False)):
            before = counts_now()
            if name == "kernels":
                zero_counts()
            t0 = time.perf_counter()
            n = N_FRAMES10[phase] if uk is None else N_PLAIN10[phase]
            runs10[name] = run_vi(phase, frames10[:n], chunks10, dev, uk, out_dir,
                                  n_profiled=1 if uk is None and phase == 27 else 0)
            print(f"[{phase}] {name}: {runs10[name]['n_calls']} calls in "
                  f"{time.perf_counter() - t0:.2f} s")
            if name == "kernels":
                counts10 = counts_now()
            else:
                check(counts_now() == before, f"[{phase}] the plain path launched a kernel")
        counts6[f"phase {phase}"] = counts10
        check_phase10(phase, runs10, poses10, counts10, card)
        if phase == 28:
            sys30 = (runs10["kernels"]["system"], frames10, chunks10, vels10)
        del runs10, frames10
        phase_done(phase)

    # ---- 30. MergeInertialBA: phase 28's System welds a second one's map
    zero_counts()
    agent30, merge_s, _ = run_merge10(sys30[0], sys30[1], sys30[2], dev, vocab, out_dir)
    counts6["phase 30"] = counts_now()
    check_phase30(agent30, merge_s, sys30[3], counts6["phase 30"], card)
    del agent30, sys30
    phase_done(30)

    # ---- 31. the console's two-agent run on mini_euroc (real imagery),
    # kernels, then the plain versions over a prefix
    zero_counts()
    rep31, rec31, run31 = run_console(dev, out_dir, torch.cuda.synchronize)
    torch.cuda.synchronize()
    counts6["phase 31"] = counts_now()
    before = counts_now()
    plain31 = console_plain_prefix(dev, rec31["voc"], N_PLAIN31)
    check(counts_now() == before, "[31] the plain path launched a kernel")
    check_phase31(rep31, rec31, plain31, counts6["phase 31"], run31, card)
    del rec31, plain31
    phase_done(31)
    print(f"total {time.perf_counter() - t_start:.2f} s")

    errs = {"orb_describe": worst_ang, "onehot_adjoint": k2_err, "onehot_gather": k3_err}
    print(f"launches per path: {counts6}")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": tpu,
        "launches": sum(c[name] for c in counts6.values()), "max_abs_err": errs[name],
        "ms": table[name]["wrap"] / 1e3, "plain_ms": table[name]["plain"] / 1e3,
        "bound_ms": table[name]["bound"] / 1e3, "bound_by": table[name]["by"],
        "library_ms": None if table[name]["lib"] is None else table[name]["lib"] / 1e3,
        "bound_us": table[name]["bound"], "device_us": table[name]["dev"],
    } for name, (src, tpu) in KERNELS.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(kernels_only="--kernels-only" in sys.argv[1:]))
