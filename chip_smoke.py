#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`dvm_slam_tpu_torch`) on one NVIDIA
card.

Drives the port's main path — ORB extraction (`make_frame`) plus two-stage
map tracking (`track_frame`), fused as `make_and_track` — at EuRoC geometry
(480x752, 1250 features, 8 levels, pt_cap 8192) on a rendered synthetic
sequence, with the hand-written K1 kernel (fused ORB orientation + steered
BRIEF, `dvm_slam_tpu_torch/csrc/orb_describe.cu`). Phases, in order; any
failure raises and the run exits non-zero:

1. require a CUDA card; print its name and power limit;
2. build K1 from the checkout's sources with nvcc (build seconds, ptxas);
3. K1 against its plain PyTorch twin on all 8 levels of frame 0, at the
   keypoints `detect_level` chose: angle atol 1e-4, <= 1e-3 bits differing;
4. the slice with the kernel: depth bootstrap from frame 0, then 29 frames
   of motion-model tracking; every frame >= 15 inliers and a translation
   error under 3x the JAX package's CPU reference run of the same frames;
   K1 launched 8 times per extracted frame;
5. the same slice with `use_kernel=False`: identical inliers, poses to 1e-4;
6. timing after warm-up, the two paths alternated: make_and_track latency
   per frame (host clock around each synchronised frame) and K1 against the
   twin per level (CUDA events).

Run from the root of a checkout: `python3 chip_smoke.py`. The last line is
`{"ok": true, "device": {...}}`; the line before it the card's name and power
limit, and before that one JSON line describing the kernel.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

H, W = 480, 752
K_EUROC = (458.654, 457.296, 367.215, 248.375)
N_FEATURES, N_LEVELS = 1250, 8
TEX_SIZE = 2048
N_FRAMES = 30  # frame 0 bootstraps the map, frames 1..29 are tracked

# The JAX package's CPU reference run of these frames (same world, geometry
# and bootstrap; `python tests/test_torch_slice.py`): per-frame inliers and
# the largest translation error against ground truth, in meters.
JAX_REF_INLIERS = [755, 703, 679, 646, 605, 580, 528, 499, 483, 435, 420, 374, 378, 369, 338,
                   313, 308, 296, 276, 260, 247, 244, 231, 219, 211, 204, 187, 185, 192]
JAX_REF_MAX_ERR_M = 0.020346
ERR_BOUND_M = 3.0 * JAX_REF_MAX_ERR_M

ANGLE_ATOL = 1e-4          # bench.py's bound for the TPU kernel against XLA
MAX_BIT_FRACTION = 1e-3
POSE_ATOL = 1e-4
KERNEL_SOURCE = "dvm_slam_tpu_torch/csrc/orb_describe.cu"
TPU_KERNEL = "dvm_slam_tpu/ops/pallas_orb.py:55"


def card_line() -> str:
    """`name, power.limit` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"smoke check failed: {what}")


def configs(use_kernel):
    from dvm_slam_tpu_torch.frontend.extractor import FrontendConfig
    from dvm_slam_tpu_torch.tracking.tracker import TrackerConfig

    fc = FrontendConfig(height=H, width=W, n_features=N_FEATURES, n_levels=N_LEVELS,
                        use_kernel=use_kernel)
    return TrackerConfig(frontend=fc, kf_cap=128, pt_cap=8192, fps=20.0)


def scene(device):
    """Frames, frame 0's depth and ground-truth poses of the benchmark scene."""
    from dvm_slam_tpu_torch.io import synthetic

    world = synthetic.PlaneWorld(seed=7, tex_size=TEX_SIZE, plane_z=6.0, extent=36.0,
                                 device=device)
    poses = synthetic.smooth_trajectory(60, lateral=2.5, forward=0.8, yaw=0.1)[:N_FRAMES]
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
    model. Returns (map, n_created, [(n_inliers, T_cw, T_pred)])."""
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
        _, res, pv, pf = tracker.make_and_track(img, m, T_pred, K, dist, cfg)
        m = m._replace(pt_visible=pv, pt_found=pf)
        T, vel = tracker.motion_model_step(T, res, cfg)
        out.append((int(res.n_inliers), T.clone(), T_pred))
    return m, int(n_created), out


def level_inputs(img, cfg):
    """Per level of one frame: (raw, blur, xy) at the main path's shapes."""
    from dvm_slam_tpu_torch.ops import fast, pyramid

    fc = cfg.frontend
    levels = pyramid.build_pyramid(img, fc.n_levels, fc.scale_factor)
    out = []
    for im, budget in zip(levels, fc.level_budgets):
        xy, _, _ = fast.detect_level(im, fc.ini_th, fc.min_th, fc.cell, budget)
        out.append((im.contiguous(), pyramid.gaussian_blur(im).contiguous(), xy))
    return out


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


def main() -> int:
    import torch

    # ---- 1. the card --------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on a card",
              file=sys.stderr)
        return 1
    from dvm_slam_tpu_torch.geometry import lie
    from dvm_slam_tpu_torch.ops import orb_descriptor, orb_kernel
    from dvm_slam_tpu_torch.tracking import tracker

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # ---- 2. build K1 ----------------------------------------------------
    rec = orb_kernel.build()
    print(f"[2] K1 built in {rec['seconds']:.2f} s -> {rec['path']}")
    for line in rec["ptxas"].splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"    ptxas: {line.strip()}")

    cfg_k = configs(None)
    imgs, depth0, poses = scene(dev)

    # ---- 3. K1 against its twin on every level of frame 0 --------------
    inputs = level_inputs(imgs[0], cfg_k)
    worst_ang, n_diff, n_bits = 0.0, 0, 0
    for lv, (raw, blur, xy) in enumerate(inputs):
        ang_k, desc_k = orb_kernel.orient_and_describe(raw, blur, xy)
        ang_t, desc_t = orb_descriptor.orient_and_describe(raw, blur, xy)
        torch.cuda.synchronize()
        err = float((ang_k - ang_t).abs().max())
        diff = int((desc_k != desc_t).sum())
        worst_ang, n_diff, n_bits = max(worst_ang, err), n_diff + diff, n_bits + desc_k.numel()
        print(f"[3] level {lv} {tuple(raw.shape)} N={xy.shape[0]}: "
              f"angle max err {err:.3e}, {diff} differing bits")
    bit_frac = n_diff / n_bits
    print(f"[3] K1 vs twin: angle max abs err {worst_ang:.3e} (atol {ANGLE_ATOL}), "
          f"differing bits {n_diff}/{n_bits} = {bit_frac:.2e} (limit {MAX_BIT_FRACTION})")
    check(worst_ang <= ANGLE_ATOL, f"K1 angle error {worst_ang} > {ANGLE_ATOL}")
    check(bit_frac <= MAX_BIT_FRACTION, f"K1 differing bit fraction {bit_frac} > {MAX_BIT_FRACTION}")

    # ---- 4. the slice through the kernel -------------------------------
    orb_kernel.launches = 0
    t0 = time.perf_counter()
    m, n_created, run_k = run_slice(imgs, depth0, cfg_k, dev)
    wall = time.perf_counter() - t0
    launches = orb_kernel.launches
    print(f"[4] bootstrap created {n_created} points; {len(run_k)} frames tracked in {wall:.2f} s "
          f"(first call included)")
    errs = [center_err(T, gt) for (_, T, _), gt in zip(run_k, poses[1:])]
    for i, ((n, _, _), e, ref) in enumerate(zip(run_k, errs, JAX_REF_INLIERS), start=1):
        print(f"[4] frame {i:2d}: inliers {n:4d} (JAX CPU ref {ref:4d}), trans err {e:.5f} m")
    print(f"[4] K1 launches: {launches} for {N_FRAMES} extracted frames x {N_LEVELS} levels")
    check(launches == N_LEVELS * N_FRAMES, f"{launches} K1 launches, expected {N_LEVELS * N_FRAMES}")
    check(all(n >= cfg_k.min_track_inliers for n, _, _ in run_k),
          f"a frame fell below {cfg_k.min_track_inliers} inliers")
    check(max(errs) < ERR_BOUND_M, f"translation error {max(errs):.5f} m >= {ERR_BOUND_M:.5f} m")
    check(all(np.isfinite(T.cpu().numpy()).all() for _, T, _ in run_k), "non-finite pose")
    print(f"[4] max trans err {max(errs):.5f} m (bound {ERR_BOUND_M:.5f} m = 3x the JAX CPU "
          f"reference's {JAX_REF_MAX_ERR_M} m)")

    # ---- 5. the same slice through the twin ----------------------------
    cfg_t = configs(False)
    _, n_created_t, run_t = run_slice(imgs, depth0, cfg_t, dev)
    check(orb_kernel.launches == launches, "the twin path launched K1")
    check(n_created_t == n_created, f"twin bootstrap created {n_created_t} != {n_created}")
    inl_k, inl_t = [r[0] for r in run_k], [r[0] for r in run_t]
    pose_diff = max(float((a[1] - b[1]).abs().max()) for a, b in zip(run_k, run_t))
    print(f"[5] twin path: inliers identical: {inl_k == inl_t}; max pose diff {pose_diff:.3e}")
    check(inl_k == inl_t, f"inliers differ: kernel {inl_k} twin {inl_t}")
    check(pose_diff <= POSE_ATOL, f"poses differ by {pose_diff}")

    # ---- 6. timing -------------------------------------------------------
    K = torch.tensor(K_EUROC, dtype=torch.float32, device=dev)
    dist = torch.zeros(4, device=dev)
    preds = [T_pred for _, _, T_pred in run_k]

    def frame_ms(cfg):
        """Per-frame make_and_track latency in ms, each frame synchronised."""
        out = []
        for img, T_pred in zip(imgs[1:], preds):
            t0 = time.perf_counter()
            tracker.make_and_track(img, m, T_pred, K, dist, cfg)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return np.asarray(out)

    # alternate the two paths, after one warm-up pass of each
    frame_ms(cfg_k), frame_ms(cfg_t)
    for name, cfg in (("K1", cfg_k), ("twin", cfg_t), ("twin", cfg_t), ("K1", cfg_k)):
        ms = frame_ms(cfg)
        q1, med, q3 = np.percentile(ms, [25, 50, 75])
        print(f"[6] make_and_track with {name}: median {med:.2f} ms/frame "
              f"(IQR {q1:.2f}-{q3:.2f}, max {ms.max():.2f}, n={len(ms)}) = "
              f"{len(ms) / ms.sum() * 1e3:.2f} frames/s on {card}")
    k_ms, t_ms = 0.0, 0.0
    for lv, (raw, blur, xy) in enumerate(inputs):
        km = time_ms(lambda: orb_kernel.orient_and_describe(raw, blur, xy), 200)
        tm = time_ms(lambda: orb_descriptor.orient_and_describe(raw, blur, xy), 50)
        k_ms, t_ms = k_ms + km, t_ms + tm
        print(f"[6] level {lv} {tuple(raw.shape)} N={xy.shape[0]}: K1 {km * 1e3:.2f} us, "
              f"twin {tm * 1e3:.2f} us on {card}")
    print(f"[6] K1 per frame (8 levels) {k_ms * 1e3:.2f} us, twin {t_ms * 1e3:.2f} us on {card}")

    # outputs of the final state are finite and shaped as the map says
    check(m.pt_pos.shape == (8192, 3) and bool(torch.isfinite(m.pt_pos).all()), "map points")
    check(lie.se3_t(run_k[-1][1]).shape == (3,), "pose shape")

    print(json.dumps({"kernels": [{
        "name": "orb_describe", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches, "max_abs_err": worst_ang,
        "ms": k_ms, "plain_ms": t_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
