"""A mixed two-agent run: a JAX `SlamAgent` (id 1) and a port `SlamAgent`
(id 2, on the CPU) on one `LoopbackTransport`, through the whole
decentralized protocol of `tests/test_multiagent.py` (BoW advertisement,
merge detection on the lead node, the pull of agent 1's map, Sim3
verification, splice, welding BA, essential graph, the asynchronous global
BA, incremental keyframe sharing both ways, the frame-tree re-parenting).

The run is the reference test's (the 8-patch world, `smooth_trajectory(80,
lateral=2.2, forward=0.6, yaw=0.08)`, agent 1 on frames 0..51 and agent 2
on 28..79, a keyframe at least every 4 frames, the console's mapper, a
branch-8 depth-2 vocabulary trained on the world) at the smallest shape at
which the JAX-only run still merges within the reference test's 0.2 m
keyframe ATE: 150x200, 300 features on 4 levels. At 135x180 the JAX-only
run merges with a 0.278 m ATE; at 120x160 agent 2 never initializes. The port's two-view RANSAC replays
the draws a JAX agent 2 would make (ROADMAP fault o); its protocol draws
come from its own generator. The wire is the only contract between the
two: every message the port publishes holds numpy arrays, bytes and Python
scalars, never a tensor.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dvm_slam_tpu.eval import metrics as jmetrics
from dvm_slam_tpu.frontend.extractor import FrontendConfig, make_frame
from dvm_slam_tpu.io import synthetic as jsyn
from dvm_slam_tpu.mapping import local_mapping as jlm
from dvm_slam_tpu.multiagent import agent as jagent
from dvm_slam_tpu.placerec import vocabulary as jvoc
from dvm_slam_tpu.tracking import tracker as jtrk

from dvm_slam_tpu_torch import convert
from dvm_slam_tpu_torch.mapping import local_mapping as tlm
from dvm_slam_tpu_torch.multiagent import agent as tagent
from dvm_slam_tpu_torch.multiagent import messages as tmsgs
from dvm_slam_tpu_torch.multiagent import transport as ttransport

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_system import reference_noise  # noqa: E402

torch.set_num_threads(2)

H, W, N_FEATURES, N_LEVELS = 150, 200, 300, 4
K = np.array([260.0, 260.0, 160.0, 120.0], np.float32) * (W / 320.0)
N_STEPS = 52
SEGMENTS = {1: (0, 52), 2: (28, 80)}
ATE_BOUND_M = 0.2          # tests/test_multiagent.py:203


def _no_tensor(v):
    if isinstance(v, torch.Tensor):
        return False
    if dataclasses.is_dataclass(v):
        return all(_no_tensor(getattr(v, f.name)) for f in dataclasses.fields(v))
    if isinstance(v, (list, tuple)):
        return all(_no_tensor(x) for x in v)
    if isinstance(v, dict):
        return all(_no_tensor(x) for x in v.values())
    return True


@pytest.fixture(scope="module")
def mixed_run():
    world = jsyn.PlaneWorld(seed=3, tex_size=1024, plane_z=6.0, extent=30.0)
    traj = jsyn.smooth_trajectory(80, lateral=2.2, forward=0.6, yaw=0.08)
    cfg = jtrk.TrackerConfig(
        frontend=FrontendConfig(height=H, width=W, n_features=N_FEATURES, n_levels=N_LEVELS),
        kf_cap=96, pt_cap=6144, fps=4.0)
    descs = []
    for i in range(0, 40, 8):
        im = world.render(jnp.asarray(traj[i]), jnp.asarray(K), H, W)
        f = make_frame(im, jnp.asarray(K), jnp.zeros(4), cfg.frontend)
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    voc = jvoc.train(np.concatenate(descs)[:6000], branch=8, depth=2, seed=0)

    bus = ttransport.LoopbackTransport()
    sent = {1: [], 2: []}
    publish = bus.publish

    def spy(sender, target, channel, msg):
        sent[sender].append((channel, msg))
        return publish(sender, target, channel, msg)

    bus.publish = spy
    a1 = jagent.SlamAgent(1, cfg, K, np.zeros(4, np.float32), voc, bus, [1, 2],
                          mapper=jlm.LocalMapper(n_neighbors=4, ba_local=8, ba_fixed=8,
                                                 ba_pts=2048, ba_iters=6))
    a2 = tagent.SlamAgent(2, convert.tracker_config_from_dict(dataclasses.asdict(cfg)), K,
                          np.zeros(4, np.float32),
                          convert.vocabulary_from_numpy(convert.vocabulary_to_numpy(voc)), bus,
                          [1, 2], mapper=tlm.LocalMapper(n_neighbors=4, ba_local=8, ba_fixed=8,
                                                         ba_pts=2048, ba_iters=6), device="cpu")
    a2.tracker._ransac_noise = reference_noise(2)
    agents = {1: a1, 2: a2}
    for step in range(N_STEPS):
        for aid, (lo, hi) in SEGMENTS.items():
            img = np.asarray(world.render(jnp.asarray(traj[lo + step]), jnp.asarray(K), H, W))
            agents[aid].process_image(img, step * 0.1)
    # end of stream: flush, then a few idle protocol iterations drain the
    # messages still in flight (the reference's run loop spins forever)
    for a in agents.values():
        a.flush()
    for extra in range(6):
        for a in agents.values():
            a.run_once((N_STEPS + extra) * 0.1)
    return agents, bus, traj, sent


class TestMixedRun:
    def test_both_merged(self, mixed_run):
        agents, _, _, _ = mixed_run
        a1, a2 = agents[1], agents[2]
        assert a1.peers[2].successfully_merged and a2.peers[1].successfully_merged, \
            f"no merge: a1.log={a1.log} a2.log={a2.log}"
        # the port (higher id) pulled agent 1's map and merged it
        assert ("merged", 1) in a2.log
        assert any(e[0] == "gba_applied" for e in a2.log)

    def test_keyframes_shared_both_ways(self, mixed_run):
        agents, bus, _, _ = mixed_run
        a1, a2 = agents[1], agents[2]
        n1, n2 = int(a1.map.n_kf), int(a2.map.n_kf)
        v1 = np.asarray(a1.map.kf_valid[:n1])
        v2 = a2.map.kf_valid[:n2].numpy()
        assert (a1.meta.kf_creator[:n1][v1] == 2).sum() > 0, "agent 1 never took the port's keyframes"
        assert (a2.meta.kf_creator[:n2][v2] == 1).sum() > 0, "the port never took agent 1's keyframes"
        assert bus.bandwidth_report()["bytes_by_channel"].get(tmsgs.CH_NEW_KEY_FRAMES, 0) > 0

    def test_frame_tree_reparented(self, mixed_run):
        agents, _, _, _ = mixed_run
        assert agents[2].frames.parent_frame == "robot1/origin"
        assert agents[1].frames.parent_frame == "world"

    def test_host_mirrors_in_sync(self, mixed_run):
        agents, _, _, _ = mixed_run
        for a in agents.values():
            assert a.check_invariants()

    def test_merged_map_consistent_with_gt(self, mixed_run):
        """The Sim3-aligned keyframe ATE of the port's merged map, as
        `tests/test_multiagent.py:187-203` measures agent 2's."""
        agents, _, traj, _ = mixed_run
        a2 = agents[2]
        m = a2.map
        n = int(m.n_kf)
        valid = m.kf_valid.numpy()
        est, gt = [], []
        for slot, ts in a2.tracker.kf_timestamps.items():
            i = SEGMENTS[2][0] + int(round(ts / 0.1))
            if slot < n and valid[slot] and i < len(traj):
                est.append(m.kf_pose[slot].numpy())
                gt.append(np.asarray(traj[i]))
        assert len(est) >= 5
        rmse, _, _ = jmetrics.ate_rmse(np.stack(est), np.stack(gt))
        assert rmse < ATE_BOUND_M, f"the port's merged-map keyframe ATE {rmse:.3f} m"

    def test_port_messages_hold_no_tensor(self, mixed_run):
        _, _, _, sent = mixed_run
        channels = {c for c, _ in sent[2]}
        assert {tmsgs.CH_NEW_KEY_FRAMES, tmsgs.CH_SUCCESSFULLY_MERGED} <= channels, channels
        assert all(_no_tensor(m) for _, m in sent[2])
