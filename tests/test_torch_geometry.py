"""Parity of the port's Lie-group and pinhole camera ops with the JAX
package, on numpy-seeded inputs. Tolerance: atol 1e-5 (f32 arithmetic
fused differently by XLA)."""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dvm_slam_tpu.geometry import cameras as jcam
from dvm_slam_tpu.geometry import lie as jlie

from dvm_slam_tpu_torch.geometry import cameras as tcam
from dvm_slam_tpu_torch.geometry import lie as tlie

torch.set_num_threads(2)

ATOL = 1e-5


def _quats(rng, n):
    q = rng.randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _poses(rng, n):
    return np.concatenate([_quats(rng, n), rng.randn(n, 3).astype(np.float32)], -1)


def _rotvecs(rng, n):
    phi = rng.randn(n, 3).astype(np.float32)
    phi[:4] *= 1e-5  # the small-angle series branch
    return phi


def _tangents(rng, n):
    xi = rng.randn(n, 6).astype(np.float32)
    xi[:4, 3:] *= 1e-5
    return xi


CASES = {
    "quat_normalize": (lambda r: (r.randn(16, 4).astype(np.float32),), "quat_normalize"),
    "quat_conj": (lambda r: (_quats(r, 16),), "quat_conj"),
    "quat_mul": (lambda r: (_quats(r, 16), _quats(r, 16)), "quat_mul"),
    "quat_rotate": (lambda r: (_quats(r, 16), r.randn(16, 3).astype(np.float32)), "quat_rotate"),
    "quat_to_matrix": (lambda r: (_quats(r, 16),), "quat_to_matrix"),
    "hat": (lambda r: (r.randn(16, 3).astype(np.float32),), "hat"),
    "so3_exp": (lambda r: (_rotvecs(r, 16),), "so3_exp"),
    "so3_log": (lambda r: (_quats(r, 16),), "so3_log"),
    "so3_left_jacobian": (lambda r: (_rotvecs(r, 16),), "so3_left_jacobian"),
    "so3_left_jacobian_inv": (lambda r: (_rotvecs(r, 16),), "so3_left_jacobian_inv"),
    "se3_exp": (lambda r: (_tangents(r, 16),), "se3_exp"),
    "se3_log": (lambda r: (_poses(r, 16),), "se3_log"),
    "se3_mul": (lambda r: (_poses(r, 16), _poses(r, 16)), "se3_mul"),
    "se3_inv": (lambda r: (_poses(r, 16),), "se3_inv"),
    "se3_apply": (lambda r: (_poses(r, 16), r.randn(16, 3).astype(np.float32)), "se3_apply"),
    "se3_matrix": (lambda r: (_poses(r, 16),), "se3_matrix"),
    "se3_retract": (lambda r: (_poses(r, 16), 0.1 * _tangents(r, 16)), "se3_retract"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_lie_matches_jax(name):
    make, fn = CASES[name]
    args = make(np.random.RandomState(zlib.crc32(name.encode())))
    want = np.asarray(getattr(jlie, fn)(*[jnp.asarray(a) for a in args]))
    got = getattr(tlie, fn)(*[torch.from_numpy(a) for a in args]).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_quat_from_matrix_matches_jax():
    R = np.array(jlie.quat_to_matrix(jnp.asarray(_quats(np.random.RandomState(3), 32))))
    np.testing.assert_allclose(tlie.quat_from_matrix(torch.from_numpy(R)).numpy(),
                               np.asarray(jlie.quat_from_matrix(jnp.asarray(R))), atol=ATOL)


def test_identities_match_jax():
    np.testing.assert_array_equal(tlie.se3_identity((2,)).numpy(), np.asarray(jlie.se3_identity((2,))))
    np.testing.assert_array_equal(tlie.quat_identity((3,)).numpy(), np.asarray(jlie.quat_identity((3,))))


K = np.array([458.654, 457.296, 367.215, 248.375], np.float32)
DIST = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05], np.float32)


@pytest.mark.parametrize("fn", ["pinhole_project", "pinhole_unproject", "radtan_distort",
                                "radtan_undistort", "undistort_pixels"])
def test_cameras_match_jax(fn):
    rng = np.random.RandomState(7)
    pts = rng.randn(64, 3).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 0.5
    pts[:4, 2] = -1.0  # behind the camera
    uv = (rng.rand(64, 2) * [752, 480]).astype(np.float32)
    xy = (rng.randn(64, 2) * 0.3).astype(np.float32)
    args = {
        "pinhole_project": (K, pts),
        "pinhole_unproject": (K, uv),
        "radtan_distort": (DIST, xy),
        "radtan_undistort": (DIST, xy),
        "undistort_pixels": (K, DIST, uv),
    }[fn]
    want = getattr(jcam, fn)(*[jnp.asarray(a) for a in args])
    got = getattr(tcam, fn)(*[torch.from_numpy(a) for a in args])
    if fn == "pinhole_project":
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        want, got = want[0], got[0]
    # undistortion iterates a fixed point on pixel-sized values: 1e-5 of a
    # normalized coordinate is ~5e-3 px
    atol = ATOL * K[0] if fn in ("undistort_pixels", "pinhole_project") else ATOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)
