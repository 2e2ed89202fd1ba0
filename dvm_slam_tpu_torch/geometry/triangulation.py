"""Two-view DLT triangulation, batched.

Port of `dvm_slam_tpu/geometry/triangulation.py` (`GeometricTools::
Triangulate`): the 4x4 homogeneous DLT system of two normalized
observations, solved through the eigenvector of A^T A with the smallest
eigenvalue. `torch.linalg.eigh` returns eigenvalues ascending, as
`jnp.linalg.eigh` does; the eigenvector's sign may differ between the two
libraries and cancels in X[:3] / X[3]. Everything stays f32, as in the
reference; batched 4x4 `eigh` on the card is another solver than LAPACK on
the CPU, so points near the callers' acceptance thresholds may flip.
"""

from __future__ import annotations

import torch

from . import lie


def projection_matrix(T_cw):
    """World->camera SE3 [...,7] -> 3x4 projection (identity intrinsics)."""
    return lie.se3_matrix(T_cw)[..., :3, :]


def triangulate(xn1, xn2, T1_cw, T2_cw):
    """DLT triangulation of normalized image points.

    xn1, xn2: [...,2] or [...,3] normalized coords (z=1 implied if 2D) in
    cameras 1 and 2; T1_cw, T2_cw: [...,7] world->camera poses.
    Returns (Xw [...,3] world points, ok [...] bool finite/solvable flag)."""
    P1 = projection_matrix(T1_cw)
    P2 = projection_matrix(T2_cw)
    if xn1.shape[-1] == 3:
        x1, y1 = xn1[..., 0] / xn1[..., 2], xn1[..., 1] / xn1[..., 2]
        x2, y2 = xn2[..., 0] / xn2[..., 2], xn2[..., 1] / xn2[..., 2]
    else:
        x1, y1 = xn1[..., 0], xn1[..., 1]
        x2, y2 = xn2[..., 0], xn2[..., 1]
    A = torch.stack([
        x1[..., None] * P1[..., 2, :] - P1[..., 0, :],
        y1[..., None] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., None] * P2[..., 2, :] - P2[..., 0, :],
        y2[..., None] * P2[..., 2, :] - P2[..., 1, :],
    ], dim=-2)                                           # [...,4,4]
    AtA = A.transpose(-1, -2) @ A
    _, V = torch.linalg.eigh(AtA)
    X = V[..., :, 0]                                     # smallest eigenvalue
    w_h = X[..., 3]
    ok = torch.abs(w_h) > 1e-12
    Xw = X[..., :3] / torch.where(ok, w_h, 1.0)[..., None]
    ok = ok & torch.all(torch.isfinite(Xw), dim=-1)
    return Xw, ok


def depth_in_camera(T_cw, Xw):
    """z-coordinate of world points in a camera frame."""
    return lie.se3_apply(T_cw, Xw)[..., 2]


def parallax_cos(T1_cw, T2_cw, Xw):
    """Cosine of the ray parallax angle at a triangulated point."""
    c1 = lie.se3_t(lie.se3_inv(T1_cw))
    c2 = lie.se3_t(lie.se3_inv(T2_cw))
    r1 = Xw - c1
    r2 = Xw - c2
    n1 = torch.linalg.norm(r1, dim=-1)
    n2 = torch.linalg.norm(r2, dim=-1)
    return torch.sum(r1 * r2, dim=-1) / torch.clamp(n1 * n2, min=1e-12)
