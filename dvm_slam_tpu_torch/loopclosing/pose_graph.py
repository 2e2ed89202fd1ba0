"""Sim(3) pose-graph (essential graph) optimization.

Port of `dvm_slam_tpu/loopclosing/pose_graph.py`
(`Optimizer::OptimizeEssentialGraph`): nodes are keyframe Sim3 poses S_iw
(world -> camera, the scale carries monocular drift); edges are spanning
tree + strong covisibility + loop/merge edges, each with a measurement S_ij
fixed when the graph is built; residual r_e = log_sim3(S_ij^-1 S_iw S_jw^-1)
in R^7.

Gauss-Newton with identity information. The per-edge 7x7 Jacobians are
forward-mode derivatives of the residual through the tangent retraction at
zero, as the reference's `jax.jacfwd` under `jax.vmap`: column k is one
`torch.func.jvp` over every edge at once (a batched JVP keeps every tensor
batched; under `vmap` a 0-d tensor meets Python floats as a double). The
Hessian is dense [N,N,7,7]: the edge blocks land with
`index_put_(accumulate=True)` (edges repeat nodes), and the [7N,7N] system
is one `torch.linalg.solve`. Points follow their
reference keyframe: X' = S_new^-1 (S_old (X)). The spanning tree and the
edge list are host numpy, copied.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jvp

from ..geometry import lie


def edge_residual(S_iw, S_jw, S_ij_meas):
    """r = log_sim3(S_ij_meas^-1 * S_iw * S_jw^-1), [...,7]."""
    rel = lie.sim3_mul(S_iw, lie.sim3_inv(S_jw))
    return lie.sim3_log(lie.sim3_mul(lie.sim3_inv(S_ij_meas), rel))


def _edge_linearization(residual, retract, dof: int, p, ei, ej, emeas):
    """Per-edge residual r [E,R] and Jacobians Ji, Jj [E,R,dof] of
    residual(retract(p_i, xi), retract(p_j, xj), meas) at xi = xj = 0:
    `jacfwd`'s columns. One forward-mode JVP over 2*dof copies of the edge
    list: copy k of the first half pushes tangent direction k through xi,
    copy k of the second half through xj."""
    E = ei.shape[0]
    reps = 2 * dof
    Si, Sj, meas = p[ei].repeat(reps, 1), p[ej].repeat(reps, 1), emeas.repeat(reps, 1)

    def f(xi, xj):
        return residual(retract(Si, xi), retract(Sj, xj), meas)

    zero = torch.zeros((reps * E, dof), dtype=p.dtype, device=p.device)
    basis = torch.eye(dof, dtype=p.dtype, device=p.device).repeat_interleave(E, dim=0)  # [dof*E,dof]
    ti = torch.cat([basis, torch.zeros_like(basis)])
    tj = torch.cat([torch.zeros_like(basis), basis])
    r, t = jvp(f, (zero, zero), (ti, tj))
    J = t.reshape(2, dof, E, -1).permute(0, 2, 3, 1)     # [2,E,R,dof]
    return r[:E], J[0], J[1]


def _gauss_newton(residual, retract, dof: int, poses, fixed, ei, ej, emeas, emask,
                  iters: int, damping: float):
    """The reference's GN loop on a dense [N*dof]^2 system; fixed nodes get
    an identity block and no coupling. Returns (poses', final_cost)."""
    N = poses.shape[0]
    dtype, dev = poses.dtype, poses.device
    ei = torch.as_tensor(ei, device=dev).to(torch.int64)
    ej = torch.as_tensor(ej, device=dev).to(torch.int64)
    emeas = torch.as_tensor(emeas, dtype=dtype, device=dev)
    fixed = torch.as_tensor(fixed, device=dev).to(torch.bool)
    w = torch.as_tensor(emask, device=dev).to(dtype)
    eye = torch.eye(dof, dtype=dtype, device=dev)
    nn = torch.arange(N, device=dev)
    free = (~fixed).to(dtype)
    p = poses
    for _ in range(iters):
        r, Ji, Jj = _edge_linearization(residual, retract, dof, p, ei, ej, emeas)
        Ji = Ji * free[ei][:, None, None]
        Jj = Jj * free[ej][:, None, None]
        Hii = torch.einsum("eki,e,ekj->eij", Ji, w, Ji)
        Hjj = torch.einsum("eki,e,ekj->eij", Jj, w, Jj)
        Hij = torch.einsum("eki,e,ekj->eij", Ji, w, Jj)
        bi = torch.einsum("eki,e,ek->ei", Ji, w, r)
        bj = torch.einsum("eki,e,ek->ei", Jj, w, r)

        H = torch.zeros((N, N, dof, dof), dtype=dtype, device=dev)
        H.index_put_((ei, ei), Hii, accumulate=True)
        H.index_put_((ej, ej), Hjj, accumulate=True)
        H.index_put_((ei, ej), Hij, accumulate=True)
        H.index_put_((ej, ei), Hij.transpose(-1, -2), accumulate=True)
        b = torch.zeros((N, dof), dtype=dtype, device=dev)
        b.index_put_((ei,), bi, accumulate=True)   # one summation order on every run
        b.index_put_((ej,), bj, accumulate=True)

        lam = damping * (1.0 + torch.einsum("nnii->", H) / (dof * N))
        H[nn, nn] += lam * eye
        fix2 = fixed[:, None] | fixed[None, :]
        H = torch.where(fix2[:, :, None, None], 0.0, H)
        H[nn, nn] += fixed.to(dtype)[:, None, None] * eye
        b = b * free[:, None]

        Hm = H.permute(0, 2, 1, 3).reshape(dof * N, dof * N)
        dx = torch.linalg.solve(Hm, -b.reshape(-1)).reshape(N, dof)
        dx = torch.where(torch.isfinite(dx), dx, 0.0) * free[:, None]
        p = retract(p, dx)
    r = residual(p[ei], p[ej], emeas)
    final = torch.sum(torch.where(w > 0, torch.sum(r * r, -1), 0.0))
    return p, final


def optimize_pose_graph(poses, fixed, ei, ej, emeas, emask, iters: int = 20,
                        damping: float = 1e-6):
    """poses [N,8] Sim3 world->camera; fixed [N] bool (the loop/merge
    anchor side); ei, ej [E] edge endpoints; emeas [E,8] measured S_ij;
    emask [E] valid edges. Returns (poses' [N,8], final_cost)."""
    return _gauss_newton(edge_residual, lie.sim3_retract, 7, poses, fixed, ei, ej, emeas,
                         emask, iters, damping)


def _embed4(x4):
    """(tx, ty, tz, yaw) -> se3 tangent [6] (v, omega) with omega = (0, 0, yaw)."""
    zero = torch.zeros(x4.shape[:-1] + (2,), dtype=x4.dtype, device=x4.device)
    return torch.cat([x4[..., :3], zero, x4[..., 3:4]], dim=-1)


def _edge_residual_se3(T_iw, T_jw, meas):
    rel = lie.se3_mul(T_iw, lie.se3_inv(T_jw))
    return lie.se3_log(lie.se3_mul(lie.se3_inv(meas), rel))


def _retract_4dof(T, x4):
    return lie.se3_retract(T, _embed4(x4))


def optimize_pose_graph_4dof(poses, fixed, ei, ej, emeas, emask, iters: int = 20,
                             damping: float = 1e-6):
    """4-DoF essential graph (`Optimizer::OptimizeEssentialGraph4DoF`): with
    an IMU roll, pitch and scale are observable, so a correction moves only
    translation and yaw. Nodes SE3 [N,7] world->camera, per-node tangent
    (tx, ty, tz, yaw) as a left-multiplied exp([v, (0, 0, yaw)]); SE3 edge
    measurements, r = log_se3(meas^-1 T_iw T_jw^-1). Returns (poses', cost)."""
    return _gauss_newton(_edge_residual_se3, _retract_4dof, 4, poses, fixed, ei, ej, emeas,
                         emask, iters, damping)


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def compute_spanning_tree(covis, kf_valid):
    """Maximum-weight spanning tree over the covisibility graph (the role of
    `KeyFrame::ChangeParent`'s incremental tree): parent[i], -1 for roots
    and invalid slots. Prim's algorithm from the lowest valid slot, host
    numpy."""
    W = _host(covis)
    valid = _host(kf_valid)
    n = W.shape[0]
    parent = np.full(n, -1, np.int64)
    nodes = np.nonzero(valid)[0]
    if len(nodes) == 0:
        return parent
    in_tree = np.zeros(n, bool)
    in_tree[nodes[0]] = True
    best_w = W[:, nodes[0]].astype(np.int64).copy()
    best_p = np.full(n, nodes[0], np.int64)
    for _ in range(len(nodes) - 1):
        cand = np.where(valid & ~in_tree, best_w, -1)
        j = int(np.argmax(cand))
        if cand[j] <= 0:
            break  # disconnected component: the remaining nodes stay roots
        parent[j] = best_p[j]
        in_tree[j] = True
        upd = W[:, j] > best_w
        best_w = np.where(upd, W[:, j], best_w)
        best_p = np.where(upd, j, best_p)
    return parent


def build_essential_edges(covis, kf_valid, min_weight: int = 100, spanning_parent=None,
                          extra_edges=None):
    """The essential-graph edge list on the host: strong covisibility
    (weight >= min_weight), spanning-tree links and loop/merge edges.
    Returns (ei, ej) int32 with i < j, deduplicated and sorted."""
    W = _host(covis)
    valid = _host(kf_valid)
    ii, jj = np.nonzero(np.triu(W >= min_weight, 1))
    keep = valid[ii] & valid[jj]
    pairs = set(zip(ii[keep].tolist(), jj[keep].tolist()))
    if spanning_parent is not None:
        for c, p in enumerate(np.asarray(spanning_parent)):
            if p >= 0 and valid[c] and valid[p]:
                pairs.add((min(c, int(p)), max(c, int(p))))
    if extra_edges:
        for a, b in extra_edges:
            if valid[a] and valid[b] and a != b:
                pairs.add((min(a, b), max(a, b)))
    if not pairs:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    arr = np.asarray(sorted(pairs), np.int32)
    return arr[:, 0], arr[:, 1]


def correct_points(pt_pos, pt_ref_kf, pt_valid, poses_old, poses_new):
    """Propagate a pose-graph correction to the map points through their
    reference keyframes: X' = S_new_rw^-1 (S_old_rw (X))."""
    r = torch.clamp(pt_ref_kf, min=0).to(torch.int64)
    Xc = lie.sim3_apply(poses_old[r], pt_pos)
    Xw = lie.sim3_apply(lie.sim3_inv(poses_new[r]), Xc)
    return torch.where(pt_valid[:, None], Xw, pt_pos)


def se3_from_sim3_poses(poses_sim3):
    """Optimized Sim3 poses back to SE3 keyframe poses, the scale folded
    into the translation: [R, t/s]."""
    return lie.sim3_fold(poses_sim3)
