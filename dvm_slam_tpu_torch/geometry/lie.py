"""SO(3) / SE(3) Lie groups as batched PyTorch functions.

Port of `dvm_slam_tpu/geometry/lie.py`: SO3, SE3 and Sim3 with the Sim3
tangent space (`sim3_exp/log/retract`) that the pose graph differentiates
at zero. `sim3_fold` is the port's name for the scale fold the reference
writes out inline wherever a world-level Sim3 re-bases a pose. Same storage
conventions:

* quaternion `[..., 4]` scalar-first `(w, x, y, z)`, unit norm;
* SE3 `[..., 7]` = `(qw, qx, qy, qz, tx, ty, tz)`;
* Sim3 `[..., 8]` = `(qw, qx, qy, qz, tx, ty, tz, s)`, scale stored directly;
* se3 tangent `[..., 6]` = `(v, omega)`, translation part first;
* sim3 tangent `[..., 7]` = `(v, omega, sigma)`, sigma = log s.

Every function broadcasts over leading dims and is branch-free
(`torch.where` with guarded denominators), as in the reference.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _cross(a, b):
    """Cross product over the last dim, written out (the reference's
    `jnp.cross` component order)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _eye3(ref):
    return torch.eye(3, dtype=ref.dtype, device=ref.device)


# --------------------------------------------------------------------------
# quaternion primitives
# --------------------------------------------------------------------------

def quat_identity(shape=(), dtype=torch.float32, device=None):
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=_EPS)


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_mul(a, b):
    """Hamilton product, scalar-first."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_rotate(q, p):
    """Rotate points `p [...,3]` by unit quaternion `q [...,4]` (the
    2-cross-product form)."""
    v = q[..., 1:4]
    w = q[..., 0:1]
    c = 2.0 * _cross(v, p)
    return p + w * c + _cross(v, c)


def quat_to_matrix(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_from_matrix(R):
    """Rotation matrix [...,3,3] -> unit quaternion, branch-free: the four
    Shepperd candidates, the numerically best one picked by a gather."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def cand(tval, nums, slot):
        s = torch.sqrt(torch.clamp(1.0 + tval, min=_EPS))
        q = torch.stack([n / (2.0 * s) for n in nums], dim=-1)
        q[..., slot] = 0.5 * s
        return q

    qw = cand(tr, [tr, m21 - m12, m02 - m20, m10 - m01], 0)
    qx = cand(m00 - m11 - m22, [m21 - m12, tr, m01 + m10, m02 + m20], 1)
    qy = cand(m11 - m00 - m22, [m02 - m20, m01 + m10, tr, m12 + m21], 2)
    qz = cand(m22 - m00 - m11, [m10 - m01, m02 + m20, m12 + m21, tr], 3)

    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [...,4,4]
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    take = idx[..., None, None].expand(idx.shape + (1, 4))
    q = torch.gather(cands, -2, take)[..., 0, :]
    q = torch.where(q[..., 0:1] < 0, -q, q)  # canonical sign: w >= 0
    return quat_normalize(q)


# --------------------------------------------------------------------------
# so(3)
# --------------------------------------------------------------------------

def hat(phi):
    """so(3) hat operator: [...,3] -> [...,3,3] skew matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(phi.shape[:-1] + (3, 3))


def so3_exp(phi):
    """Rotation vector [...,3] -> unit quaternion [...,4]."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = theta2 < 1e-8
    theta = torch.sqrt(torch.where(small, 1.0, theta2))
    half = 0.5 * theta
    # sin(theta/2)/theta: series 1/2 - theta^2/48
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([w, k * phi], dim=-1)


def so3_log(q):
    """Unit quaternion [...,4] -> rotation vector [...,3] with |phi| <= pi."""
    q = torch.where(q[..., 0:1] < 0, -q, q)  # w >= 0 so angle in [0, pi]
    w = q[..., 0:1]
    v = q[..., 1:4]
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    small = n2 < 1e-12
    n = torch.sqrt(torch.where(small, 1.0, n2))
    angle = 2.0 * torch.atan2(n, w)
    # angle/n, series for small n: 2/w * (1 - n^2/(3 w^2))
    ws = torch.clamp(w, min=_EPS)
    k = torch.where(small, 2.0 / ws * (1.0 - n2 / (3.0 * ws * ws)), angle / n)
    return k * v


def so3_left_jacobian(phi):
    """V(phi): the SO(3) left Jacobian, used by se3_exp. [...,3] -> [...,3,3]."""
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < 1e-8
    safe = torch.sqrt(torch.where(small, 1.0, theta2))
    A = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))
    B = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (safe - torch.sin(safe)) / (safe ** 3))
    K = hat(phi)
    return _eye3(phi) + A[..., None, None] * K + B[..., None, None] * (K @ K)


def so3_left_jacobian_inv(phi):
    theta2 = torch.sum(phi * phi, dim=-1)
    small = theta2 < 1e-8
    safe = torch.sqrt(torch.where(small, 1.0, theta2))
    half = 0.5 * safe
    cot = half * torch.cos(half) / torch.sin(half)
    C = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - cot) / (safe * safe))
    K = hat(phi)
    return _eye3(phi) - 0.5 * K + C[..., None, None] * (K @ K)


# --------------------------------------------------------------------------
# SE(3)
# --------------------------------------------------------------------------

def se3_identity(shape=(), dtype=torch.float32, device=None):
    T = torch.zeros(tuple(shape) + (7,), dtype=dtype, device=device)
    T[..., 0] = 1.0
    return T


def se3(q, t):
    return torch.cat([q, t], dim=-1)


def se3_q(T):
    return T[..., 0:4]


def se3_t(T):
    return T[..., 4:7]


def se3_exp(xi):
    """se3 tangent [...,6] = (v, omega) -> SE3 [...,7]."""
    v, omega = xi[..., 0:3], xi[..., 3:6]
    q = so3_exp(omega)
    t = (so3_left_jacobian(omega) @ v[..., None])[..., 0]
    return se3(q, t)


def se3_log(T):
    omega = so3_log(se3_q(T))
    v = (so3_left_jacobian_inv(omega) @ se3_t(T)[..., None])[..., 0]
    return torch.cat([v, omega], dim=-1)


def se3_mul(a, b):
    q = quat_mul(se3_q(a), se3_q(b))
    t = quat_rotate(se3_q(a), se3_t(b)) + se3_t(a)
    return se3(quat_normalize(q), t)


def se3_inv(T):
    qi = quat_conj(se3_q(T))
    return se3(qi, -quat_rotate(qi, se3_t(T)))


def se3_apply(T, p):
    return quat_rotate(se3_q(T), p) + se3_t(T)


def se3_matrix(T):
    """[...,7] -> homogeneous [...,4,4]."""
    R = quat_to_matrix(se3_q(T))
    t = se3_t(T)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=T.dtype, device=T.device)
    bottom = bottom.expand(T.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_from_matrix(M):
    return se3(quat_from_matrix(M[..., :3, :3]), M[..., :3, 3])


def se3_retract(T, xi):
    """Left-multiplicative retraction: exp(xi) * T (optimizer update rule)."""
    return se3_mul(se3_exp(xi), T)


# --------------------------------------------------------------------------
# Sim(3): the group action T * p = s R p + t
# --------------------------------------------------------------------------

def sim3_identity(shape=(), dtype=torch.float32, device=None):
    S = torch.zeros(tuple(shape) + (8,), dtype=dtype, device=device)
    S[..., 0] = 1.0
    S[..., 7] = 1.0
    return S


def sim3(q, t, s):
    return torch.cat([q, t, s[..., None] if s.dim() == q.dim() - 1 else s], dim=-1)


def sim3_from_se3(T, s=None):
    s = (torch.ones(T.shape[:-1] + (1,), dtype=T.dtype, device=T.device) if s is None
         else torch.as_tensor(s, dtype=T.dtype, device=T.device).reshape(T.shape[:-1] + (1,)))
    return torch.cat([T, s], dim=-1)


def sim3_to_se3(S):
    """Drop the scale (keep rotation and translation)."""
    return S[..., 0:7]


def sim3_mul(a, b):
    q = quat_normalize(quat_mul(sim3_q(a), sim3_q(b)))
    t = sim3_s(a)[..., None] * quat_rotate(sim3_q(a), sim3_t(b)) + sim3_t(a)
    s = sim3_s(a) * sim3_s(b)
    return torch.cat([q, t, s[..., None]], dim=-1)


def sim3_inv(S):
    qi = quat_conj(sim3_q(S))
    si = 1.0 / sim3_s(S)
    ti = -si[..., None] * quat_rotate(qi, sim3_t(S))
    return torch.cat([qi, ti, si[..., None]], dim=-1)


def sim3_fold(S):
    """The SE3 [...,7] with a Sim3's scale folded into its translation,
    (q, t / s): how a world-level Sim3 re-bases a camera pose."""
    return se3(sim3_q(S), sim3_t(S) / torch.clamp(sim3_s(S), min=1e-12)[..., None])


def sim3_q(S):
    return S[..., 0:4]


def sim3_t(S):
    return S[..., 4:7]


def sim3_s(S):
    return S[..., 7]


def sim3_apply(S, p):
    return sim3_s(S)[..., None] * quat_rotate(sim3_q(S), p) + sim3_t(S)


def _sim3_W(omega, sigma):
    """The Sim(3) `W` matrix with t = W(omega, sigma) v in `sim3_exp`
    (Strasdat's thesis / Sophus `sim3.hpp` closed forms), branch-free over
    four regimes with the reference's truncated series and safe substitutes
    (`th`, `sg`, `csafe`): every branch is evaluated, so the unselected ones
    must stay finite for forward-mode derivatives at zero."""
    theta2 = torch.sum(omega * omega, dim=-1)
    s_theta = theta2 < 1e-8
    s_sigma = torch.abs(sigma) < 1e-4
    one = torch.ones_like(theta2)
    th = torch.sqrt(torch.where(s_theta, one, theta2))
    sg = torch.where(s_sigma, one, sigma)
    es = torch.exp(sigma)

    # C = (e^sigma - 1)/sigma
    C = torch.where(s_sigma, 1.0 + 0.5 * sigma + sigma * sigma / 6.0, (es - 1.0) / sg)
    # regime 1: theta small, sigma small (first order in sigma)
    A11 = 0.5 + sigma / 3.0
    B11 = 1.0 / 6.0 + sigma / 8.0
    # regime 2: theta small, sigma not small
    A10 = ((sg - 1.0) * es + 1.0) / (sg * sg)
    B10 = ((0.5 * sg * sg - sg + 1.0) * es - 1.0) / (sg ** 3)
    # regime 3: theta not small, sigma small
    A01 = (1.0 - torch.cos(th)) / (th * th)
    B01 = (th - torch.sin(th)) / (th ** 3)
    # regime 4: general
    a = es * torch.sin(th)
    b = es * torch.cos(th)
    c = theta2 + sigma * sigma
    csafe = torch.where(c < _EPS, one, c)
    A00 = (a * sg + (1.0 - b) * th) / (th * csafe)
    B00 = (C - ((b - 1.0) * sg + a * th) / csafe) / (th * th)

    A = torch.where(s_theta, torch.where(s_sigma, A11, A10), torch.where(s_sigma, A01, A00))
    B = torch.where(s_theta, torch.where(s_sigma, B11, B10), torch.where(s_sigma, B01, B00))
    K = hat(omega)
    return C[..., None, None] * _eye3(omega) + A[..., None, None] * K + B[..., None, None] * (K @ K)


def sim3_exp(xi):
    """sim3 tangent [...,7] = (v, omega, sigma) -> Sim3 [...,8]."""
    v, omega, sigma = xi[..., 0:3], xi[..., 3:6], xi[..., 6]
    q = so3_exp(omega)
    t = (_sim3_W(omega, sigma) @ v[..., None])[..., 0]
    return torch.cat([q, t, torch.exp(sigma)[..., None]], dim=-1)


def sim3_log(S):
    """Sim3 [...,8] -> sim3 tangent [...,7]; one batched 3x3 solve."""
    omega = so3_log(sim3_q(S))
    sigma = torch.log(torch.clamp(sim3_s(S), min=_EPS))
    v = torch.linalg.solve(_sim3_W(omega, sigma), sim3_t(S)[..., :, None])[..., 0]
    return torch.cat([v, omega, sigma[..., None]], dim=-1)


def sim3_retract(S, xi):
    """Left-multiplicative retraction exp(xi) * S (the pose graph's update)."""
    return sim3_mul(sim3_exp(xi), S)
