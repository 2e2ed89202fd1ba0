"""The yardstick of the kernels: the card's peaks and each kernel call's
least bytes and operations, from the shapes of its inputs and outputs.

Copied from `chip_smoke.py` phase 15: every input byte is counted as read
once and every output byte as written once, whatever the kernel reads
again, so the count is the same whatever implements the call.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, 700 W: HBM3 bandwidth and the f32 rate
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# K1's operations per keypoint: the moments over the 31x31 window (mask, x
# and y products, two sums), the 512 steered pattern points (four products,
# two sums) and 256 compares
K1_OPS_PER_KEYPOINT = 5 * 31 * 31 + 6 * 512 + 256
PATTERN_BYTES = 256 * 4 * 4   # the [256, 4] int32 sampling pattern


def bound_s(nbytes: float, nops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the f32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S)


def k1(raws, blurs, xy, offsets):
    """(bytes, ops) of `orb_kernel.orient_and_describe_levels`: each level's
    raw and blurred image and the keypoints read, the angles and the 256
    descriptor bytes written, the pattern read once."""
    n = xy.shape[0]
    pixels = sum(r.numel() for r in raws) + sum(b.numel() for b in blurs)
    return 4 * (pixels + 2 * n + n) + 256 * n + PATTERN_BYTES, n * K1_OPS_PER_KEYPOINT


def k2(vals, pidx, n_cols):
    """(bytes, ops) of `scatter_kernel.onehot_adjoint`: vals [L,G,F] and
    pidx [L,F] read, out [L,G,n_cols] written. Its operations, G per hit,
    take far less time than its bytes at every BA shape; they are left at 0."""
    L, G, F = vals.shape
    return 4 * (L * G * F + L * F + L * G * n_cols), 0


def k3(pts_pl, pidx):
    """(bytes, ops) of `scatter_kernel.onehot_gather`: the point table
    [G,P] and pidx [L,F] read, out [L,G,F] written; no arithmetic."""
    G, P = pts_pl.shape
    L, F = pidx.shape
    return 4 * (G * P + L * F + L * G * F), 0
