"""FAST-9/16 corner detection + grid-bucketed spatially-uniform top-k.

Port of `dvm_slam_tpu/ops/fast.py`: the dense segment test at both
thresholds, 3x3 local-max suppression, the per-cell dual-threshold fallback
and the breadth-first ranked selection across cells. Two details keep the
selected corners identical to the reference:

* `jax.lax.top_k` returns ties lowest index first; `torch.topk` promises no
  tie order, so every top-k here is a stable descending sort, sliced.
* The selection key `rank * 1e9 - score` is f32, and XLA evaluates it as one
  fused multiply-add. At 1e9 the f32 spacing is 64, so the rounding decides
  which scores tie; the key is computed exactly in f64 and rounded once to
  f32, which is what the fused operation gives.
"""

from __future__ import annotations

import numpy as np
import torch

# 16-pixel Bresenham circle of radius 3, (dx, dy), clockwise from 12 o'clock.
RING_OFFSETS = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)  # (dx=col offset, dy=row offset)

ARC_LEN = 9  # FAST-9/16 contiguous arc length
BORDER = 16  # detection margin


def _ring_stack(img):
    """[H,W] -> list of the 16 ring-shifted images (`torch.roll` wraps; the
    BORDER mask hides the wrapped rows and columns)."""
    return [torch.roll(img, shifts=(-int(dy), -int(dx)), dims=(-2, -1))
            for dx, dy in RING_OFFSETS]


def _arc_mask(flags):
    """16 bool maps -> bool map of 'some 9 contiguous ring pixels set'."""
    bits = torch.zeros(flags[0].shape, dtype=torch.int64, device=flags[0].device)
    for i, f in enumerate(flags):
        bits = bits | (f.to(torch.int64) << i)
    # duplicate to handle wraparound, then AND of 9 shifts
    m = bits | (bits << 16)
    acc = m
    for k in range(1, ARC_LEN):
        acc = acc & (m >> k)
    return acc != 0


def fast_response(img, threshold: float):
    """Dense FAST-9/16 response map. img [H,W] f32 -> [H,W] f32 score (0
    where not a corner); the score is the ring SAD over the contributing
    side, summed in ring order."""
    ring = _ring_stack(img)
    is_bright = _arc_mask([r > img + threshold for r in ring])
    is_dark = _arc_mask([r < img - threshold for r in ring])
    score_b = torch.zeros_like(img)
    score_d = torch.zeros_like(img)
    for r in ring:
        score_b = score_b + torch.clamp(r - img - threshold, min=0.0)
        score_d = score_d + torch.clamp(img - r - threshold, min=0.0)
    score = torch.maximum(torch.where(is_bright, score_b, 0.0),
                          torch.where(is_dark, score_d, 0.0))

    h, w = img.shape[-2:]
    row = torch.arange(h, device=img.device)[:, None]
    col = torch.arange(w, device=img.device)[None, :]
    inside = (row >= BORDER) & (row < h - BORDER) & (col >= BORDER) & (col < w - BORDER)
    return torch.where(inside, score, 0.0)


def local_max_3x3(score):
    """3x3 non-max suppression: keep score only at strict local maxima."""
    neigh = [torch.roll(score, shifts=(dy, dx), dims=(-2, -1))
             for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dx, dy) != (0, 0)]
    m = torch.stack(neigh, 0).amax(0)
    return torch.where(score > m, score, 0.0)


def _top_k(x, k: int):
    """(values, indices) of the k largest along the last dim, ties lowest
    index first (`jax.lax.top_k` order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def detect_level(img, ini_th: float, min_th: float, cell: int, max_out: int):
    """Detect up to `max_out` spatially-uniform corners on one pyramid level.

    A cell uses its high-threshold responses if it has any, otherwise its
    low-threshold ones. Returns (xy [max_out,2] f32 (x=col, y=row), score
    [max_out] f32, valid [max_out] bool), slots filled breadth-first by
    in-cell rank.
    """
    hi = local_max_3x3(fast_response(img, ini_th))
    lo = local_max_3x3(fast_response(img, min_th))

    h, w = img.shape
    gh, gw = -(-h // cell), -(-w // cell)
    ph, pw = gh * cell, gw * cell
    pad = (0, pw - w, 0, ph - h)
    hi_c = torch.nn.functional.pad(hi, pad).reshape(gh, cell, gw, cell).permute(0, 2, 1, 3).reshape(gh, gw, -1)
    lo_c = torch.nn.functional.pad(lo, pad).reshape(gh, cell, gw, cell).permute(0, 2, 1, 3).reshape(gh, gw, -1)
    use_hi = torch.any(hi_c > 0, dim=-1, keepdim=True)
    resp = torch.where(use_hi, hi_c, lo_c)  # per-cell threshold fallback

    k = min(max_out, cell * cell)
    top_s, top_i = _top_k(resp, k)  # [gh,gw,k] in-cell rank order
    dev = img.device
    cy = torch.arange(gh, device=dev)[:, None, None] * cell + top_i // cell
    cx = torch.arange(gw, device=dev)[None, :, None] * cell + top_i % cell

    flat_s = top_s.reshape(-1)
    flat_rank = torch.arange(k, device=dev).expand(gh, gw, k).reshape(-1)
    flat_y = cy.reshape(-1)
    flat_x = cx.reshape(-1)

    # breadth-first across cells: order by (rank asc, score desc), invalid last
    valid = flat_s > 0
    key = (flat_rank.to(torch.float64) * 1e9 - flat_s.to(torch.float64)).to(torch.float32)
    order_key = torch.where(valid, key, float("inf"))
    sel = _top_k(-order_key, max_out)[1]

    xy = torch.stack([flat_x[sel], flat_y[sel]], dim=-1).to(torch.float32)
    return xy, flat_s[sel], valid[sel]
