"""Bundle adjustment's adjoint scatter and point gather, with dispatch.

Counterpart of `dvm_slam_tpu/ops/pallas_scatter.py`. Two functions of the
observation -> point incidence `pidx [L,F]` (negative = no observation):

* `onehot_adjoint`: `out[l,g,p] = sum_f vals[l,g,f] * (pidx[l,f] == p)`,
  the assembly of BA's point blocks (H_pp, b_p, W) from per-observation
  value planes; duplicates accumulate, `pidx < 0` or `>= P` adds nothing.
* `onehot_gather`: `out[l,g,f] = pts_pl[g, pidx[l,f]]`, 0 where `pidx` is
  outside `[0, P)` (the Pallas kernel's meaning; the reference's CPU row
  gather clamps `>= P`, which no call site produces).

The plain versions here are the reference's XLA forms: the dense one-hot
product of `onehot_adjoint_xla` as one f32 `torch.bmm` (deterministic on
both devices, unlike `index_add_`, which uses float atomics on CUDA) and the
masked row gather. The hand-written Hopper kernels K2 and K3 are in
`ops/scatter_kernel.py` + `csrc/onehot_scatter.cu`.

Dispatch (`use_kernel`, as `FrontendConfig.use_kernel`): None takes the
kernel for CUDA tensors and the plain version for CPU tensors; False always
the plain version; True always the kernel, and raises for CPU tensors.

`onehot_adjoint_batched` and `onehot_gather_batched` serve B windows (one
per map, `ba.bundle_adjust_batched`) with ONE call each, the kernels' bodies
unchanged: K2's rows are independent, so B windows of L rows fold into
B*L rows; K3's table is shared by all rows, so the B maps' point tables
sit side by side in one [G, B*P] table and map b's indices are offset by
b*P, after an index outside map b's [0, P) has become -1.
"""

from __future__ import annotations

import torch

from . import scatter_kernel


def onehot_adjoint_plain(vals, pidx, n_cols: int):
    """[L,G,F] f32 x [L,F] int -> [L,G,n_cols] f32, through the dense [L,F,P]
    one-hot (168 MB at L=20, F=512, P=4096)."""
    cols = torch.arange(n_cols, dtype=pidx.dtype, device=pidx.device)
    oh = (pidx[..., None] == cols).to(vals.dtype)                 # [L,F,P]
    return torch.bmm(vals, oh)


def onehot_adjoint_ordered(vals, pidx, n_cols: int):
    """K2's order of addition in plain PyTorch: every output starts at 0 and
    adds its features in ascending f, one feature per step (a row holds one
    index per f, so no step adds twice to one element). Bit-identical to the
    kernel; a check of the kernel, not a path of the port."""
    L, G, F = vals.shape
    out = vals.new_zeros((L, G, n_cols + 1))                      # column n_cols: no point
    col = torch.where((pidx >= 0) & (pidx < n_cols), pidx, n_cols).to(torch.int64)
    rows = torch.arange(L, device=vals.device)
    for f in range(F):
        out[rows, :, col[:, f]] += vals[:, :, f]
    return out[..., :n_cols]


def onehot_gather_plain(pts_pl, pidx):
    """[G,P] f32 plane-major table, [L,F] int -> [L,G,F] f32."""
    P = pts_pl.shape[1]
    ok = (pidx >= 0) & (pidx < P)
    g = pts_pl[:, torch.where(ok, pidx, 0).to(torch.int64)]      # [G,L,F]
    return torch.where(ok[:, None, :], g.permute(1, 0, 2), 0.0)


def _use_kernel(t, use_kernel) -> bool:
    if use_kernel is False:
        return False
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no BA scatter path for device {t.device}")
    if use_kernel:
        raise ValueError(f"use_kernel=True needs CUDA tensors, got {t.device}")
    return False


def onehot_adjoint(vals, pidx, n_cols: int, use_kernel=None):
    """K2 for CUDA tensors, the plain version for CPU tensors (see module
    docstring for `use_kernel`)."""
    if _use_kernel(vals, use_kernel):
        return scatter_kernel.onehot_adjoint(vals, pidx, n_cols)
    return onehot_adjoint_plain(vals, pidx, n_cols)


def onehot_gather(pts_pl, pidx, use_kernel=None):
    """K3 for CUDA tensors, the plain version for CPU tensors."""
    if _use_kernel(pts_pl, use_kernel):
        return scatter_kernel.onehot_gather(pts_pl, pidx)
    return onehot_gather_plain(pts_pl, pidx)


def fold_rows(pidx, n_cols: int):
    """[B,L,F] indices into B tables of n_cols each -> [B*L,F] int32 indices
    into their side-by-side table: map b's index p in [0, n_cols) becomes
    b*n_cols + p, any other becomes -1 (before the offset, so that map b
    never reads map b+1's point)."""
    B = pidx.shape[0]
    if B * n_cols >= 2 ** 31:
        raise ValueError(f"{B} tables of {n_cols} columns overflow int32 indices")
    off = (torch.arange(B, dtype=torch.int32, device=pidx.device) * n_cols)[:, None, None]
    ok = (pidx >= 0) & (pidx < n_cols)
    return torch.where(ok, pidx.to(torch.int32) + off, -1).reshape(-1, pidx.shape[-1])


def onehot_adjoint_batched(vals, pidx, n_cols: int, use_kernel=None):
    """B windows in one K2 call: vals [B,L,G,F] (any strides that let B and
    L merge, as `bundle_adjust_batched`'s view does), pidx [B,L,F] int32 ->
    [B,L,G,n_cols], each window's rows those of its own call."""
    B, L, G, F = vals.shape
    out = onehot_adjoint(vals.reshape(B * L, G, F), pidx.reshape(B * L, F), n_cols, use_kernel)
    return out.reshape(B, L, G, n_cols)


def onehot_gather_batched(pts_pl, pidx, use_kernel=None):
    """B maps in one K3 call: pts_pl [B,G,P], pidx [B,L,F] -> [B,L,G,F],
    `out[b,l,g,f] = pts_pl[b, g, pidx[b,l,f]]`, 0 outside [0, P)."""
    B, G, P = pts_pl.shape
    L, F = pidx.shape[1:]
    table = pts_pl.permute(1, 0, 2).reshape(G, B * P)
    return onehot_gather(table, fold_rows(pidx, P).contiguous(), use_kernel).reshape(B, L, G, F)
