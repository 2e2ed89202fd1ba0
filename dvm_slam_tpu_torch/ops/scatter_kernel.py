"""K2 and K3: BA's adjoint scatter and point gather as hand-written CUDA.

`onehot_adjoint` replaces the Pallas `_adjoint_kernel` and `onehot_gather`
the Pallas `_gather_kernel` of `dvm_slam_tpu/ops/pallas_scatter.py`. Both
launch `csrc/onehot_scatter.cu` (built with nvcc for sm_90a at first use,
bound with ctypes) on the current stream, without synchronising, and take
CUDA tensors only: the plain versions and the dispatch live in
`ops/scatter.py`. A launch that CUDA refuses raises.

`launches_adjoint` and `launches_gather` count kernel launches, so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

launches_adjoint = 0
launches_gather = 0

# K2 stages G_CHUNK value planes of one row in shared memory next to two
# compacted index lists: (G_CHUNK + 2) * F * 4 bytes; the card grants a block
# at most 227 KB.
G_CHUNK = 8
MAX_SMEM = 232448


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("onehot_scatter")
    sig = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    for fn in (lib.onehot_adjoint, lib.onehot_gather):
        fn.argtypes = sig
        fn.restype = ctypes.c_int
    return lib


def build() -> dict:
    """Build (or find) and load the kernels; returns their build record."""
    _lib()
    return _build.build_log["onehot_scatter"]


def _check(name, table, pidx, table_dims):
    if table.device.type != "cuda" or pidx.device != table.device:
        raise ValueError(f"{name} takes CUDA tensors on one device, got "
                         f"{table.device} and {pidx.device}")
    if table.dtype != torch.float32 or pidx.dtype != torch.int32:
        raise TypeError(f"{name} takes float32 values and int32 indices, got "
                        f"{table.dtype} and {pidx.dtype}")
    if table.dim() != table_dims or pidx.dim() != 2:
        raise ValueError(f"{name}: bad ranks {tuple(table.shape)} and {tuple(pidx.shape)}")
    if not (table.is_contiguous() and pidx.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def onehot_adjoint(vals, pidx, n_cols: int):
    """K2: `out[l,g,p] = sum_f vals[l,g,f] * (pidx[l,f] == p)`, summed in
    ascending f. vals [L,G,F] f32, pidx [L,F] int32 -> [L,G,n_cols] f32."""
    global launches_adjoint
    _check("onehot_adjoint", vals, pidx, 3)
    L, G, F = vals.shape
    if pidx.shape != (L, F):
        raise ValueError(f"pidx must be [{L},{F}], got {tuple(pidx.shape)}")
    if (G_CHUNK + 2) * F * 4 > MAX_SMEM:
        raise ValueError(f"onehot_adjoint: F={F} exceeds the block's shared memory")
    out = torch.empty((L, G, n_cols), dtype=torch.float32, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().onehot_adjoint(vals.data_ptr(), pidx.data_ptr(), out.data_ptr(),
                                    L, G, F, n_cols, stream)
    _raise_on(err, "onehot_adjoint")
    if out.numel() > 0:  # the C entry launches nothing for an empty output
        launches_adjoint += 1
    return out


def onehot_gather(pts_pl, pidx):
    """K3: `out[l,g,f] = pts_pl[g, pidx[l,f]]`, 0 where pidx is outside
    [0, P). pts_pl [G,P] f32, pidx [L,F] int32 -> [L,G,F] f32."""
    global launches_gather
    _check("onehot_gather", pts_pl, pidx, 2)
    G, P = pts_pl.shape
    L, F = pidx.shape
    out = torch.empty((L, G, F), dtype=torch.float32, device=pts_pl.device)
    with torch.cuda.device(pts_pl.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().onehot_gather(pts_pl.data_ptr(), pidx.data_ptr(), out.data_ptr(),
                                   L, G, F, P, stream)
    _raise_on(err, "onehot_gather")
    if out.numel() > 0:
        launches_gather += 1
    return out
