"""K2 and K3: BA's adjoint scatter and point gather as hand-written CUDA.

`onehot_adjoint` replaces the Pallas `_adjoint_kernel` and `onehot_gather`
the Pallas `_gather_kernel` of `dvm_slam_tpu/ops/pallas_scatter.py`. Both
launch `csrc/onehot_scatter.cu` (built with nvcc for sm_90a at first use,
bound with ctypes once) on the current stream, without synchronising, and
take CUDA tensors only: the plain versions and the dispatch live in
`ops/scatter.py`. A launch that CUDA refuses raises.

Both run once per LM step of every BA, and at BA's shapes their device time
is a fraction of the host's, so the host path is kept short: the C
functions are bound once, the checks read only device, dtype, shape and
strides, the device context is entered only when the tensor is not on the
current device, and the current device and stream are read as raw values
(`torch.cuda.current_stream(dev)` builds a Stream object on every call).

Each launch is counted as the tracer's `k2.launches` or `k3.launches`
(`utils/profiling.py`), so a run can show that its main path went through
the kernels; each call is the span `k2` or `k3`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..utils import profiling

_fns = None  # (onehot_adjoint, onehot_gather), bound at first use


def _bind():
    global _fns
    lib = _build.load("onehot_scatter")
    ptrs = [ctypes.c_void_p] * 3
    lib.onehot_adjoint.argtypes = (ptrs + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3
                                   + [ctypes.c_void_p])
    lib.onehot_gather.argtypes = ptrs + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.onehot_adjoint.restype = lib.onehot_gather.restype = ctypes.c_int
    _fns = (lib.onehot_adjoint, lib.onehot_gather)
    return _fns


def build() -> dict:
    """Build (or find) and load the kernels; returns their build record."""
    _bind()
    return _build.build_log["onehot_scatter"]


def _check(name, table, pidx, table_dims) -> int:
    """The tensors' CUDA device index; raises on what the kernel does not take."""
    dev = table.get_device()
    if not table.is_cuda or pidx.get_device() != dev:
        raise ValueError(f"{name} takes CUDA tensors on one device, got "
                         f"{table.device} and {pidx.device}")
    if table.dtype != torch.float32 or pidx.dtype != torch.int32:
        raise TypeError(f"{name} takes float32 values and int32 indices, got "
                        f"{table.dtype} and {pidx.dtype}")
    if table.dim() != table_dims or pidx.dim() != 2:
        raise ValueError(f"{name}: bad ranks {tuple(table.shape)} and {tuple(pidx.shape)}")
    if not pidx.is_contiguous():
        raise ValueError(f"{name} takes contiguous indices")
    return dev


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


@profiling.traced("k2")
def onehot_adjoint(vals, pidx, n_cols: int):
    """K2: `out[l,g,p] = sum_f vals[l,g,f] * (pidx[l,f] == p)`, summed from 0
    in ascending f. vals [L,G,F] f32 with any strides (`bundle_adjust`
    passes a view of feature-major [L,F,G] storage), pidx [L,F] int32
    contiguous -> [L,G,n_cols] f32."""
    dev = _check("onehot_adjoint", vals, pidx, 3)
    if dev != torch._C._cuda_getDevice():
        with torch.cuda.device(dev):
            return onehot_adjoint(vals, pidx, n_cols)
    L, G, F = vals.shape
    if pidx.shape != (L, F):
        raise ValueError(f"pidx must be [{L},{F}], got {tuple(pidx.shape)}")
    out = vals.new_empty((L, G, n_cols))
    if out.numel() == 0:  # nothing to write, nothing launched
        return out
    sL, sG, sF = vals.stride()
    err = (_fns or _bind())[0](vals.data_ptr(), pidx.data_ptr(), out.data_ptr(), L, G, F,
                               n_cols, sL, sG, sF, torch._C._cuda_getCurrentRawStream(dev))
    _raise_on(err, "onehot_adjoint")
    profiling.count_launch("k2")
    return out


@profiling.traced("k3")
def onehot_gather(pts_pl, pidx):
    """K3: `out[l,g,f] = pts_pl[g, pidx[l,f]]`, 0 where pidx is outside
    [0, P). pts_pl [G,P] f32 contiguous, pidx [L,F] int32 -> [L,G,F] f32."""
    dev = _check("onehot_gather", pts_pl, pidx, 2)
    if dev != torch._C._cuda_getDevice():
        with torch.cuda.device(dev):
            return onehot_gather(pts_pl, pidx)
    if not pts_pl.is_contiguous():
        raise ValueError("onehot_gather takes a contiguous point table")
    G, P = pts_pl.shape
    L, F = pidx.shape
    out = pts_pl.new_empty((L, G, F))
    if out.numel() == 0:
        return out
    err = (_fns or _bind())[1](pts_pl.data_ptr(), pidx.data_ptr(), out.data_ptr(), L, G, F, P,
                               torch._C._cuda_getCurrentRawStream(dev))
    _raise_on(err, "onehot_gather")
    profiling.count_launch("k3")
    return out
