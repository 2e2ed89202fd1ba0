"""K1: fused ORB orientation + steered BRIEF as a hand-written CUDA kernel.

`orient_and_describe_levels` replaces `dvm_slam_tpu/ops/pallas_orb.py`'s
Pallas kernel for a whole frame: one launch of `csrc/orb_describe.cu` (built
with nvcc for sm_90a at first use, bound with ctypes once) covers every
pyramid level, on the current stream, without synchronising; a launch that
CUDA refuses raises. `orient_and_describe` is the one-level call of the same
kernel. On CPU tensors both run the plain PyTorch twin in
`ops/orb_descriptor.py`, which computes the same floats in the same order.

The extractor calls the kernel once per frame, and its device time is a
fraction of the host's, so the host path is kept short as in
`scatter_kernel.py`: the level table goes to the C entry as one array of
plain integers, the checks read only device, dtype, shape and contiguity, the
device context is entered only off the current device, and the current
device and stream are read as raw values.

Each launch (not a twin call) is counted as the tracer's `k1.launches`
(`utils/profiling.py`), so a run can show that its main path went through
the kernel; each call is the span `k1`.
"""

from __future__ import annotations

import array
import ctypes
import functools

import torch

from .. import _build
from ..utils import profiling
from . import orb_descriptor

MAX_LEVELS = 64  # the kernel's level table holds this many levels (8 frames of 8)

_FLAGS = ("--fmad=false",)  # keep every multiply and add separately rounded

_fn = None  # orb_describe_levels, bound at first use


def _bind():
    global _fn
    lib = _build.load("orb_describe", _FLAGS)
    fn = lib.orb_describe_levels
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _fn = fn
    return fn


def build() -> dict:
    """Build (or find) and load the kernel; returns its build record."""
    _bind()
    return _build.build_log["orb_describe"]


@functools.lru_cache(maxsize=8)
def _pattern_on(dev: int):
    return torch.from_numpy(orb_descriptor.PATTERN).to(torch.device("cuda", dev)).contiguous()


def level_table(raws, blurs, xy, offsets) -> array.array:
    """The kernel's level table as an int64 array: the levels' raw image
    pointers, blurred image pointers, heights, widths, then `offsets`
    (level l's keypoints are xy[offsets[l]:offsets[l+1]]). Raises on what
    the kernel does not take: more than MAX_LEVELS levels, offsets that do
    not run from 0 to len(xy) without decreasing, images that are not
    float32, [H,W] alike raw and blurred, at least 31x31 and contiguous, and
    tensors on more than one device."""
    n = len(raws)
    if not 1 <= n <= MAX_LEVELS:
        raise ValueError(f"K1 takes 1 to {MAX_LEVELS} levels, got {n}")
    if len(blurs) != n or len(offsets) != n + 1:
        raise ValueError(f"{n} raw levels need {n} blurred levels and {n + 1} offsets, got "
                         f"{len(blurs)} and {len(offsets)}")
    if xy.dtype != torch.float32:
        raise TypeError(f"K1 takes float32 keypoints, got {xy.dtype}")
    if xy.dim() != 2 or xy.shape[1] != 2 or not xy.is_contiguous():
        raise ValueError(f"xy must be a contiguous [F,2], got {tuple(xy.shape)}")
    if offsets[0] != 0 or offsets[-1] != xy.shape[0] or any(
            b < a for a, b in zip(offsets, offsets[1:])):
        raise ValueError(f"offsets must rise from 0 to {xy.shape[0]}, got {tuple(offsets)}")
    dev = xy.get_device()  # -1 on the CPU; an int costs less than a torch.device
    hs, ws = [], []
    for raw, blur in zip(raws, blurs):
        shape = raw.shape
        if raw.dtype != torch.float32 or blur.dtype != torch.float32:
            raise TypeError(f"K1 takes float32 images, got {raw.dtype} and {blur.dtype}")
        if len(shape) != 2 or blur.shape != shape:
            raise ValueError(f"a level's images must be one [H,W] shape, got "
                             f"{tuple(shape)} and {tuple(blur.shape)}")
        if shape[0] < orb_descriptor.PATCH_SIZE or shape[1] < orb_descriptor.PATCH_SIZE:
            raise ValueError(f"level {shape[0]}x{shape[1]} is smaller than the 31x31 patch")
        if raw.get_device() != dev or blur.get_device() != dev:
            raise ValueError(f"images and xy must lie on one device, got {raw.device}, "
                             f"{blur.device} and {xy.device}")
        if not (raw.is_contiguous() and blur.is_contiguous()):
            raise ValueError("K1 takes contiguous level images")
        hs.append(shape[0])
        ws.append(shape[1])
    return array.array("q", [r.data_ptr() for r in raws] + [b.data_ptr() for b in blurs]
                       + hs + ws + list(offsets))


@profiling.traced("k1")
def orient_and_describe_levels(raws, blurs, xy, offsets):
    """(angle [F] f32, desc [F,256] uint8) of a frame's keypoints `xy` [F,2]
    in level pixels, level l's being xy[offsets[l]:offsets[l+1]] on the raw
    level `raws[l]` and its blur `blurs[l]`: one kernel launch for CUDA
    tensors, the twin for CPU tensors."""
    table = level_table(raws, blurs, xy, offsets)
    if xy.device.type == "cpu":
        return orb_descriptor.orient_and_describe_levels(raws, blurs, xy, offsets)
    if not xy.is_cuda:
        raise ValueError(f"no K1 kernel for device {xy.device}")
    dev = xy.get_device()
    if dev != torch._C._cuda_getDevice():
        with torch.cuda.device(dev):
            return orient_and_describe_levels(raws, blurs, xy, offsets)
    n = xy.shape[0]
    angle = xy.new_empty((n,))
    desc = xy.new_empty((n, orb_descriptor.DESC_BITS), dtype=torch.uint8)
    if n == 0:  # nothing to write, nothing launched
        return angle, desc
    err = (_fn or _bind())(table.buffer_info()[0], len(raws), xy.data_ptr(),
                           _pattern_on(dev).data_ptr(), angle.data_ptr(), desc.data_ptr(), n,
                           torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"orb_describe_levels launch failed: cudaError {err}")
    profiling.count_launch("k1")
    return angle, desc


def orient_and_describe(img_raw, img_blur, xy):
    """(angle [N] f32, desc [N,256] uint8) for the keypoints `xy` [N,2] of
    one level: the one-level call of `orient_and_describe_levels`."""
    return orient_and_describe_levels((img_raw,), (img_blur,), xy, (0, xy.shape[0]))
