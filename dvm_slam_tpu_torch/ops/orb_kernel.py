"""K1: fused ORB orientation + steered BRIEF as a hand-written CUDA kernel.

`orient_and_describe` replaces `dvm_slam_tpu/ops/pallas_orb.py`'s Pallas
kernel. On a CUDA tensor it launches `csrc/orb_describe.cu` (built with nvcc
for sm_90a at first use, bound with ctypes) on the current stream, without
synchronising; a launch that CUDA refuses raises. On a CPU tensor it runs
the plain PyTorch twin, `ops/orb_descriptor.orient_and_describe`, which
computes the same floats in the same order.

`launches` counts kernel launches (not twin calls), so a run can show that
its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import orb_descriptor

launches = 0

_FLAGS = ("--fmad=false",)  # keep every multiply and add separately rounded


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("orb_describe", _FLAGS)
    lib.orb_describe.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.orb_describe.restype = ctypes.c_int
    return lib


def build() -> dict:
    """Build (or find) and load the kernel; returns its build record."""
    _lib()
    return _build.build_log["orb_describe"]


@functools.lru_cache(maxsize=8)
def _pattern_on(device: torch.device):
    return torch.from_numpy(orb_descriptor.PATTERN).to(device).contiguous()


def _check(img_raw, img_blur, xy):
    if img_raw.dtype != torch.float32 or img_blur.dtype != torch.float32 or xy.dtype != torch.float32:
        raise TypeError("orient_and_describe takes float32 images and xy")
    if img_raw.dim() != 2 or img_blur.shape != img_raw.shape:
        raise ValueError(f"images must be one [H,W] shape, got {tuple(img_raw.shape)} "
                         f"and {tuple(img_blur.shape)}")
    h, w = img_raw.shape
    if h < orb_descriptor.PATCH_SIZE or w < orb_descriptor.PATCH_SIZE:
        raise ValueError(f"level {h}x{w} is smaller than the 31x31 patch")
    if xy.dim() != 2 or xy.shape[1] != 2:
        raise ValueError(f"xy must be [N,2], got {tuple(xy.shape)}")
    if not (img_raw.device == img_blur.device == xy.device):
        raise ValueError("images and xy must lie on one device")
    if not (img_raw.is_contiguous() and img_blur.is_contiguous() and xy.is_contiguous()):
        raise ValueError("orient_and_describe takes contiguous tensors")


def orient_and_describe(img_raw, img_blur, xy):
    """(angle [N] f32, desc [N,256] uint8) for the keypoints `xy` [N,2] of
    one level: the kernel for CUDA tensors, the twin for CPU tensors."""
    global launches
    if img_raw.device.type == "cpu":
        return orb_descriptor.orient_and_describe(img_raw, img_blur, xy)
    if img_raw.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {img_raw.device}")
    _check(img_raw, img_blur, xy)
    h, w = img_raw.shape
    n = xy.shape[0]
    angle = torch.empty((n,), dtype=torch.float32, device=xy.device)
    desc = torch.empty((n, orb_descriptor.DESC_BITS), dtype=torch.uint8, device=xy.device)
    with torch.cuda.device(xy.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().orb_describe(
            img_raw.data_ptr(), img_blur.data_ptr(), xy.data_ptr(),
            _pattern_on(xy.device).data_ptr(), angle.data_ptr(), desc.data_ptr(),
            n, h, w, stream,
        )
    if err != 0:
        raise RuntimeError(f"orb_describe launch failed: cudaError {err}")
    if n > 0:  # the C entry launches nothing for an empty level
        launches += 1
    return angle, desc
