"""ctypes bridge to the native C++ map codec (`native/mapcodec.cpp`).

Port of `dvm_slam_tpu/multiagent/native_codec.py`: drop-in accelerators for
`codec.pack_arrays` / `codec.unpack_arrays` that produce byte-identical
blobs. The reference loads `native/libdvmmapcodec.so`, built by `make -C
native`; the port compiles the same source with the host's `g++` (the
flags of `native/Makefile`, `-lz`) into `build/dvm_slam_tpu_torch/` at first
use (`_build.load_cxx`), and never loads a library under `native/`. Where
the library cannot be built (no compiler, no zlib headers), every call
falls back to the pure-Python codec, as the reference's does;
`available()` says which path runs.
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path

import numpy as np

from .. import _build
from . import codec as pycodec

SOURCE = Path(__file__).resolve().parents[2] / "native" / "mapcodec.cpp"

_LIB = None
_FAILED = None  # the build error, once a build has failed


def load_library():
    """The bound codec library, built at the first call; None where it
    cannot be built (`build_error()` says why)."""
    global _LIB, _FAILED
    if _LIB is not None or _FAILED is not None:
        return _LIB
    try:
        lib = _build.load_cxx("mapcodec", SOURCE, libs=("-lz",))
    except (OSError, RuntimeError) as e:
        _FAILED = str(e)
        return None
    lib.dvm_pack.restype = ctypes.c_int
    lib.dvm_pack.argtypes = [
        ctypes.c_int, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.dvm_unpack_raw.restype = ctypes.c_int
    lib.dvm_unpack_raw.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.dvm_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    _LIB = lib
    return lib


def available() -> bool:
    return load_library() is not None


def build_error():
    """Why the library could not be built, or None."""
    load_library()
    return _FAILED


def pack_arrays(arrays: dict) -> bytes:
    lib = load_library()
    if lib is None:
        return pycodec.pack_arrays(arrays)
    n = len(arrays)
    names = b"".join(k.encode() + b"\0" for k in arrays)
    codes = (ctypes.c_uint8 * n)()
    ndims = (ctypes.c_uint8 * n)()
    dims_list = []
    payload_ptrs = (ctypes.c_void_p * n)()
    sizes = (ctypes.c_uint64 * n)()
    keep = []
    for i, (k, arr) in enumerate(arrays.items()):
        arr = np.ascontiguousarray(arr)
        dt = np.dtype(arr.dtype).newbyteorder("<") if arr.dtype != bool else np.dtype("bool")
        arr = arr.astype(dt, copy=False)
        keep.append(arr)
        codes[i] = pycodec._DTYPE_CODES[np.dtype(dt)]
        ndims[i] = arr.ndim
        dims_list.extend(arr.shape)
        payload_ptrs[i] = arr.ctypes.data_as(ctypes.c_void_p)
        sizes[i] = arr.nbytes
    dims = (ctypes.c_uint32 * len(dims_list))(*dims_list)
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_uint64()
    rc = lib.dvm_pack(n, names, codes, ndims, dims, payload_ptrs, sizes,
                      ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0:
        raise RuntimeError(f"dvm_pack failed: {rc}")
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.dvm_free(out)


def unpack_arrays(blob: bytes) -> dict:
    lib = load_library()
    if lib is None:
        return pycodec.unpack_arrays(blob)
    buf = (ctypes.c_uint8 * len(blob)).from_buffer_copy(blob)
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_uint64()
    rc = lib.dvm_unpack_raw(buf, len(blob), ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0:
        raise RuntimeError(f"dvm_unpack_raw failed: {rc}")
    try:
        raw = ctypes.string_at(out, out_len.value)
    finally:
        lib.dvm_free(out)
    # parse the frame (pure python, cheap relative to inflate)
    off = 0
    magic, n = struct.unpack_from("<II", raw, off)
    if magic != pycodec.MAGIC:
        raise ValueError(f"bad map codec magic {magic:#x}")
    off += 8
    arrays = {}
    for _ in range(n):
        (nlen,) = struct.unpack_from("<B", raw, off)
        off += 1
        name = raw[off:off + nlen].decode()
        off += nlen
        code, ndim = struct.unpack_from("<BB", raw, off)
        off += 2
        dims = struct.unpack_from(f"<{ndim}I", raw, off)
        off += 4 * ndim
        dt = pycodec._DTYPES[code]
        count = int(np.prod(dims)) if ndim else 1
        arr = np.frombuffer(raw, dtype=dt, count=count, offset=off).reshape(dims)
        off += arr.nbytes
        arrays[name] = arr.copy()
    return arrays


def use_native_in_codec():
    """Route `codec.MapPacket` through the native pack when the library is
    available (a global swap of `codec.pack_arrays`, as the reference's;
    `restore_codec` undoes it). Returns `available()`."""
    if available() and pycodec.pack_arrays is not pack_arrays:
        pycodec.pack_arrays_python = pycodec.pack_arrays
        pycodec.pack_arrays = pack_arrays  # type: ignore[assignment]
    return available()


def restore_codec():
    """Undo `use_native_in_codec`: `codec.pack_arrays` is the Python one again."""
    if pycodec.pack_arrays is pack_arrays:
        pycodec.pack_arrays = pycodec.pack_arrays_python
