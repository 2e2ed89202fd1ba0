"""Build and load the port's CUDA sources, and the native map codec, at
first use.

Each `csrc/*.cu` file has a plain C interface and is compiled by `nvcc` into
its own shared library under `build/dvm_slam_tpu_torch/` at the root of the
checkout (git-ignored), then loaded with `ctypes`. The host C++ map codec
(`native/mapcodec.cpp`, `multiagent/native_codec.py`) is compiled the same
way by the host's `g++`, into the same directory. The library's file name
carries a hash of the source and flags, so an edited source is rebuilt and a
stale library is never loaded. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "dvm_slam_tpu_torch"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")  # native/Makefile's, without -Wall

_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, dict] = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def cxx_path() -> str:
    """The host C++ compiler: $CXX, then g++ on $PATH."""
    found = shutil.which(os.environ.get("CXX", "g++"))
    if not found:
        raise RuntimeError("no host C++ compiler: set CXX or put g++ on PATH")
    return found


def _compile_and_load(name: str, src: Path, compiler: str, flags: list,
                      libs: tuple = ()) -> ctypes.CDLL:
    """Compile `src` into `build/dvm_slam_tpu_torch/<name>_<hash>.so` unless
    that file exists, load it and record the build in `build_log[name]`."""
    if name in _loaded:
        return _loaded[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags + list(libs)).encode()
                            ).hexdigest()[:16]
    out = BUILD_DIR / f"{name}_{digest}.so"
    t0 = time.perf_counter()
    report = ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(src), *libs],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(compiler).name} failed for {src.name}:\n{proc.stdout}\n"
                               f"{proc.stderr}")
        report = (proc.stdout + proc.stderr).strip()
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    build_log[name] = {"seconds": time.perf_counter() - t0, "ptxas": report, "path": str(out)}
    lib = ctypes.CDLL(str(out))
    _loaded[name] = lib
    return lib


def load(name: str, extra_flags: tuple = ()) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if needed and return the loaded library.

    `build_log[name]` records the build seconds (0 when the library was
    already built) and nvcc's `-Xptxas -v` report."""
    if name in _loaded:
        return _loaded[name]
    flags = ARCH_FLAGS + BASE_FLAGS + list(extra_flags) + ["-Xptxas", "-v"]
    return _compile_and_load(name, CSRC / f"{name}.cu", nvcc_path(), flags)


def load_cxx(name: str, src: Path, flags: tuple = CXX_FLAGS, libs: tuple = ()) -> ctypes.CDLL:
    """Compile a host C++ source (the map codec, `native/mapcodec.cpp`) with
    the host compiler if needed and return the loaded library; built and
    recorded as `load` builds a CUDA source."""
    return _compile_and_load(name, src, cxx_path(), list(flags), libs)
