"""Build and load the port's CUDA kernels (nvcc + ctypes).

The repo's native idiom (`native/Makefile`, `io/native.py`): a shared
library with a plain C interface, loaded with ctypes. `load()` compiles
`csrc/phase_kernels.cu` with nvcc on first use into `ops/_build/`, keyed
by a hash of the source and of `nvcc --version`, so an edited source or
another toolkit builds anew. The library is written under a temporary
name and renamed into place, so two processes never load a half-written
file. A failed build raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "phase_kernels.cu")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-O3", "-std=c++17", "-arch=sm_90a", "-shared", "-Xcompiler", "-fPIC")

_lib: "ctypes.CDLL | None" = None
_lock = threading.Lock()


def nvcc_path() -> str:
    """nvcc on PATH, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> str:
    """Path of the built library for this source and this nvcc."""
    version = subprocess.run(
        [nvcc_path(), "--version"], check=True, capture_output=True, text=True
    ).stdout
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(version.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"phase_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if this source/toolkit pair has no library yet."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, SOURCE],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {SOURCE}:\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.msm_kinetic_phase.restype = ctypes.c_int
            lib.msm_kinetic_phase.argtypes = [
                ctypes.c_void_p,  # z
                ctypes.c_void_p,  # out
                ctypes.c_void_p,  # scale
                ctypes.c_int64,  # batch
                ctypes.c_int,  # n
                ctypes.c_int,  # dims
                ctypes.c_int,  # is_double
                ctypes.c_void_p,  # stream
            ]
            lib.msm_phase_rotate.restype = ctypes.c_int
            lib.msm_phase_rotate.argtypes = [
                ctypes.c_void_p,  # z
                ctypes.c_void_p,  # field
                ctypes.c_void_p,  # out
                ctypes.c_void_p,  # coeff
                ctypes.c_int64,  # batch
                ctypes.c_int64,  # cells
                ctypes.c_int,  # is_double
                ctypes.c_void_p,  # stream
            ]
            _lib = lib
        return _lib
