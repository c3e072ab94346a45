"""Build and load the port's CUDA kernels (nvcc + ctypes).

The repo's native idiom (`native/Makefile`, `io/native.py`): a shared
library with a plain C interface, loaded with ctypes. `load()` compiles
every source in `csrc/` on first use into one library in `ops/_build/`,
keyed by a hash of the sources and headers, of `nvcc --version` and of
the flags, so an edited source or another toolkit builds anew. Each source is compiled
by its own nvcc, all started together, and the objects are linked into the
library. The library is written under a temporary name and renamed into
place, so two processes never load a half-written file. A failed build
raises; nothing falls back to the CPU.
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
_CSRC = os.path.join(_HERE, "csrc")
SOURCES = tuple(
    os.path.join(_CSRC, name)
    for name in ("phase_kernels.cu", "fft_kernels.cu", "fused_kernels.cu", "copy_kernels.cu",
                 "restore_kernels.cu", "random_kernels.cu")
)
# headers the sources include: part of the library's hash, not compiled alone
HEADERS = tuple(
    os.path.join(_CSRC, name)
    for name in ("fft_common.cuh", "plane_cluster.cuh", "radix16.cuh", "lane_radix.cuh",
                 "axis_radix.cuh", "split_radix.cuh")
)
BUILD_DIR = os.path.join(_HERE, "_build")
ARCH = "-arch=sm_90a"
# --split-compile=0: each nvcc runs its optimizations on all CPUs. On an
# 8-core H100 host fused_kernels.cu took 66.6 s without it and 35.4 s with
# it, with the same registers and spills in every kernel (ptxas -v).
COMPILE_FLAGS = ("-O3", "-std=c++17", ARCH, "--split-compile=0", "-Xcompiler", "-fPIC", "-c")
LINK_FLAGS = (ARCH, "-shared")

_lib: "ctypes.CDLL | None" = None
_lock = threading.Lock()

_P, _I, _I64, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
_U32 = ctypes.c_uint32
# entry point -> argtypes (every one returns a cudaError_t as int)
_SIGNATURES = {
    # z, out, scale, batch, n, dims, is_double, stream
    "msm_kinetic_phase": [_P, _P, _P, _I64, _I, _I, _I, _P],
    # z, field, out, coeff, batch, cells, is_double, stream
    "msm_phase_rotate": [_P, _P, _P, _P, _I64, _I64, _I, _P],
    # in, out, b1, log_n, lanes, inverse, is_double, stages (0: radix),
    # twiddles, stream
    "msm_fft_axis": [_P, _P, _I64, _I, _I64, _I, _I, _I, _P, _P],
    # in, out, m, log_n, inverse, is_double, cluster (0: split or stages),
    # stages (1: the stages form), twiddles, stream
    "msm_fft_plane": [_P, _P, _I64, _I, _I, _I, _I, _I, _P, _P],
    # in, out, m, log_n, is_double, cluster, stages, twiddles, stream
    "msm_fft_plane_real_fwd": [_P, _P, _I64, _I, _I, _I, _I, _P, _P],
    # in, tmp (the split and stages forms' scratch, else None), out, m,
    # log_n, is_double, cluster, stages, twiddles, stream
    "msm_fft_plane_real_inv": [_P, _P, _P, _I64, _I, _I, _I, _I, _P, _P],
    # in, out, b1, log_n, lanes, s0, s12, f0, f12, cutoff, partials (or None),
    # is_double, stages (0: radix), twiddles, stream
    "msm_axis_roundtrip_kick": [_P, _P, _I64, _I, _I64, _P, _P, _P, _P, _D, _P, _I, _I, _P, _P],
    # in, out, b1, log_n, lanes, s0, s12, coeff, is_double, stages (0:
    # radix), twiddles, stream
    "msm_axis_roundtrip_poisson": [_P, _P, _I64, _I, _I64, _P, _P, _D, _I, _I, _P, _P],
    # in, out, b1, log_n, lanes, map, is_double, stages (0: radix),
    # twiddles, stream
    "msm_axis_roundtrip_map": [_P, _P, _I64, _I, _I64, _P, _I, _I, _P, _P],
    # in, psi, rho, m, log_n, pref, is_double, cluster (0: split or stages),
    # stages (1: the stages form), twiddles, stream
    "msm_plane_inv_density": [_P, _P, _P, _I64, _I, _D, _I, _I, _I, _P, _P],
    # phik, psi, out, maxes, coeff, m, planes_per_batch, log_n, is_double,
    # cluster (0: split or stages), stages (1: the stages form), twiddles,
    # stream
    "msm_plane_potkick_fwd": [_P, _P, _P, _P, _P, _I64, _I64, _I, _I, _I, _I, _P, _P],
    # psi, out, m, log_n, pref, is_double, cluster (0: split or stages),
    # stages (1: the stages form), twiddles, stream
    "msm_plane_density_fwd": [_P, _P, _I64, _I, _D, _I, _I, _I, _P, _P],
    # in, rho, m, log_n, pref, is_double, cluster (0: split or stages),
    # stages (1: the stages form), twiddles, stream
    "msm_plane_inv_density_rho_only": [_P, _P, _I64, _I, _D, _I, _I, _I, _P, _P],
    # in, tmp (the split and stages forms' scratch, else None), maxes, m,
    # log_n, is_double, cluster (0: split or stages), stages (1: the stages
    # form), twiddles, stream
    "msm_plane_real_inv_max": [_P, _P, _P, _I64, _I, _I, _I, _I, _P, _P],
    # in, out, b1, log_n, lanes, f0, f12, is_double, stages (0: radix),
    # twiddles, stream
    "msm_axis_inv_kick": [_P, _P, _I64, _I, _I64, _P, _P, _I, _I, _P, _P],
    # in, out, b1, log_n, lanes, s0, s12, cutoff, partials, is_double, stages
    # (0: radix), twiddles, stream
    "msm_axis_fwd_reduce": [_P, _P, _I64, _I, _I64, _P, _P, _D, _P, _I, _I, _P, _P],
    # in, out, rows, log_n, inverse, is_double, row_form (0: radix), twiddles,
    # stream
    "msm_fft_lane": [_P, _P, _I64, _I, _I, _I, _I, _P, _P],
    # in, out, rows, log_n, is_double, row_form (0: radix), twiddles, stream
    "msm_fft_lane_real_fwd": [_P, _P, _I64, _I, _I, _I, _P, _P],
    "msm_fft_lane_real_inv": [_P, _P, _I64, _I, _I, _I, _P, _P],
    # in, out, b1, log_n, lanes, map, is_double, stages (0: radix), twiddles,
    # stream
    "msm_fft_axis_inv_map": [_P, _P, _I64, _I, _I64, _P, _I, _I, _P, _P],
    # z, out, scale, batch, n, dims, is_double, stream
    "msm_poisson_multiply": [_P, _P, _P, _I64, _I, _I, _I, _P],
    # a, b, ca, cb, n, stream
    "msm_copy_planes": [_P, _P, _P, _P, _I64, _P],
    # new, old, mask, batch, bytes a stream, stream
    "msm_masked_restore": [_P, _P, _P, _I64, _I64, _P],
    # out, key words k0 and k1, count, kind (0 words, 1 uniform, 2
    # normal), width (32, 64), lo, hi, stream
    "msm_threefry": [_P, _U32, _U32, _I64, _I, _I, _D, _D, _P],
    # lam (float32), out (float32 counts), stats (int64 x 4), count, key
    # words k0 and k1, table rounds, stream
    "msm_poisson": [_P, _P, _P, _I64, _U32, _U32, _I, _P],
}


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
    """Path of the built library for these sources, headers and nvcc."""
    version = subprocess.run(
        [nvcc_path(), "--version"], check=True, capture_output=True, text=True
    ).stdout
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(version.encode())
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"msm_kernels_{h.hexdigest()[:16]}.so")


def _run(procs: list) -> None:
    """Wait for every (source, Popen) pair; raise on the first failure."""
    failed = []
    for src, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {src}:\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> str:
    """Compile the kernels if these sources/toolkit have no library yet."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objects = [
            os.path.join(work, os.path.basename(src) + ".o") for src in SOURCES
        ]
        _run([
            (src, subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ))
            for src, obj in zip(SOURCES, objects)
        ])
        tmp = os.path.join(work, "lib.so")
        _run([("link", subprocess.Popen(
            [nvcc, *LINK_FLAGS, "-o", tmp, *objects],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))])
        os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise on the nonzero cudaError_t an entry point returned."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
