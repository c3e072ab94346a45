# Copied from msm_tpu/io/native.py, which is JAX-free; keep the two in step.
"""ctypes binding for the native I/O core (native/libmsm_io.so).

The C++ writer streams interleaved complex data straight into the two npy
plane files without numpy `.real`/`.imag` temporaries and releases the GIL
for the whole write (see native/msm_io.cpp). Falls back silently when the
library has not been built (`make -C native`).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _lib_path() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "native", "libmsm_io.so")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.msm_write_complex_pair.restype = ctypes.c_int
        lib.msm_write_complex_pair.argtypes = [
            ctypes.c_char_p,
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int,
        ]
        lib.msm_write_npy.restype = ctypes.c_int
        lib.msm_write_npy.argtypes = lib.msm_write_complex_pair.argtypes
        if hasattr(lib, "msm_read_complex_pair"):
            lib.msm_read_complex_pair.restype = ctypes.c_int
            lib.msm_read_complex_pair.argtypes = [
                ctypes.c_char_p,
                ctypes.c_void_p,
                ctypes.c_uint64,
                ctypes.c_int,
            ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def _shape_arr(shape) -> "ctypes.Array":
    return (ctypes.c_uint64 * len(shape))(*shape)


def write_complex_pair(path_base: str, arr: np.ndarray) -> None:
    """Write `{base}_real`/`{base}_imag` from an interleaved complex array."""
    lib = _load()
    assert lib is not None
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.complex64:
        is_double = 0
    elif arr.dtype == np.complex128:
        is_double = 1
    else:
        raise TypeError(f"expected complex array, got {arr.dtype}")
    rc = lib.msm_write_complex_pair(
        path_base.encode(),
        arr.ctypes.data_as(ctypes.c_void_p),
        arr.size,
        is_double,
        _shape_arr(arr.shape),
        arr.ndim,
    )
    if rc != 0:
        raise OSError(f"native complex pair write failed ({rc}): {path_base}")


def can_read() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "msm_read_complex_pair")


def read_complex_pair(path_base: str, shape, dtype) -> np.ndarray:
    """Read `{base}_real`/`{base}_imag` planes into one interleaved complex
    array in a single GIL-free pass (no real+imag numpy temporaries)."""
    lib = _load()
    assert lib is not None
    dtype = np.dtype(dtype)
    assert dtype in (np.complex64, np.complex128)
    out = np.empty(shape, dtype)
    rc = lib.msm_read_complex_pair(
        path_base.encode(),
        out.ctypes.data_as(ctypes.c_void_p),
        out.size,
        1 if dtype == np.complex128 else 0,
    )
    if rc != 0:
        raise OSError(f"native complex pair read failed ({rc}): {path_base}")
    return out


def write_npy(path: str, arr: np.ndarray) -> None:
    """Write a real float32/float64 npy file at exactly `path`."""
    lib = _load()
    assert lib is not None
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.float32:
        is_double = 0
    elif arr.dtype == np.float64:
        is_double = 1
    else:
        raise TypeError(f"native writer supports f32/f64, got {arr.dtype}")
    rc = lib.msm_write_npy(
        path.encode(),
        arr.ctypes.data_as(ctypes.c_void_p),
        arr.size,
        is_double,
        _shape_arr(arr.shape),
        arr.ndim,
    )
    if rc != 0:
        raise OSError(f"native npy write failed ({rc}): {path}")
