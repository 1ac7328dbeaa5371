"""ctypes bindings for the native data-loader kernels (native/).

Provides drop-in accelerated versions of the hot host-side preprocessing:
trilinear spacing resample (optionally fused with CT intensity windowing)
and nearest-neighbour label resample. Falls back to the NumPy path when the
shared library has not been built (`make -C native`).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "libmedseg_native.so")

_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    i64 = ctypes.c_int64
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    lib.medseg_resample_trilinear.argtypes = [
        fp, i64, i64, i64, fp, i64, i64, i64,
        ctypes.c_int, ctypes.c_float, ctypes.c_float]
    lib.medseg_resample_nearest_i32.argtypes = [ip, i64, i64, i64,
                                                ip, i64, i64, i64]
    lib.medseg_native_abi_version.restype = ctypes.c_int
    if lib.medseg_native_abi_version() != 1:
        return None
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def resample_trilinear(vol: np.ndarray, out_shape: Tuple[int, int, int],
                       window: Optional[Tuple[float, float]] = None) -> np.ndarray:
    """(D, H, W) float32 -> out_shape, half-pixel trilinear; optional fused
    clip((x-a_min)/(a_max-a_min), 0, 1) intensity window."""
    lib = _load()
    assert lib is not None, "native library not built (make -C native)"
    vol = np.ascontiguousarray(vol, np.float32)
    out = np.empty(out_shape, np.float32)
    a_min, a_max = window if window else (0.0, 1.0)
    lib.medseg_resample_trilinear(
        vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), *vol.shape,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), *out_shape,
        1 if window else 0, a_min, a_max)
    return out


def resample_nearest(vol: np.ndarray,
                     out_shape: Tuple[int, int, int]) -> np.ndarray:
    """(D, H, W) integer labels -> out_shape, nearest neighbour."""
    lib = _load()
    assert lib is not None, "native library not built (make -C native)"
    src = np.ascontiguousarray(vol, np.int32)
    out = np.empty(out_shape, np.int32)
    lib.medseg_resample_nearest_i32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), *src.shape,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), *out_shape)
    return out.astype(vol.dtype, copy=False)
