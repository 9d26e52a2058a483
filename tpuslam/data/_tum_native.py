"""ctypes wrapper around the native TUM decode library (csrc/tum_decode.cc).

Importing this module raises if the shared library hasn't been built
(csrc/build.sh) — tpuslam/data/tum.py then decodes with data/png.py.
ctypes releases the GIL during the C call, so the prefetch thread decodes
truly in parallel with tracking.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "_libtum_native.so")
_lib = ctypes.CDLL(_LIB_PATH)

_lib.tum_png16_header.argtypes = [
    ctypes.c_char_p,
    ctypes.POINTER(ctypes.c_int),
    ctypes.POINTER(ctypes.c_int),
    ctypes.POINTER(ctypes.c_int),
]
_lib.tum_png16_header.restype = ctypes.c_int
_lib.tum_png16_decode.argtypes = [
    ctypes.c_char_p,
    ctypes.POINTER(ctypes.c_uint16),
    ctypes.c_int,
    ctypes.c_int,
]
_lib.tum_png16_decode.restype = ctypes.c_int
_lib.tum_associate.argtypes = [
    ctypes.POINTER(ctypes.c_double),
    ctypes.c_int,
    ctypes.POINTER(ctypes.c_double),
    ctypes.c_int,
    ctypes.c_double,
    ctypes.POINTER(ctypes.c_int32),
]
_lib.tum_associate.restype = ctypes.c_int


def decode_png16(path: str) -> np.ndarray:
    """16-bit grayscale PNG -> (H, W) uint16 array."""
    h = ctypes.c_int()
    w = ctypes.c_int()
    depth = ctypes.c_int()
    rc = _lib.tum_png16_header(path.encode(), ctypes.byref(h),
                               ctypes.byref(w), ctypes.byref(depth))
    if rc != 0:
        raise IOError(f"tum_png16_header({path}) failed: {rc}")
    out = np.empty((h.value, w.value), dtype=np.uint16)
    rc = _lib.tum_png16_decode(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        h.value,
        w.value,
    )
    if rc != 0:
        raise IOError(f"tum_png16_decode({path}) failed: {rc}")
    return out


def associate_native(ta: np.ndarray, tb: np.ndarray,
                     max_difference: float) -> np.ndarray:
    """Greedy nearest-timestamp matching; returns (len(ta),) int32 of
    indices into tb (−1 = unmatched)."""
    ta = np.ascontiguousarray(ta, dtype=np.float64)
    tb = np.ascontiguousarray(tb, dtype=np.float64)
    out = np.empty((len(ta),), dtype=np.int32)
    _lib.tum_associate(
        ta.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(ta),
        tb.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(tb),
        float(max_difference),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out
