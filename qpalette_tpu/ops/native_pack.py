"""ctypes binding for the native host library (native/qpt_pack.cpp and
native/kmeans1d.cpp).

Replaces the reference's numba packers (lib/quantizer/pack_op.py) for
host-side quantization/IO.  The library is not committed: the first use
builds it from source with `make -C native`.  Where no C++ toolchain is
available the callers fall back to the JAX codecs in ops/packing.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import warnings
from typing import Optional

import numpy as np

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
LIB_NAME = "libqpt_pack.so"

_CDLL: Optional[ctypes.CDLL] = None
_CDLL_TRIED = False
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def native_library() -> Optional[ctypes.CDLL]:
    """The shared library, built on first use.  The build writes a private
    file name and renames it into place (atomic), so concurrent test
    workers never load a half-written library."""
    global _CDLL, _CDLL_TRIED
    if _CDLL_TRIED:
        return _CDLL
    _CDLL_TRIED = True
    path = os.path.join(NATIVE_DIR, LIB_NAME)
    if not os.path.exists(path):
        tmp = f"{LIB_NAME}.{os.getpid()}.tmp"
        try:
            subprocess.run(["make", "-s", "-C", NATIVE_DIR, f"LIB={tmp}"],
                           check=True, capture_output=True, timeout=300)
            os.replace(os.path.join(NATIVE_DIR, tmp), path)
        except (OSError, subprocess.SubprocessError) as e:
            warnings.warn(f"building {path} failed ({e}); using the JAX "
                          f"codecs")
            return None
    _CDLL = ctypes.CDLL(path)
    return _CDLL


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    lib = native_library()
    if lib is None:
        return None
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.qpt_pack_rows.argtypes = [i32p, u32p, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int,
                                  ctypes.c_int64]
    lib.qpt_unpack_rows.argtypes = [u32p, i32p, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_int,
                                    ctypes.c_int64]
    lib.qpt_pack_trellis.argtypes = [i32p, u32p, ctypes.c_int64,
                                     ctypes.c_int]
    lib.qpt_unpack_trellis.argtypes = [u32p, i32p, ctypes.c_int64,
                                       ctypes.c_int]
    _LIB = lib
    return lib


def available() -> bool:
    return _lib() is not None


def pack_rows(indices: np.ndarray, bits: int) -> Optional[np.ndarray]:
    lib = _lib()
    if lib is None:
        return None
    idx = np.ascontiguousarray(indices, dtype=np.int32)
    m, P = idx.shape
    wpr = -(-(P * bits) // 32) + 1
    out = np.zeros((m, wpr), np.uint32)
    lib.qpt_pack_rows(
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        m, P, bits, wpr)
    return out


def unpack_rows(packed: np.ndarray, bits: int,
                n_idx: int) -> Optional[np.ndarray]:
    lib = _lib()
    if lib is None:
        return None
    w = np.ascontiguousarray(packed, dtype=np.uint32)
    m, wpr = w.shape
    out = np.zeros((m, n_idx), np.int32)
    lib.qpt_unpack_rows(
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        m, n_idx, bits, wpr)
    return out


def pack_trellis(states: np.ndarray, KV: int) -> Optional[np.ndarray]:
    lib = _lib()
    if lib is None:
        return None
    s = np.ascontiguousarray(states, dtype=np.int32)
    T = s.shape[0]
    out = np.zeros((T, 4 * KV), np.uint32)
    lib.qpt_pack_trellis(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), T, KV)
    return out


def unpack_trellis(packed: np.ndarray, KV: int) -> Optional[np.ndarray]:
    lib = _lib()
    if lib is None:
        return None
    w = np.ascontiguousarray(packed, dtype=np.uint32)
    T = w.shape[0]
    out = np.zeros((T, 128), np.int32)
    lib.qpt_unpack_trellis(
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), T, KV)
    return out
