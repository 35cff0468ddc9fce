"""ctypes binding to the native C++ MSM oracle (cpp/liboracle.so).

The library is built with `make -C cpp` when it is missing; it needs only a
C++ compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from functools import lru_cache

import numpy as np

_CPP_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "cpp"))
_LIB_PATH = os.path.join(_CPP_DIR, "liboracle.so")


@lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    if not os.path.exists(_LIB_PATH):
        subprocess.run(["make", "-C", _CPP_DIR], check=True, capture_output=True)
    lib = ctypes.CDLL(_LIB_PATH)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.oracle_msm.argtypes = [u64p, u64p, ctypes.c_size_t, ctypes.c_int, u64p]
    lib.oracle_msm.restype = None
    lib.oracle_msm_parallel.argtypes = [
        u64p, u64p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, u64p
    ]
    lib.oracle_msm_parallel.restype = None
    lib.oracle_gen_points.argtypes = [ctypes.c_size_t, ctypes.c_uint64, u64p]
    lib.oracle_gen_points.restype = None
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _u64x4_to_int(a: np.ndarray) -> int:
    v = 0
    for i in range(3, -1, -1):
        v = (v << 64) | int(a[i])
    return v


def available() -> bool:
    """Whether the native library is built (it is built at first use
    otherwise)."""
    return os.path.exists(_LIB_PATH)


def gen_points(n: int, seed: int = 1) -> np.ndarray:
    """n deterministic affine subgroup points as an [n, 8] uint64 array
    (x in words 0..3, y in words 4..7), from a native additive walk."""
    out = np.zeros((n, 8), dtype=np.uint64)
    _lib().oracle_gen_points(n, seed, _ptr(out))
    return out


def points_u64_to_ints(arr: np.ndarray) -> list[tuple[int, int]]:
    """[n, 8] uint64 points -> affine (x, y) int pairs."""
    return [(_u64x4_to_int(row[:4]), _u64x4_to_int(row[4:])) for row in arr]


def _check_inputs(points: np.ndarray, scalars: np.ndarray):
    pbuf = np.ascontiguousarray(points, dtype=np.uint64).reshape(-1)
    sbuf = np.ascontiguousarray(scalars, dtype=np.uint64).reshape(-1)
    n = points.shape[0]
    if pbuf.size != 8 * n or sbuf.size != 4 * n:
        raise ValueError(f"points must be [n, 8] and scalars [n, 4] uint64, "
                         f"got {points.shape} and {scalars.shape}")
    return pbuf, sbuf, n


def msm(points: np.ndarray, scalars: np.ndarray, c: int = 16) -> tuple[int, int]:
    """Affine MSM result of [n, 8] uint64 points and [n, 4] uint64 scalars,
    by the native serial Pippenger."""
    pbuf, sbuf, n = _check_inputs(points, scalars)
    out = np.zeros(8, dtype=np.uint64)
    _lib().oracle_msm(_ptr(pbuf), _ptr(sbuf), n, c, _ptr(out))
    return _u64x4_to_int(out[:4]), _u64x4_to_int(out[4:])


def msm_parallel(points: np.ndarray, scalars: np.ndarray, c: int = 16,
                 nthreads: int = 0) -> tuple[int, int]:
    """As :func:`msm`, one native thread per scalar window."""
    if nthreads <= 0:
        nthreads = os.cpu_count() or 1
    pbuf, sbuf, n = _check_inputs(points, scalars)
    out = np.zeros(8, dtype=np.uint64)
    _lib().oracle_msm_parallel(_ptr(pbuf), _ptr(sbuf), n, c, nthreads, _ptr(out))
    return _u64x4_to_int(out[:4]), _u64x4_to_int(out[4:])
