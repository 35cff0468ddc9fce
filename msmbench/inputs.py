"""A cell's inputs, made from --seed: the points and the pool of scalar
vectors.

The points are a grid: point i*cols + j is (alpha_i + beta_j)*G, with the
multiples alpha (one a row) and beta (one a column) drawn from the seed, and
made by points.cpp, which this module builds with the host's C++ compiler
into build/ beside it on first use.  Every scalar is uniform in [0, r).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from functools import lru_cache

import numpy as np

from . import reference

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "points.cpp")
BUILD_DIR = os.path.join(HERE, "build")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

#: The subgroup order as eight little-endian 32-bit words.
R_WORDS = np.array([(reference.R >> (32 * i)) & 0xFFFFFFFF for i in range(8)], dtype=np.uint32)
R_BITS = reference.R.bit_length()


@dataclasses.dataclass
class Inputs:
    points: np.ndarray          # [n, 8] uint64: affine x (4 words), y (4 words)
    alpha: list[int]            # the rows' multiples of G
    beta: list[int]             # the columns' multiples of G
    vectors: np.ndarray         # [vectors, n, 8] uint32 scalar words


def _compiler() -> str:
    for name in ("g++", "c++"):
        exe = shutil.which(name)
        if exe:
            return exe
    raise RuntimeError("no C++ compiler (g++ or c++) to build the point generator")


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libpoints-{h.hexdigest()[:16]}.so")


def build() -> float:
    """Compile points.cpp unless its library is there; the seconds spent."""
    path = library_path()
    if os.path.exists(path):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", tmp, SOURCE],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed:\n{proc.stdout}")
    os.replace(tmp, path)
    return time.perf_counter() - t0


@lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(library_path())
    lib.msmbench_grid_points.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.msmbench_grid_points.restype = ctypes.c_int
    return lib


def grid_shape(n: int) -> tuple[int, int]:
    """(rows, cols): cols the power of two nearest above sqrt(n)."""
    log2n = (max(n, 1) - 1).bit_length()
    cols = 1 << (log2n + 1) // 2
    return -(-n // cols), cols


def below_order(rng: np.random.Generator, count: int) -> np.ndarray:
    """[count, 8] uint32 words of integers uniform in [0, r)."""
    out = np.zeros((count, 8), dtype=np.uint32)
    todo = np.arange(count)
    while todo.size:
        w = rng.integers(0, 1 << 32, size=(todo.size, 8), dtype=np.uint32)
        top, rest = divmod(R_BITS, 32)
        w[:, top + (rest > 0):] = 0
        if rest:
            w[:, top] &= np.uint32((1 << rest) - 1)
        lt = np.zeros(todo.size, dtype=bool)
        eq = np.ones(todo.size, dtype=bool)
        for i in range(7, -1, -1):
            lt |= eq & (w[:, i] < R_WORDS[i])
            eq &= w[:, i] == R_WORDS[i]
        out[todo[lt]] = w[lt]
        todo = todo[~lt]
    return out


def words_to_ints(words: np.ndarray) -> list[int]:
    return [reference.words_to_int(w) for w in words]


def make(seed: int, n: int, vectors: int, threads: int | None = None) -> Inputs:
    """The points and `vectors` scalar vectors of one run, from the seed."""
    points_seq, scalars_seq = np.random.SeedSequence(seed).spawn(2)
    prng = np.random.default_rng(points_seq)
    rows, cols = grid_shape(n)
    alpha_w, beta_w = below_order(prng, rows), below_order(prng, cols)
    srng = np.random.default_rng(scalars_seq)
    vecs = np.stack([below_order(srng, n) for _ in range(vectors)])
    return Inputs(grid_points(alpha_w, beta_w, n, threads), words_to_ints(alpha_w),
                  words_to_ints(beta_w), vecs)


def grid_points(alpha_w: np.ndarray, beta_w: np.ndarray, n: int,
                threads: int | None = None) -> np.ndarray:
    """[n, 8] uint64 affine points (alpha_i + beta_j)*G of the grid whose row
    and column multiples are the [rows, 8] and [cols, 8] uint32 words."""
    alpha = np.ascontiguousarray(alpha_w).view(np.uint64)
    beta = np.ascontiguousarray(beta_w).view(np.uint64)
    out = np.empty((n, 8), dtype=np.uint64)
    threads = threads or min(8, os.cpu_count() or 1)
    err = _library().msmbench_grid_points(
        alpha.ctypes.data, alpha.shape[0], beta.ctypes.data, beta.shape[0], n, threads,
        out.ctypes.data)
    if err:
        raise ValueError(f"points.cpp refused a grid of {alpha.shape[0]} x {beta.shape[0]} "
                         f"for {n} points")
    return out
