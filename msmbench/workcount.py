"""The work an MSM needs, counted from its inputs, and the H100's peaks.

These functions count the algorithm, not the port's loops, so a kernel
rewritten in fewer operations reads a higher share of its roofline and never
more than 100%.

The bucket accumulation of a signed-window MSM does one mixed addition per
non-zero signed digit: the HWCD 2008 mixed add with a precomputed 2d*t on
this a = -1 curve, 7 field products.  A product of 253-bit Montgomery
numbers in eight 32-bit words by CIOS is 2*8^2 + 8 = 136 wide (32 x 32 ->
64-bit) products, each counted as two 32-bit multiply-adds.
"""

from __future__ import annotations

import numpy as np

#: Field products in one mixed addition (HWCD 2008, precomputed 2d*t).
PRODUCTS_PER_MADD = 7
#: 32-bit multiply-adds in one 253-bit Montgomery product (CIOS, 8 words).
MULADDS_PER_PRODUCT = 272
#: One H100 SXM: 64 32-bit multiply-adds a clock on each of its 132 SMs
#: (CUDA C++ Programming Guide, compute capability 9.0) at 1.98 GHz.
PEAK_MULADDS_PER_S = 16.75e12
#: One H100 SXM's HBM3 bandwidth (data sheet).
PEAK_BYTES_PER_S = 3.35e12
#: Bytes of one affine point (x, y) and of one scalar, 253-bit numbers in
#: eight 32-bit words each.
POINT_BYTES = 64
SCALAR_BYTES = 32


def window_values(scalars: np.ndarray, c: int, windows: int) -> np.ndarray:
    """[n, 8] uint32 little-endian scalar words -> [windows, n] int64 unsigned
    c-bit window values (c <= 32)."""
    s = scalars.astype(np.uint64)
    nw = s.shape[1]
    out = np.empty((windows, s.shape[0]), dtype=np.int64)
    for j in range(windows):
        idx, off = divmod(j * c, 32)
        v = s[:, idx] >> np.uint64(off) if idx < nw else np.zeros(s.shape[0], np.uint64)
        if off + c > 32 and idx + 1 < nw:
            v = v | (s[:, idx + 1] << np.uint64(32 - off))
        out[j] = (v & np.uint64((1 << c) - 1)).astype(np.int64)
    return out


def nonzero_signed_digits(scalars: np.ndarray, c: int, windows: int) -> int:
    """The number of non-zero digits of the scalars' signed c-bit windows
    (each digit in [-2^(c-1), 2^(c-1)), the carry passed up), over all
    windows: the mixed additions of the bucket accumulation."""
    vals = window_values(scalars, c, windows)
    carry = np.zeros(vals.shape[1], dtype=np.int64)
    nonzero = 0
    for j in range(windows):
        d = vals[j] + carry
        wrap = d >= (1 << (c - 1))
        d = np.where(wrap, d - (1 << c), d)
        carry = wrap.astype(np.int64)
        nonzero += int(np.count_nonzero(d))
    if carry.any():
        raise ValueError(f"{windows} windows of {c} bits do not hold these scalars")
    return nonzero


def accum_muladds(nonzero_digits: int) -> int:
    """32-bit multiply-adds of the bucket accumulation."""
    return nonzero_digits * PRODUCTS_PER_MADD * MULADDS_PER_PRODUCT


def accum_input_bytes(n: int, windows: int, fixed_base: bool) -> int:
    """Bytes the accumulation must read at least once: every scalar, and
    every point it adds (n points, or over a precomputed base the n*windows
    window-shifted points)."""
    points = n * windows if fixed_base else n
    return points * POINT_BYTES + n * SCALAR_BYTES


def least_time_s(muladds: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take, and which bound sets it ("ops" or
    "bytes")."""
    t_ops, t_bytes = muladds / PEAK_MULADDS_PER_S, nbytes / PEAK_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
