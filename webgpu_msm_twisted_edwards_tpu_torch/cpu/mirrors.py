"""Python-int mirrors of the pipeline's stages: the ground truth of the
per-stage validator (ops/debug.py) and of the tests.

Digits are signed windows, buckets are indexed by |digit| - 1 and weighted
by |digit|, and the window sums fold by Horner's rule, as on the device.
"""

from __future__ import annotations

from ..utils.params import SUBGROUP_ORDER, MsmConfig
from .curve import ExtPoint


def decompose_scalars_signed(scalars: list[int], num_windows: int, window_bits: int) -> list[list[int]]:
    """Signed window decomposition, one list of digits per scalar: each digit
    in [-2^(c-1), 2^(c-1) - 1] and scalar == sum(digit[i] * 2^(c*i)).
    Raises ValueError when the final carry is 1 (the scalar is too large for
    num_windows signed windows)."""
    l = 1 << window_bits
    half = l >> 1
    mask = l - 1
    out = []
    for s in scalars:
        digits = []
        carry = 0
        for i in range(num_windows):
            d = ((s >> (i * window_bits)) & mask) + carry
            if d >= half:
                d -= l
                carry = 1
            else:
                carry = 0
            digits.append(d)
        if carry:
            raise ValueError("final carry is 1: scalar too large for signed windows")
        out.append(digits)
    return out


def bucket_accumulation_signed(
    points: list[ExtPoint], digits_per_scalar: list[list[int]], num_windows: int, window_bits: int
) -> list[list[ExtPoint]]:
    """Per-window signed bucket sums: buckets[w][b] == the sum of sign * P_i
    over the points whose window-w digit has |digit| == b + 1 (a zero digit
    adds nothing)."""
    nb = 1 << (window_bits - 1)
    buckets = [[ExtPoint.identity() for _ in range(nb)] for _ in range(num_windows)]
    for pt, digits in zip(points, digits_per_scalar):
        for w in range(num_windows):
            d = digits[w]
            if d == 0:
                continue
            idx = abs(d) - 1
            addend = pt if d > 0 else pt.neg()
            buckets[w][idx] = buckets[w][idx].add(addend)
    return buckets


def running_sum_bucket_reduction(buckets: list[ExtPoint]) -> ExtPoint:
    """Serial reduction: sum_b (b + 1) * buckets[b], by running sums from the
    top bucket down."""
    m = ExtPoint.identity()
    g = ExtPoint.identity()
    for b in range(len(buckets) - 1, -1, -1):
        m = m.add(buckets[b])
        g = g.add(m)
    return g


def parallel_bucket_reduction(buckets: list[ExtPoint], num_threads: int = 4) -> ExtPoint:
    """The same sum in num_threads contiguous chunks: each chunk's running
    sums g_t (local weights 1..chunk) and total m_t, then the fix-up
    g_t += m_t * (t * chunk) by double-and-add, then the sum of the g_t."""
    nb = len(buckets)
    if nb % num_threads:
        raise ValueError(f"{nb} buckets do not split into {num_threads} chunks")
    chunk = nb // num_threads
    total = ExtPoint.identity()
    for t in range(num_threads):
        m = ExtPoint.identity()
        g = ExtPoint.identity()
        for k in range(chunk - 1, -1, -1):
            m = m.add(buckets[t * chunk + k])
            g = g.add(m)
        g = g.add(m.mul(t * chunk))
        total = total.add(g)
    return total


def horner(window_sums: list[ExtPoint], window_bits: int) -> ExtPoint:
    """sum_w 2^(c*w) * S_w by Horner's rule, from the top window down."""
    acc = window_sums[-1]
    for w in range(len(window_sums) - 2, -1, -1):
        for _ in range(window_bits):
            acc = acc.double()
        acc = acc.add(window_sums[w])
    return acc


def cuzk_serial_msm(points: list[ExtPoint], scalars: list[int], cfg: MsmConfig) -> ExtPoint:
    """The whole pipeline serially: scalars reduced mod the subgroup order,
    signed decomposition, bucket sums, running-sum reduction, Horner."""
    scalars = [s % SUBGROUP_ORDER for s in scalars]
    digits = decompose_scalars_signed(scalars, cfg.num_windows, cfg.chunk_size)
    buckets = bucket_accumulation_signed(points, digits, cfg.num_windows, cfg.chunk_size)
    sums = [running_sum_bucket_reduction(b) for b in buckets]
    return horner(sums, cfg.chunk_size)


def pippenger_msm(points: list[ExtPoint], scalars: list[int], window_bits: int = 16) -> ExtPoint:
    """Classic unsigned Pippenger over 256-bit scalars: per window, buckets
    by digit, each bucket scaled by its digit, then Horner."""
    num_windows = -(-256 // window_bits)
    mask = (1 << window_bits) - 1
    sums = []
    for w in range(num_windows):
        buckets: dict[int, ExtPoint] = {}
        for pt, s in zip(points, scalars):
            d = (s >> (w * window_bits)) & mask
            if d == 0:
                continue
            buckets[d] = buckets[d].add(pt) if d in buckets else pt
        acc = ExtPoint.identity()
        for d, bp in buckets.items():
            acc = acc.add(bp.mul(d))
        sums.append(acc)
    return horner(sums, window_bits)
