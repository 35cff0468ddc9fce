"""The arithmetic of the end-to-end metrics and of their spread."""

from __future__ import annotations

import statistics


def msm_ms(window_s: float, msms: int) -> float:
    """The window's wall time over the MSMs completed in it, in ms."""
    if msms <= 0:
        raise ValueError("no MSM completed in the window")
    return window_s * 1e3 / msms


def p95(values: list[float]) -> float:
    """The 95th percentile of all values, none trimmed
    (statistics.quantiles, exclusive method)."""
    if len(values) < 2:
        raise ValueError(f"a percentile needs two values or more, got {len(values)}")
    return statistics.quantiles(values, n=20)[18]


def spread(values: list[float]) -> float:
    """The distance between the first and third quartiles as a share of the
    median (statistics.quantiles, exclusive method)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
