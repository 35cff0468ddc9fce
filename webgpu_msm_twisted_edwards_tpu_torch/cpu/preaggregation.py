"""Cluster pre-aggregation of one window's points into a one-row CSR
matrix: a host mirror of a bucket-preprocessing experiment.

Points whose digit (bucket) collides within a window are added first, so
the sparse matrix has at most one entry per bucket: adds before the CSR is
built in place of adds in its product.  The device pipeline gets the same
effect from its sorted segmented scan, so nothing on the device path calls
this; the group operation is the caller's (string concatenation in the
tests).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

from .matrices import CSRSparseMatrix


def precompute_with_cluster_method(chunks: Sequence[int], n_rows: int) -> dict[int, list[int]]:
    """Point indices grouped by equal chunk value, in first-seen order of the
    values; zero chunks (no bucket) are skipped."""
    clusters: dict[int, list[int]] = {}
    for i, c in enumerate(chunks):
        if c == 0:
            continue
        clusters.setdefault(c, []).append(i)
    return clusters


def pre_aggregate(points: Sequence[Any], clusters: dict[int, list[int]],
                  add: Callable[[Any, Any], Any]) -> tuple[list[Any], list[int]]:
    """Each cluster's points added in index order: (the sums, their chunk
    values)."""
    vals, chunk_vals = [], []
    for c, idxs in clusters.items():
        acc = points[idxs[0]]
        for i in idxs[1:]:
            acc = add(acc, points[i])
        vals.append(acc)
        chunk_vals.append(c)
    return vals, chunk_vals


def create_csr_cpu(points: Sequence[Any], chunks: Sequence[int], num_buckets: int,
                   add: Callable[[Any, Any], Any]) -> CSRSparseMatrix:
    """The pre-aggregated one-row CSR matrix of one window: each bucket at
    most once, in bucket order; bucket b holds chunk value b + 1."""
    clusters = precompute_with_cluster_method(chunks, len(points))
    vals, chunk_vals = pre_aggregate(points, clusters, add)
    order = sorted(range(len(vals)), key=lambda k: chunk_vals[k])
    data = [vals[k] for k in order]
    col_idx = [chunk_vals[k] - 1 for k in order]
    return CSRSparseMatrix(data, col_idx, [0, len(data)], num_buckets)
