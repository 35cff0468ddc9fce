"""Sorted signed-bucket accumulation in plain torch ops: the JAX package's
ops/buckets.py, which XLA compiles (the small-input path's stages 2 and 3).

Per window, the entries are sorted by bucket key (stably, so equal keys keep
point order), bucket starts and counts come from a binary search, and the
bucket sums are accumulated layer by layer: round j adds the j-th point of
every bucket of every window at once, for max(count) rounds.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.params import MsmConfig
from . import curve as C


class SortedBuckets(NamedTuple):
    """Per-window sorted bucket layout."""

    #: [W, n] bucket keys in ascending order; the key num_buckets is the
    #: sentinel of a zero digit (never accumulated).
    keys: torch.Tensor
    #: [W, n] the point index of each sorted entry.
    point_idx: torch.Tensor
    #: [W, n] the digit's sign, +1 or -1 (int32).
    sign: torch.Tensor
    #: [W, NB] the start of each bucket in the sorted order.
    starts: torch.Tensor
    #: [W, NB] the number of entries of each bucket.
    counts: torch.Tensor


def sort_buckets(digits: torch.Tensor, cfg: MsmConfig) -> SortedBuckets:
    """[n, W] int32 signed digits -> the per-window sorted layout.  The key
    of a digit d != 0 is |d| - 1; a zero digit takes the sentinel NB."""
    nb = cfg.num_buckets
    n = digits.shape[0]
    d = digits.T.contiguous()                                          # [W, n]
    sign = torch.where(d < 0, -1, 1).to(torch.int32)
    keys = torch.where(d == 0, nb, d.abs() - 1).to(torch.int32)
    keys_s, perm = torch.sort(keys, dim=1, stable=True)
    idx = torch.arange(n, dtype=torch.int32, device=d.device).expand_as(keys)
    queries = torch.arange(nb + 1, dtype=torch.int32, device=d.device).expand(d.shape[0], -1)
    offsets = torch.searchsorted(keys_s, queries.contiguous(), side="left", out_int32=True)
    return SortedBuckets(keys_s, torch.gather(idx, 1, perm), torch.gather(sign, 1, perm),
                         offsets[:, :nb], offsets[:, 1:] - offsets[:, :nb])


def accumulate_buckets(points: C.PointXYTZ, sb: SortedBuckets) -> C.PointXYTZ:
    """[W, NB] bucket sums of the [n] batch of points, signs applied.
    Round j adds, to each bucket, its j-th entry or (past its count) the
    identity; the entry is read at min(start + j, n - 1).  Reading
    max(count) from the device is the one sync."""
    wdim, nb = sb.starts.shape
    n = sb.point_idx.shape[1]
    table = torch.stack(tuple(points), dim=1)                          # [n, 4, L]
    acc = C.identity((wdim, nb), table.device)
    for j in range(int(sb.counts.max())):
        safe = (sb.starts + j).clamp(max=n - 1).to(torch.int64)
        pidx = torch.gather(sb.point_idx, 1, safe)
        sgn = torch.gather(sb.sign, 1, safe)
        pt = C.PointXYTZ(*table[pidx.to(torch.int64)].unbind(-2))      # [W, NB, L] each
        pt = C.select(sgn < 0, C.negate(pt), pt)
        acc = C.add_masked(acc, pt, j < sb.counts)
    return acc
