"""Bucket accumulation by scatter, with no sort (the SMTVP experiment), in
plain torch ops: the JAX package's ops/smtvp.py.

A bucket sum is a group operation, so no scatter-add of the library
expresses it and collisions must be serialized: one step a point, each
adding its (signed) point into its bucket with a full point add at batch
width 1.  The pipeline does the same W*n additions as a sorted segmented
scan at full width; this is kept as a benchmarked experiment
(benchmarks smtvp).
"""

from __future__ import annotations

import torch

from ..utils.params import MsmConfig
from . import bpr as BPR
from . import convert as CV
from . import curve as C
from . import field as F


def smtvp_buckets(points: C.PointXYTZ, digits_w: torch.Tensor, nb: int) -> C.PointXYTZ:
    """One window's signed digits scattered into nb buckets, one point a
    step.  points: [n, L] Montgomery-form limbs each (z = R); digits_w: [n]
    signed digits.  Returns [nb, L] bucket sums: bucket b holds the sum of
    the points with |digit| == b + 1, the sign applied.  The bucket index
    stays on the device (no host sync a step)."""
    n = digits_w.shape[0]
    bk = C.identity((nb,), points.x.device)
    bk = C.PointXYTZ(*(u.clone() for u in bk))
    d = digits_w.to(torch.int64)
    neg_all = d < 0
    slot_all = torch.where(d == 0, 0, d.abs() - 1)
    for i in range(n):
        neg, slot, keep = neg_all[i:i + 1], slot_all[i:i + 1], d[i:i + 1] == 0
        pt = points.at(slice(i, i + 1))
        # Signed bucket: negate x and t for a negative digit.
        px, pt_t = F.select(neg, F.neg(torch.stack([pt.x, pt.t])), torch.stack([pt.x, pt.t]))
        cur = C.PointXYTZ(*(u.index_select(0, slot) for u in bk))
        s = C.select(keep, cur, C.add(cur, C.PointXYTZ(px, pt.y, pt_t, pt.z)))
        for u, v in zip(bk, s):
            u.index_copy_(0, slot, v)
    return bk


def smtvp_window_sums(coords: torch.Tensor, scalars: torch.Tensor, cfg: MsmConfig) -> C.PointXYTZ:
    """The window sums of a whole MSM by scatter (an experiment; the
    pipeline is for real work): [n, 2, 8] and [n, 8] int32 words -> [W]
    window sums, as models/cuzk.py::msm_window_sums_device returns them."""
    xm, ym, tm = CV.points_to_mont_limbs(coords)
    pts = C.PointXYTZ(xm, ym, tm, F.r_limbs(coords.device).expand_as(xm))
    digits = CV.decompose_scalars_signed(scalars, cfg)                 # [n, W]
    rows = [smtvp_buckets(pts, digits[:, w], cfg.num_buckets) for w in range(cfg.num_windows)]
    buckets = C.PointXYTZ(*(torch.stack([r[i] for r in rows]) for i in range(4)))
    return BPR.reduce_buckets(buckets, num_chunks=min(256, cfg.num_buckets))
