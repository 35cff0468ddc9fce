"""Batched extended twisted Edwards points in Montgomery-form limbs, in
plain torch ops: the JAX package's ops/curve.py, which XLA compiles.

A point batch is four [..., L] int64 limb tensors (X, Y, T, Z).  The
formulas are the unified add-2008-hwcd and dbl-2008-hwcd with a = -1, over
ops/field.py's fully reduced add, sub and product, in the JAX functions'
order of operations, so every coordinate equals the JAX function's limb
for limb.  (The kernels' cached-form madd and full add, with lazy sums,
give the same points in other limbs.)  The independent products of a
formula run as one stacked product.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.params import PARAMS
from . import field as F


class PointXYTZ(NamedTuple):
    """A batch of extended points, Montgomery-form limbs [..., L] each."""

    x: torch.Tensor
    y: torch.Tensor
    t: torch.Tensor
    z: torch.Tensor

    @property
    def batch_shape(self) -> torch.Size:
        return self.x.shape[:-1]

    def at(self, idx) -> "PointXYTZ":
        """The points at batch index `idx` (any torch index)."""
        return PointXYTZ(self.x[idx], self.y[idx], self.t[idx], self.z[idx])


def edwards_d_mont_limbs(device="cpu") -> torch.Tensor:
    return F._limbs(PARAMS.edwards_d_mont, torch.device(device))


def identity(batch_shape=(), device="cpu") -> PointXYTZ:
    """(0 : 1 : 0 : 1) in Montgomery form: (0, R, 0, R)."""
    r = F.r_limbs(device).expand(*batch_shape, F.L)
    z = torch.zeros((*batch_shape, F.L), dtype=torch.int64, device=device)
    return PointXYTZ(z, r, z, r)


def _stack(*ts: torch.Tensor) -> torch.Tensor:
    return torch.stack(torch.broadcast_tensors(*ts))


def add(p1: PointXYTZ, p2: PointXYTZ) -> PointXYTZ:
    """add-2008-hwcd (9 products and the product by d), unified: it also
    doubles and adds the identity."""
    xy1, xy2 = F.add(_stack(p1.x, p2.x), _stack(p1.y, p2.y))
    a, b, t2, d, m = F.mont_mul(_stack(p1.x, p1.y, p1.t, p1.z, xy1),
                                _stack(p2.x, p2.y, p2.t, p2.z, xy2))
    c = F.mont_mul(edwards_d_mont_limbs(t2.device), t2)
    h, g = F.add(_stack(b, d), _stack(a, c))        # b + a == a + b, limb for limb
    e, f = F.sub(_stack(m, d), _stack(h, c))
    return PointXYTZ(*F.mont_mul(_stack(e, g, e, f), _stack(f, h, h, g)))


def double(p1: PointXYTZ) -> PointXYTZ:
    """dbl-2008-hwcd with a = -1."""
    xy = F.add(p1.x, p1.y)
    sq = _stack(p1.x, p1.y, p1.z, xy)
    a, b, zz, xy2 = F.mont_mul(sq, sq)
    c, ab = F.add(_stack(zz, a), _stack(zz, b))
    d = F.neg(a)
    g = F.add(d, b)
    h, e, f = F.sub(_stack(d, xy2, g), _stack(b, ab, c))
    return PointXYTZ(*F.mont_mul(_stack(e, g, e, f), _stack(f, h, h, g)))


def negate(p: PointXYTZ) -> PointXYTZ:
    """(X, Y, T, Z) -> (-X, Y, -T, Z)."""
    x, t = F.neg(_stack(p.x, p.t))
    return PointXYTZ(x, p.y, t, p.z)


def select(mask: torch.Tensor, a: PointXYTZ, b: PointXYTZ) -> PointXYTZ:
    """a where mask, else b."""
    return PointXYTZ(*(F.select(mask, u, v) for u, v in zip(a, b)))


def add_masked(acc: PointXYTZ, p: PointXYTZ, valid: torch.Tensor) -> PointXYTZ:
    """acc + (p where valid, else the identity): the identity is added, not
    skipped, so the limbs are the JAX function's."""
    return add(acc, select(valid, p, identity(valid.shape, valid.device)))


def scale_u32(p: PointXYTZ, k: torch.Tensor, num_bits: int) -> PointXYTZ:
    """k * P per lane for k < 2^num_bits (k: the batch shape), MSB-first
    double-and-add over all num_bits bits, the add selected per lane."""
    acc = identity(p.batch_shape, p.x.device)
    for bit in range(num_bits - 1, -1, -1):
        acc = double(acc)
        acc = select(((k >> bit) & 1) == 1, add(acc, p), acc)
    return acc


def gather(points: PointXYTZ, idx: torch.Tensor) -> PointXYTZ:
    """The points of an [n] batch at an integer index tensor of any shape."""
    return points.at(idx)


def tree_reduce_axis(p: PointXYTZ, axis: int) -> PointXYTZ:
    """The sum along batch axis `axis`, pairwise in log2 rounds: padded to a
    power of two m with the identity, each round adds lane i + offset to
    lane i for i < offset, offset = m/2, m/4, ..., 1; lane 0 is the sum.
    Lanes at or past offset are not computed, as nothing reads them."""
    n = p.x.shape[axis]
    q = PointXYTZ(*(u.movedim(axis, 0) for u in p))
    if n == 1:
        return q.at(0)
    m = 1 << (n - 1).bit_length()
    if m != n:
        pad = identity((m - n, *q.batch_shape[1:]), q.x.device)
        q = PointXYTZ(*(torch.cat([u, v]) for u, v in zip(q, pad)))
    offset = m >> 1
    while offset:
        q = add(q.at(slice(0, offset)), q.at(slice(offset, 2 * offset)))
        offset >>= 1
    return q.at(0)
