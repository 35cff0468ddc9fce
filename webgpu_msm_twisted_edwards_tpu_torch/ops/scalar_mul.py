"""Batched scalar multiplication, double-and-add against Booth recoding, in
plain torch ops on ops/curve.py: the JAX package's ops/scalar_mul.py.
Every lane walks every bit, the adds selected per lane."""

from __future__ import annotations

import torch

from . import curve as C


def _bit(k: torch.Tensor, bit: int) -> torch.Tensor:
    """Bit `bit` of k ([..., 8] int32 LE words with the u32 bits), as a
    bool tensor of the batch shape."""
    return ((k[..., bit // 32].to(torch.int64) >> (bit % 32)) & 1) == 1


def double_and_add(p: C.PointXYTZ, k: torch.Tensor, num_bits: int = 256) -> C.PointXYTZ:
    """k * P per lane, most significant bit first; k: [..., 8] scalar words."""
    acc = C.identity(p.batch_shape, p.x.device)
    for bit in range(num_bits - 1, -1, -1):
        acc = C.double(acc)
        acc = C.select(_bit(k, bit), C.add(acc, p), acc)
    return acc


def booth(p: C.PointXYTZ, k: torch.Tensor, num_bits: int = 256) -> C.PointXYTZ:
    """k * P per lane by Booth (signed-binary) recoding: digit i is
    b_{i-1} - b_i, so a run of ones costs one add and one subtract:
    k*P = sum_{i=0}^{num_bits} (b_{i-1} - b_i) * 2^i * P with b_{-1} = 0 and
    b_{num_bits} = 0 (2k - k telescopes to k)."""
    neg_p = C.negate(p)
    zero = torch.zeros(k.shape[:-1], dtype=torch.bool, device=k.device)

    def b(j: int) -> torch.Tensor:
        return _bit(k, j) if 0 <= j < num_bits else zero

    acc = C.identity(p.batch_shape, p.x.device)
    for i in range(num_bits, -1, -1):
        acc = C.double(acc)
        plus, minus = b(i - 1) & ~b(i), b(i) & ~b(i - 1)
        acc = C.select(plus, C.add(acc, p), acc)
        acc = C.select(minus, C.add(acc, neg_p), acc)
    return acc
