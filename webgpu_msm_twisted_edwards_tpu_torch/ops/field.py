"""Field arithmetic over limb-last [..., L] int64 tensors of 13-bit limbs, in
plain torch ops: the JAX package's ops/field.py, which XLA compiles.

Inputs are normalized limbs (each < 2^13), as every function here returns
them.  Every function broadcasts over the leading dims, so independent
operations of one formula run as one call on stacked operands.

The XLA Montgomery product is the carry-free interleaved form with a final
conditional subtraction, so it equals the kernels' reduced product
(ops/kernels/common.py::mont_mul with reduce=True), which mont_mul runs with
the limb axis moved to dim -2.  add, sub and cond_sub_p run their carry and
borrow sweeps in five 52-bit digits (four limbs each, 5 * 52 = 260 bits)
rather than twenty limbs: the JAX sweeps drop the carry out of limb 19, so
both compute a + b and a - b mod 2^260 and give the same limbs.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils.params import PARAMS
from .kernels import common as C

L = C.L
#: Limbs of one sweep digit, and its width.
_LPD = 4
_DW = _LPD * C.W
_DMASK = (1 << _DW) - 1


@lru_cache(maxsize=None)
def _limbs(v: int, device: torch.device) -> torch.Tensor:
    """The [L] limbs of v on `device`; cached, so read-only."""
    return torch.from_numpy(C.int_to_limbs(v).astype(np.int64)).to(device)


@lru_cache(maxsize=None)
def _shifts(device: torch.device) -> torch.Tensor:
    return torch.arange(0, _DW, C.W, dtype=torch.int64, device=device)


def p_limbs(device="cpu") -> torch.Tensor:
    return _limbs(PARAMS.p, torch.device(device))


def r_limbs(device="cpu") -> torch.Tensor:
    """R mod p: the Montgomery form of 1."""
    return _limbs(PARAMS.r, torch.device(device))


def r2_limbs(device="cpu") -> torch.Tensor:
    return _limbs(PARAMS.r2, torch.device(device))


def one_limbs(device="cpu") -> torch.Tensor:
    return _limbs(1, torch.device(device))


def _to_digits(a: torch.Tensor) -> torch.Tensor:
    """[..., L] limbs -> [..., L/4] 52-bit digits."""
    return (a.reshape(*a.shape[:-1], L // _LPD, _LPD) << _shifts(a.device)).sum(-1)


def _from_digits(d: torch.Tensor) -> torch.Tensor:
    """[..., L/4] 52-bit digits -> [..., L] limbs."""
    return ((d.unsqueeze(-1) >> _shifts(d.device)) & C.MASK).reshape(*d.shape[:-1], L)


def _sweep(s: torch.Tensor):
    """Digit-wise sums or differences (|s_i| < 2^53) -> (the digits of
    s mod 2^260, the carry out of the top digit: 1, 0, or -1 for a
    borrow)."""
    out, c = [], None
    for i in range(s.shape[-1]):
        v = s[..., i] if c is None else s[..., i] + c
        out.append(v & _DMASK)
        c = v >> _DW
    return torch.stack(out, dim=-1), c


def _cond_sub_p_digits(s: torch.Tensor) -> torch.Tensor:
    diff, borrow = _sweep(s - _to_digits(p_limbs(s.device)))
    return torch.where((borrow == 0).unsqueeze(-1), diff, s)


def geq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a >= b as values, over the batch dims."""
    return _sweep(_to_digits(a) - _to_digits(b))[1] == 0


def cond_sub_p(a: torch.Tensor) -> torch.Tensor:
    """a - p if a >= p, else a."""
    return _from_digits(_cond_sub_p_digits(_to_digits(a)))


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b mod p: the sum mod 2^260, then cond_sub_p."""
    s, _ = _sweep(_to_digits(a) + _to_digits(b))
    return _from_digits(_cond_sub_p_digits(s))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p: on a borrow, the difference plus p, mod 2^260."""
    diff, borrow = _sweep(_to_digits(a) - _to_digits(b))
    plus_p, _ = _sweep(diff + _to_digits(p_limbs(a.device)))
    return _from_digits(torch.where((borrow < 0).unsqueeze(-1), plus_p, diff))


def neg(a: torch.Tensor) -> torch.Tensor:
    """-a mod p, with neg(0) == 0."""
    return sub(torch.zeros_like(a), a)


def mont_mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x*y*R^-1 mod p over [..., L] limbs (broadcasting), reduced below p."""
    x, y = torch.broadcast_tensors(C.u32(x), C.u32(y))
    shape = x.shape
    pv = p_limbs(x.device)[:, None]
    out = C.mont_mul(x.reshape(-1, L).T, y.reshape(-1, L).T, pv)
    return out.T.reshape(shape)


def mont_sqr(x: torch.Tensor) -> torch.Tensor:
    return mont_mul(x, x)


def to_mont(x: torch.Tensor) -> torch.Tensor:
    """x*R mod p: the product with R^2."""
    return mont_mul(x, r2_limbs(x.device))


def from_mont(x: torch.Tensor) -> torch.Tensor:
    """x*R^-1 mod p: the product with 1."""
    return mont_mul(x, one_limbs(x.device))


def mont_inv(x: torch.Tensor) -> torch.Tensor:
    """The Montgomery-domain inverse x^(p-2), MSB-first square-and-multiply:
    given a*R returns a^-1*R; mont_inv(0) == 0."""
    acc = r_limbs(x.device).expand(x.shape)
    for bit in bin(PARAMS.p - 2)[2:]:
        acc = mont_sqr(acc)
        if bit == "1":
            acc = mont_mul(acc, x)
    return acc


def _prefix_products(a: torch.Tensor) -> torch.Tensor:
    """Inclusive products along dim -2, in log2(N) rounds."""
    off = 1
    while off < a.shape[-2]:
        a = torch.cat([a[..., :off, :], mont_mul(a[..., :-off, :], a[..., off:, :])], dim=-2)
        off *= 2
    return a


def mont_inv_batch(z: torch.Tensor) -> torch.Tensor:
    """Montgomery-domain inverses of [..., N, L] along dim -2 by batch
    inversion: prefix and suffix products, one Fermat inverse of the total,
    two products an element.  Zeros invert to zero and are kept out of the
    products.  Every product is reduced below p, so the order in which the
    products associate does not change the limbs."""
    zero_mask = is_zero(z)
    one = r_limbs(z.device).expand(z.shape)
    zs = select(zero_mask, one, z)
    prefix = _prefix_products(zs)
    suffix = _prefix_products(zs.flip(-2)).flip(-2)
    total_inv = mont_inv(prefix[..., -1:, :])
    left = torch.cat([one[..., :1, :], prefix[..., :-1, :]], dim=-2)
    right = torch.cat([suffix[..., 1:, :], one[..., :1, :]], dim=-2)
    inv = mont_mul(mont_mul(total_inv, left), right)
    return select(zero_mask, torch.zeros_like(z), inv)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-1)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a where mask, else b; mask has the batch shape (no limb dim)."""
    return torch.where(mask.unsqueeze(-1), a, b)
