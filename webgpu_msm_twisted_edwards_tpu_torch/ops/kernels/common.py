"""Plain PyTorch field arithmetic on [..., L, B] limb tensors.

Counterparts of webgpu_msm_twisted_edwards_tpu/ops/pallas/common.py and of
csrc/field.cuh.  Values are u32 words held in int64 tensors: torch cannot do
arithmetic on uint32 tensors on the CPU, so every sum, difference and product
is masked back to 32 bits where the u32 arithmetic of the kernels wraps, and
the results match the kernels' bit for bit.  The limb axis is dim -2 and the
batch axis dim -1; a leading axis stacks independent operations (the JAX
package's `*_many` batching).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...utils.params import PARAMS

L = PARAMS.num_words          # 20
W = PARAMS.word_size          # 13
MASK = PARAMS.mask
N0 = PARAMS.n0
#: Packed representation: 2 limbs per u32 -> 10 u32 per field element.
LP = (L + 1) // 2
M32 = 0xFFFFFFFF


def int_to_limbs(v: int) -> np.ndarray:
    return np.array([(v >> (i * W)) & PARAMS.mask for i in range(L)], dtype=np.uint32)


#: Column indices of each constant in make_consts_array().
CONST_P, CONST_D, CONST_R, CONST_R2, CONST_Q4 = 0, 1, 2, 3, 4


def _q4_digits(width: int) -> np.ndarray:
    """4p in headroom form, in digits of `width` bits: the same value, but
    every digit except the top is >= 2^width - 1, so q4 - b never borrows
    digit-wise for a normalized b < 3p.  Used by the lazy subtraction
    a - b == a + (4p - b): 13-bit limbs here and in csrc/field.cuh, 26-bit
    digits in csrc/field26.cuh."""
    n = -(-L * W // width)
    mask = (1 << width) - 1
    v = 4 * PARAMS.p
    q = [(v >> (i * width)) & mask for i in range(n)]
    for i in range(n - 1):
        q[i] += 1 << width
        q[i + 1] -= 1
    top_max = (3 * PARAMS.p) >> ((n - 1) * width)
    if not (all(qi >= mask for qi in q[:-1]) and q[-1] >= top_max + 1
            and sum(qi << (i * width) for i, qi in enumerate(q)) == v):
        raise AssertionError("4p headroom form does not hold for these parameters")
    return np.array(q, dtype=np.uint32)


def make_consts_array() -> np.ndarray:
    """[L, 8] uint32: columns p, d*R mod p, R mod p, R^2 mod p, the headroom
    form of 4p, then zeros.  csrc/field.cuh holds the same columns."""
    out = np.zeros((L, 8), dtype=np.uint32)
    out[:, CONST_P] = int_to_limbs(PARAMS.p)
    out[:, CONST_D] = int_to_limbs(PARAMS.edwards_d_mont)
    out[:, CONST_R] = int_to_limbs(PARAMS.r)
    out[:, CONST_R2] = int_to_limbs(PARAMS.r2)
    out[:, CONST_Q4] = _q4_digits(W)
    return out


class Consts(NamedTuple):
    """Constant field elements as [L, 1] int64 tensors."""

    p: torch.Tensor
    d: torch.Tensor
    r: torch.Tensor
    r2: torch.Tensor
    q4: torch.Tensor


def load_consts(device) -> Consts:
    c = torch.from_numpy(make_consts_array().astype(np.int64)).to(device)
    return Consts(*(c[:, i:i + 1] for i in (CONST_P, CONST_D, CONST_R, CONST_R2, CONST_Q4)))


def u32(t: torch.Tensor) -> torch.Tensor:
    """Bits of an int32 (or any integer) tensor as int64 values in [0, 2^32)."""
    return t.to(torch.int64) & M32


def to_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor with the same bits."""
    return torch.where(t >= (1 << 31), t - (1 << 32), t).to(torch.int32)


# ---------------------------------------------------------------------------
# Pack / unpack: 2 limbs per u32 word (lo in bits 0..15, hi in 16..31).


def pack2(a: torch.Tensor) -> torch.Tensor:
    """[..., L, B] limbs -> [..., LP, B] packed words."""
    return (a[..., 0::2, :] | (a[..., 1::2, :] << 16)) & M32


def unpack2(pk: torch.Tensor) -> torch.Tensor:
    """[..., LP, B] packed words -> [..., L, B] limbs."""
    both = torch.stack([pk & 0xFFFF, pk >> 16], dim=-2)          # [..., LP, 2, B]
    return both.reshape(*pk.shape[:-2], 2 * pk.shape[-2], pk.shape[-1])


# ---------------------------------------------------------------------------
# Normalization.


def carry_sweep(s: torch.Tensor) -> torch.Tensor:
    """Propagate carries so every limb < 2^w; the carry out of the top limb
    is dropped."""
    out = []
    c = torch.zeros_like(s[..., 0, :])
    for i in range(L):
        v = (s[..., i, :] + c) & M32
        out.append(v & MASK)
        c = v >> W
    return torch.stack(out, dim=-2)


# ---------------------------------------------------------------------------
# Montgomery products and lazy additions.


#: Digits of the plain Montgomery product: two limbs, 26 bits, so that a
#: digit product (< 2^54) and a column of ten of them stay inside int64.
_D = 2 * W
_DMASK = (1 << _D) - 1
#: -p^-1 mod 2^26.
_N0D = (-pow(PARAMS.p, -1, 1 << _D)) % (1 << _D)


def make_digit_consts() -> dict:
    """The constants of csrc/field26.cuh (the point formulas in 26-bit
    digits of csrc/ec26.cuh, and the table conversion): p, R mod p,
    R^2 mod p, d*R mod p and the headroom form of 4p as lists of 26-bit
    digits, and N0' = -p^-1 mod 2^26."""
    def digits(v: int) -> list[int]:
        return [(v >> (i * _D)) & _DMASK for i in range(LP)]
    return {"p": digits(PARAMS.p), "r": digits(PARAMS.r), "r2": digits(PARAMS.r2),
            "d": digits(PARAMS.edwards_d_mont),
            "q4": _q4_digits(_D).tolist(), "n0": _N0D}


def _digits(a: torch.Tensor) -> torch.Tensor:
    """[..., L, B] limbs -> [..., LP, B] 26-bit digits."""
    return a[..., 0::2, :] | (a[..., 1::2, :] << W)


def _columns(xd: torch.Tensor, yd: torch.Tensor) -> torch.Tensor:
    """[..., LP, B] digits of x and y -> [..., 2*LP, B] column sums of x*y:
    column m = sum over i + j = m of x_i*y_j.  Row i of the digit products
    is shifted right by i (padded to width 2*LP+1 and read back at width
    2*LP), then the rows are summed."""
    prod = xd.unsqueeze(-2) * yd.unsqueeze(-3)                   # [..., LP, LP, B]
    lead, b = prod.shape[:-3], prod.shape[-1]
    prod = torch.cat([prod, prod.new_zeros(*lead, LP, LP + 1, b)], dim=-2)
    prod = prod.reshape(*lead, LP * (2 * LP + 1), b)[..., :2 * LP * LP, :]
    return prod.reshape(*lead, LP, 2 * LP, b).sum(dim=-3)


def mont_mul(x: torch.Tensor, y: torch.Tensor, pv: torch.Tensor, reduce: bool = True) -> torch.Tensor:
    """x*y*R^-1 over normalized limbs (each < 2^13); reduce=False skips the
    final conditional subtraction (the lazy product, < p + x*y/R).

    The kernels (csrc/field.cuh) run the carry-free interleaved form, one
    13-bit digit of the quotient at a time.  This plain version takes 26-bit
    digits, a tenth of the sequential steps: Montgomery's quotient
    Q = -x*y*p^-1 mod R is the same for any digit size, so both give the
    value (x*y + Q*p)/R mod 2^260 (the kernels' accumulators never wrap on
    such limbs, and they drop the carry out of limb 19), and the same limbs
    after normalization and the conditional subtraction."""
    pd = _digits(pv)                                             # [LP, 1]
    acc = _columns(_digits(x), _digits(y))
    carry = 0
    for m in range(LP):
        t = acc[..., m, :] + carry
        q = ((t & _DMASK) * _N0D) & _DMASK
        carry = (t + q * pd[0]) >> _D                            # low digit cancels
        acc[..., m + 1:m + LP, :] += q.unsqueeze(-2) * pd[1:]
    out = []
    for m in range(LP):
        v = acc[..., LP + m, :] + carry
        out.append(v & _DMASK)
        carry = v >> _D
    d = torch.stack(out, dim=-2)
    if reduce:
        borrow = 0
        diff = []
        for m in range(LP):
            v = d[..., m, :] - pd[m] - borrow
            borrow = (v < 0).to(torch.int64)
            diff.append(v & _DMASK)
        d = torch.where((borrow == 0).unsqueeze(-2), torch.stack(diff, dim=-2), d)
    return torch.stack([d & MASK, d >> W], dim=-2).reshape(torch.broadcast_shapes(x.shape, y.shape))


def mont_many(pairs, pv: torch.Tensor) -> list[torch.Tensor]:
    """Lazy Montgomery products of independent pairs, computed stacked."""
    x = torch.stack([p[0] for p in pairs])
    y = torch.stack([p[1] for p in pairs])
    return list(mont_mul(x, y, pv, reduce=False).unbind(0))


def add_many(pairs) -> list[torch.Tensor]:
    """Lazy additions of independent pairs (carries normalized only)."""
    return list(carry_sweep(torch.stack([(a + b) & M32 for a, b in pairs])).unbind(0))


def sub_many(pairs, c: Consts) -> list[torch.Tensor]:
    """Lazy subtractions a - b + 4p (b < 3p) of independent pairs."""
    return list(carry_sweep(torch.stack(
        [(a + ((c.q4 - b) & M32)) & M32 for a, b in pairs])).unbind(0))


def fr_add_lazy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b with carry normalization only (no reduction mod p)."""
    return carry_sweep((a + b) & M32)


def fr_sub_lazy(a: torch.Tensor, b: torch.Tensor, c: Consts) -> torch.Tensor:
    """a - b + 4p, borrow-free for b < 3p."""
    return carry_sweep((a + ((c.q4 - b) & M32)) & M32)


def fr_neg_lazy(b: torch.Tensor, c: Consts) -> torch.Tensor:
    """4p - b (== -b mod p), borrow-free for b < 3p."""
    return carry_sweep((c.q4 - b) & M32)
