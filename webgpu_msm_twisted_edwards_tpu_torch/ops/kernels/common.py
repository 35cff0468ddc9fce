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


def _q4_limbs() -> np.ndarray:
    """4p in headroom form: the same value, but every limb except the top is
    >= 2^w, so q4 - b never borrows limb-wise for a normalized b < 3p.  Used
    by the lazy subtraction a - b == a + (4p - b)."""
    v = 4 * PARAMS.p
    q = [(v >> (i * W)) & PARAMS.mask for i in range(L)]
    for i in range(L - 1):
        q[i] += 1 << W
        q[i + 1] -= 1
    b19_max = (3 * PARAMS.p) >> ((L - 1) * W)
    if not (all(qi >= PARAMS.mask for qi in q[:-1]) and q[-1] >= b19_max + 1
            and sum(qi << (i * W) for i, qi in enumerate(q)) == v):
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
    out[:, CONST_Q4] = _q4_limbs()
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


def geq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a >= b over normalized limbs: [..., B] bool."""
    ge = torch.ones_like(a[..., 0, :], dtype=torch.bool)
    for i in range(L):
        ai, bi = a[..., i, :], b[..., i, :]
        ge = (ai > bi) | ((ai == bi) & ge)
    return ge


def sub_limbs(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(a - b) limb-wise with borrow propagation: (diff, borrow)."""
    borrow = torch.zeros_like(a[..., 0, :])
    out = []
    for i in range(L):
        d = (a[..., i, :] + (1 << W) - b[..., i, :] - borrow) & M32
        borrow = (1 - (d >> W)) & M32
        out.append(d & MASK)
    return torch.stack(out, dim=-2), borrow


def cond_sub_p(a: torch.Tensor, pv: torch.Tensor) -> torch.Tensor:
    """a >= p ? a - p : a (a < 2p)."""
    pb = pv.expand_as(a)
    diff, _ = sub_limbs(a, pb)
    return torch.where(geq(a, pb).unsqueeze(-2), diff, a)


# ---------------------------------------------------------------------------
# Montgomery products and lazy additions.


def mont_mul(x: torch.Tensor, y: torch.Tensor, pv: torch.Tensor, reduce: bool = True) -> torch.Tensor:
    """x*y*R^-1, carry-free interleaved form; reduce=False skips the final
    conditional subtraction (the lazy product, < p + x*y/R)."""
    s = torch.zeros_like(x)
    zrow = torch.zeros_like(x[..., 0:1, :])
    for i in range(L):
        xi = x[..., i:i + 1, :]
        t = s[..., 0:1, :] + xi * y[..., 0:1, :]
        qi = (N0 * (t & MASK)) & MASK
        u = (s + xi * y + qi * pv) & M32
        c = u[..., 0:1, :] >> W
        s = torch.cat([(u[..., 1:2, :] + c) & M32, u[..., 2:, :], zrow], dim=-2)
    s = carry_sweep(s)
    if not reduce:
        return s
    return cond_sub_p(s, pv)


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
