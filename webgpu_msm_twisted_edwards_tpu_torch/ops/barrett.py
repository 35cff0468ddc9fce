"""Barrett modular multiplication over w-bit limb tensors, in plain torch
ops: the JAX package's ops/barrett.py.

x*y mod p without Montgomery form: the schoolbook full product, a quotient
estimate from its high part times mu = floor(2^(2s) / p), then at most two
corrections.  The pipeline enters Montgomery form by a product with R^2
instead; this module serves the benchmarks.  Limb-last [..., L] int64
tensors of normalized limbs; no intermediate exceeds 32 bits, so the limbs
equal the JAX version's uint32 ones.
"""

from __future__ import annotations

import torch

from ..utils.params import PARAMS, FieldParams


def _const_limbs(v: int, num: int, w: int) -> list[int]:
    return [(v >> (i * w)) & ((1 << w) - 1) for i in range(num)]


def _schoolbook(x: torch.Tensor, y, nx: int, ny: int, w: int, mask: int) -> torch.Tensor:
    """Column sums of x (nx limbs) times y (ny limbs: a tensor or python
    ints), carry-swept into nx + ny normalized limbs."""
    cols = []
    for k in range(nx + ny):
        acc = None
        for i in range(max(0, k - ny + 1), min(nx, k + 1)):
            t = x[..., i] * y[..., k - i] if isinstance(y, torch.Tensor) else x[..., i] * y[k - i]
            acc = t if acc is None else acc + t
        cols.append(acc if acc is not None else torch.zeros_like(x[..., 0]))
    out, c = [], None
    for v in cols:
        v = v if c is None else v + c
        out.append(v & mask)
        c = v >> w
    return torch.stack(out, dim=-1)


def mul_wide(x: torch.Tensor, y: torch.Tensor, params: FieldParams = PARAMS) -> torch.Tensor:
    """The schoolbook full product: [..., L] x [..., L] -> [..., 2L]
    normalized limbs."""
    L = params.num_words
    x, y = torch.broadcast_tensors(x, y)
    return _schoolbook(x, y, L, L, params.word_size, params.mask)


def _shift_right_bits(z: torch.Tensor, bits: int, out_limbs: int,
                      params: FieldParams) -> torch.Tensor:
    """z >> bits as `out_limbs` limbs."""
    w, mask = params.word_size, params.mask
    limb_off, rem = bits // w, bits % w
    nz = z.shape[-1]
    outs = []
    for i in range(out_limbs):
        src = i + limb_off
        lo = z[..., src] >> rem if src < nz else torch.zeros_like(z[..., 0])
        if rem and src + 1 < nz:
            lo = lo | (z[..., src + 1] << (w - rem))
        outs.append(lo & mask)
    return torch.stack(outs, dim=-1)


def _sub_borrow(a: torch.Tensor, b, n: int, w: int, mask: int) -> list[torch.Tensor]:
    """The n low limbs of a - b mod 2^(n*w), borrow by borrow (b: a tensor
    or python ints)."""
    borrow = torch.zeros_like(a[..., 0])
    out = []
    for i in range(n):
        bi = b[..., i] if isinstance(b, torch.Tensor) else b[i]
        d = a[..., i] + (1 << w) - bi - borrow
        borrow = 1 - (d >> w)
        out.append(d & mask)
    return out


def cond_sub(r: torch.Tensor, p_limbs: list[int], w: int, mask: int) -> torch.Tensor:
    """r - p where r >= p, else r."""
    ge = torch.ones_like(r[..., 0], dtype=torch.bool)
    for i, pi in enumerate(p_limbs):
        ge = (r[..., i] > pi) | ((r[..., i] == pi) & ge)
    sub = torch.stack(_sub_borrow(r, p_limbs, len(p_limbs), w, mask), dim=-1)
    return torch.where(ge.unsqueeze(-1), sub, r)


def barrett_mul(x: torch.Tensor, y: torch.Tensor, params: FieldParams = PARAMS) -> torch.Tensor:
    """x*y mod p by Barrett reduction: with s the bit length of p and
    mu = floor(2^(2s) / p), q = ((z >> (s-1)) * mu) >> (s+1) and
    r = z - q*p, then at most two subtractions of p."""
    L, w, mask = params.num_words, params.word_size, params.mask
    s = params.p.bit_length()
    mu_limbs = _const_limbs((1 << (2 * s)) // params.p, L + 1, w)
    p_limbs = _const_limbs(params.p, L, w)

    z = mul_wide(x, y, params)                                  # [..., 2L]
    zh = _shift_right_bits(z, s - 1, L + 1, params)             # z >> (s-1)
    qfull = _schoolbook(zh, mu_limbs, L + 1, L + 1, w, mask)
    q = _shift_right_bits(qfull, s + 1, L, params)

    # r = z - q*p in its low L+1 limbs (r < 3p < 2^(s+2)).
    qp = _schoolbook(q, p_limbs, L, L, w, mask)[..., :L + 1]
    r = torch.stack(_sub_borrow(z[..., :L + 1], qp, L + 1, w, mask)[:L], dim=-1)
    for _ in range(2):
        r = cond_sub(r, p_limbs, w, mask)
    return r
