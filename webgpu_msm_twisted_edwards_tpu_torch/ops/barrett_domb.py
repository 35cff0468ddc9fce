"""Barrett-Domb modular multiplication over w-bit limb tensors, in plain
torch ops: the JAX package's ops/barrett_domb.py (cpu/barrett_domb.py is
its python-int mirror).

x*y mod p without Montgomery form.  The quotient estimate uses only the
most significant half of the product, through an MSB-half schoolbook
product with m = floor(2^(2s+z) / p) (s the bit length of p, z the limbs'
slack); the remainder needs only the least significant half of l*p.  At
w=13 the slack z = 7 >= log2(4 + L/2^z), so no extra-diagonal correction
is needed (asserted).
"""

from __future__ import annotations

import math

import torch

from ..utils.params import PARAMS, FieldParams
from .barrett import _const_limbs, _shift_right_bits, _sub_borrow, cond_sub, mul_wide


def _sweep_cols(cols: list, w: int, mask: int) -> list[torch.Tensor]:
    out, c = [], None
    for v in cols:
        v = v if c is None else v + c
        out.append(v & mask)
        c = v >> w
    out.append(c & mask)
    return out


def msb_mul(a: torch.Tensor, b_limbs: list[int], params: FieldParams = PARAMS) -> torch.Tensor:
    """An estimate of (a*b) >> (L*w) from the partial-product columns
    i+j >= L-1 only (the slack bits cover its error).  a: [..., L]; b: L
    constant limbs.  Returns [..., L]."""
    L = params.num_words
    cols = [None] * L
    for i in range(L):
        for j in range(L):
            if i + j >= L - 1:
                v = i + j - (L - 1)
                t = a[..., i] * b_limbs[j]
                cols[v] = t if cols[v] is None else cols[v] + t
    out = _sweep_cols(cols, params.word_size, params.mask)
    # Drop the partial column 0 (>> w): limbs 1..L are the estimate.
    return torch.stack(out[1:L + 1], dim=-1)


def lsb_mul(a: torch.Tensor, b_limbs: list[int], params: FieldParams = PARAMS) -> torch.Tensor:
    """(a*b) mod 2^(L*w) from the columns i+j < L.  a: [..., L]; b: L
    constant limbs.  Returns [..., L]."""
    L = params.num_words
    cols = [None] * L
    for i in range(L):
        for j in range(L - i):
            t = a[..., i] * b_limbs[j]
            cols[i + j] = t if cols[i + j] is None else cols[i + j] + t
    return torch.stack(_sweep_cols(cols, params.word_size, params.mask)[:L], dim=-1)


def barrett_domb_mul(x: torch.Tensor, y: torch.Tensor,
                     params: FieldParams = PARAMS) -> torch.Tensor:
    """x*y mod p by the Domb variant of Barrett reduction:
    ab = x*y; ab_msb = floor(ab * 2^(2z) / 2^(L*w));
    l = floor((msb_mul(ab_msb, m_low) + ab_msb) / 2^z)   (m's top bit is 1);
    r = (ab - l*p) mod 2^(L*w), then subtractions of p to below p."""
    L, w, mask = params.num_words, params.word_size, params.mask
    s = params.p.bit_length()
    z = L * w - s
    assert z >= math.log2(4 + L / 2**z), "extra-diagonal branch not implemented"
    m = params.barrett_domb_m
    assert m >> (L * w) == 1, "m must have exactly one bit above L*w"
    m_low = _const_limbs(m - (1 << (L * w)), L, w)
    p_limbs = _const_limbs(params.p, L, w)

    ab = mul_wide(x, y, params)                                  # [..., 2L]
    ab_msb = _shift_right_bits(ab, L * w - 2 * z, L, params)     # [..., L]
    t = msb_mul(ab_msb, m_low, params)
    # l_full = t + ab_msb (mod 2^(L*w)), then >> z.
    lf = _sweep_cols([t[..., i] + ab_msb[..., i] for i in range(L)], w, mask)[:L]
    l = _shift_right_bits(torch.stack(lf, dim=-1), z, L, params)

    ls = lsb_mul(l, p_limbs, params)
    # The true remainder is a small multiple of p plus the residue, far
    # below 2^(L*w), so the wrap of this difference never fires.
    r = torch.stack(_sub_borrow(ab, ls, L, w, mask), dim=-1)
    # The quotient estimate is at most 2 below ab/p for z >= 1 (Domb 2019,
    # section 3), so r < 3p; three subtractions leave one as margin.
    assert z >= 1, "the remainder bound r < 3p assumes slack z >= 1"
    for _ in range(3):
        r = cond_sub(r, p_limbs, w, mask)
    return r
