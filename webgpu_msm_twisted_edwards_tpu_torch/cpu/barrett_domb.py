"""Barrett-Domb modular multiplication over python-int limb lists: the
host mirror of ops/barrett_domb.py.

x*y mod p without Montgomery form, by the Domb variant of Barrett: the
quotient estimate uses only the most significant halves of the products,
with m = floor(2^(2s+z) / p) (s the bit length of p, z the limbs' slack),
and the remainder only the least significant half of l*p.  The building
blocks work on w-bit little-endian limb lists: machine_multiply, mp_adder,
mp_subtracter, mp_msb_multiply, mp_lsb_multiply, mp_full_multiply,
mp_shifter_left/right, barrett_domb_mul.
"""

from __future__ import annotations

from ..utils.params import PARAMS, FieldParams


def to_limbs(v: int, num: int, w: int) -> list[int]:
    return [(v >> (i * w)) & ((1 << w) - 1) for i in range(num)]


def from_limbs(limbs: list[int], w: int) -> int:
    return sum(l << (i * w) for i, l in enumerate(limbs))


def machine_multiply(a: int, b: int, w: int) -> tuple[int, int]:
    """w-bit x w-bit -> (lo, hi) w-bit words."""
    t = a * b
    return t & ((1 << w) - 1), t >> w


def mp_adder(a: list[int], b: list[int], w: int) -> tuple[list[int], int]:
    out, carry = [], 0
    for ai, bi in zip(a, b):
        s = ai + bi + carry
        out.append(s & ((1 << w) - 1))
        carry = s >> w
    return out, carry


def mp_subtracter(a: list[int], b: list[int], w: int) -> tuple[list[int], int]:
    out, borrow = [], 0
    for ai, bi in zip(a, b):
        d = ai - bi - borrow
        borrow = 1 if d < 0 else 0
        out.append(d + (borrow << w))
    return out, borrow


def mp_shifter_left(a: list[int], shift_bits: int, w: int) -> list[int]:
    v = from_limbs(a, w) << shift_bits
    return to_limbs(v, len(a), w)


def mp_shifter_right(a: list[int], shift_bits: int, w: int) -> list[int]:
    v = from_limbs(a, w) >> shift_bits
    return to_limbs(v, len(a), w)


def mp_msb_multiply(a: list[int], b: list[int], w: int) -> list[int]:
    """Upper-half schoolbook product: only columns >= n-1 (the error is
    covered by the slack bits)."""
    n = len(a)
    cols = [0] * n
    for i in range(n):
        for j in range(n):
            if i + j >= n - 1:
                cols_idx = i + j - (n - 1)
                if cols_idx < n:
                    cols[cols_idx] += a[i] * b[j]
    # normalize and drop the partial column 0 (approximation floor)
    out = []
    carry = 0
    for c in cols:
        s = c + carry
        out.append(s & ((1 << w) - 1))
        carry = s >> w
    out.append(carry & ((1 << w) - 1))
    return mp_shifter_right(out[: len(a) + 1], w, w)[: len(a)]


def mp_lsb_multiply(a: list[int], b: list[int], w: int) -> list[int]:
    """Lower-half schoolbook product: columns < n."""
    n = len(a)
    cols = [0] * n
    for i in range(n):
        for j in range(n - i):
            cols[i + j] += a[i] * b[j]
    out, carry = [], 0
    for c in cols:
        s = c + carry
        out.append(s & ((1 << w) - 1))
        carry = s >> w
    return out


def mp_full_multiply(a: list[int], b: list[int], w: int) -> list[int]:
    v = from_limbs(a, w) * from_limbs(b, w)
    return to_limbs(v, 2 * len(a), w)


def mp_gt(a: list[int], b: list[int]) -> bool:
    """Lexicographic a > b over little-endian limbs."""
    for i in range(len(a) - 1, -1, -1):
        if a[i] != b[i]:
            return a[i] > b[i]
    return False


def barrett_domb_mul(a: list[int], b: list[int], params: FieldParams = PARAMS) -> list[int]:
    """x*y mod p (exact), Domb-Barrett, from the building blocks above:

    ab = mp_full_multiply(a, b); ab_msb = top L limbs of ab << 2z;
    l = (mp_msb_multiply(ab_msb, m_low) + ab_msb) >> z   (m's top bit is 1);
    r = (ab_lsb - mp_lsb_multiply(l, p)) mod 2^(L*w); subtract p while >= p.

    At w=13 the slack z = 7 >= log2(4 + L/2^z), so no extra-diagonal
    correction is needed; the result is fully reduced (below p).
    """
    w = params.word_size
    L = params.num_words
    s = params.p.bit_length()
    z = L * w - s
    m = params.barrett_domb_m
    assert m >> (L * w) == 1, "m must have exactly one bit above L*w"
    m_low = to_limbs(m - (1 << (L * w)), L, w)
    p_limbs = to_limbs(params.p, L, w)

    ab = mp_full_multiply(a, b, w)                     # 2L limbs
    ab_shift = mp_shifter_left(ab, 2 * z, w)           # << 2z (mod 2^(2Lw))
    ab_msb = ab_shift[L:]
    t = mp_msb_multiply(ab_msb, m_low, w)
    l_full, _ = mp_adder(t, ab_msb, w)
    l = mp_shifter_right(l_full, z, w)
    ls = mp_lsb_multiply(l, p_limbs, w)
    r, _ = mp_subtracter(ab[:L], ls, w)
    while mp_gt(r, p_limbs) or r == p_limbs:
        r, _ = mp_subtracter(r, p_limbs, w)
    return r


def barrett_domb_mul_int(x: int, y: int, params: FieldParams = PARAMS) -> int:
    w = params.word_size
    L = params.num_words
    return from_limbs(
        barrett_domb_mul(to_limbs(x, L, w), to_limbs(y, L, w), params), w
    )
