"""An independent naive arithmetic on the device: u256 words and plain-domain
(non-Montgomery) field and point operations, in plain torch ops: the JAX
package's ops/u256.py.

It shares nothing with the pipeline's arithmetic (the 13-bit Montgomery
limbs of ops/kernels/common.py and ops/field.py): another limb width (8 x
32-bit words), another domain (plain), another product (shift-and-add, a
reduction at every step), another reduction (one conditional subtraction).
The naive MSM built on it (models/baselines.py) therefore checks the
pipeline with arithmetic that cannot share its faults.

A batch of field elements is an [..., 8, B] int64 tensor: little-endian
32-bit words on dim -2, the batch on dim -1.  torch on the CPU has no
arithmetic on uint32, so the words are int64 and every carry and borrow is
taken with explicit 32-bit masks and shifts.  Field values stay in [0, p).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils.params import EDWARDS_D, P

WORDS = 8
M32 = 0xFFFFFFFF
#: Bit length of p (253): the shift-and-add product scans this many bits.
PBITS = P.bit_length()


def int_to_words(v: int) -> np.ndarray:
    return np.array([(v >> (32 * i)) & M32 for i in range(WORDS)], dtype=np.int64)


@lru_cache(maxsize=None)
def _const(v: int, device: torch.device) -> torch.Tensor:
    """The [8, 1] words of v on `device`; cached, so read-only."""
    return torch.from_numpy(int_to_words(v)[:, None]).to(device)


@lru_cache(maxsize=None)
def _pow2(device: torch.device) -> torch.Tensor:
    return torch.tensor([[1 << i] for i in range(WORDS)], dtype=torch.int64, device=device)


@lru_cache(maxsize=None)
def _bit_index(device: torch.device) -> torch.Tensor:
    return torch.arange(WORDS, dtype=torch.int64, device=device)[:, None]


def p_words(shape_b: int, device="cpu") -> torch.Tensor:
    return _const(P, torch.device(device)).expand(WORDS, shape_b)


def d_words(shape_b: int, device="cpu") -> torch.Tensor:
    return _const(EDWARDS_D, torch.device(device)).expand(WORDS, shape_b)


def _carry(s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Word-wise sums or differences [..., 8, B] (|word| < 2^62) -> (their
    value mod 2^256 as words, the carry out of the top word: negative for a
    borrow)."""
    out, c = [], None
    for i in range(WORDS):
        v = s[..., i, :] if c is None else s[..., i, :] + c
        out.append(v & M32)
        c = v >> 32
    return torch.stack(out, dim=-2), c.unsqueeze(-2)


def u256_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod 2^256, carry by carry."""
    return _carry(a + b)[0]


def u256_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod 2^256, borrow by borrow."""
    return _carry(a - b)[0]


def u256_gte(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a >= b, [..., 1, B] bool: the sign of the most significant nonzero
    word difference, found as the sign of sum_i sign(a_i - b_i) * 2^i."""
    key = (torch.sign(a - b) * _pow2(a.device)).sum(dim=-2, keepdim=True)
    return key >= 0


def u256_double(a: torch.Tensor) -> torch.Tensor:
    """a << 1 mod 2^256: each word's top bit carried into the next word."""
    hi = a >> 31
    carry_in = torch.cat([torch.zeros_like(hi[..., :1, :]), hi[..., :-1, :]], dim=-2)
    return ((a << 1) & M32) | carry_in


def field_reduce_once(a: torch.Tensor, pw: torch.Tensor) -> torch.Tensor:
    """a - p where a >= p, else a: reduces any a < 2p."""
    return torch.where(u256_gte(a, pw), u256_sub(a, pw), a)


def _sweep_nonneg(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Nonnegative word sums [..., 8, B] (each < 2^62) -> (their value mod
    2^256 as words, the carry out of the top word), with the word carries
    found at once rather than word by word.  Each word's bits above 32 are
    added into the next word first; then a word carries out exactly when it
    overflows (generates) or is all ones with a carry in (propagates), and
    the carries into every word are the carries of the 8-bit binary sum
    A + G, A holding a word's bit where it generates or propagates and G
    where it generates."""
    dev = t.device
    hi = t >> 32
    u = (t & M32) + torch.nn.functional.pad(hi[..., :-1, :], (0, 0, 1, 0))
    gen = u >> 32
    low = u & M32
    a, g = (torch.stack([gen + (low == M32), gen]) * _pow2(dev)).sum(dim=-2, keepdim=True)
    s = a + g
    carries = s ^ a ^ g                              # bit i: the carry into word i
    words = (low + ((carries >> _bit_index(dev)) & 1)) & M32
    return words, hi[..., -1:, :] + ((s >> WORDS) & 1)


@lru_cache(maxsize=None)
def _sum_offsets(ndim: int, device: torch.device) -> torch.Tensor:
    """[2, 1, ..., 8, 1]: zero, and the words of 2^256 - p."""
    off = torch.stack([torch.zeros_like(_const(P, device)), _const((1 << 256) - P, device)])
    return off.reshape(2, *([1] * (ndim - 2)), WORDS, 1)


def _sum_reduce(s: torch.Tensor) -> torch.Tensor:
    """The word-wise sums s of two values in [0, p) -> their sum mod p, the
    value field_reduce_once(u256_add(a, b)) gives: s + 2^256 - p carries out
    of the top word exactly when s >= p, and its low 256 bits are then
    s - p; both sums are swept at once."""
    both, top = _sweep_nonneg(s.unsqueeze(0) + _sum_offsets(s.dim(), s.device))
    return torch.where(top[1] > 0, both[1], both[0])


def field_add(a: torch.Tensor, b: torch.Tensor, pw: torch.Tensor) -> torch.Tensor:
    """a + b mod p.  pw goes unused (the sum's reduction adds the constant
    2^256 - p); it keeps the JAX package's signature, as in field_mul."""
    return _sum_reduce(a + b)


def field_sub(a: torch.Tensor, b: torch.Tensor, pw: torch.Tensor) -> torch.Tensor:
    """a - b mod p: on a borrow, (a + p) - b."""
    both, top = _carry(torch.stack(torch.broadcast_tensors(a - b, a + pw - b)))
    return torch.where(top[0] < 0, both[1], both[0])


def field_double(a: torch.Tensor, pw: torch.Tensor) -> torch.Tensor:
    # a < p < 2^253, so 2a < 2^254 never wraps 2^256.
    return field_reduce_once(u256_double(a), pw)


def field_mul(a: torch.Tensor, b: torch.Tensor, pw: torch.Tensor,
              nbits: int = PBITS) -> torch.Tensor:
    """The shift-and-add modular product over the nbits low bits of b (p's
    253 bits; a constant b gives its own bit length, as the steps past its
    top bit leave acc as it is): for each bit i, acc <- acc + sh (reduced)
    where the bit is set, and sh <- 2 sh (reduced), sh starting at a.  The
    two updates of a step run as one stacked sum and sweep: 2 sh is sh + sh,
    the same value as u256_double's."""
    a, b = torch.broadcast_tensors(a, b)
    widx = torch.arange(nbits, device=a.device) // 32
    shifts = (torch.arange(nbits, device=a.device) % 32)[:, None]
    # sel[0][..., i, :]: bit i of b; sel[1]: the shifted multiplicand is
    # updated at every step.
    take = ((b.index_select(-2, widx) >> shifts) & 1) == 1
    sel = torch.stack([take, torch.ones_like(take)])
    # Row 0 the accumulator, row 1 the shifted multiplicand.
    state = torch.stack([torch.zeros_like(a), a])
    for i in range(nbits):
        state = torch.where(sel[..., i:i + 1, :], _sum_reduce(state + state[1]), state)
    return state[0]


# ---------------------------------------------------------------------------
# Naive extended twisted Edwards points in the plain domain: (x, y, t, z)
# tuples of [8, B] word tensors.


def pt_identity_words(shape_b: int, device="cpu"):
    zero = torch.zeros((WORDS, shape_b), dtype=torch.int64, device=device)
    one = zero.clone()
    one[0] = 1
    return (zero, one, zero, one)


def pt_add(p1, p2, pw, dw):
    """The unified add-2008-hwcd with a = -1 in the plain domain: 10
    shift-and-add products, each group of independent ones as one stacked
    product."""
    x1, y1, t1, z1 = p1
    x2, y2, t2, z2 = p2
    pw = pw.expand_as(x1)
    a, b, tt, zz = field_mul(
        torch.stack([field_sub(y1, x1, pw), field_add(y1, x1, pw), t1, z1]),
        torch.stack([field_sub(y2, x2, pw), field_add(y2, x2, pw), t2, z2]), pw)
    c = field_double(field_mul(tt, dw, pw, nbits=EDWARDS_D.bit_length()), pw)
    d = field_double(zz, pw)
    e = field_sub(b, a, pw)
    f = field_sub(d, c, pw)
    g = field_add(d, c, pw)
    h = field_add(b, a, pw)
    return tuple(field_mul(torch.stack([e, g, e, f]), torch.stack([f, h, h, g]), pw).unbind(0))


def pt_double(p1, pw):
    """dbl-2008-hwcd with a = -1 in the plain domain."""
    x1, y1, _t1, z1 = p1
    pw = pw.expand_as(x1)
    xy = field_add(x1, y1, pw)
    sq = torch.stack([x1, y1, z1, xy])
    a, b, zz, xy2 = field_mul(sq, sq, pw)
    c = field_double(zz, pw)
    # D = a*A with a = -1.
    d = field_sub(torch.zeros_like(a), a, pw)
    e = field_sub(field_sub(xy2, a, pw), b, pw)
    g = field_add(d, b, pw)
    f = field_sub(g, c, pw)
    h = field_sub(d, b, pw)
    return tuple(field_mul(torch.stack([e, g, e, f]), torch.stack([f, h, h, g]), pw).unbind(0))


def pt_select(mask, a, b):
    return tuple(torch.where(mask, ai, bi) for ai, bi in zip(a, b))


def _bit_step(acc, base, take, pw, dw):
    """One bit of double-and-add: 2 acc, plus base where `take` is set."""
    acc = pt_double(acc, pw)
    return pt_select(take, pt_add(acc, base, pw, dw), acc)


def _bit_steps_on_a_graph(acc, base, takes, pw, dw):
    """The double-and-add loop with one step captured as a CUDA graph and
    replayed once a bit: the same kernels on the same tensors, launched by
    one replay rather than by tens of thousands of host dispatches (a step
    is about 47 000 small kernels; one host dispatch costs more than one
    kernel takes).  The step reads the bit's mask from a buffer copied in
    before each replay and writes the accumulator back in place."""
    state = tuple(a.clone() for a in acc)
    take = takes[0].clone()
    # One eager step on a side stream first: it makes the cached constants
    # and warms the allocator, as capture needs.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _bit_step(state, base, take, pw, dw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for a, b in zip(state, _bit_step(state, base, take, pw, dw)):
            a.copy_(b)
    for t in takes:
        take.copy_(t)
        graph.replay()
    return tuple(a.clone() for a in state)


def naive_msm_words(coords_u32: torch.Tensor, scalars_u32: torch.Tensor, bits: int = 256):
    """The naive MSM on this stack: [n, 2, 8] plain affine coordinate words
    and [n, 8] scalar words (int32 tensors with the u32 bits, or int64) ->
    one (x, y, t, z) of [8, 1] word tensors (plain domain, projective).
    Each point runs double-and-add over `bits` scalar bits, most significant
    first (on a card, one step as a CUDA graph replayed a bit); then a
    log-depth pairwise tree sums the n results."""
    n = coords_u32.shape[0]
    dev = coords_u32.device
    words = coords_u32.to(torch.int64) & M32
    pw, dw = p_words(n, dev), d_words(n, dev)
    x = words[:, 0, :].T.contiguous()            # [8, n] LE words
    y = words[:, 1, :].T.contiguous()
    t = field_mul(x, y, pw)
    z = torch.zeros((WORDS, n), dtype=torch.int64, device=dev)
    z[0] = 1
    base = (x, y, t, z)
    sc = (scalars_u32.to(torch.int64) & M32).T   # [8, n]

    takes = [((sc[idx // 32:idx // 32 + 1] >> (idx % 32)) & 1) == 1
             for idx in range(bits - 1, -1, -1)]
    acc = pt_identity_words(n, dev)
    if dev.type == "cuda" and takes:
        acc = _bit_steps_on_a_graph(acc, base, takes, pw, dw)
    else:
        for take in takes:
            acc = _bit_step(acc, base, take, pw, dw)

    # Pairwise tree: lanes [0, m/2) plus [m/2, 2*(m/2)), an odd last lane
    # carried to the next round.
    m = n
    while m > 1:
        half = m // 2
        lo = tuple(a[:, :half] for a in acc)
        hi = tuple(a[:, half:2 * half] for a in acc)
        merged = pt_add(lo, hi, p_words(half, dev), d_words(half, dev))
        if m % 2:
            merged = tuple(torch.cat([a, b[:, m - 1:m]], dim=1) for a, b in zip(merged, acc))
            m = half + 1
        else:
            m = half
        acc = merged
    return acc
