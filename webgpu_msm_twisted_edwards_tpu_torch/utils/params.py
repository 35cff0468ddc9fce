"""Curve and limb parameters for ed-on-bls12-377 (the "Edwards BLS12" twisted
Edwards curve) and the Montgomery constants derived from them.

The port's own copy of the JAX package's parameter layer: the field is the
253-bit prime P held as 20 little-endian 13-bit limbs in 32-bit words, so a
limb product fits in 26 bits and the interleaved Montgomery product can add
two products per limb for all 20 iterations without an intermediate carry.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

#: Base field prime (the scalar field of BLS12-377).
P = 8444461749428370424248824938781546531375899335154063827935233455917409239041

#: Twisted Edwards `a` coefficient: a = -1 mod p.
EDWARDS_A = P - 1

#: Twisted Edwards `d` coefficient.
EDWARDS_D = 3021

#: Order of the prime-order subgroup.
SUBGROUP_ORDER = 2111115437357092606062206234695386632838870926408408195193685246394721360383

#: Affine generator of the prime-order subgroup.
GENERATOR_X = 1540945439182663264862696551825005342995406165131907382295858612069623286213
GENERATOR_Y = 8003546896475222703853313610036801932325312921786952001586936882361378122196

#: Limb width in bits.
WORD_SIZE = 13

#: Bits of a scalar at the API boundary (8 u32 words).
SCALAR_BITS = 256


def _egcd(a: int, b: int) -> tuple[int, int, int]:
    """Extended gcd: returns (g, x, y) with a*x + b*y = g."""
    old_r, r = a, b
    old_s, s = 1, 0
    old_t, t = 0, 1
    while r != 0:
        q = old_r // r
        old_r, r = r, old_r - q * r
        old_s, s = s, old_s - q * s
        old_t, t = t, old_t - q * t
    return old_r, old_s, old_t


@dataclasses.dataclass(frozen=True)
class FieldParams:
    """Derived constants for limb-based Montgomery arithmetic."""

    p: int
    word_size: int
    num_words: int
    #: Maximum number of product terms in a schoolbook multiply.
    max_terms: int
    #: How many w-bit x w-bit products fit in a u32 accumulator.
    k: int
    #: Carry-free inner-loop iterations of the Montgomery product, floor(k/2).
    nsafe: int
    #: -p^-1 mod 2^word_size.
    n0: int
    #: Montgomery radix R = 2^(num_words*word_size) reduced mod p.
    r: int
    #: R^-1 mod p.
    rinv: int
    #: R^2 mod p: a Montgomery product with it enters Montgomery form.
    r2: int
    #: Edwards d in Montgomery form: d*R mod p.
    edwards_d_mont: int
    #: Limb mask 2^word_size - 1.
    mask: int

    @property
    def r_full(self) -> int:
        """Unreduced Montgomery radix 2^(num_words*word_size)."""
        return 1 << (self.num_words * self.word_size)

    def to_mont(self, x: int) -> int:
        return (x * self.r_full) % self.p

    def from_mont(self, x: int) -> int:
        return (x * self.rinv) % self.p


@lru_cache(maxsize=None)
def compute_field_params(p: int = P, word_size: int = WORD_SIZE) -> FieldParams:
    """Derive the Montgomery and limb constants for prime `p` and limb width
    `word_size`."""
    if word_size <= 0:
        raise ValueError(f"word_size must be positive, got {word_size}")
    num_words = -(-p.bit_length() // word_size)
    k = (1 << 32) // (1 << (2 * word_size))
    r_full = 1 << (num_words * word_size)
    g, rinv, pprime = _egcd(r_full, p)
    if g != 1:
        raise ValueError("p must be odd")
    neg_p_inv = (-pprime) % r_full
    return FieldParams(
        p=p,
        word_size=word_size,
        num_words=num_words,
        max_terms=num_words * 2,
        k=k,
        nsafe=k // 2,
        n0=neg_p_inv % (1 << word_size),
        r=r_full % p,
        rinv=rinv % p,
        r2=(r_full * r_full) % p,
        edwards_d_mont=(EDWARDS_D * r_full) % p,
        mask=(1 << word_size) - 1,
    )


#: The parameter set of the whole pipeline (w=13, 20 limbs, nsafe=32).
PARAMS = compute_field_params()


@dataclasses.dataclass(frozen=True)
class MsmConfig:
    """Static configuration of one MSM: the window size `chunk_size` (c) gives
    `num_windows` signed c-bit windows over `scalar_bits` bits."""

    chunk_size: int = 16
    scalar_bits: int = SCALAR_BITS

    @property
    def num_windows(self) -> int:
        return -(-self.scalar_bits // self.chunk_size)

    @property
    def num_buckets(self) -> int:
        """Signed buckets per window, excluding the zero bucket: 2^(c-1)."""
        return 1 << (self.chunk_size - 1)


def default_msm_config(n: int) -> MsmConfig:
    """The generic window sizing: c=16 from 2^16 points, c=4 below."""
    return MsmConfig(chunk_size=16 if n >= (1 << 16) else 4)


def tpu_msm_config(n: int) -> MsmConfig:
    """Window sizing of the bucket pipeline for n >= 4096: c=13 below 2^19
    points, c=16 from 2^19.  Copied unchanged from the JAX package, where it
    was tuned on that package's own accelerator, so that every stage here
    compares one to one with it.  Its re-derivation on the H100 is queued in
    ROADMAP.md."""
    return MsmConfig(chunk_size=13 if n < (1 << 19) else 16)
