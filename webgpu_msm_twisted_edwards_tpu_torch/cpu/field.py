"""Python-int field arithmetic over the base field: the host's ground truth."""

from __future__ import annotations

from ..utils.params import P


def finv(a: int, p: int = P) -> int:
    """Modular inverse via Fermat (p prime)."""
    if a % p == 0:
        raise ZeroDivisionError("inverse of 0")
    return pow(a, p - 2, p)


def fsqrt(a: int, p: int = P) -> int | None:
    """A square root of a mod p (Tonelli-Shanks), or None for a non-residue."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t, r = t * c % p, r * b % p
    return r
