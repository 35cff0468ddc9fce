"""Python-int field arithmetic over the base field: the host's ground truth."""

from __future__ import annotations

from ..utils.params import P


def finv(a: int, p: int = P) -> int:
    """Modular inverse via Fermat (p prime)."""
    if a % p == 0:
        raise ZeroDivisionError("inverse of 0")
    return pow(a, p - 2, p)
