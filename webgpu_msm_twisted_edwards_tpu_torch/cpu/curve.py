"""Python-int extended twisted Edwards arithmetic: host decode of the device
result, the ground truth of the mirrors (cpu/mirrors.py) and the tests'
reference sums.

Curve: a*x^2 + y^2 = 1 + d*x^2*y^2 over F_p with a = -1, d = 3021.  Points
are extended coordinates (X, Y, T, Z) with x = X/Z, y = Y/Z, T = XY/Z.
"""

from __future__ import annotations

import dataclasses

from ..utils.params import EDWARDS_A, EDWARDS_D, GENERATOR_X, GENERATOR_Y, P, SUBGROUP_ORDER
from .field import finv, fsqrt


@dataclasses.dataclass(frozen=True)
class ExtPoint:
    x: int
    y: int
    t: int
    z: int

    @staticmethod
    def identity() -> "ExtPoint":
        return ExtPoint(0, 1, 0, 1)

    @staticmethod
    def from_affine(x: int, y: int) -> "ExtPoint":
        return ExtPoint(x % P, y % P, (x * y) % P, 1)

    def to_affine(self) -> tuple[int, int]:
        zinv = finv(self.z)
        return (self.x * zinv) % P, (self.y * zinv) % P

    def is_identity(self) -> bool:
        """x/z == 0 and y/z == 1."""
        return self.x % P == 0 and (self.y - self.z) % P == 0

    def neg(self) -> "ExtPoint":
        return ExtPoint((-self.x) % P, self.y, (-self.t) % P, self.z)

    def add(self, o: "ExtPoint") -> "ExtPoint":
        """add-2008-hwcd, unified for a = -1."""
        p = P
        a = self.x * o.x % p
        b = self.y * o.y % p
        c = EDWARDS_D * self.t % p * o.t % p
        d = self.z * o.z % p
        e = ((self.x + self.y) * (o.x + o.y) - a - b) % p
        f = (d - c) % p
        g = (d + c) % p
        h = (b + a) % p
        return ExtPoint(e * f % p, g * h % p, e * h % p, f * g % p)

    def double(self) -> "ExtPoint":
        """dbl-2008-hwcd with a = -1."""
        p = P
        a = self.x * self.x % p
        b = self.y * self.y % p
        c = 2 * self.z * self.z % p
        d = (-a) % p
        e = ((self.x + self.y) * (self.x + self.y) - a - b) % p
        g = (d + b) % p
        f = (g - c) % p
        h = (d - b) % p
        return ExtPoint(e * f % p, g * h % p, e * h % p, f * g % p)

    def mul(self, k: int) -> "ExtPoint":
        """Double-and-add scalar multiplication, k reduced mod the subgroup
        order."""
        k %= SUBGROUP_ORDER
        acc = ExtPoint.identity()
        base = self
        while k:
            if k & 1:
                acc = acc.add(base)
            base = base.double()
            k >>= 1
        return acc

    def assert_on_curve(self) -> None:
        x, y = self.to_affine()
        lhs = (EDWARDS_A * x * x + y * y) % P
        rhs = (1 + EDWARDS_D * x * x % P * y * y) % P
        if lhs != rhs:
            raise AssertionError("point not on curve")


GENERATOR = ExtPoint.from_affine(GENERATOR_X, GENERATOR_Y)


def get_point_from_x(x: int) -> ExtPoint:
    """The point of the prime-order subgroup with this x: y^2 = (1 - a*x^2) /
    (1 - d*x^2), the root whose multiple by the order is the identity."""
    num = (1 - EDWARDS_A * x * x) % P
    den = (1 - EDWARDS_D * x * x) % P
    y = fsqrt(num * finv(den) % P)
    if y is None:
        raise ValueError("x is not on the curve")
    pt = ExtPoint.from_affine(x, y)
    if not pt.mul(SUBGROUP_ORDER).is_identity():
        pt = ExtPoint.from_affine(x, (-y) % P)
        if not pt.mul(SUBGROUP_ORDER).is_identity():
            raise ValueError("neither y candidate is in the prime-order subgroup")
    return pt


def naive_msm(points: list[ExtPoint], scalars: list[int]) -> ExtPoint:
    """sum_i k_i * P_i by one double-and-add multiplication a point."""
    acc = ExtPoint.identity()
    for pt, s in zip(points, scalars):
        acc = acc.add(pt.mul(s))
    return acc
