"""The plain reference that decides `correct`: Python integers and NumPy.

It imports nothing of the program.  Every point the benchmark makes is a
known multiple of the subgroup generator G (inputs.py: point i*cols + j is
(alpha_i + beta_j)*G), so an MSM over those points is

    Q = sum_k s_k * P_k = (sum_k s_k * (alpha_i + beta_j) mod r) * G
      = (sum_i alpha_i * rowsum_i + sum_j beta_j * colsum_j mod r) * G,

where rowsum_i and colsum_j add the scalars of row i and column j.  That
needs two sums over the scalars in NumPy, a few thousand products of Python
integers and one scalar multiplication, whatever the number of points.  The
premise is checked by itself: `wrong_points` recomputes a sample of the
points handed to the program as (alpha_i + beta_j)*G.

Curve: ed-on-bls12-377, -x^2 + y^2 = 1 + d*x^2*y^2 over F_p, in extended
coordinates (X, Y, T, Z) with the HWCD 2008 formulas.
"""

from __future__ import annotations

import numpy as np

#: The base field's prime (the scalar field of BLS12-377).
P = 8444461749428370424248824938781546531375899335154063827935233455917409239041
#: The twisted Edwards d; a = -1.
D = 3021
#: The order of the prime-order subgroup.
R = 2111115437357092606062206234695386632838870926408408195193685246394721360383
#: The affine generator of that subgroup.
GX = 1540945439182663264862696551825005342995406165131907382295858612069623286213
GY = 8003546896475222703853313610036801932325312921786952001586936882361378122196

IDENTITY = (0, 1, 0, 1)


def add(p1: tuple, p2: tuple) -> tuple:
    """add-2008-hwcd, unified, a = -1."""
    x1, y1, t1, z1 = p1
    x2, y2, t2, z2 = p2
    a = x1 * x2 % P
    b = y1 * y2 % P
    c = D * t1 % P * t2 % P
    d = z1 * z2 % P
    e = ((x1 + y1) * (x2 + y2) - a - b) % P
    f, g, h = (d - c) % P, (d + c) % P, (b + a) % P
    return e * f % P, g * h % P, e * h % P, f * g % P


def double(p1: tuple) -> tuple:
    """dbl-2008-hwcd, a = -1."""
    x, y, _, z = p1
    a, b = x * x % P, y * y % P
    c = 2 * z * z % P
    e = ((x + y) * (x + y) - a - b) % P
    g = (b - a) % P
    f, h = (g - c) % P, (-a - b) % P
    return e * f % P, g * h % P, e * h % P, f * g % P


def mul(k: int, pt: tuple) -> tuple:
    """k * pt by double and add."""
    acc, base = IDENTITY, pt
    while k:
        if k & 1:
            acc = add(acc, base)
        base = double(base)
        k >>= 1
    return acc


def affine(pt: tuple) -> tuple[int, int]:
    x, y, _, z = pt
    zi = pow(z, P - 2, P)
    return x * zi % P, y * zi % P


def generator() -> tuple:
    return GX, GY, GX * GY % P, 1


def words_to_int(words) -> int:
    """Little-endian 32-bit words (any unsigned width) -> one integer."""
    return sum(int(w) << (32 * i) for i, w in enumerate(words))


def log_sum(scalars: np.ndarray, alpha: list[int], beta: list[int]) -> int:
    """sum_k s_k * log(P_k) mod r for [n, 8] uint32 scalar words over the
    grid of points with row multiples alpha and column multiples beta."""
    rows, cols = len(alpha), len(beta)
    n = scalars.shape[0]
    if n > rows * cols:
        raise ValueError(f"{n} scalars for a grid of {rows} x {cols} points")
    grid = np.zeros((rows * cols, scalars.shape[1]), dtype=np.uint64)
    grid[:n] = scalars
    grid = grid.reshape(rows, cols, -1)
    # Sums of at most 2^31 words of 32 bits are exact in 64 bits.
    row_sums, col_sums = grid.sum(axis=1), grid.sum(axis=0)
    total = sum(a * words_to_int(w) for a, w in zip(alpha, row_sums))
    total += sum(b * words_to_int(w) for b, w in zip(beta, col_sums))
    return total % R


def expected(scalars: np.ndarray, alpha: list[int], beta: list[int]) -> tuple[int, int]:
    """The affine MSM of the scalars over the grid's points."""
    return affine(mul(log_sum(scalars, alpha, beta), generator()))


def wrong_points(points: np.ndarray, alpha: list[int], beta: list[int],
                 sample: np.ndarray) -> int:
    """How many of the sampled points of [n, 8] uint64 affine (x, y) words
    differ from (alpha_i + beta_j)*G."""
    cols = len(beta)
    wrong = 0
    for k in sample.tolist():
        want = affine(mul((alpha[k // cols] + beta[k % cols]) % R, generator()))
        got = words_to_int(points[k, :4].view(np.uint32)), words_to_int(points[k, 4:].view(np.uint32))
        wrong += got != want
    return wrong
