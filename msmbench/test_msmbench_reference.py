"""The point generator and the reference against sums worked out point by
point with Python integers."""

from __future__ import annotations

import numpy as np
import pytest

from msmbench import inputs
from msmbench import reference as ref


def _affine_points(points: np.ndarray):
    return [(ref.words_to_int(p[:4].view(np.uint32)), ref.words_to_int(p[4:].view(np.uint32)))
            for p in points]


def _direct_msm(points, scalars) -> tuple[int, int]:
    acc = ref.IDENTITY
    for (x, y), s in zip(_affine_points(points), scalars):
        acc = ref.add(acc, ref.mul(ref.words_to_int(s), (x, y, x * y % ref.P, 1)))
    return ref.affine(acc)


@pytest.fixture(scope="module")
def small():
    return inputs.make(2**33 + 17, 37, 3)


def test_points_lie_on_the_curve_and_are_their_logs(small):
    for x, y in _affine_points(small.points):
        assert (-x * x + y * y - 1 - ref.D * x * x * y * y) % ref.P == 0
    rows, cols = inputs.grid_shape(37)
    assert (len(small.alpha), len(small.beta)) == (rows, cols) and rows * cols >= 37
    assert ref.wrong_points(small.points, small.alpha, small.beta, np.arange(37)) == 0
    assert ref.mul(ref.R, ref.generator())[0] % ref.P == 0      # G has order r


def test_reference_equals_the_direct_sum(small):
    for v in small.vectors:
        assert ref.expected(v, small.alpha, small.beta) == _direct_msm(small.points, v)


def test_a_changed_point_or_scalar_is_seen(small):
    bad = small.points.copy()
    bad[5, 0] ^= 1
    assert ref.wrong_points(bad, small.alpha, small.beta, np.arange(37)) == 1
    v = small.vectors[0].copy()
    v[3, 0] ^= 1
    assert ref.expected(v, small.alpha, small.beta) != ref.expected(
        small.vectors[0], small.alpha, small.beta)


def test_the_same_seed_gives_the_same_inputs():
    a, b = (inputs.make(2**31 + 5, 40, 2) for _ in range(2))
    assert (a.points == b.points).all() and (a.vectors == b.vectors).all()
    c = inputs.make(2**31 + 6, 40, 2)
    assert not (a.vectors == c.vectors).all()


def test_scalars_are_below_the_order_and_use_its_top_bits():
    v = inputs.below_order(np.random.default_rng(1), 4096)
    ints = [ref.words_to_int(w) for w in v]
    assert max(ints) < ref.R and max(ints).bit_length() == 251
