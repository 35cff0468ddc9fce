"""The port's arithmetic variants and experiments against the JAX package
and python ints, bit for bit (tolerance 0): the Montgomery products at
limb widths 12-16, Barrett and Barrett-Domb (and its host mirror), the
independent u256 stack and its naive MSM, double-and-add against Booth,
and the scatter bucket sums.  Inputs come from numpy seeds.  The jitted
JAX functions whose compile would dominate (Barrett, Barrett-Domb) run
op by op under jax.disable_jit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_twisted_edwards_tpu.cpu import barrett_domb as JCB
from webgpu_msm_twisted_edwards_tpu.ops import barrett as JB
from webgpu_msm_twisted_edwards_tpu.ops import barrett_domb as JD
from webgpu_msm_twisted_edwards_tpu.ops import convert as JCV
from webgpu_msm_twisted_edwards_tpu.ops import curve as JC
from webgpu_msm_twisted_edwards_tpu.ops import montgomery_variants as JMV
from webgpu_msm_twisted_edwards_tpu.ops import scalar_mul as JSM
from webgpu_msm_twisted_edwards_tpu.ops import smtvp as JST
from webgpu_msm_twisted_edwards_tpu.ops import u256 as JU
from webgpu_msm_twisted_edwards_tpu.utils.params import PARAMS as JPARAMS
from webgpu_msm_twisted_edwards_tpu_torch.cpu import barrett_domb as CB
from webgpu_msm_twisted_edwards_tpu_torch.cpu.curve import GENERATOR, ExtPoint
from webgpu_msm_twisted_edwards_tpu_torch.ops import barrett as B
from webgpu_msm_twisted_edwards_tpu_torch.ops import barrett_domb as BD
from webgpu_msm_twisted_edwards_tpu_torch.ops import convert as CV
from webgpu_msm_twisted_edwards_tpu_torch.ops import curve as C
from webgpu_msm_twisted_edwards_tpu_torch.ops import field as F
from webgpu_msm_twisted_edwards_tpu_torch.ops import montgomery_variants as MV
from webgpu_msm_twisted_edwards_tpu_torch.ops import scalar_mul as SM
from webgpu_msm_twisted_edwards_tpu_torch.ops import smtvp as ST
from webgpu_msm_twisted_edwards_tpu_torch.ops import u256 as U
from webgpu_msm_twisted_edwards_tpu_torch.utils.params import PARAMS, P, MsmConfig

BATCH = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops; with several test
    workers sharing the cores, torch's intra-op threads would mostly wait on
    each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _limbs_of(vals, w: int, num: int) -> np.ndarray:
    return np.array([[(v >> (w * i)) & ((1 << w) - 1) for i in range(num)] for v in vals],
                    dtype=np.uint32)


def _value(limbs, w: int) -> int:
    return sum(int(x) << (w * i) for i, x in enumerate(limbs))


def _field_values(seed: int, n: int = BATCH) -> list[int]:
    rng = np.random.default_rng(seed)
    vals = [int(v) % P for v in rng.integers(0, 1 << 63, size=(n, 4), dtype=np.uint64)
            .astype(object).dot([1, 1 << 64, 1 << 128, 1 << 192])]
    vals[0], vals[1] = P - 1, 0
    return vals


def _port(t: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(t.astype(np.int64))


@pytest.mark.parametrize("w", [12, 13, 14, 15, 16])
def test_montgomery_variants_match_jax_and_ints(w):
    """Random limbs (the maximal limb in lane 0) against the JAX family of
    the width; values below p against x*y*R^-1 mod p, also as a chain."""
    params, fn = MV.mont_mul_for_width(w)
    jparams, jfn = JMV.mont_mul_for_width(w)
    assert (params.num_words, params.nsafe, params.n0) == (jparams.num_words, jparams.nsafe,
                                                           jparams.n0)
    rng = np.random.default_rng(w)
    x = rng.integers(0, 1 << w, size=(BATCH, params.num_words), dtype=np.uint32)
    y = rng.integers(0, 1 << w, size=(BATCH, params.num_words), dtype=np.uint32)
    x[0] = y[0] = (1 << w) - 1
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_array_equal(fn(_port(x), _port(y)).numpy(), want)

    xs, ys = _field_values(w), _field_values(w + 100)
    rinv = pow(1 << (params.num_words * w), -1, P)
    xl, yl = _port(_limbs_of(xs, w, params.num_words)), _port(_limbs_of(ys, w, params.num_words))
    got = [_value(r, w) for r in fn(xl, yl).tolist()]
    assert got == [a * b * rinv % P for a, b in zip(xs, ys)]
    _, chain = MV.cost_loop(w, BATCH, 3)
    got = [_value(r, w) for r in chain(xl, yl).tolist()]
    assert got == [a * pow(b * rinv, 3, P) % P for a, b in zip(xs, ys)]


@pytest.mark.parametrize("name", ["barrett", "barrett_domb"])
def test_barrett_products_match_jax_and_ints(name):
    jfn, fn = {"barrett": (JB.barrett_mul, B.barrett_mul),
               "barrett_domb": (JD.barrett_domb_mul, BD.barrett_domb_mul)}[name]
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 13, size=(BATCH, 20), dtype=np.uint32)
    y = rng.integers(0, 1 << 13, size=(BATCH, 20), dtype=np.uint32)
    x[0] = y[0] = (1 << 13) - 1
    with jax.disable_jit():
        want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_array_equal(fn(_port(x), _port(y)).numpy(), want)
    xs, ys = _field_values(4), _field_values(5)
    got = fn(_port(_limbs_of(xs, 13, 20)), _port(_limbs_of(ys, 13, 20)))
    assert [_value(r, 13) for r in got.tolist()] == [a * b % P for a, b in zip(xs, ys)]


def test_barrett_domb_host_mirror_matches_jax_and_ints():
    assert PARAMS.barrett_domb_m == JPARAMS.barrett_domb_m
    xs, ys = _field_values(6), _field_values(7)
    for a, b in zip(xs, ys):
        assert CB.barrett_domb_mul_int(a, b) == JCB.barrett_domb_mul_int(a, b) == a * b % P
    limbs = CB.to_limbs(xs[2], 20, 13)
    assert CB.mp_msb_multiply(limbs, limbs, 13) == JCB.mp_msb_multiply(limbs, limbs, 13)


def _words(vals) -> torch.Tensor:
    """[8, n] int64 words of n ints."""
    return torch.from_numpy(np.stack([U.int_to_words(v) for v in vals], axis=1))


def _ints(t: torch.Tensor) -> list[int]:
    return [sum(int(t[i, j]) << (32 * i) for i in range(8)) for j in range(t.shape[1])]


def test_u256_field_ops_match_ints():
    rng = np.random.default_rng(8)
    big = [int(v) for v in rng.integers(0, 1 << 63, size=(BATCH, 4), dtype=np.uint64)
           .astype(object).dot([1, 1 << 64, 1 << 128, 1 << 192]) * 2 + 1]
    big2 = big[::-1]
    big2[0] = big[0]                                    # equal operands in lane 0
    a, b = _words(big), _words(big2)
    m = 1 << 256
    assert _ints(U.u256_add(a, b)) == [(x + y) % m for x, y in zip(big, big2)]
    assert _ints(U.u256_sub(a, b)) == [(x - y) % m for x, y in zip(big, big2)]
    assert U.u256_gte(a, b)[0].tolist() == [x >= y for x, y in zip(big, big2)]
    assert _ints(U.u256_double(a)) == [2 * x % m for x in big]
    xs, ys = _field_values(9), _field_values(10)
    x, y, pw = _words(xs), _words(ys), U.p_words(BATCH)
    assert _ints(U.field_add(x, y, pw)) == [(s + t) % P for s, t in zip(xs, ys)]
    assert _ints(U.field_sub(x, y, pw)) == [(s - t) % P for s, t in zip(xs, ys)]
    assert _ints(U.field_double(x, pw)) == [2 * s % P for s in xs]
    assert _ints(U.field_reduce_once(_words([P + 5, P - 1]), U.p_words(2))) == [5, P - 1]
    assert _ints(U.field_mul(x, y, pw)) == [s * t % P for s, t in zip(xs, ys)]


def _curve_points(n: int, seed: int) -> list[ExtPoint]:
    rng = np.random.default_rng(seed)
    return [GENERATOR.mul(int(k)) for k in rng.integers(1, 1 << 40, size=n)]


def _plain_point(pts: list[ExtPoint]):
    return tuple(_words([getattr(p, c) for p in pts]) for c in "xytz")


def _affine(coords) -> list[tuple[int, int]]:
    x, y, t, z = (_ints(c) for c in coords)
    return [ExtPoint(*v).to_affine() for v in zip(x, y, t, z)]


def test_u256_point_ops_match_the_cpu_curve():
    p1, p2 = _curve_points(4, 11), _curve_points(4, 12)
    p2[0] = p1[0]                                       # the unified add doubles
    pw, dw = U.p_words(4), U.d_words(4)
    got = _affine(U.pt_add(_plain_point(p1), _plain_point(p2), pw, dw))
    assert got == [a.add(b).to_affine() for a, b in zip(p1, p2)]
    assert _affine(U.pt_double(_plain_point(p1), pw)) == [a.double().to_affine() for a in p1]
    ident = _affine(U.pt_identity_words(4))
    assert ident == [ExtPoint.identity().to_affine()] * 4


def _coords(pts: list[ExtPoint]) -> np.ndarray:
    coords = np.zeros((len(pts), 2, 8), dtype=np.uint32)
    for i, p in enumerate(pts):
        x, y = p.to_affine()
        coords[i, 0] = U.int_to_words(x).astype(np.uint32)
        coords[i, 1] = U.int_to_words(y).astype(np.uint32)
    return coords


def test_naive_msm_words_matches_jax_and_ints():
    """n = 4 points, 16-bit scalars, bits=16."""
    pts = _curve_points(4, 13)
    rng = np.random.default_rng(13)
    ks = [int(k) for k in rng.integers(0, 1 << 16, size=4)]
    sc = np.zeros((4, 8), dtype=np.uint32)
    sc[:, 0] = ks
    coords = _coords(pts)
    want = jax.jit(lambda c, s: JU.naive_msm_words(c, s, bits=16))(jnp.asarray(coords),
                                                                  jnp.asarray(sc))
    got = U.naive_msm_words(torch.from_numpy(coords.view(np.int32)),
                            torch.from_numpy(sc.view(np.int32)), bits=16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    total = ExtPoint.identity()
    for p, k in zip(pts, ks):
        total = total.add(p.mul(k))
    assert _affine(got) == [total.to_affine()]


def _mont_inputs(pts: list[ExtPoint]):
    """The points as Montgomery limbs for both packages: the port's
    conversion, handed to JAX as uint32 (the conversions agree limb for limb:
    test_torch_small_path.py)."""
    coords = _coords(pts)
    xm, ym, tm = CV.points_to_mont_limbs(torch.from_numpy(coords.view(np.int32)))
    port = C.PointXYTZ(xm, ym, tm, F.r_limbs().expand_as(xm).contiguous())
    return port, JC.PointXYTZ(*(jnp.asarray(u.numpy().astype(np.uint32)) for u in port))


def _eq_points(port: C.PointXYTZ, jax_pt) -> None:
    for a, b in zip(port, (jax_pt.x, jax_pt.y, jax_pt.t, jax_pt.z)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))


def _mont_affine(p: C.PointXYTZ) -> list[tuple[int, int]]:
    def ints(a):
        return [PARAMS.from_mont(_value(r, 13)) for r in a.tolist()]
    return [ExtPoint(*v).to_affine() for v in zip(*(ints(a) for a in p))]


def test_booth_matches_double_and_add_and_jax():
    """16-bit scalars, 16 bits: Booth limb for limb as the JAX Booth; Booth
    and double-and-add the same points, k*P."""
    pts = _curve_points(4, 14)
    rng = np.random.default_rng(14)
    k = np.zeros((4, 8), dtype=np.uint32)
    k[:, 0] = rng.integers(0, 1 << 16, size=4)
    k[1, 0] = 0xFFFF                                    # one run of ones
    port_pt, jax_pt = _mont_inputs(pts)
    kt = torch.from_numpy(k.view(np.int32))
    dbl = SM.double_and_add(port_pt, kt, num_bits=16)
    booth = SM.booth(port_pt, kt, num_bits=16)
    _eq_points(booth, JSM.booth(jax_pt, jnp.asarray(k), num_bits=16))
    want = [p.mul(int(s)).to_affine() for p, s in zip(pts, k[:, 0])]
    assert _mont_affine(dbl) == _mont_affine(booth) == want


def test_smtvp_buckets_match_jax():
    """n = 64 points, c = 4: 8 buckets of one window's signed digits, zero
    digits included."""
    pts = _curve_points(64, 15)
    rng = np.random.default_rng(15)
    sc = rng.integers(0, 1 << 32, size=(64, 8), dtype=np.uint64).astype(np.uint32)
    sc[:, 7] &= 0xFFFF
    sc[:4, 0] &= ~np.uint32(0xF)                        # zero digits in window 0
    cfg = MsmConfig(chunk_size=4)
    digits = CV.decompose_scalars_signed(torch.from_numpy(sc.view(np.int32)), cfg)[:, 0]
    jdigits = JCV.decompose_scalars_signed(jnp.asarray(sc), cfg)[:, 0]
    np.testing.assert_array_equal(digits.numpy(), np.asarray(jdigits))
    port_pt, jax_pt = _mont_inputs(pts)
    got = ST.smtvp_buckets(port_pt, digits, cfg.num_buckets)
    _eq_points(got, JST.smtvp_buckets(jax_pt, jdigits, cfg.num_buckets))
    # Bucket b holds the signed sum of the points with |digit| == b + 1.
    for b in (0, 5):
        want = ExtPoint.identity()
        for p, d in zip(pts, digits.tolist()):
            if abs(d) == b + 1:
                want = want.add(p if d > 0 else p.neg())
        assert _mont_affine(C.PointXYTZ(*(u[b:b + 1] for u in got))) == [want.to_affine()]
