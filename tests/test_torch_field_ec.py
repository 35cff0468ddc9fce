"""The port's plain field and curve arithmetic against the JAX package's
device functions, bit for bit (tolerance 0: integer arithmetic).

The jnp functions of ops/pallas/common.py and ops/pallas/ec.py run directly
on [20, B] uint32 arrays on the CPU; the port's plain versions run on the
same limbs as int64 tensors.  Inputs are random limbs inside the documented
lazy bounds: values < 9p for product inputs, subtrahends < 3p.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webgpu_msm_twisted_edwards_tpu.ops.pallas import common as JC
from webgpu_msm_twisted_edwards_tpu.ops.pallas import ec as JE
from webgpu_msm_twisted_edwards_tpu.utils import limbs as JL
from webgpu_msm_twisted_edwards_tpu.utils import params as JP
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import common as TC
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import ec as TE
from webgpu_msm_twisted_edwards_tpu_torch.utils import limbs as TL
from webgpu_msm_twisted_edwards_tpu_torch.utils import params as TP

P = TP.PARAMS.p
B = 96


def _limbs(rng, bound: int) -> np.ndarray:
    """[L, B] uint32 normalized limbs of random values below `bound`."""
    vals = [int.from_bytes(rng.bytes(40), "little") % bound for _ in range(B)]
    return np.stack([TC.int_to_limbs(v) for v in vals], axis=1)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


def _same(jax_out, torch_out) -> bool:
    return np.array_equal(np.asarray(jax_out).astype(np.int64), torch_out.numpy())


@pytest.fixture(scope="module")
def consts():
    arr = JC.make_consts_array()
    jc = JC.Consts(*(jnp.asarray(arr[:, i:i + 1]) for i in range(5)))
    return jc, TC.load_consts("cpu")


def test_params_match_jax():
    for f in ("p", "word_size", "num_words", "max_terms", "k", "nsafe", "n0", "r", "rinv",
              "r2", "edwards_d_mont", "mask"):
        assert getattr(TP.PARAMS, f) == getattr(JP.PARAMS, f), f
    for name in ("P", "EDWARDS_A", "EDWARDS_D", "SUBGROUP_ORDER", "GENERATOR_X",
                 "GENERATOR_Y", "SCALAR_BITS"):
        assert getattr(TP, name) == getattr(JP, name), name
    for n in (1 << 12, 1 << 16, 1 << 18, 1 << 19, 1 << 20):
        for fn in ("default_msm_config", "tpu_msm_config"):
            a, b = getattr(TP, fn)(n), getattr(JP, fn)(n)
            assert (a.chunk_size, a.num_windows, a.num_buckets) == (
                b.chunk_size, b.num_windows, b.num_buckets), (fn, n)


def test_limb_codecs_match_jax():
    vals = [0, 1, P - 1, TP.SUBGROUP_ORDER, (1 << 256) - 1]
    words = TL.ints_to_u32_words(vals)
    assert np.array_equal(words, JL.ints_to_u32_words(vals))
    assert TL.u32_words_to_ints(words) == JL.u32_words_to_ints(words) == vals
    assert TL.words_le_to_int(TC.int_to_limbs(P - 5), 13) == P - 5


def test_consts_array_matches_jax():
    np.testing.assert_array_equal(TC.make_consts_array(), JC.make_consts_array())


def test_cuda_header_constants_match_consts_array():
    """csrc/field.cuh spells out the constants the kernels use."""
    path = os.path.join(os.path.dirname(TC.__file__), "..", "..", "csrc", "field.cuh")
    src = open(path).read()
    arr = TC.make_consts_array()
    for name, col in (("C_P", TC.CONST_P), ("C_R", TC.CONST_R), ("C_R2", TC.CONST_R2),
                      ("C_Q4", TC.CONST_Q4)):
        body = re.search(name + r"\[MSM_L\] = \{([^}]*)\}", src).group(1)
        assert [int(v, 16) for v in body.replace(",", " ").split()] == arr[:, col].tolist(), name
    assert int(re.search(r"#define MSM_N0 (0x[0-9A-Fa-f]+)u", src).group(1), 16) == TP.PARAMS.n0


def test_field26_header_constants_match_common():
    """csrc/field26.cuh spells out the 26-bit digit constants of the scans'
    madd: p, R mod p, 4p in headroom form, and N0' = -p^-1 mod 2^26; and
    R^2 mod p, which the table conversion multiplies by."""
    path = os.path.join(os.path.dirname(TC.__file__), "..", "..", "csrc", "field26.cuh")
    src = open(path).read()
    want = TC.make_digit_consts()
    for fn, key in (("d_p", "p"), ("d_r", "r"), ("d_r2", "r2"), ("d_q4", "q4")):
        body = re.search(fn + r"\(int i\) \{\s*constexpr uint32_t v\[MSM_LD\] = \{([^}]*)\}",
                         src).group(1)
        assert [int(v, 16) for v in body.replace(",", " ").split()] == want[key], fn
    assert int(re.search(r"#define MSM_N0D (0x[0-9A-Fa-f]+)u", src).group(1), 16) == want["n0"]
    assert want["p"][0] == 1 and want["n0"] == (1 << 26) - 1      # so q = -t mod 2^26


def test_field26_header_d_matches_common():
    """csrc/field26.cuh's digits of d*R mod p, the second input of the carry
    scan's product by d (csrc/ec26.cuh::full_add26_x4), are the column of
    make_consts_array that csrc/field.cuh's 13-bit full add reads."""
    path = os.path.join(os.path.dirname(TC.__file__), "..", "..", "csrc", "field26.cuh")
    body = re.search(r"d_d\(int i\) \{\s*constexpr uint32_t v\[MSM_LD\] = \{([^}]*)\}",
                     open(path).read()).group(1)
    got = [int(v, 16) for v in body.replace(",", " ").split()]
    assert got == TC.make_digit_consts()["d"]
    limbs = TC.make_consts_array()[:, TC.CONST_D].tolist()
    assert got == [limbs[2 * i] | (limbs[2 * i + 1] << 13) for i in range(10)]


def _extreme_operands(rng, case: str):
    """(x, y) limbs for test_mont_mul_at_extremes: one operand at an extreme
    value (all B lanes), the other random below 9p; or x = y."""
    y = _limbs(rng, 9 * P)
    if case == "x=y":
        return y, y.copy()
    if case == "under 9p":
        vals = [9 * P - 1 - int(rng.integers(0, 1 << 20)) for _ in range(B)]
        return np.stack([TC.int_to_limbs(v) for v in vals], axis=1), y
    v = {"0": 0, "1": 1, "p-1": P - 1}[case]
    return np.repeat(TC.int_to_limbs(v)[:, None], B, axis=1), y


@pytest.mark.parametrize("reduce", [True, False])
@pytest.mark.parametrize("case", ["0", "1", "p-1", "under 9p", "x=y"])
def test_mont_mul_at_extremes(consts, case, reduce):
    """The 26-bit-digit product (the plain version, and the scans' field26.cuh)
    against the JAX 13-bit mont_mul at the ends of the lazy input range."""
    jc, tc = consts
    x, y = _extreme_operands(np.random.default_rng(5), case)
    for a, b in ((x, y), (y, x)):
        assert _same(JC.mont_mul(jnp.asarray(a), jnp.asarray(b), jc.p, reduce=reduce),
                     TC.mont_mul(_t(a), _t(b), tc.p, reduce=reduce))


@pytest.mark.parametrize("reduce", [True, False])
def test_mont_mul(consts, reduce):
    jc, tc = consts
    rng = np.random.default_rng(1 + reduce)
    x, y = _limbs(rng, 9 * P), _limbs(rng, 9 * P)
    assert _same(JC.mont_mul(jnp.asarray(x), jnp.asarray(y), jc.p, reduce=reduce),
                 TC.mont_mul(_t(x), _t(y), tc.p, reduce=reduce))


def test_mont_many_matches_jax(consts):
    jc, tc = consts
    rng = np.random.default_rng(3)
    pairs = [(_limbs(rng, 9 * P), _limbs(rng, 9 * P)) for _ in range(3)]
    want = JC.mont_many([(jnp.asarray(a), jnp.asarray(b)) for a, b in pairs], jc.p)
    got = TC.mont_many([(_t(a), _t(b)) for a, b in pairs], tc.p)
    assert all(_same(w, g) for w, g in zip(want, got))


def test_carry_sweep():
    rng = np.random.default_rng(4)
    s = rng.integers(0, 1 << 32, size=(TC.L, B), dtype=np.uint64).astype(np.uint32)
    assert _same(JC.carry_sweep(jnp.asarray(s)), TC.carry_sweep(_t(s)))


@pytest.mark.parametrize("op", ["add", "sub", "neg"])
def test_lazy_add_sub_neg(consts, op):
    jc, tc = consts
    rng = np.random.default_rng(5)
    a, b = _limbs(rng, 6 * P), _limbs(rng, 3 * P)
    if op == "add":
        want, got = JC.fr_add_lazy(jnp.asarray(a), jnp.asarray(b)), TC.fr_add_lazy(_t(a), _t(b))
    elif op == "sub":
        want = JC.fr_sub_lazy(jnp.asarray(a), jnp.asarray(b), jc)
        got = TC.fr_sub_lazy(_t(a), _t(b), tc)
    else:
        want, got = JC.fr_neg_lazy(jnp.asarray(b), jc), TC.fr_neg_lazy(_t(b), tc)
    assert _same(want, got)


def test_pack2_unpack2():
    rng = np.random.default_rng(6)
    a = _limbs(rng, 2 * P)
    pk = JC.pack2(jnp.asarray(a))
    assert _same(pk, TC.pack2(_t(a)))
    assert _same(JC.unpack2(pk), TC.unpack2(_t(np.asarray(pk))))


@pytest.mark.parametrize("op", ["madd", "full_add", "double"])
def test_point_formulas(consts, op):
    """Accumulator coordinates < 1.3p; madd's cached table operands < 5.3p."""
    jc, tc = consts
    rng = np.random.default_rng(7)
    p1 = [_limbs(rng, 13 * P // 10) for _ in range(4)]
    p2 = [_limbs(rng, 13 * P // 10 if op != "madd" else 53 * P // 10) for _ in range(4)]
    j1, t1 = JE.Pt(*map(jnp.asarray, p1)), TE.Pt(*map(_t, p1))
    j2, t2 = JE.Pt(*map(jnp.asarray, p2)), TE.Pt(*map(_t, p2))
    if op == "madd":
        want, got = JE.madd(j1, j2.x, j2.y, j2.t, jc), TE.madd(t1, t2.x, t2.y, t2.t, tc)
    elif op == "full_add":
        want, got = JE.full_add(j1, j2, jc), TE.full_add(t1, t2, tc)
    else:
        want, got = JE.double(j1, jc), TE.double(t1, tc)
    assert all(_same(w, g) for w, g in zip(want, got))


def test_pack_unpack_points_match_jax(consts):
    jc, tc = consts
    rng = np.random.default_rng(8)
    pts = [_limbs(rng, P) for _ in range(4)]
    packed = JE.pt_pack(JE.Pt(*map(jnp.asarray, pts)))
    assert _same(packed, TE.pt_pack(TE.Pt(*map(_t, pts))))
    assert all(_same(w, g) for w, g in zip(JE.pt_unpack(packed),
                                          TE.pt_unpack(_t(np.asarray(packed)))))
    ident = JE.pt_identity((TC.L, 3), jc)
    assert all(_same(w, g) for w, g in zip(ident, TE.pt_identity(3, tc)))
