"""The port's fixed-base (precomputed SRS) path on the CPU, against the JAX
package bit for bit (tolerance 0: integer arithmetic).

- The plain versions of build_table_pair, double_rows, normalize_rows and
  msm_scan_rm_signed against the JAX kernels in interpret mode, at 128 rows
  or fragments, and the field and word glue against ops/field.py and
  ops/convert.py.
- The slice stage by stage at n=64/c=8 (the inputs of test_precompute.py's
  fixed-base test) against one eager JAX run, module-scoped: its stages
  composed are precompute_fixed_base and fixed_base_total_rows for the one
  entry block they choose.  The block pads 2048 entries to 8192, so the
  padded entries' gather rows pass the table's end.
- The two-block run, the public entry points against compute_msm and a
  python-int reference, and a base made from the JAX package's table.
"""

import dataclasses
import os
import re
from unittest import mock

import jax.numpy as jnp
import numpy as np
import jax_kernel_cache
import pytest
import torch

from conftest import random_points_scalars
from webgpu_msm_twisted_edwards_tpu.ops import convert as JCV
from webgpu_msm_twisted_edwards_tpu.ops import field as JF
from webgpu_msm_twisted_edwards_tpu.ops import precompute as JPRE
from webgpu_msm_twisted_edwards_tpu.ops.pallas import convert as JPC
from webgpu_msm_twisted_edwards_tpu.ops.pallas import ec as JE
from webgpu_msm_twisted_edwards_tpu.ops.pallas import scan as JS
from webgpu_msm_twisted_edwards_tpu.utils import params as JP
from webgpu_msm_twisted_edwards_tpu_torch import (
    compute_msm,
    compute_msm_batch_precomputed,
    compute_msm_precomputed,
    precompute_msm_base,
)
from webgpu_msm_twisted_edwards_tpu_torch.cpu.curve import ExtPoint
from webgpu_msm_twisted_edwards_tpu_torch.models.cuzk import packed_rows_to_extpoints
from webgpu_msm_twisted_edwards_tpu_torch.ops import convert as CV
from webgpu_msm_twisted_edwards_tpu_torch.ops import field as F
from webgpu_msm_twisted_edwards_tpu_torch.ops import msm_pipeline as MP
from webgpu_msm_twisted_edwards_tpu_torch.ops import precompute as PRE
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import common as C
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import convert as KC
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import ec as KE
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import precompute as KP
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import scan as KS
from webgpu_msm_twisted_edwards_tpu_torch.utils.interop import (
    from_numpy_u32,
    precomputed_from_numpy,
    to_numpy_u32,
)
from webgpu_msm_twisted_edwards_tpu_torch.utils.limbs import ints_to_u32_words
from webgpu_msm_twisted_edwards_tpu_torch.utils.params import PARAMS, SUBGROUP_ORDER, MsmConfig

N = 64
CFG = MsmConfig(chunk_size=8, scalar_bits=253)
P = PARAMS.p


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops; with several test
    workers sharing the cores, torch's intra-op threads would mostly wait on
    each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _jax_kernels_compiled_once():
    """Repeated JAX kernel calls reuse one compile (tests/jax_kernel_cache.py)."""
    with jax_kernel_cache.cached():
        yield


def _eq(jax_out, port_out: torch.Tensor) -> None:
    want = np.asarray(jax_out)
    got = to_numpy_u32(port_out) if want.dtype == np.uint32 else port_out.numpy()
    np.testing.assert_array_equal(got, want)


def _coords(points) -> np.ndarray:
    return np.stack([ints_to_u32_words([p[0] for p in points]),
                     ints_to_u32_words([p[1] for p in points])], axis=1)


def _affine_points(n: int, seed: int) -> list[tuple[int, int]]:
    pts, _ = random_points_scalars(n, seed=seed)
    return [(p.x, p.y) for p in pts]


def _limbs(rng, n: int, bound: int) -> np.ndarray:
    """[n, L] uint32 normalized limbs of random values below `bound`."""
    vals = [int.from_bytes(rng.bytes(40), "little") % bound for _ in range(n)]
    return np.stack([C.int_to_limbs(v) for v in vals])


def _projective_rows(n: int, seed: int) -> np.ndarray:
    """[n, TW] uint32 packed Montgomery rows of curve points in projective
    form (x, y, t, z scaled by a random lambda), the last row all zero."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, KE.TW), dtype=np.uint32)
    for i, (x, y) in enumerate(_affine_points(n - 1, seed)):
        lam = int(rng.integers(1, 1 << 62)) * 7919 % P
        for ci, v in enumerate((x * lam, y * lam, x * y % P * lam, lam)):
            limbs = C.int_to_limbs(PARAMS.to_mont(v % P))
            rows[i, ci * 10:(ci + 1) * 10] = limbs[0::2] | (limbs[1::2] << 16)
    return rows


def _reference(points, scalars) -> tuple[int, int]:
    acc = ExtPoint.identity()
    for (x, y), k in zip(points, scalars):
        acc = acc.add(ExtPoint.from_affine(x, y).mul(k % SUBGROUP_ORDER))
    return acc.to_affine()


def _affine(rows: torch.Tensor) -> tuple[int, int]:
    return packed_rows_to_extpoints(to_numpy_u32(rows))[0].to_affine()


# ---------------------------------------------------------------------------
# The four kernels' plain versions against the JAX kernels.


def test_exponent_constant_matches_the_field():
    """csrc/precompute.cu spells out p - 2 for the Fermat loop."""
    path = os.path.join(os.path.dirname(KP.__file__), "..", "..", "csrc", "precompute.cu")
    src = open(path).read()
    body = re.search(r"C_EXP\[8\] = \{([^}]*)\}", src).group(1)
    words = [int(v, 16) for v in body.replace(",", " ").split()]
    assert sum(w << (32 * i) for i, w in enumerate(words)) == KP.EXP == P - 2
    assert int(re.search(r"#define MSM_EXP_BITS (\d+)", src).group(1)) == KP.EXP_BITS == 253


def _double_rows_bounds() -> tuple[int, int, int]:
    """Bounds on ops/kernels/ec.py::double's f and g and on the z = f*g it
    returns, iterated from canonical coordinates (the precompute's first
    rows) to their fixed point (double_rows feeds its rows back): a lazy
    product of inputs below u and v is below p + u*v/R (Q < R), a - b + 4p
    below a + 4p, 4p - a at most 4p."""
    r = 1 << (C.L * C.W)

    def prod(u, v):
        return P + u * v // r + 1

    b = P
    for _ in range(8):
        a, e_in = prod(b, b), prod(2 * b, 2 * b)
        d = 4 * P
        e, h, g = e_in + 4 * P, d + 4 * P, d + a
        f = g + 4 * P
        b = max(prod(e, f), prod(g, h), prod(e, h), prod(f, g))
    return f, g, prod(f, g)


def test_normalize_rows_plain_is_canonical_on_lazy_z():
    """The premise of the kernel's batch inversion (csrc/precompute.cu): on
    the lazy z that double_rows makes (below 1.21p), on z = p and on z = 0,
    normalize_rows_plain gives the canonical words of x*z^-1*R and y*z^-1*R
    mod p, and zeros where z = 0 mod p.  Canonical residues are unique, so
    any exact schedule of reduced products gives these words."""
    f, g, zb = _double_rows_bounds()
    assert 100 * f < 901 * P and 100 * g < 501 * P and 100 * zb < 121 * P
    rng = np.random.default_rng(21)
    zs = [int.from_bytes(rng.bytes(40), "little") % zb for _ in range(8)]
    zs += [zb - 1, P + 1, P, 0]
    xs = [int.from_bytes(rng.bytes(40), "little") % zb for _ in zs]
    ys = [int.from_bytes(rng.bytes(40), "little") % zb for _ in zs]
    rows = np.zeros((len(zs), KE.TW), dtype=np.uint32)
    for i, vals in enumerate(zip(xs, ys, ys, zs)):
        for ci, v in enumerate(vals):
            limbs = C.int_to_limbs(v)
            rows[i, ci * 10:(ci + 1) * 10] = limbs[0::2] | (limbs[1::2] << 16)
    got = to_numpy_u32(KP.normalize_rows_plain(from_numpy_u32(rows)))
    r = 1 << (C.L * C.W)
    for i, (x, y, z) in enumerate(zip(xs, ys, zs)):
        zinv = pow(z, -1, P) if z % P else 0
        for ci, v in enumerate((x * zinv * r % P, y * zinv * r % P)):
            word = got[i, ci * 10:(ci + 1) * 10].astype(np.int64)
            limbs = np.stack([word & 0xFFFF, word >> 16], axis=-1).reshape(-1)
            assert all(limbs < 1 << C.W)
            assert sum(int(l) << (C.W * k) for k, l in enumerate(limbs)) == v < P
        assert not got[i, 20:].any()


def test_build_table_pair_matches_jax():
    coords = _coords(_affine_points(128, 1))
    want = JPC.build_table_pair(jnp.asarray(coords), interpret=True)
    got = KC.build_table_pair(from_numpy_u32(coords))
    _eq(want[0], got[0])
    _eq(want[1], got[1])
    _eq(want[0], KC.build_table(from_numpy_u32(coords)))


def test_double_rows_matches_jax():
    rows = _projective_rows(128, 2)
    want = JE.double_rows(jnp.asarray(rows), 2, interpret=True)
    _eq(want, KE.double_rows(from_numpy_u32(rows), 2))


def test_normalize_rows_matches_jax():
    """Projective rows, and a zero row (z = 0 inverts to 0)."""
    rows = _projective_rows(128, 3)
    want = JPRE.normalize_rows(jnp.asarray(rows), interpret=True)
    _eq(want, KP.normalize_rows(from_numpy_u32(rows)))


def test_msm_scan_rm_signed_matches_jax():
    """128 fragments of single-table rows, sorted keys, mixed signs.  The
    table is the port's build_table, which test_build_table_pair_matches_jax
    holds to the JAX kernel's."""
    rng = np.random.default_rng(4)
    table = to_numpy_u32(KC.build_table(from_numpy_u32(_coords(_affine_points(64, 4)))))
    nf = 128
    rows = table[rng.integers(0, 64, size=nf * KS.K)].reshape(nf, KS.K, KS.TWR)
    keys = np.sort(rng.integers(0, 9, size=(KS.K, nf)), axis=0).astype(np.int32)
    sign = rng.integers(0, 2, size=(KS.K, nf)).astype(np.int32)
    bits = np.asarray(JS.keys_to_sames(jnp.asarray(keys))) | (sign << 1)
    want = JS.msm_scan_rm_signed(jnp.asarray(rows), jnp.asarray(bits), interpret=True)
    _eq(want, KS.msm_scan_rm_signed(from_numpy_u32(rows), torch.from_numpy(bits)))


# ---------------------------------------------------------------------------
# The glue JAX leaves to XLA.


@pytest.mark.parametrize("op", ["mont_mul", "to_mont", "from_mont"])
def test_field_glue_matches_jax(op):
    rng = np.random.default_rng(5)
    x, y = _limbs(rng, 96, P), _limbs(rng, 96, P)
    if op == "mont_mul":
        want, got = JF.mont_mul(jnp.asarray(x), jnp.asarray(y)), F.mont_mul(_t(x), _t(y))
    else:
        want, got = getattr(JF, op)(jnp.asarray(x)), getattr(F, op)(_t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_xla_product_is_the_kernels_reduced_product():
    """ops/field.py's product (carry-free, one final conditional subtraction)
    equals the kernels' reduced product over the lazy range (< 9p)."""
    rng = np.random.default_rng(6)
    x, y = _limbs(rng, 96, 9 * P), _limbs(rng, 96, 9 * P)
    want = np.asarray(JF.mont_mul(jnp.asarray(x), jnp.asarray(y))).astype(np.int64)
    got = C.mont_mul(_t(x).T, _t(y).T, C.load_consts("cpu").p, reduce=True).T
    np.testing.assert_array_equal(got.numpy(), want)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


def test_word_and_limb_glue_matches_jax():
    coords = _coords(_affine_points(32, 7))
    words = coords.reshape(-1, 8)
    limbs = CV.u32_words_to_limbs(from_numpy_u32(words))
    np.testing.assert_array_equal(limbs.numpy(), np.asarray(JCV.u32_words_to_limbs(
        jnp.asarray(words))).astype(np.int64))
    np.testing.assert_array_equal(CV.limbs_to_u32_words(limbs).numpy(), words.astype(np.int64))
    want = JCV.points_to_mont_limbs(jnp.asarray(coords))
    for w, g in zip(want, CV.points_to_mont_limbs(from_numpy_u32(coords))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


# ---------------------------------------------------------------------------
# The slice, stage by stage, against one JAX run at n=64, c=8.


@pytest.fixture(scope="module")
def jax_run():
    """Eager JAX stages, Pallas kernels in interpret mode.  c=8 over 253
    bits is 32 windows: 2048 merged entries, one block of 8192."""
    pts, scalars = random_points_scalars(N, seed=93)
    points = [(p.x, p.y) for p in pts]
    coords, sc = _coords(points), ints_to_u32_words(scalars)
    cfg = JP.MsmConfig(chunk_size=8, scalar_bits=253)
    merged = JPRE.shifted_base_coords(jnp.asarray(coords), cfg, interpret=True)
    table = JPRE._stage_merged_table(merged, interpret=True)
    nblk, blocks = JPRE.default_entry_block(cfg.num_windows * N, table.size * 4)
    digits = JPRE._stage_merged_digits(jnp.asarray(sc), chunk_size=8, scalar_bits=253,
                                       pad_to=nblk * blocks, interpret=True)
    buckets = JPRE._stage_merged_block(table, digits, np.int32(0), nb=cfg.num_buckets,
                                       nblk=nblk, interpret=True)
    total = JPRE._stage_merged_total(buckets, interpret=True)
    out = {k: np.asarray(v) for k, v in (("merged", merged), ("table", table),
                                         ("digits", digits), ("buckets", buckets),
                                         ("total", total))}
    out.update(points=points, scalars=scalars, coords=coords, sc=sc, nblk=nblk, blocks=blocks)
    return out


@pytest.fixture(scope="module")
def port(jax_run):
    """The port's precompute.  The doubling and normalization chain runs
    once: precompute_fixed_base gets its merged coordinates."""
    coords = from_numpy_u32(jax_run["coords"])
    merged = PRE.shifted_base_coords(coords, CFG)
    with mock.patch.object(PRE, "shifted_base_coords", return_value=merged) as shifted:
        pre = PRE.precompute_fixed_base(coords, CFG)
    shifted.assert_called_once_with(coords, CFG)
    return {"merged": merged, "pre": pre}


def test_merged_coords_match_jax(jax_run, port):
    """Window j holds 2^(8j) * P_i: double_rows, normalize_rows, from_mont
    and the word repack, 31 times."""
    _eq(jax_run["merged"], port["merged"])


def test_table_and_blocks_match_jax(jax_run, port):
    pre = port["pre"]
    _eq(jax_run["table"], pre.table)
    assert (pre.n, pre.nblk, pre.blocks) == (N, jax_run["nblk"], jax_run["blocks"]) == (N, 8192, 1)
    assert pre.n_entries == 2048 and pre.table_bytes == 2048 * KS.TWR * 4


def test_digits_match_jax(jax_run):
    got = PRE._stage_merged_digits(from_numpy_u32(jax_run["sc"]), CFG, jax_run["nblk"])
    _eq(jax_run["digits"], got)


def test_block_bucket_rows_match_jax(jax_run):
    """The JAX table and digits in: sort, histogram, gather with the padded
    entries past the table's 2048 rows, signed scan, carries, extraction."""
    got = PRE._stage_merged_block(from_numpy_u32(jax_run["table"]),
                                  torch.from_numpy(jax_run["digits"].copy()), 0, CFG.num_buckets,
                                  jax_run["nblk"])
    _eq(jax_run["buckets"], got)


def test_total_rows_match_jax(jax_run, port):
    _eq(jax_run["total"], PRE._stage_merged_total(from_numpy_u32(jax_run["buckets"])))
    total = PRE.fixed_base_total_rows(port["pre"], from_numpy_u32(jax_run["sc"]))
    _eq(jax_run["total"], total)
    assert _affine(total) == _reference(jax_run["points"], jax_run["scalars"])


def test_precomputed_from_numpy_runs_on_the_jax_table(jax_run):
    pre = precomputed_from_numpy(jax_run["table"], 8, N, jax_run["nblk"], jax_run["blocks"],
                                 "cpu")
    assert pre.cfg == CFG and pre.table.dtype == torch.int32
    _eq(jax_run["total"], PRE.fixed_base_total_rows(pre, from_numpy_u32(jax_run["sc"])))


def test_two_blocks_equal_one_block(jax_run, port):
    """Two entry blocks of 1024: their bucket arrays add row by row, so the
    total is the same group element (another projective representative)."""
    pre2 = dataclasses.replace(port["pre"], nblk=1024, blocks=2)
    total = PRE.fixed_base_total_rows(pre2, from_numpy_u32(jax_run["sc"]))
    assert _affine(total) == _affine(from_numpy_u32(jax_run["total"]))


def test_without_table_base_the_table_must_be_doubled(jax_run):
    """Without table_base the table's row count selects the mode, as in the
    JAX package: 2n rows doubled, n rows single (read as table_base=0
    reads it); any other count is refused rather than misread."""
    digits = torch.from_numpy(jax_run["digits"][:N].copy())[None, :]
    with pytest.raises(ValueError, match=f"expected {N} \\(single\\) or {2 * N}"):
        MP.window_group_bucket_sums(from_numpy_u32(jax_run["table"][:N // 2]), digits, 256)
    table = from_numpy_u32(jax_run["table"][:N])
    assert torch.equal(MP.window_group_bucket_sums(table, digits, 256),
                       MP.window_group_bucket_sums(table, digits, 256, table_base=0))


# ---------------------------------------------------------------------------
# Entry points.


def test_compute_msm_precomputed_matches_compute_msm_and_reference(jax_run, port):
    """48 scalars (padded with zeros to the base's 64 points), some >= the
    subgroup order; then a batch of two."""
    points = jax_run["points"]
    scalars = list(jax_run["scalars"][:48])
    scalars[0] += SUBGROUP_ORDER
    scalars[1] = (1 << 256) - 1
    want = _reference(points[:48], scalars)
    got = compute_msm_precomputed(port["pre"], scalars)
    assert (got["x"], got["y"]) == want
    pad = 512 - 48
    assert compute_msm(points[:48] + [points[0]] * pad, scalars + [0] * pad, chunk_size=8,
                       device="cpu") == got
    batch = compute_msm_batch_precomputed(port["pre"], [scalars, [1] * N])
    assert batch[0] == got
    assert (batch[1]["x"], batch[1]["y"]) == _reference(points, [1] * N)


def test_precompute_msm_base_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        precompute_msm_base(_affine_points(8, 10))


def test_default_entry_block_matches_jax(monkeypatch):
    """At 2^20 points and c=16 a 16 GiB device needs four blocks; 80 GB fits
    the 2^24 merged entries in one."""
    import webgpu_msm_twisted_edwards_tpu.utils.runtime as jax_runtime

    n_entries = 16 << 20
    table_bytes = n_entries * KS.TWR * 4
    for mem, blocks in ((16 << 30, 4), (80 * 10**9, 1)):
        monkeypatch.setattr(jax_runtime, "device_memory_bytes", lambda *a, mem=mem: mem)
        monkeypatch.setattr(PRE, "device_memory_bytes", lambda *a, mem=mem: mem)
        got = PRE.default_entry_block(n_entries, table_bytes)
        assert got == JPRE.default_entry_block(n_entries, table_bytes)
        assert got[1] == blocks
