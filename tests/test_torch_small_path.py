"""The port's small-input path (plain torch ops) against the JAX package's
pure-XLA pipeline, on the CPU.

- Bit for bit (tolerance 0: integer limbs) on numpy inputs made from a seed:
  the field ops, the curve ops, sort_buckets and accumulate_buckets,
  reduce_buckets, and msm_window_sums_device, whose JAX counterpart
  _jitted_pipeline(4, 256) compiles once for the module; the JAX
  compute_msm_batch reuses that program off the TPU.
- compute_msm outside the bucket pipeline against python-int sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pipeline import _packed, _points, _reference_msm, _scalars

from webgpu_msm_twisted_edwards_tpu.models import cuzk as JCZ
from webgpu_msm_twisted_edwards_tpu.ops import bpr as JBPR
from webgpu_msm_twisted_edwards_tpu.ops import buckets as JB
from webgpu_msm_twisted_edwards_tpu.ops import curve as JC
from webgpu_msm_twisted_edwards_tpu.ops import field as JF
from webgpu_msm_twisted_edwards_tpu_torch import compute_msm, compute_msm_batch
from webgpu_msm_twisted_edwards_tpu_torch.models import cuzk
from webgpu_msm_twisted_edwards_tpu_torch.ops import bpr as BPR
from webgpu_msm_twisted_edwards_tpu_torch.ops import buckets as B
from webgpu_msm_twisted_edwards_tpu_torch.ops import curve as C
from webgpu_msm_twisted_edwards_tpu_torch.ops import field as F
from webgpu_msm_twisted_edwards_tpu_torch.ops.convert import (
    decompose_scalars_signed,
    points_to_mont_limbs,
)
from webgpu_msm_twisted_edwards_tpu_torch.utils.interop import from_numpy_u32
from webgpu_msm_twisted_edwards_tpu_torch.utils.params import PARAMS, MsmConfig

CFG4 = MsmConfig(chunk_size=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain ops are many small tensor ops; with several test workers
    sharing the cores, torch's intra-op threads would mostly wait on each
    other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _field_limbs(rng, n: int) -> np.ndarray:
    """[n, 20] uint32 limbs of values below p: 0 and p - 1 first."""
    vals = [0, PARAMS.p - 1] + [int.from_bytes(rng.bytes(32), "little") % PARAMS.p
                                for _ in range(n - 2)]
    return np.array([[(v >> (13 * i)) & 0x1FFF for i in range(20)] for v in vals],
                    dtype=np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


def _eq(want, got: torch.Tensor) -> None:
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64), got.numpy())


def _eq_points(want, got: C.PointXYTZ) -> None:
    for w, g in zip((want.x, want.y, want.t, want.z), got):
        _eq(w, g)


def _jpoint(p: C.PointXYTZ):
    return JC.PointXYTZ(*(jnp.asarray(u.numpy().astype(np.uint32)) for u in p))


def _mont_points(n: int, seed: int) -> C.PointXYTZ:
    """n curve points in Montgomery form, z = R."""
    coords, _ = _packed(_points(n, seed), [0] * n)
    x, y, t = points_to_mont_limbs(from_numpy_u32(coords))
    return C.PointXYTZ(x, y, t, F.r_limbs().expand_as(x))


FIELD_OPS = ["limb constants", "add", "sub", "geq", "mont_mul", "neg", "cond_sub_p",
             "mont_sqr", "mont_inv", "mont_inv_batch", "is_zero", "select"]


@pytest.mark.parametrize("op", FIELD_OPS)
def test_field_op_matches_jax(op):
    """64 elements, 0 and p - 1 among them, against a permutation with more
    zeros and one equal element: equal values, zero differences, carries
    and borrows all occur."""
    rng = np.random.default_rng(3)
    a = _field_limbs(rng, 64)
    b = a[rng.permutation(64)]
    b[5:9] = 0
    b[10] = a[10]
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), _t(a), _t(b)
    if op == "limb constants":
        for name in ("p_limbs", "r_limbs", "r2_limbs", "one_limbs"):
            _eq(getattr(JF, name)(), getattr(F, name)())
        _eq(JC.edwards_d_mont_limbs(), C.edwards_d_mont_limbs())
    elif op in ("add", "sub", "geq", "mont_mul"):
        _eq(getattr(JF, op)(ja, jb), getattr(F, op)(ta, tb))
    elif op == "mont_inv_batch":
        _eq(JF.mont_inv_batch(jb.reshape(4, 16, 20)), F.mont_inv_batch(tb.reshape(4, 16, 20)))
    elif op == "select":
        mask = rng.integers(0, 2, 64).astype(bool)
        _eq(JF.select(jnp.asarray(mask), ja, jb), F.select(torch.from_numpy(mask), ta, tb))
    else:
        _eq(getattr(JF, op)(jb), getattr(F, op)(tb))


CURVE_OPS = ["add", "double", "negate", "select", "add_masked", "scale_u32", "tree_reduce_axis"]


@pytest.mark.parametrize("op", CURVE_OPS)
def test_curve_op_matches_jax(op):
    """8 points (the identity among them); the tree over 5 lanes pads to 8."""
    p, q = _mont_points(8, 21), _mont_points(8, 22)
    ident = C.identity((1,))
    q = C.PointXYTZ(*(torch.cat([u[:7], v]) for u, v in zip(q, ident)))
    jp, jq = _jpoint(p), _jpoint(q)
    mask = torch.tensor([1, 0, 1, 1, 0, 0, 1, 0], dtype=torch.bool)
    jmask = jnp.asarray(mask.numpy())
    if op == "add":
        _eq_points(JC.add(jp, jq), C.add(p, q))
    elif op == "double":
        _eq_points(JC.double(jq), C.double(q))
    elif op == "negate":
        _eq_points(JC.negate(jq), C.negate(q))
    elif op == "select":
        _eq_points(JC.select(jmask, jp, jq), C.select(mask, p, q))
    elif op == "add_masked":
        _eq_points(JC.add_masked(jp, jq, jmask), C.add_masked(p, q, mask))
    elif op == "scale_u32":
        k = np.array([0, 1, 2, 3, 5, 8, 13, 15], dtype=np.uint32)
        _eq_points(JC.scale_u32(jp, jnp.asarray(k), 4), C.scale_u32(p, _t(k), 4))
    else:
        five = C.PointXYTZ(*(u[:5].reshape(5, 1, 20) for u in p))
        _eq_points(JC.tree_reduce_axis(_jpoint(five), axis=0), C.tree_reduce_axis(five, axis=0))


def test_sort_and_accumulate_buckets_match_jax():
    """n = 32, c = 4 (a zero scalar, so zero digits take the sentinel): the
    stable sort's keys, indices and signs, the starts and counts, then the
    [W, 8] bucket sums."""
    n = 32
    scalars = _scalars(n, 23)
    scalars[4] = 0
    coords, sc = _packed(_points(n, 23), scalars)
    digits = decompose_scalars_signed(from_numpy_u32(sc), CFG4)
    want = JB.sort_buckets(jnp.asarray(digits.numpy()), CFG4)
    got = B.sort_buckets(digits, CFG4)
    for w, g in zip(want, got):
        _eq(w, g)
    x, y, t = points_to_mont_limbs(from_numpy_u32(coords))
    points = C.PointXYTZ(x, y, t, F.r_limbs().expand_as(x))
    _eq_points(JB.accumulate_buckets(_jpoint(points), want), B.accumulate_buckets(points, got))


def test_reduce_buckets_matches_jax():
    """[4, 8] buckets in 4 chunks of 2: running sums, the fix-up by
    double-and-add, and the tree over the chunks."""
    pts = _mont_points(32, 24)
    buckets = C.PointXYTZ(*(u.reshape(4, 8, 20) for u in pts))
    _eq_points(JBPR.reduce_buckets(_jpoint(buckets), num_chunks=4),
               BPR.reduce_buckets(buckets, num_chunks=4))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX pipeline at n = 64, c = 4, bpr_chunks = 256, compiled once."""
    n = 64
    points = _points(n, 25)
    vectors = [_scalars(n, 25), _scalars(n, 26)]
    vectors[0][2] = 0
    coords, sc = _packed(points, vectors[0])
    sums = JCZ._jitted_pipeline(4, 256)(jnp.asarray(coords), jnp.asarray(sc))
    return {"points": points, "vectors": vectors, "coords": coords, "sc": sc, "sums": sums}


def test_msm_window_sums_device_matches_jax(jax_run):
    sums = cuzk.msm_window_sums_device(from_numpy_u32(jax_run["coords"]),
                                       from_numpy_u32(jax_run["sc"]), CFG4, bpr_chunks=256)
    _eq_points(jax_run["sums"], sums)


def test_compute_msm_batch_small_path_matches_jax(jax_run, monkeypatch):
    """Two vectors at n = 64, c = 4: the JAX batch runs the compiled
    pipeline once a vector off the TPU, the port's the small-input path;
    one guard for both vectors."""
    guards = []
    guard = cuzk.reduce_scalars_mod_order
    monkeypatch.setattr(cuzk, "reduce_scalars_mod_order",
                        lambda sc: (guards.append(sc.shape[0]), guard(sc))[1])
    want = JCZ.compute_msm_batch(jax_run["points"], jax_run["vectors"], chunk_size=4)
    got = compute_msm_batch(jax_run["points"], jax_run["vectors"], chunk_size=4, device="cpu")
    assert got == want
    assert guards == [128]


def test_small_path_all_equal_scalars():
    """n = 64, c = 4, every scalar equal: in each window one bucket takes
    every entry, so accumulation runs 64 rounds."""
    points = _points(64, 27)
    s = _scalars(1, 27)[0]
    got = compute_msm(points, [s] * 64, chunk_size=4, device="cpu")
    assert (got["x"], got["y"]) == _reference_msm(points, [s] * 64)


def test_small_path_forced_at_the_bucket_pipeline_size():
    """use_kernels=False at n = 512, c = 8 equals the bucket pipeline."""
    points, scalars = _points(512, 28), _scalars(512, 28)
    got = compute_msm(points, scalars, chunk_size=8, use_kernels=False, device="cpu")
    assert got == compute_msm(points, scalars, chunk_size=8, device="cpu")


def test_bucket_pipeline_needs_windows_of_8_bits():
    with pytest.raises(ValueError, match="c >= 8"):
        compute_msm(_points(8, 29), [1] * 8, chunk_size=4, use_kernels=True, device="cpu")
