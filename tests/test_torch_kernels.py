"""The plain PyTorch version of each ported kernel against its JAX function,
bit for bit (tolerance 0: integer arithmetic).

The JAX side runs its Pallas kernels in interpret mode on the CPU, at the
small shapes of test_pallas_kernels.py; the port's wrappers take their plain
versions because the tensors lie on the CPU.  Inputs are made with numpy
from fixed seeds and handed to both.
"""

import jax.numpy as jnp
import numpy as np
import jax_kernel_cache
import pytest
import torch

from webgpu_msm_twisted_edwards_tpu.ops.pallas import bpr as JB
from webgpu_msm_twisted_edwards_tpu.ops.pallas import convert as JCV
from webgpu_msm_twisted_edwards_tpu.ops.pallas import ec as JE
from webgpu_msm_twisted_edwards_tpu.ops.pallas import gather as JG
from webgpu_msm_twisted_edwards_tpu.ops.pallas import hist as JH
from webgpu_msm_twisted_edwards_tpu.ops.pallas import scan as JS
from webgpu_msm_twisted_edwards_tpu_torch.cpu.curve import GENERATOR
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import _build
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import bpr as B
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import convert as CV
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import ec as E
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import gather as G
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import hist as H
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import scan as S
from webgpu_msm_twisted_edwards_tpu_torch.utils.interop import from_numpy_u32, to_numpy_u32
from webgpu_msm_twisted_edwards_tpu_torch.utils.limbs import ints_to_u32_words
from webgpu_msm_twisted_edwards_tpu_torch.utils.params import PARAMS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions issue many small tensor ops; with several test
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


def _affine_points(n: int, seed: int):
    pt, step = GENERATOR.mul(seed * 7919 + 1), GENERATOR.mul(seed * 104729 + 3)
    out = []
    for _ in range(n):
        out.append(pt.to_affine())
        pt = pt.add(step)
    return out


def _coords(n: int, seed: int) -> np.ndarray:
    pts = _affine_points(n, seed)
    return np.stack([ints_to_u32_words([p[0] for p in pts]),
                     ints_to_u32_words([p[1] for p in pts])], axis=1)


def _point_rows(n: int, seed: int) -> np.ndarray:
    """[n, 64] uint32 packed Montgomery rows of real curve points."""
    rows = np.zeros((n, E.TW), dtype=np.uint32)
    for i, (x, y) in enumerate(_affine_points(n, seed)):
        for ci, v in enumerate((x, y, x * y % PARAMS.p, 1)):
            m = PARAMS.to_mont(v)
            limbs = [(m >> (13 * j)) & PARAMS.mask for j in range(20)]
            for j in range(10):
                rows[i, ci * 10 + j] = limbs[2 * j] | (limbs[2 * j + 1] << 16)
    return rows


def _eq(jax_out, port_out: torch.Tensor) -> None:
    want = np.asarray(jax_out)
    got = to_numpy_u32(port_out) if want.dtype == np.uint32 else port_out.numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def table():
    """A doubled table of 64 real points, as uint32 (from the JAX kernel)."""
    return np.asarray(JCV.build_table_doubled(jnp.asarray(_coords(64, 1)), interpret=True))


def test_build_table_doubled(table):
    _eq(table, CV.build_table_doubled(from_numpy_u32(_coords(64, 1))))


def test_bucket_counts_sentinels_and_empty_buckets():
    rng = np.random.default_rng(5)
    wg, n, nb = 3, 512, 256
    keys = rng.integers(0, nb + 1, size=(wg, n)).astype(np.int32)
    keys[0, :100] = 7
    keys[1, :] = nb
    keys[2, :] = np.sort(keys[2]) % 50                     # buckets 50.. empty
    want = JH.bucket_counts(jnp.asarray(keys), nb, interpret=True)
    _eq(want, H.bucket_counts(torch.from_numpy(keys), nb))


def test_row_gather(table):
    rng = np.random.default_rng(6)
    pidx_t = rng.integers(0, table.shape[0], size=(S.K, 128)).astype(np.int32)
    want = JG.dma_row_gather(jnp.asarray(table), jnp.asarray(pidx_t), interpret=True)
    _eq(want, G.row_gather(from_numpy_u32(table), torch.from_numpy(pidx_t)))


def test_msm_scan_rm_sames(table):
    rng = np.random.default_rng(7)
    nf = 128
    pidx = rng.integers(0, table.shape[0], size=nf * S.K)
    rows = table[pidx].reshape(nf, S.K, S.TWR)
    keys = np.sort(rng.integers(0, 9, size=(S.K, nf)), axis=0).astype(np.int32)
    sames = np.array(JS.keys_to_sames(jnp.asarray(keys)))
    _eq(sames, S.keys_to_sames(torch.from_numpy(keys)))
    want = JS.msm_scan_rm_sames(jnp.asarray(rows), jnp.asarray(sames), interpret=True)
    _eq(want, S.msm_scan_rm_sames(from_numpy_u32(rows), torch.from_numpy(sames)))


def test_ab_scan_level():
    rng = np.random.default_rng(8)
    a = rng.integers(0, 2, size=16).astype(np.int32)
    b = _point_rows(16, 8)
    want = JS.ab_scan_level(jnp.asarray(a), jnp.asarray(b), 8, interpret=True)
    got = S.ab_scan_level(torch.from_numpy(a), from_numpy_u32(b), 8)
    for w, g in zip(want, got):
        _eq(w, g)


def test_seg_carry_scan_recursion():
    """n > kab: two levels, the chunk padding (10 steps to 12), and the
    masked-add carry apply."""
    rng = np.random.default_rng(9)
    n = 10
    a = rng.integers(0, 2, size=n).astype(np.int32)
    b = _point_rows(n, 9)
    want = JS.seg_carry_scan(jnp.asarray(a), jnp.asarray(b), kab=4, interpret=True)
    _eq(want, S.seg_carry_scan(torch.from_numpy(a), from_numpy_u32(b), kab=4))


def test_masked_add_rows():
    """Unset rows pass through with their padding words zeroed."""
    a, b = _point_rows(8, 10), _point_rows(8, 11)
    a[:, 4 * 10:] = np.arange(8 * (E.TW - 40), dtype=np.uint32).reshape(8, -1) + 1
    mask = np.array([1, 0, 1, 1, 0, 1, 0, 1], dtype=np.int32)
    want = JE.masked_add_rows(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask),
                              interpret=True)
    _eq(want, E.masked_add_rows(from_numpy_u32(a), from_numpy_u32(b), torch.from_numpy(mask)))


def test_bpr_stages():
    """Stage 1, stage 2 (two chunks per window) and the per-window
    reduction, each fed the JAX stage's input."""
    w, nb = 2, 128
    buckets = _point_rows(w * nb, 12)
    jm, jg = JB.bpr_stage1(jnp.asarray(buckets), interpret=True)
    m, g = B.bpr_stage1(from_numpy_u32(buckets))
    _eq(jm, m)
    _eq(jg, g)
    jg2 = JB.bpr_stage2(jm, jg, 2, interpret=True)
    g2 = B.bpr_stage2(m, g, 2)
    _eq(jg2, g2)
    _eq(JB.reduce_rows_per_window(jg2, 2, interpret=True), B.reduce_rows_per_window(g2, 2))


@pytest.mark.parametrize("w,per_window", [(2, 2), (2, 8)])
def test_reduce_rows_per_window(w, per_window):
    """The per-window reduction alone, in one round (per_window = 2) and in
    three (per_window = 8): each round adds the second half of every
    window's rows to its first half."""
    rows = _point_rows(w * per_window, 15)
    want = JB.reduce_rows_per_window(jnp.asarray(rows), per_window, interpret=True)
    _eq(want, B.reduce_rows_per_window(from_numpy_u32(rows), per_window))


def test_horner_fold_identity_padding():
    """W = 5 windows are padded with identity rows to 8 lanes."""
    sums = _point_rows(5, 13)
    want = JB.horner_fold(jnp.asarray(sums), 13, interpret=True)
    _eq(want, B.horner_fold(from_numpy_u32(sums), 13))


def test_library_hash_covers_the_headers_it_includes():
    """A library's name hashes its source and the headers that source
    includes, so an edit to the probes' header rebuilds only the probes."""
    assert set(_build._sources("scan")) == {"scan.cu", "scan.cuh", "ec26.cuh", "field.cuh",
                                            "field26.cuh"}
    assert "probe_scan.cuh" not in _build._sources("scan_variants")
    assert {"probe_scan.cuh", "scan.cuh"} <= set(_build._sources("probe_move"))
    assert _build._sources("hist") == ["hist.cu"]
