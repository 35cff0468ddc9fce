"""The port's host mirrors cpu/matrices.py and cpu/preaggregation.py against
the JAX package's, on the same inputs: the dense / ELL / CSR round trip,
transpose, smvp and smtvp with string concatenation as the group operation
(as the cuZK reference's CSR tests do), the serial cuZK MSM, and the
pre-aggregated CSR.  Exact: equal strings, equal python-int points.
"""

import random

import pytest

from webgpu_msm_twisted_edwards_tpu.cpu import curve as JCURVE
from webgpu_msm_twisted_edwards_tpu.cpu import matrices as JM
from webgpu_msm_twisted_edwards_tpu.cpu import preaggregation as JP
from webgpu_msm_twisted_edwards_tpu.utils.params import MsmConfig as JMsmConfig
from webgpu_msm_twisted_edwards_tpu_torch.cpu import matrices as M
from webgpu_msm_twisted_edwards_tpu_torch.cpu import preaggregation as P
from webgpu_msm_twisted_edwards_tpu_torch.cpu.curve import GENERATOR, ExtPoint
from webgpu_msm_twisted_edwards_tpu_torch.utils.params import SUBGROUP_ORDER, MsmConfig


def _add(a, b):
    return a + b


def _scale(elem, v):
    return elem * v


def _fields(m) -> tuple:
    return tuple(getattr(m, f) for f in m.__dataclass_fields__)


def _random_dense(rng: random.Random, rows: int, cols: int) -> list[list]:
    """Entries "r<i>c<j>", about a third of them None (zero)."""
    return [[None if rng.random() < 0.35 else f"r{i}c{j}" for j in range(cols)]
            for i in range(rows)]


@pytest.mark.parametrize("shape", [(3, 3), (5, 8), (9, 4), (1, 6)])
def test_matrices_match_jax(shape):
    rows, cols = shape
    data = _random_dense(random.Random(rows * 31 + cols), rows, cols)
    dense, jdense = M.DenseMatrix(data), JM.DenseMatrix(data)
    assert dense.transpose().data == jdense.transpose().data
    vec = [1 + i % 3 for i in range(cols)]
    assert dense.matrix_vec_mult(vec, _add, _scale) == jdense.matrix_vec_mult(vec, _add, _scale)

    ell = M.ELLSparseMatrix.dense_to_sparse_matrix(dense)
    assert _fields(ell) == _fields(JM.ELLSparseMatrix.dense_to_sparse_matrix(jdense))
    csr = M.CSRSparseMatrix.ell_to_csr(ell, cols)
    jcsr = JM.CSRSparseMatrix.ell_to_csr(JM.ELLSparseMatrix.dense_to_sparse_matrix(jdense), cols)
    assert _fields(csr) == _fields(jcsr) and csr.num_rows == jcsr.num_rows == rows
    t, jt = csr.transpose(), jcsr.transpose()
    assert _fields(t) == _fields(jt)
    assert _fields(t.transpose()) == _fields(csr)
    rvec = [1 + i % 2 for i in range(rows)]
    assert csr.smvp(vec, _add, _scale) == jcsr.smvp(vec, _add, _scale)
    assert csr.smtvp(rvec, _add, _scale) == jcsr.smtvp(rvec, _add, _scale)
    # The transposed product is the product of the transpose.
    assert csr.smtvp(rvec, _add, _scale) == t.smvp(rvec, _add, _scale)


def test_string_mock_values():
    """The values the cuZK reference's CSR test expects."""
    dense = M.DenseMatrix([["a", None, "b"], [None, "c", None], ["d", "e", None]])
    csr = M.CSRSparseMatrix.ell_to_csr(M.ELLSparseMatrix.dense_to_sparse_matrix(dense), 3)
    assert (csr.data, csr.row_ptr) == (["a", "b", "c", "d", "e"], [0, 2, 3, 5])
    assert (csr.transpose().data, csr.transpose().col_idx) == (["a", "d", "c", "e", "b"],
                                                               [0, 2, 1, 2, 0])
    assert csr.smvp([1, 1, 1], _add, _scale) == ["ab", "c", "de"]
    assert csr.smtvp([1, 1, 1], _add, _scale) == ["ad", "ce", "b"]


@pytest.mark.parametrize("n,c", [(24, 4), (9, 6)])
def test_serial_cuzk_matches_jax(n, c):
    rng = random.Random(n + c)
    pts = [GENERATOR.mul(rng.randrange(1, SUBGROUP_ORDER)) for _ in range(n)]
    scalars = [rng.randrange(0, SUBGROUP_ORDER) for _ in range(n)]
    scalars[0] = 0
    got = M.execute_serial_cuzk([ExtPoint.from_affine(*p.to_affine()) for p in pts], scalars,
                                MsmConfig(chunk_size=c))
    want = JM.execute_serial_cuzk([JCURVE.ExtPoint.from_affine(*p.to_affine()) for p in pts],
                                  scalars, JMsmConfig(chunk_size=c))
    naive = ExtPoint.identity()
    for p, k in zip(pts, scalars):
        naive = naive.add(p.mul(k))
    assert got.to_affine() == want.to_affine() == naive.to_affine()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_preaggregation_matches_jax(seed):
    rng = random.Random(seed)
    n, nb = 12 + seed, 4 + 2 * seed
    points = [f"P{i}" for i in range(n)]
    chunks = [rng.randrange(0, nb + 1) for _ in range(n)]
    clusters = P.precompute_with_cluster_method(chunks, n)
    assert clusters == JP.precompute_with_cluster_method(chunks, n)
    assert P.pre_aggregate(points, clusters, _add) == JP.pre_aggregate(points, clusters, _add)
    csr = P.create_csr_cpu(points, chunks, nb, _add)
    assert _fields(csr) == _fields(JP.create_csr_cpu(points, chunks, nb, _add))
    # One row, each bucket at most once, in bucket order.
    assert csr.row_ptr == [0, len(csr.data)] and csr.col_idx == sorted(set(csr.col_idx))


def test_preaggregation_string_mock():
    points, chunks = ["P0", "P1", "P2", "P3", "P4"], [3, 1, 3, 0, 1]
    assert P.precompute_with_cluster_method(chunks, 5) == {3: [0, 2], 1: [1, 4]}
    csr = P.create_csr_cpu(points, chunks, num_buckets=4, add=_add)
    assert (csr.data, csr.col_idx, csr.row_ptr) == (["P1P4", "P0P2"], [0, 2], [0, 2])
