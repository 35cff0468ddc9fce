"""Dense, ELL and CSR sparse matrices over group elements, and the serial
cuZK MSM built on them: the host mirror of the cuZK data structures.

The matrices hold arbitrary group elements: any values with an `add` and a
`scale` given by the caller (cpu/curve.py's ExtPoint, or strings joined by
concatenation in the tests), None standing for zero.
execute_serial_cuzk runs one MSM through them window by window: an ELL
matrix with one row per point and one entry at column |digit| - 1, its CSR
form, the transpose (CSC), a sparse matrix-vector product by all ones for
the bucket sums, the running-sum bucket reduction and Horner's rule.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

from ..utils.params import MsmConfig
from .curve import ExtPoint
from .mirrors import decompose_scalars_signed


@dataclass
class DenseMatrix:
    """Row-major dense matrix of group elements or None (zero)."""

    data: list[list[Any]]

    @property
    def num_rows(self) -> int:
        return len(self.data)

    @property
    def num_cols(self) -> int:
        return len(self.data[0]) if self.data else 0

    def transpose(self) -> "DenseMatrix":
        return DenseMatrix([[self.data[r][c] for r in range(self.num_rows)]
                            for c in range(self.num_cols)])

    def matrix_vec_mult(self, vec: Sequence[Any], add, scale) -> list[Any]:
        """y_r = sum_c data[r][c] * vec[c] with the caller's add and scale."""
        out = []
        for row in self.data:
            acc = None
            for elem, v in zip(row, vec):
                if elem is None:
                    continue
                term = scale(elem, v)
                acc = term if acc is None else add(acc, term)
            out.append(acc)
        return out


@dataclass
class ELLSparseMatrix:
    """ELL format: per row, the values and column indices of its non-zeros."""

    data: list[list[Any]]
    col_idx: list[list[int]]
    row_length: list[int]

    @classmethod
    def dense_to_sparse_matrix(cls, dense: DenseMatrix) -> "ELLSparseMatrix":
        data, col_idx, row_length = [], [], []
        for row in dense.data:
            vals, cols = [], []
            for c, elem in enumerate(row):
                if elem is not None:
                    vals.append(elem)
                    cols.append(c)
            data.append(vals)
            col_idx.append(cols)
            row_length.append(len(vals))
        return cls(data, col_idx, row_length)


@dataclass
class CSRSparseMatrix:
    """CSR format: the non-zeros row by row, their columns, and each row's
    start in them (row_ptr, num_rows + 1 entries)."""

    data: list[Any]
    col_idx: list[int]
    row_ptr: list[int]
    num_cols: int

    @classmethod
    def ell_to_csr(cls, ell: ELLSparseMatrix, num_cols: int) -> "CSRSparseMatrix":
        data, col_idx, row_ptr = [], [], [0]
        for vals, cols in zip(ell.data, ell.col_idx):
            data.extend(vals)
            col_idx.extend(cols)
            row_ptr.append(len(data))
        return cls(data, col_idx, row_ptr, num_cols)

    @property
    def num_rows(self) -> int:
        return len(self.row_ptr) - 1

    def transpose(self) -> "CSRSparseMatrix":
        """Serial CSR -> CSC transpose: a histogram of the columns, its
        prefix sum, then a scatter of each entry to its column's cursor
        (rows in order, so each new row keeps its entries' row order)."""
        counts = [0] * self.num_cols
        for c in self.col_idx:
            counts[c] += 1
        new_row_ptr = [0]
        for c in counts:
            new_row_ptr.append(new_row_ptr[-1] + c)
        cursor = list(new_row_ptr[:-1])
        new_data = [None] * len(self.data)
        new_col_idx = [0] * len(self.data)
        for r in range(self.num_rows):
            for k in range(self.row_ptr[r], self.row_ptr[r + 1]):
                c = self.col_idx[k]
                pos = cursor[c]
                cursor[c] += 1
                new_data[pos] = self.data[k]
                new_col_idx[pos] = r
        return CSRSparseMatrix(new_data, new_col_idx, new_row_ptr, self.num_rows)

    def smvp(self, vec: Sequence[Any], add, scale) -> list[Any]:
        """Sparse matrix-vector product: out[r] = sum_k data[k] * vec[col[k]]
        (cuZK runs it on the transposed matrix with vec all ones)."""
        out = []
        for r in range(self.num_rows):
            acc = None
            for k in range(self.row_ptr[r], self.row_ptr[r + 1]):
                term = scale(self.data[k], vec[self.col_idx[k]])
                acc = term if acc is None else add(acc, term)
            out.append(acc)
        return out

    def smtvp(self, vec: Sequence[Any], add, scale) -> list[Any]:
        """Transposed product without the transpose: out[c] += data[k] *
        vec[r] over the rows in order."""
        out: list[Any] = [None] * self.num_cols
        for r in range(self.num_rows):
            for k in range(self.row_ptr[r], self.row_ptr[r + 1]):
                c = self.col_idx[k]
                term = scale(self.data[k], vec[r])
                out[c] = term if out[c] is None else add(out[c], term)
        return out


def execute_serial_cuzk(points: list[ExtPoint], scalars: list[int], cfg: MsmConfig) -> ExtPoint:
    """sum_i k_i * P_i by the serial cuZK pipeline over the matrix classes:
    per window an ELL matrix, its CSR form and transpose, the SMVP bucket
    sums, the running-sum reduction; then Horner's rule over the windows."""
    n = len(points)
    c = cfg.chunk_size
    w = cfg.num_windows
    nb = cfg.num_buckets
    digits = decompose_scalars_signed(scalars, w, c)
    ident = ExtPoint.identity()

    window_sums = []
    for win in range(w):
        # One row a point, one entry at column |digit| - 1, the sign applied.
        data, col_idx, row_len = [], [], []
        for i in range(n):
            d = digits[i][win]
            if d == 0:
                data.append([])
                col_idx.append([])
                row_len.append(0)
                continue
            pt = points[i] if d > 0 else points[i].neg()
            data.append([pt])
            col_idx.append([abs(d) - 1])
            row_len.append(1)
        ell = ELLSparseMatrix(data, col_idx, row_len)
        csc = CSRSparseMatrix.ell_to_csr(ell, nb).transpose()
        buckets = csc.smvp([1] * csc.num_cols, add=lambda a, b: a.add(b),
                           scale=lambda pt, one: pt)
        # Running sums: sum_b (b+1) * bucket[b].
        m = g = ident
        for b in range(nb - 1, -1, -1):
            if buckets[b] is not None:
                m = m.add(buckets[b])
            g = g.add(m)
        window_sums.append(g)

    acc = window_sums[-1]
    for win in range(w - 2, -1, -1):
        for _ in range(c):
            acc = acc.add(acc)
        acc = acc.add(window_sums[win])
    return acc
