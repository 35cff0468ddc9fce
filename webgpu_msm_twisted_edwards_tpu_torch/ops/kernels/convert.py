"""Point conversion: affine u32 words -> cached Montgomery table rows (y-x,
y+x, 2*d*t as unpacked limbs at columns 0..59 of a TWR = 128-word row), with
the rows of the points' negations as the doubled table's second half
(build_table_doubled), as a second output (build_table_pair), or not at all
(build_table).

Kernel: csrc/convert.cu, replacing the JAX package's
ops/pallas/convert.py::_convert_kernel_full and ::_convert_kernel.
"""

from __future__ import annotations

import torch

from ..convert import u32_words_to_limbs
from . import _build
from .common import (
    L,
    fr_add_lazy,
    fr_neg_lazy,
    fr_sub_lazy,
    load_consts,
    mont_many,
    mont_mul,
    to_i32,
)

#: Table row width in u32.
TWR = 128


def _table_rows_plain(coords: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[n, 2, 8] int32 -> ([n, TWR] point rows, [n, TWR] negation rows) as
    int64 u32 values."""
    n = coords.shape[0]
    c = load_consts(coords.device)
    x = u32_words_to_limbs(coords[:, 0]).T                      # [L, n]
    y = u32_words_to_limbs(coords[:, 1]).T
    xm, ym = mont_many([(x, c.r2.expand_as(x)), (y, c.r2.expand_as(y))], c.p)
    tm = mont_mul(xm, ym, c.p)
    tdm = mont_mul(tm, c.d.expand_as(tm), c.p)
    dm = fr_sub_lazy(ym, xm, c)                                  # y - x (+4p)
    sm = fr_add_lazy(xm, ym)                                     # y + x
    td2 = fr_add_lazy(tdm, tdm)                                  # 2*d*t
    ntd2 = fr_neg_lazy(td2, c)
    pad = torch.zeros((TWR - 3 * L, n), dtype=torch.int64, device=coords.device)
    return torch.cat([dm, sm, td2, pad]).T, torch.cat([sm, dm, ntd2, pad]).T


def build_table_doubled_plain(coords: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`build_table_doubled`."""
    return to_i32(torch.cat(_table_rows_plain(coords)))


def build_table_pair_plain(coords: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`build_table_pair`."""
    pos, neg = _table_rows_plain(coords)
    return to_i32(pos), to_i32(neg)


def build_table_doubled(coords: torch.Tensor) -> torch.Tensor:
    """[n, 2, 8] int32 affine coordinate words -> [2n, TWR] int32 doubled
    table: rows 0..n-1 the points, rows n..2n-1 their negations.  Launches
    csrc/convert.cu on CUDA tensors; CPU tensors take the plain version."""
    _build.capture("convert", coords)
    if not _build.on_cuda(coords):
        return build_table_doubled_plain(coords)
    n = coords.shape[0]
    coords = _build.check(coords, torch.int32, (n, 2, 8), "coords")
    out = torch.empty((2 * n, TWR), dtype=torch.int32, device=coords.device)
    _build.launch("convert", "convert", "msm_build_table_doubled", coords, out, n)
    return out


def build_table_pair(coords: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[n, 2, 8] int32 affine coordinate words -> ([n, TWR] point rows,
    [n, TWR] negation rows), int32.  Launches csrc/convert.cu on CUDA
    tensors; CPU tensors take the plain version."""
    _build.capture("convert_pair", coords)
    if not _build.on_cuda(coords):
        return build_table_pair_plain(coords)
    n = coords.shape[0]
    coords = _build.check(coords, torch.int32, (n, 2, 8), "coords")
    out = torch.empty((n, TWR), dtype=torch.int32, device=coords.device)
    neg = torch.empty_like(out)
    _build.launch("convert_pair", "convert", "msm_build_table_pair", coords, out, neg, n)
    return out, neg


def build_table(coords: torch.Tensor) -> torch.Tensor:
    """The first output of :func:`build_table_pair` alone: the single table
    of the fixed-base path, whose digit signs the scan applies.  The kernel
    skips the negation rows; the launch counts as convert_pair's."""
    _build.capture("convert_pair", coords)
    if not _build.on_cuda(coords):
        return build_table_pair_plain(coords)[0]
    n = coords.shape[0]
    coords = _build.check(coords, torch.int32, (n, 2, 8), "coords")
    out = torch.empty((n, TWR), dtype=torch.int32, device=coords.device)
    _build.launch("convert_pair", "convert", "msm_build_table", coords, out, n)
    return out
