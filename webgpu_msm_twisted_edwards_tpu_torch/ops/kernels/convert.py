"""Point conversion: affine u32 words -> the doubled table of cached
Montgomery rows (y-x, y+x, 2*d*t as unpacked limbs at columns 0..59 of a
TWR = 128-word row; rows n..2n-1 hold the negations).

Kernel: csrc/convert.cu, replacing the JAX package's
ops/pallas/convert.py::_convert_kernel_full.
"""

from __future__ import annotations

import torch

from . import _build
from .common import (
    L,
    MASK,
    W,
    fr_add_lazy,
    fr_neg_lazy,
    fr_sub_lazy,
    load_consts,
    mont_many,
    mont_mul,
    to_i32,
    u32,
)

#: Table row width in u32.
TWR = 128


def _limbs_from_words(words: torch.Tensor) -> torch.Tensor:
    """[8, B] LE u32 words (int64) -> [L, B] limbs."""
    rows = []
    for i in range(L):
        b = i * W
        idx, off = b // 32, b % 32
        v = words[idx] >> off
        if off + W > 32 and idx + 1 < 8:
            v = v | ((words[idx + 1] << (32 - off)) & 0xFFFFFFFF)
        rows.append(v & MASK)
    return torch.stack(rows)


def build_table_doubled_plain(coords: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`build_table_doubled`."""
    n = coords.shape[0]
    c = load_consts(coords.device)
    wds = u32(coords.reshape(n, 16)).T                           # [16, n]
    x = _limbs_from_words(wds[0:8])
    y = _limbs_from_words(wds[8:16])
    xm, ym = mont_many([(x, c.r2.expand_as(x)), (y, c.r2.expand_as(y))], c.p)
    tm = mont_mul(xm, ym, c.p)
    tdm = mont_mul(tm, c.d.expand_as(tm), c.p)
    dm = fr_sub_lazy(ym, xm, c)                                  # y - x (+4p)
    sm = fr_add_lazy(xm, ym)                                     # y + x
    td2 = fr_add_lazy(tdm, tdm)                                  # 2*d*t
    ntd2 = fr_neg_lazy(td2, c)
    pad = torch.zeros((TWR - 3 * L, n), dtype=torch.int64, device=coords.device)
    pos = torch.cat([dm, sm, td2, pad]).T
    neg = torch.cat([sm, dm, ntd2, pad]).T
    return to_i32(torch.cat([pos, neg]))


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
