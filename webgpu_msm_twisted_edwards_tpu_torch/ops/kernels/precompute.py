"""Batch affine normalization of packed projective rows, for the fixed-base
precompute (ops/precompute.py): per row zinv = z^(p-2) (Fermat), then x*zinv
and y*zinv, all reduced Montgomery products.

Kernel: csrc/precompute.cu, replacing the JAX package's
ops/precompute.py::_inv_norm_kernel (normalize_rows).  The kernel inverts
by Montgomery's batch inversion, which gives the same canonical words.
"""

from __future__ import annotations

import torch

from ...utils.params import PARAMS
from . import _build
from .common import LP, load_consts, mont_mul, pack2, to_i32
from .ec import TW, rows_to_pt

#: The Fermat exponent of the inverse, p - 2, and its bit length.
EXP = PARAMS.p - 2
EXP_BITS = EXP.bit_length()


def normalize_rows_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`normalize_rows`."""
    c = load_consts(rows.device)
    p = rows_to_pt(rows)
    acc = c.r.expand_as(p.z)
    for b in range(EXP_BITS - 1, -1, -1):
        acc = mont_mul(acc, acc, c.p)
        if (EXP >> b) & 1:
            acc = mont_mul(acc, p.z, c.p)
    xy = mont_mul(torch.stack([p.x, p.y]), acc.expand(2, -1, -1), c.p)
    pad = torch.zeros((TW - 2 * LP, rows.shape[0]), dtype=torch.int64, device=rows.device)
    return to_i32(torch.cat([pack2(xy[0]), pack2(xy[1]), pad]).T)


def normalize_rows(rows: torch.Tensor) -> torch.Tensor:
    """[N, TW] int32 packed projective Montgomery rows -> [N, TW] int32 rows
    holding the affine x*R (packed words 0..9) and y*R (words 10..19), then
    zeros; a row whose z is 0 mod p gives x = y = 0.  A bit of p-2 that is
    0 skips its multiply; the JAX kernel computes it and selects, which
    keeps the same value.  Launches csrc/precompute.cu on CUDA tensors (a
    batch inversion: every value is a canonical residue, so the words are
    the plain version's); CPU tensors take the plain version."""
    _build.capture("normalize", rows)
    if not _build.on_cuda(rows):
        return normalize_rows_plain(rows)
    n = rows.shape[0]
    rows = _build.check(rows, torch.int32, (n, TW), "rows")
    out = torch.empty_like(rows)
    _build.launch("normalize", "precompute", "msm_normalize_rows", rows, out, n)
    return out

