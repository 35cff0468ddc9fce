"""Extended twisted Edwards point arithmetic on limb tensors, and the point
kernels over packed rows: the masked add, the quarter-store extraction and
repeated doubling.

Plain counterparts of webgpu_msm_twisted_edwards_tpu/ops/pallas/ec.py and of
the point formulas of csrc/ec26.cuh: the rotated
a = -1 hwcd formulas, with the same lazy products in the same order, so the
projective representatives match bit for bit.
Points are 4-tuples of [..., L, B] int64 limb tensors in Montgomery form.
Packed point rows are [N, TW] int32: x, y, t, z as LP packed words each,
then zero words.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ...utils.params import PARAMS
from . import _build
from .common import (
    L,
    LP,
    Consts,
    int_to_limbs,
    add_many,
    fr_add_lazy,
    fr_neg_lazy,
    fr_sub_lazy,
    load_consts,
    mont_many,
    mont_mul,
    pack2,
    sub_many,
    to_i32,
    u32,
    unpack2,
)

#: Packed point row width in u32 (4*LP = 40 used).
TW = 64


class Pt(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    t: torch.Tensor
    z: torch.Tensor


def pt_identity(b: int, c: Consts) -> Pt:
    """(0 : R : 0 : R), the Montgomery form of (0 : 1 : 0 : 1), over B lanes."""
    r = c.r.expand(-1, b)
    zero = torch.zeros_like(r)
    return Pt(zero, r, zero, r)


@lru_cache(maxsize=None)
def _identity_row_on(device: torch.device) -> torch.Tensor:
    r = int_to_limbs(PARAMS.r).astype(np.int64)
    packed_r = torch.from_numpy(r[0::2] | (r[1::2] << 16))
    row = torch.zeros(TW, dtype=torch.int64)
    row[LP:2 * LP] = packed_r
    row[3 * LP:4 * LP] = packed_r
    return to_i32(row).to(device)


def identity_row(device=None) -> torch.Tensor:
    """The packed (0 : R : 0 : R) identity as one [TW] int32 row.  A copy on
    the device of the row kept there at the first call: a copy from host
    memory would wait for the device's stream (a host sync in every window
    group, which would serialize the shards of a multi-card MSM)."""
    device = torch.device(device or "cpu")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _identity_row_on(device).clone()


def pt_select(mask: torch.Tensor, a: Pt, b: Pt) -> Pt:
    """mask [B] bool: True takes a."""
    return Pt(*(torch.where(mask, ai, bi) for ai, bi in zip(a, b)))


def pt_pack(p: Pt) -> torch.Tensor:
    """Pt -> [4*LP, B] packed words."""
    return torch.cat([pack2(p.x), pack2(p.y), pack2(p.t), pack2(p.z)], dim=0)


def pt_unpack(rows: torch.Tensor) -> Pt:
    """[>= 4*LP, B] packed words -> Pt."""
    return Pt(*(unpack2(rows[i * LP:(i + 1) * LP]) for i in range(4)))


def rows_to_pt(rows: torch.Tensor) -> Pt:
    """[N, TW] int32 packed rows -> Pt over N lanes."""
    return pt_unpack(u32(rows[:, :4 * LP]).T)


def pt_to_rows(p: Pt) -> torch.Tensor:
    """Pt over N lanes -> [N, TW] int32 packed rows with zero padding."""
    packed = to_i32(pt_pack(p).T)
    pad = torch.zeros((packed.shape[0], TW - 4 * LP), dtype=torch.int32, device=packed.device)
    return torch.cat([packed, pad], dim=1)


def madd(p1: Pt, d2, s2, td2, c: Consts) -> Pt:
    """p1 + a table point in cached form (d2 = y2-x2, s2 = y2+x2,
    td2 = 2*d*t2, affine with Z = R): 7 Montgomery products.  Every
    intermediate is twice the add-2008-hwcd value, so the result is the sum
    scaled projectively by 4.  Lazy bounds: accumulator coordinates < 1.3p,
    table rows < 5.3p, all product inputs < 9p, subtrahends < 3p."""
    d1 = fr_sub_lazy(p1.y, p1.x, c)
    s1, dd = add_many([(p1.x, p1.y), (p1.z, p1.z)])
    a, b, cc = mont_many([(d1, d2), (s1, s2), (p1.t, td2)], c.p)
    e, f = sub_many([(b, a), (dd, cc)], c)
    g, h = add_many([(dd, cc), (b, a)])
    return Pt(*mont_many([(e, f), (g, h), (e, h), (f, g)], c.p))


def full_add(p1: Pt, p2: Pt, c: Consts) -> Pt:
    """Unified add of two arbitrary points: 9 Montgomery products, the
    product by d lazy."""
    d1, d2 = sub_many([(p1.y, p1.x), (p2.y, p2.x)], c)
    s1, s2 = add_many([(p1.x, p1.y), (p2.x, p2.y)])
    a, b, t12, z12 = mont_many([(d1, d2), (s1, s2), (p1.t, p2.t), (p1.z, p2.z)], c.p)
    cc1 = mont_mul(t12, c.d.expand_as(t12), c.p, reduce=False)
    cc, dd = add_many([(cc1, cc1), (z12, z12)])
    e, f = sub_many([(b, a), (dd, cc)], c)
    g, h = add_many([(dd, cc), (b, a)])
    return Pt(*mont_many([(e, f), (g, h), (e, h), (f, g)], c.p))


def double(p1: Pt, c: Consts) -> Pt:
    """dbl-2008-hwcd with a = -1: 8 Montgomery products."""
    xy = fr_add_lazy(p1.x, p1.y)
    a, b, zz, e_in = mont_many([(p1.x, p1.x), (p1.y, p1.y), (p1.z, p1.z), (xy, xy)], c.p)
    cc, s_ab = add_many([(zz, zz), (a, b)])
    d = fr_neg_lazy(a, c)
    e, h = sub_many([(e_in, s_ab), (d, b)], c)
    g = fr_add_lazy(d, b)
    f = fr_sub_lazy(g, cc, c)
    return Pt(*mont_many([(e, f), (g, h), (e, h), (f, g)], c.p))


def masked_add_rows_plain(a_rows: torch.Tensor, b_rows: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`masked_add_rows`.  As the kernel does, it adds
    only the rows whose mask is set; the others are copied with their padding
    words zeroed (unpacking and repacking leaves the used words as they are)."""
    rows = (mask != 0).nonzero().flatten()
    out = a_rows.clone()
    out[:, 4 * LP:] = 0
    if rows.numel():
        c = load_consts(a_rows.device)
        s = full_add(rows_to_pt(a_rows[rows]), rows_to_pt(b_rows[rows]), c)
        out[rows] = pt_to_rows(s)
    return out


def masked_add_rows(a_rows: torch.Tensor, b_rows: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Row i of the result is mask_i ? a_i + b_i : a_i, over [N, TW] int32
    packed rows and an [N] int32 mask.  Launches csrc/ec.cu on CUDA tensors;
    CPU tensors take the plain version."""
    _build.capture("masked_add", a_rows, b_rows, mask)
    if not _build.on_cuda(a_rows, b_rows, mask):
        return masked_add_rows_plain(a_rows, b_rows, mask)
    n = a_rows.shape[0]
    a_rows = _build.check(a_rows, torch.int32, (n, TW), "a_rows")
    b_rows = _build.check(b_rows, torch.int32, (n, TW), "b_rows")
    mask = _build.check(mask.to(torch.int32), torch.int32, (n,), "mask")
    out = torch.empty_like(a_rows)
    _build.launch("masked_add", "ec", "msm_masked_add_rows", a_rows, b_rows, mask, out, n)
    return out


def extract_reconstruct_rows_plain(base_rows: torch.Tensor, pair_rows: torch.Tensor,
                                   bits: torch.Tensor, carry_rows: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`extract_reconstruct_rows`: the JAX kernel's
    compute-and-select, every step computed and kept where its bit is set."""
    c = load_consts(base_rows.device)
    twr = pair_rows.shape[1] // 2
    v = rows_to_pt(base_rows)
    ident = pt_identity(base_rows.shape[0], c)
    for base, mbit, sbit in ((0, 1, 4), (twr, 2, 8)):
        slab = u32(pair_rows[:, base:base + 3 * L]).T
        stepped = madd(pt_select((bits & sbit) != 0, v, ident),
                       slab[0:L], slab[L:2 * L], slab[2 * L:3 * L], c)
        v = pt_select((bits & mbit) != 0, stepped, v)
    out = pt_select((bits & 16) != 0, full_add(v, rows_to_pt(carry_rows), c), v)
    return pt_to_rows(out)


def extract_reconstruct_rows(base_rows: torch.Tensor, pair_rows: torch.Tensor,
                             bits: torch.Tensor, carry_rows: torch.Tensor) -> torch.Tensor:
    """The quarter-store extraction: per row, the scan value at an unstored
    step replayed from base_rows [N, TW] (the nearest stored value before
    it) with up to two scan steps over pair_rows [N, 2*twr] (the scan-input
    rows of steps 4q and 4q+1, cached form in the first 3L words of each
    half), then the carry added.  bits [N] int32: 1 step at 4q, 2 step at
    4q+1, 4 and 8 their same-segment bits (clear: the step restarts from the
    identity), 16 add carry_rows [N, TW].  Returns [N, TW] int32 packed rows
    with zero padding.  Launches csrc/ec.cu on CUDA tensors; CPU tensors
    take the plain version."""
    _build.capture("extract_reconstruct", base_rows, pair_rows, bits, carry_rows)
    if not _build.on_cuda(base_rows, pair_rows, bits, carry_rows):
        return extract_reconstruct_rows_plain(base_rows, pair_rows, bits, carry_rows)
    n, twr2 = pair_rows.shape
    if twr2 % 8 or twr2 < 6 * L:
        raise ValueError(f"pair_rows width {twr2}: expected two rows of >= {3 * L} words, "
                         "each a multiple of 4")
    base_rows = _build.check(base_rows, torch.int32, (n, TW), "base_rows")
    pair_rows = _build.check(pair_rows, torch.int32, (n, twr2), "pair_rows")
    bits = _build.check(bits.to(torch.int32), torch.int32, (n,), "bits")
    carry_rows = _build.check(carry_rows, torch.int32, (n, TW), "carry_rows")
    out = torch.empty_like(base_rows)
    _build.launch("extract_reconstruct", "ec", "msm_extract_reconstruct_rows", base_rows,
                  pair_rows, bits, carry_rows, out, n, twr2 // 2)
    return out


def double_rows_plain(rows: torch.Tensor, times: int) -> torch.Tensor:
    """Plain version of :func:`double_rows`."""
    c = load_consts(rows.device)
    p = rows_to_pt(rows)
    for _ in range(times):
        p = double(p, c)
    return pt_to_rows(p)


def double_rows(rows: torch.Tensor, times: int) -> torch.Tensor:
    """Row i of the result is 2^times * row i (dbl-2008-hwcd, `times`
    doublings), over [N, TW] int32 packed rows; padding words come out zero.
    Launches csrc/ec.cu on CUDA tensors; CPU tensors take the plain
    version."""
    _build.capture("double_rows", rows, times)
    if not _build.on_cuda(rows):
        return double_rows_plain(rows, times)
    n = rows.shape[0]
    rows = _build.check(rows, torch.int32, (n, TW), "rows")
    out = torch.empty_like(rows)
    _build.launch("double_rows", "ec", "msm_double_rows", rows, out, n, times)
    return out
