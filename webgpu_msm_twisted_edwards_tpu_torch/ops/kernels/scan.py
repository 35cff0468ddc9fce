"""Bucket accumulation as a segmented scan over sorted entries.

Entries sorted by bucket are cut into fragments of K = 64; each fragment is
scanned on its own (`msm_scan_rm_sames`, one mixed add per entry), and a
hierarchical carry scan over fragments (`seg_carry_scan`) stitches buckets
that span fragments.

The fixed-base path scans rows of the single (non-negated) table with
`msm_scan_rm_signed`, which applies each entry's digit sign itself.

Kernels: csrc/scan.cu, replacing the JAX package's
ops/pallas/scan.py::_msm_scan_rm_sames_kernel, ::_msm_scan_rm_signed_kernel
and ::_ab_scan_kernel.
"""

from __future__ import annotations

import torch

from . import _build
from .common import L, fr_neg_lazy, load_consts, u32
from .convert import TWR
from .ec import TW, full_add, madd, masked_add_rows, pt_identity, pt_select, pt_to_rows, rows_to_pt

#: Entries per fragment (scan depth).
K = 64


def keys_to_sames(keys_t: torch.Tensor) -> torch.Tensor:
    """[K, NF] sorted bucket keys -> [K, NF] int32 same-as-previous bits.
    Row 0 is 0: every fragment starts a fresh segment, and continuation
    across fragments is the carry scan's job."""
    eq = (keys_t[1:] == keys_t[:-1]).to(torch.int32)
    return torch.cat([torch.zeros_like(eq[:1]), eq])


def _scan_rm_plain(rows: torch.Tensor, bits_t: torch.Tensor, signed: bool) -> torch.Tensor:
    nf = rows.shape[0]
    c = load_consts(rows.device)
    ident = pt_identity(nf, c)
    acc = ident
    steps = []
    for j in range(K):
        slab = u32(rows[:, j, 0:3 * L]).T                       # [3L, NF]
        d2, s2, td2 = slab[0:L], slab[L:2 * L], slab[2 * L:3 * L]
        if signed:
            neg = (bits_t[j] & 2) != 0
            d2, s2 = torch.where(neg, s2, d2), torch.where(neg, d2, s2)
            td2 = torch.where(neg, fr_neg_lazy(td2, c), td2)
            same = (bits_t[j] & 1) != 0
        else:
            same = bits_t[j] != 0
        acc = madd(pt_select(same, acc, ident), d2, s2, td2, c)
        steps.append(pt_to_rows(acc))
    return torch.stack(steps, dim=1).reshape(nf, K // 2, 2 * TW)


def msm_scan_rm_sames_plain(rows: torch.Tensor, sames_t: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`msm_scan_rm_sames`."""
    return _scan_rm_plain(rows, sames_t, signed=False)


def msm_scan_rm_signed_plain(rows: torch.Tensor, bits_t: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`msm_scan_rm_signed`."""
    return _scan_rm_plain(rows, bits_t, signed=True)


def msm_scan_rm_sames(rows: torch.Tensor, sames_t: torch.Tensor) -> torch.Tensor:
    """rows: [NF, K, TWR] int32 gathered table rows (pre-negated, row-major);
    sames_t: [K, NF] int32 from :func:`keys_to_sames`.  Returns T
    [NF, K//2, 2*TW] int32: per fragment the inclusive scan
    acc_j = madd(same_j ? acc_{j-1} : identity, row_j), steps (2i, 2i+1)
    side by side in row i.  Launches csrc/scan.cu on CUDA tensors; CPU
    tensors take the plain version."""
    _build.capture("scan", rows, sames_t)
    if not _build.on_cuda(rows, sames_t):
        return msm_scan_rm_sames_plain(rows, sames_t)
    nf = rows.shape[0]
    rows = _build.check(rows, torch.int32, (nf, K, TWR), "rows")
    sames_t = _build.check(sames_t, torch.int32, (K, nf), "sames_t")
    out = torch.empty((nf, K // 2, 2 * TW), dtype=torch.int32, device=rows.device)
    _build.launch("scan", "scan", "msm_scan_rm_sames", rows, sames_t, out, nf)
    return out


def msm_scan_rm_signed(rows: torch.Tensor, bits_t: torch.Tensor) -> torch.Tensor:
    """As :func:`msm_scan_rm_sames` over rows of the single (non-negated)
    table: bits_t [K, NF] int32 holds the same-as-previous bit in bit 0 and
    the digit's sign in bit 1; a negative entry adds the negated point (y-x
    and y+x swapped, 2*d*t negated).  Launches csrc/scan.cu on CUDA tensors;
    CPU tensors take the plain version."""
    _build.capture("scan_signed", rows, bits_t)
    if not _build.on_cuda(rows, bits_t):
        return msm_scan_rm_signed_plain(rows, bits_t)
    nf = rows.shape[0]
    rows = _build.check(rows, torch.int32, (nf, K, TWR), "rows")
    bits_t = _build.check(bits_t, torch.int32, (K, nf), "bits_t")
    out = torch.empty((nf, K // 2, 2 * TW), dtype=torch.int32, device=rows.device)
    _build.launch("scan_signed", "scan", "msm_scan_rm_signed", rows, bits_t, out, nf)
    return out


# ---------------------------------------------------------------------------
# Hierarchical carry scan: C_{f+1} = a_f * C_f + b_f (exclusive, C_0 = id).


def ab_scan_level_plain(a: torch.Tensor, b: torch.Tensor, kab: int):
    """Plain version of :func:`ab_scan_level`."""
    n = a.shape[0]
    nc = n // kab
    c = load_consts(a.device)
    a2 = a.reshape(nc, kab)
    b3 = b.reshape(nc, kab, TW)
    ident = pt_identity(nc, c)
    acc = ident
    apre = torch.ones(nc, dtype=torch.int32, device=a.device)
    c_rows, apres = [], []
    for j in range(kab):
        c_rows.append(pt_to_rows(acc))
        apres.append(apre)
        aj = a2[:, j] != 0
        acc = full_add(pt_select(aj, acc, ident), rows_to_pt(b3[:, j]), c)
        apre = torch.where(aj, apre, torch.zeros_like(apre))
    return (torch.stack(c_rows, dim=1).reshape(n, TW), torch.stack(apres, dim=1).reshape(n),
            apre, pt_to_rows(acc))


def ab_scan_level(a: torch.Tensor, b: torch.Tensor, kab: int):
    """One level over chunks of kab fragments: a [N] int32 (0/1), b [N, TW]
    int32 packed points, N divisible by kab.  Returns (c_local [N, TW]
    exclusive scan within each chunk, apre [N] exclusive prefix-AND of a
    within each chunk, a_agg [N//kab], b_agg [N//kab, TW]).  Launches
    csrc/scan.cu on CUDA tensors; CPU tensors take the plain version."""
    n = a.shape[0]
    if n % kab:
        raise ValueError(f"N={n} is not a multiple of kab={kab}")
    _build.capture("ab_scan", a, b, kab)
    if not _build.on_cuda(a, b):
        return ab_scan_level_plain(a, b, kab)
    nc = n // kab
    a = _build.check(a.to(torch.int32), torch.int32, (n,), "a")
    b = _build.check(b, torch.int32, (n, TW), "b")
    c_loc = torch.empty((n, TW), dtype=torch.int32, device=a.device)
    apre = torch.empty((n,), dtype=torch.int32, device=a.device)
    a_agg = torch.empty((nc,), dtype=torch.int32, device=a.device)
    b_agg = torch.empty((nc, TW), dtype=torch.int32, device=a.device)
    _build.launch("ab_scan", "scan", "msm_ab_scan_level", a, b, c_loc, apre, a_agg, b_agg,
                  nc, kab)
    return c_loc, apre, a_agg, b_agg


def seg_carry_scan(a: torch.Tensor, b: torch.Tensor, kab: int = K) -> torch.Tensor:
    """Exclusive linear scan C_{f+1} = a_f*C_f + b_f over [N] fragments:
    a [N] int32 (0/1), b [N, TW] packed points -> C [N, TW].  The levels,
    their padding to <= 128 or a multiple of 128 chunks, and the order of the
    adds are the JAX package's, so the carries match it bit for bit."""
    n = a.shape[0]
    if n <= kab:
        return ab_scan_level(a, b, n)[0]
    nc = -(-n // kab)
    if nc > 128:
        nc = -(-nc // 128) * 128
    target = nc * kab
    if target != n:
        pad = target - n
        a = torch.cat([a, torch.zeros((pad,), dtype=a.dtype, device=a.device)])
        b = torch.cat([b, b[-1:].expand(pad, b.shape[1])])
        return seg_carry_scan(a, b, kab)[:n]
    c_loc, apre, a_agg, b_agg = ab_scan_level(a, b, kab)
    cin = seg_carry_scan(a_agg, b_agg, kab)                         # [N//kab, TW]
    return masked_add_rows(c_loc, cin.repeat_interleave(kab, dim=0), apre)
