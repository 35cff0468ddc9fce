"""Bucket-point reduction (per window S = sum_b (b+1) * Bucket[b]) and the
Horner fold over windows (total = sum_w 2^(c*w) * S_w).

Kernels: csrc/bpr.cu, replacing the JAX package's
ops/pallas/bpr.py::_bpr_stage1_kernel, ::_bpr_stage2_kernel and
::_horner_kernel.  The reduction across chunks, a loop of masked adds in
the JAX package, is one launch of csrc/ec.cu's reduce kernel, in the same
order (first half + second half).
"""

from __future__ import annotations

import torch

from . import _build
from .common import load_consts
from .ec import (
    TW,
    Pt,
    double,
    full_add,
    identity_row,
    masked_add_rows,
    masked_add_rows_plain,
    pt_identity,
    pt_select,
    pt_to_rows,
    rows_to_pt,
)

#: Buckets per chunk in stage 1.
CHUNK = 64


def bpr_stage1_plain(buckets: torch.Tensor, chunk: int = CHUNK):
    """Plain version of :func:`bpr_stage1`."""
    nc = buckets.shape[0] // chunk
    c = load_consts(buckets.device)
    b3 = buckets.reshape(nc, chunk, TW)
    m = g = pt_identity(nc, c)
    for j in range(chunk - 1, -1, -1):
        m = full_add(m, rows_to_pt(b3[:, j]), c)
        g = full_add(g, m, c)
    return pt_to_rows(m), pt_to_rows(g)


def bpr_stage1(buckets: torch.Tensor, chunk: int = CHUNK):
    """buckets: [W*NB, TW] int32 packed rows, bucket-major per window.  Per
    chunk of `chunk` buckets, scanned in descending order, m += S_j and
    g += m.  Returns (m, g), each [W*NB/chunk, TW].  Launches csrc/bpr.cu on
    CUDA tensors; CPU tensors take the plain version."""
    n = buckets.shape[0]
    if n % chunk:
        raise ValueError(f"{n} bucket rows are not a multiple of chunk={chunk}")
    _build.capture("bpr1", buckets, chunk)
    if not _build.on_cuda(buckets):
        return bpr_stage1_plain(buckets, chunk)
    nc = n // chunk
    buckets = _build.check(buckets, torch.int32, (n, TW), "buckets")
    m = torch.empty((nc, TW), dtype=torch.int32, device=buckets.device)
    g = torch.empty_like(m)
    _build.launch("bpr1", "bpr", "msm_bpr_stage1", buckets, m, g, nc, chunk)
    return m, g


def _num_bits(chunks_per_window: int, chunk: int) -> int:
    return max(1, int((chunks_per_window - 1) * chunk).bit_length())


def bpr_stage2_plain(m: torch.Tensor, g: torch.Tensor, chunks_per_window: int,
                     chunk: int = CHUNK) -> torch.Tensor:
    """Plain version of :func:`bpr_stage2`."""
    nc = m.shape[0]
    c = load_consts(m.device)
    kfac = (torch.arange(nc, device=m.device) % chunks_per_window) * chunk
    mp = rows_to_pt(m)
    acc = pt_identity(nc, c)
    num_bits = _num_bits(chunks_per_window, chunk)
    for bit in range(num_bits - 1, -1, -1):
        acc = double(acc, c)
        acc = pt_select(((kfac >> bit) & 1) != 0, full_add(acc, mp, c), acc)
    return pt_to_rows(full_add(rows_to_pt(g), acc, c))


def bpr_stage2(m: torch.Tensor, g: torch.Tensor, chunks_per_window: int,
               chunk: int = CHUNK) -> torch.Tensor:
    """g += m * ((lane % chunks_per_window) * chunk) by MSB-first
    double-and-add, lane being the global chunk index.  m, g: [NC, TW] int32.
    Launches csrc/bpr.cu on CUDA tensors; CPU tensors take the plain
    version."""
    _build.capture("bpr2", m, g, chunks_per_window, chunk)
    if not _build.on_cuda(m, g):
        return bpr_stage2_plain(m, g, chunks_per_window, chunk)
    nc = m.shape[0]
    m = _build.check(m, torch.int32, (nc, TW), "m")
    g = _build.check(g, torch.int32, (nc, TW), "g")
    out = torch.empty_like(m)
    _build.launch("bpr2", "bpr", "msm_bpr_stage2", m, g, out, nc, chunks_per_window, chunk,
                  _num_bits(chunks_per_window, chunk))
    return out


#: Rows of one window that the reduce kernel holds in shared memory (as
#: csrc/ec.cu's REDUCE_MAX_ROWS): a window of more rows is first halved by
#: masked adds until it fits.
REDUCE_MAX_ROWS = 1024


def _windows(rows: torch.Tensor, per_window: int) -> int:
    if per_window & (per_window - 1):
        raise ValueError(f"per_window={per_window} is not a power of two")
    return rows.shape[0] // per_window


def _halve(rows: torch.Tensor, w: int, cur: int, add) -> torch.Tensor:
    """One round: of each window's `cur` rows, the first half plus the
    second half, row by row, with the masked add `add`."""
    half = cur // 2
    r3 = rows.reshape(w, cur, TW)
    a = r3[:, :half].reshape(w * half, TW)
    b = r3[:, half:].reshape(w * half, TW)
    ones = torch.ones((w * half,), dtype=torch.int32, device=rows.device)
    return add(a, b, ones)


def reduce_rows_per_window_plain(rows: torch.Tensor, per_window: int) -> torch.Tensor:
    """Plain version of :func:`reduce_rows_per_window`: the JAX package's
    loop of masked adds, one a round."""
    w = _windows(rows, per_window)
    cur = per_window
    while cur > 1:
        rows = _halve(rows, w, cur, masked_add_rows_plain)
        cur //= 2
    return rows.reshape(w, TW)


def reduce_rows_per_window(rows: torch.Tensor, per_window: int) -> torch.Tensor:
    """Log-depth reduction of [W*per_window, TW] packed rows to [W, TW]:
    each round adds the second half of every window's rows to its first
    half.  per_window must be a power of two.  On CUDA tensors every round
    runs in one launch of csrc/ec.cu's reduce kernel (after rounds of the
    masked add while a window exceeds REDUCE_MAX_ROWS rows); CPU tensors
    take the plain version."""
    w = _windows(rows, per_window)
    _build.capture("reduce_rows", rows, per_window)
    if not _build.on_cuda(rows):
        return reduce_rows_per_window_plain(rows, per_window)
    if per_window == 1:
        return rows.reshape(w, TW)
    cur = per_window
    while cur > REDUCE_MAX_ROWS:
        rows = _halve(rows, w, cur, masked_add_rows)
        cur //= 2
    rows = _build.check(rows, torch.int32, (w * cur, TW), "rows")
    out = torch.empty((w, TW), dtype=torch.int32, device=rows.device)
    _build.launch("reduce_rows", "ec", "msm_reduce_rows_per_window", rows, out, w, cur)
    return out


def bpr(buckets: torch.Tensor, num_windows: int) -> torch.Tensor:
    """[W*NB, TW] packed bucket rows -> [W, TW] packed window sums, bucket b
    (0-based within its window) weighted b+1."""
    nb = buckets.shape[0] // num_windows
    chunk = min(CHUNK, nb)
    if nb % chunk:
        raise ValueError(f"nb={nb} is not a multiple of chunk={chunk}")
    m, g = bpr_stage1(buckets, chunk=chunk)
    chunks_per_window = nb // chunk
    g2 = bpr_stage2(m, g, chunks_per_window, chunk=chunk)
    return reduce_rows_per_window(g2, chunks_per_window)


# ---------------------------------------------------------------------------
# Horner fold: total = sum_w 2^(cbits*w) * S_w.


def _horner_lanes(w: int) -> int:
    return 1 << max(3, (w - 1).bit_length())


def _pad_identity(sums: torch.Tensor, lanes: int) -> torch.Tensor:
    w = sums.shape[0]
    if lanes == w:
        return sums
    return torch.cat([sums, identity_row(sums.device).expand(lanes - w, TW)])


def horner_fold_plain(sums: torch.Tensor, cbits: int) -> torch.Tensor:
    """Plain version of :func:`horner_fold`."""
    w = sums.shape[0]
    lanes = _horner_lanes(w)
    c = load_consts(sums.device)
    p = rows_to_pt(_pad_identity(sums, lanes))
    target = torch.arange(lanes, device=sums.device) * cbits
    for d in range(cbits * (w - 1)):
        p = pt_select(d < target, double(p, c), p)
    shift = 1
    while shift < lanes:
        rot = Pt(*(torch.cat([a[:, shift:], a[:, :shift]], dim=1) for a in p))
        p = full_add(p, rot, c)
        shift *= 2
    return pt_to_rows(p)[:1]


def horner_fold(sums: torch.Tensor, cbits: int) -> torch.Tensor:
    """[W, TW] packed window sums -> [1, TW] packed projective total
    sum_w 2^(cbits*w) * S_w.  The W lanes are padded with identity rows to a
    power of two >= 8 (the kernel pads its own); lane l doubles
    min(cbits*l, cbits*(W-1)) times, then rotate-and-add rounds leave the
    total in lane 0.  Launches csrc/bpr.cu on CUDA tensors; CPU tensors take
    the plain version."""
    _build.capture("horner", sums, cbits)
    if not _build.on_cuda(sums):
        return horner_fold_plain(sums, cbits)
    w = sums.shape[0]
    lanes = _horner_lanes(w)
    if lanes > 64:
        raise ValueError(f"{w} windows exceed the kernel's 64 lanes")
    sums = _build.check(sums, torch.int32, (w, TW), "sums")
    out = torch.empty((1, TW), dtype=torch.int32, device=sums.device)
    _build.launch("horner", "bpr", "msm_horner_fold", sums, out, w, cbits, lanes)
    return out
