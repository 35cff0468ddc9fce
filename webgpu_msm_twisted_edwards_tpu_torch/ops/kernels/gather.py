"""Row gather into scan order: out[f*K + j] = table[pidx_t[j, f]].

Kernels: csrc/gather.cu.  They replace the JAX package's
ops/pallas/gather.py::dma_row_gather (its _dma_gather_kernel drove the TPU's
DMA engines); the pipeline takes them at >= 2^21 gathered rows per window
group and plain indexing below that, as the JAX pipeline does.

A call with more than PARTITION_ENTRIES_PER_ROW entries a table row (the
quarter store's: 2^24 entries over 2^21 rows at 2^20 points) is two
launches: a counting partition of the entries by tile of 2^tile_log2 table
rows (:func:`gather_order`; one C entry that runs three kernels), then the
copy in that order, so that the rows the warps in flight read are those of
a few tiles, which the L2 holds, and each table row is read from device
memory about once.  Other calls copy in entry order in one launch.  A
launch counts one call of a C entry, as every wrapper of the port counts
it; both count as launches of "gather".
"""

from __future__ import annotations

import torch

from . import _build

#: log2 of the table rows of one tile of the partition (chosen on the H100:
#: PERF.md §6, row 3).  A table of more than MAX_TILES tiles takes tiles
#: as much larger as it needs.
TILE_LOG2 = 12
#: Most tiles of one partition (csrc/gather.cu: RG_MAX_TILES).
MAX_TILES = 4096
#: Entries of one partition block (csrc/gather.cu: RG_PART_ENTRIES).
PART_ENTRIES = 1 << 14
#: A call with more entries than this many a table row takes the partition;
#: others copy in entry order, which then wins by the partition's fixed
#: cost (the crossover measured on the H100: PERF.md §6, row 3).
PARTITION_ENTRIES_PER_ROW = 2


def row_gather_plain(table: torch.Tensor, pidx_t: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`row_gather`."""
    return table[pidx_t.T.reshape(-1).to(torch.int64)]


def tile_log2(nt: int) -> int:
    """log2 of the tile of an nt-row table: TILE_LOG2, or larger where the
    table would have more than MAX_TILES tiles."""
    return max(TILE_LOG2, (max(nt, 1) - 1).bit_length() - (MAX_TILES.bit_length() - 1))


def gather_order_plain(pidx_t: torch.Tensor, nt: int) -> torch.Tensor:
    """Plain version of :func:`gather_order`: the entries in pidx_t's order
    (e = j*NF + f), stably sorted by tile."""
    k, nf = pidx_t.shape
    e = torch.arange(k * nf, dtype=torch.int64, device=pidx_t.device)
    rows = pidx_t.reshape(-1).to(torch.int64)
    _, perm = torch.sort(rows >> tile_log2(nt), stable=True)
    j, f = e[perm] // nf, e[perm] % nf
    return torch.stack([f * k + j, rows[perm]], dim=1).to(torch.int32)


def gather_order(pidx_t: torch.Tensor, nt: int) -> torch.Tensor:
    """pidx_t: [K, NF] int32 rows in [0, nt).  Returns [NF*K, 2] int32:
    (output row f*K + j, table row pidx_t[j, f]) of every entry, their table
    rows' tiles (row >> tile_log2(nt)) in non-decreasing order.  Within a
    tile the kernel's order is that of its atomics; copying in any such order
    gives the same rows.  Launches the partition of csrc/gather.cu on CUDA
    tensors; CPU tensors take the plain version."""
    if not _build.on_cuda(pidx_t):
        return gather_order_plain(pidx_t, nt)
    k, nf = pidx_t.shape
    pidx_t = _build.check(pidx_t, torch.int32, (k, nf), "pidx_t")
    tl = tile_log2(nt)
    ntiles = ((max(nt, 1) - 1) >> tl) + 1
    entries = nf * k
    counts = torch.empty((ntiles, -(-entries // PART_ENTRIES)), dtype=torch.int32,
                         device=pidx_t.device)
    totals = torch.empty(ntiles, dtype=torch.int32, device=pidx_t.device)
    order = torch.empty((entries, 2), dtype=torch.int32, device=pidx_t.device)
    _build.launch("gather", "gather", "msm_row_gather_partition", pidx_t, counts, totals, order,
                  nf, k, tl, ntiles)
    return order


def row_gather(table: torch.Tensor, pidx_t: torch.Tensor) -> torch.Tensor:
    """table: [nt, w] int32 rows (w a multiple of 4); pidx_t: [K, NF] int32
    with the row of entry f*K + j at [j, f], each in [0, nt).  Returns
    [NF*K, w], equal to table[pidx] for the flat entry-major index.
    Launches csrc/gather.cu on CUDA tensors (the partition and the copy in
    its order where NF*K > PARTITION_ENTRIES_PER_ROW * nt, else the copy in
    entry order); CPU tensors take the plain version."""
    _build.capture("gather", table, pidx_t)
    if not _build.on_cuda(table, pidx_t):
        return row_gather_plain(table, pidx_t)
    nt, w = table.shape
    k, nf = pidx_t.shape
    if w % 4:
        raise ValueError(f"row width {w} must be a multiple of 4")
    table = _build.check(table, torch.int32, (nt, w), "table")
    pidx_t = _build.check(pidx_t, torch.int32, (k, nf), "pidx_t")
    out = torch.empty((nf * k, w), dtype=torch.int32, device=table.device)
    if nf * k <= PARTITION_ENTRIES_PER_ROW * nt:
        _build.launch("gather", "gather", "msm_row_gather", table, pidx_t, out, nf, k, w)
    else:
        order = gather_order(pidx_t, nt)
        _build.launch("gather", "gather", "msm_row_gather_sorted", table, order, out, nf * k, w)
    return out


def row_gather_flat(table: torch.Tensor, flat_idx: torch.Tensor, k: int = 64) -> torch.Tensor:
    """table[flat_idx] for a flat [N] index vector (N a multiple of k)
    through :func:`row_gather`: the counterpart of the JAX package's
    ops/pallas/gather.py::dma_gather_flat, which the extraction gathers take
    under MSM_DMA_EXTRACT.  The kernels take any row width that is a
    multiple of 4 words, so the 64-word carry rows need no padding to 128."""
    n = flat_idx.shape[0]
    if n % k:
        raise ValueError(f"{n} indices: expected a multiple of {k}")
    return row_gather(table, flat_idx.to(torch.int32).reshape(n // k, k).T.contiguous())
