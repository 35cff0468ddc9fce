"""Row gather into scan order: out[f*K + j] = table[pidx_t[j, f]].

Kernel: csrc/gather.cu.  It replaces the JAX package's
ops/pallas/gather.py::dma_row_gather (its _dma_gather_kernel drove the TPU's
DMA engines); the pipeline takes it at >= 2^21 gathered rows per window
group and plain indexing below that, as the JAX pipeline does.
"""

from __future__ import annotations

import torch

from . import _build


def row_gather_plain(table: torch.Tensor, pidx_t: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`row_gather`."""
    return table[pidx_t.T.reshape(-1).to(torch.int64)]


def row_gather(table: torch.Tensor, pidx_t: torch.Tensor) -> torch.Tensor:
    """table: [nt, w] int32 rows (w a multiple of 4); pidx_t: [K, NF] int32
    with the row of entry f*K + j at [j, f], each in [0, nt).  Returns
    [NF*K, w], equal to table[pidx] for the flat entry-major index.
    Launches csrc/gather.cu on CUDA tensors; CPU tensors take the plain
    version."""
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
    _build.launch("gather", "gather", "msm_row_gather", table, pidx_t, out, nf, k, w)
    return out


def row_gather_flat(table: torch.Tensor, flat_idx: torch.Tensor, k: int = 64) -> torch.Tensor:
    """table[flat_idx] for a flat [N] index vector (N a multiple of k)
    through :func:`row_gather`: the counterpart of the JAX package's
    ops/pallas/gather.py::dma_gather_flat, which the extraction gathers take
    under MSM_DMA_EXTRACT.  The kernel takes any row width that is a multiple
    of 4 words, so the 64-word carry rows need no padding to 128."""
    n = flat_idx.shape[0]
    if n % k:
        raise ValueError(f"{n} indices: expected a multiple of {k}")
    return row_gather(table, flat_idx.to(torch.int32).reshape(n // k, k).T.contiguous())
