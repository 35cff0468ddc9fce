"""Bucket counts per window: counts[w, b] = #{i : keys[w, i] == b} for
b < nb; the sentinel key nb (a zero digit) is not counted.

Kernel: csrc/hist.cu (a histogram in the shared memory of a thread block
cluster, which writes every count), replacing the JAX package's
ops/pallas/hist.py::_hist_body.
"""

from __future__ import annotations

import torch

from . import _build


def bucket_counts_plain(keys: torch.Tensor, nb: int) -> torch.Tensor:
    """Plain version of :func:`bucket_counts`."""
    wg = keys.shape[0]
    k = keys.to(torch.int64)
    valid = (k >= 0) & (k < nb)
    flat = (torch.arange(wg, device=keys.device)[:, None] * nb + k)[valid]
    return torch.bincount(flat, minlength=wg * nb).reshape(wg, nb).to(torch.int32)


def bucket_counts(keys: torch.Tensor, nb: int) -> torch.Tensor:
    """keys: [Wg, n] int32 in [0, nb] -> [Wg, nb] int32 counts.  Key order is
    irrelevant.  Launches csrc/hist.cu on CUDA tensors; CPU tensors take the
    plain version."""
    _build.capture("hist", keys, nb)
    if not _build.on_cuda(keys):
        return bucket_counts_plain(keys, nb)
    if keys.dtype != torch.int32 or keys.dim() != 2:
        raise TypeError(f"keys: expected a 2-d int32 tensor, got {keys.dtype} {tuple(keys.shape)}")
    wg, n = keys.shape
    counts = torch.empty((wg, nb), dtype=torch.int32, device=keys.device)
    # The kernel reads the keys where they lie: the pipeline's are a
    # transposed view, and a contiguous copy would cost more than the count.
    _build.launch("hist", "hist", "msm_bucket_counts", keys, counts, wg, n, nb, *keys.stride())
    return counts
