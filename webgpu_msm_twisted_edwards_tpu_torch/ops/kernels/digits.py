"""The bucket sort's input: per window, each entry's sort key and signed
table row, made from the scalar words in one pass.

For the windows [w0, w0 + wg) of the signed c-bit digits d of scalar i
(ops/convert.py::decompose_scalars_signed):

    keys[w - w0, i] = nb if d == 0 else |d| - 1
    idxs[w - w0, i] = row_base + w * row_stride + i, plus sbit if d < 0

both [wg, n] int32, window-major.  The doubled table takes sbit = n (the
negated half) and row_stride = 0; the fixed base's merged single table
sbit = 1 << 30 (the sign rides payload bit 30 for the scan) and
row_stride = n, so entry w*n + i reads row w*n + i.

Kernel: csrc/digits.cu.  It replaces no TPU kernel: the JAX package leaves
this work to XLA, and the plain version is the port's PyTorch form of it.
"""

from __future__ import annotations

import torch

from ...utils.params import MsmConfig
from ..convert import decompose_scalars_signed
from . import _build


def window_entries(digits: torch.Tensor, nb: int, sbit: int, row_base: int = 0,
                   row_stride: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """[wg, n] signed digits -> (keys, idxs), each [wg, n] int32: the key and
    signed row of each entry, the first window's rows from row_base."""
    wg, n = digits.shape
    keys = torch.where(digits == 0, nb, digits.abs() - 1).to(torch.int32)
    idx = torch.arange(n, dtype=torch.int32, device=digits.device)
    if row_base:
        idx = idx + row_base
    if row_stride:
        idx = idx + torch.arange(wg, dtype=torch.int32, device=digits.device)[:, None] * row_stride
    return keys, torch.where(digits < 0, idx + sbit, idx)


def signed_window_entries_plain(scalars: torch.Tensor, cfg: MsmConfig, sbit: int,
                                row_base: int = 0, row_stride: int = 0, w0: int = 0,
                                wg: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`signed_window_entries`."""
    wg = cfg.num_windows - w0 if wg is None else wg
    digits = decompose_scalars_signed(scalars, cfg).T[w0:w0 + wg]
    return window_entries(digits, cfg.num_buckets, sbit, row_base + w0 * row_stride, row_stride)


def signed_window_entries(scalars: torch.Tensor, cfg: MsmConfig, sbit: int, row_base: int = 0,
                          row_stride: int = 0, w0: int = 0,
                          wg: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """[n, 8] int32 scalar words -> (keys, idxs), each [wg, n] int32, for the
    windows [w0, w0 + wg) of cfg (wg=None: through the last).  Launches
    csrc/digits.cu on CUDA tensors; CPU tensors take the plain version."""
    _build.capture("digits", scalars, cfg, sbit, row_base, row_stride, w0, wg)
    if not _build.on_cuda(scalars):
        return signed_window_entries_plain(scalars, cfg, sbit, row_base, row_stride, w0, wg)
    c, nw = cfg.chunk_size, cfg.num_windows
    wg = nw - w0 if wg is None else wg
    scalars = _build.check(scalars, torch.int32, (-1, 8), "scalars")
    n = scalars.shape[0]
    last_row = row_base + (w0 + wg - 1) * row_stride + n - 1 + sbit
    if not (1 <= c <= 30 and 0 <= w0 and 0 < wg and w0 + wg <= nw
            and (w0 + wg - 1) * c < 256 and wg * n < 1 << 31 and last_row < 1 << 31
            and min(row_base, row_stride, sbit) >= 0):
        raise ValueError(f"signed_window_entries: c={c}, windows [{w0}, {w0 + wg}) of {nw}, "
                         f"n={n}, sbit={sbit}, rows from {row_base} by {row_stride}")
    keys = torch.empty((wg, n), dtype=torch.int32, device=scalars.device)
    idxs = torch.empty((wg, n), dtype=torch.int32, device=scalars.device)
    _build.launch("digits", "digits", "msm_signed_window_entries", scalars, keys, idxs, n, c, w0,
                  wg, cfg.num_buckets, sbit, row_base, row_stride)
    return keys, idxs
