"""u32 arrays between numpy and the port's tensors, and a precomputed base
from the JAX package's.

The port holds u32 data as torch.int32 tensors with the same bits; the
kernels read them as uint32_t.
"""

from __future__ import annotations

import numpy as np
import torch


def from_numpy_u32(a: np.ndarray, device=None) -> torch.Tensor:
    """A numpy uint32 array -> an int32 tensor with the same bits on `device`
    (default: the CPU)."""
    if a.dtype != np.uint32:
        raise TypeError(f"expected a uint32 array, got {a.dtype}")
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a.view(np.int32)).to(device or "cpu")


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """An int32 tensor -> a numpy uint32 array with the same bits."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected an int32 tensor, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def precomputed_from_numpy(table: np.ndarray, chunk_size: int, n: int, nblk: int, blocks: int,
                           device=None):
    """A precomputed base (ops/precompute.py::PrecomputedBase) on `device`
    (default: the CPU) from the parts of the JAX package's: its merged table
    as a numpy uint32 array, its window size and its ints."""
    from ..ops.precompute import PrecomputedBase
    from .params import MsmConfig

    return PrecomputedBase(table=from_numpy_u32(table, device),
                           cfg=MsmConfig(chunk_size=chunk_size, scalar_bits=253),
                           n=n, nblk=nblk, blocks=blocks)
