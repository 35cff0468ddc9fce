"""Codecs between python ints and the u32 word layouts of the pipeline."""

from __future__ import annotations

from collections.abc import Iterable, Sequence

import numpy as np


def words_le_to_int(words: Sequence[int] | np.ndarray, word_size: int) -> int:
    """Little-endian words of `word_size` bits -> python int."""
    val = 0
    for i, w in enumerate(np.asarray(words).tolist()):
        val += int(w) << (i * word_size)
    return val


def ints_to_u32_words(vals: Iterable[int], num_u32: int = 8) -> np.ndarray:
    """[n] ints -> [n, num_u32] uint32 little-endian 32-bit words: the input
    layout of coordinates and scalars."""
    vals = list(vals)
    out = np.empty((len(vals), num_u32), dtype=np.uint32)
    for i, v in enumerate(vals):
        for j in range(num_u32):
            out[i, j] = (v >> (32 * j)) & 0xFFFFFFFF
    return out


def u32_words_to_ints(arr: np.ndarray) -> list[int]:
    """Inverse of :func:`ints_to_u32_words`."""
    arr = np.asarray(arr, dtype=np.uint64)
    out = []
    for row in arr:
        val = 0
        for j in range(arr.shape[1] - 1, -1, -1):
            val = (val << 32) | int(row[j])
        out.append(val)
    return out
