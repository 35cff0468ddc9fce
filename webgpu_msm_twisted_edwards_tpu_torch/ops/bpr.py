"""Parallel running-sum bucket reduction in plain torch ops: the JAX
package's ops/bpr.py, which XLA compiles (the small-input path's stage 4;
the bucket pipeline reduces on the kernels of ops/kernels/bpr.py).

Per window S = sum_b (b + 1) * B[b] over [W, NB] bucket sums: the buckets
split into chunks; per chunk, a descending running sum gives its total m
and its locally weighted sum g; the fix-up g += m * (chunk base) runs by
double-and-add on every chunk lane; a pairwise tree adds the chunks.
"""

from __future__ import annotations

import torch

from . import curve as C


def reduce_buckets(buckets: C.PointXYTZ, num_chunks: int = 256) -> C.PointXYTZ:
    """[W, NB] bucket sums -> [W] window sums; bucket b (0-based) has weight
    b + 1.  num_chunks is clamped to NB and must divide it."""
    wdim, nb = buckets.batch_shape
    num_chunks = min(num_chunks, nb)
    if nb % num_chunks:
        raise ValueError(f"{num_chunks} chunks do not divide {nb} buckets")
    chunk_len = nb // num_chunks
    dev = buckets.x.device
    bk = C.PointXYTZ(*(u.reshape(wdim, num_chunks, chunk_len, u.shape[-1]) for u in buckets))

    m = g = C.identity((wdim, num_chunks), dev)
    for idx in range(chunk_len - 1, -1, -1):
        m = C.add(m, bk.at((slice(None), slice(None), idx)))
        g = C.add(g, m)

    # Local weights were 1..chunk_len; chunk t's are t*chunk_len + 1 onwards.
    chunk_base = (torch.arange(num_chunks, device=dev) * chunk_len).expand(wdim, num_chunks)
    num_bits = max(1, (nb - chunk_len).bit_length())
    g = C.add(g, C.scale_u32(m, chunk_base, num_bits))
    return C.tree_reduce_axis(g, axis=1)
