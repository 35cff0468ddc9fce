"""The bucket sort's input (ops/kernels/digits.py): the plain version of
signed_window_entries against decompose_scalars_signed followed by the
pipeline's entries step, and against the python-int digit mirror, bit for
bit; then the pipeline's steps around it.

No JAX here: the digits and the entries step are held to the JAX package by
tests/test_torch_pipeline.py and tests/test_torch_precompute.py; this file
holds the one-pass form to them.
"""

import numpy as np
import pytest
import torch

from webgpu_msm_twisted_edwards_tpu_torch.cpu.mirrors import decompose_scalars_signed as mirror
from webgpu_msm_twisted_edwards_tpu_torch.ops import msm_pipeline as MP
from webgpu_msm_twisted_edwards_tpu_torch.ops import precompute as PRE
from webgpu_msm_twisted_edwards_tpu_torch.ops.convert import decompose_scalars_signed
from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import digits as D
from webgpu_msm_twisted_edwards_tpu_torch.utils.limbs import ints_to_u32_words
from webgpu_msm_twisted_edwards_tpu_torch.utils.params import SUBGROUP_ORDER, MsmConfig


def _scalars(c: int) -> list[int]:
    """Scalars below the subgroup order that drive the carry chain: 0, 1,
    r - 1, 2^(c-1) - 1 and 2^(c-1) (the wrap's edge), all-ones runs over one
    window, two windows, a 32-bit word, a word straddled by a 13-bit window
    and everything below bit 250, every window at 2^(c-1) (a carry into
    each next window), then random ones."""
    r = SUBGROUP_ORDER
    half = 1 << (c - 1)
    special = [0, 1, r - 1, half - 1, half, (1 << c) - 1, (1 << 2 * c) - 1,
               0xFFFFFFFF << 32, 0xFFFFFFFF << 96, ((1 << 39) - 1) << 26, (1 << 250) - 1,
               sum(half << (c * w) for w in range(250 // c)),
               sum(((1 << c) - 1) << (c * w) for w in range(0, 250 // c, 2))]
    rng = np.random.default_rng(c)
    rand = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(243)]
    return [s % r for s in special] + rand


@pytest.mark.parametrize("window_range", ["all", "slice"])
@pytest.mark.parametrize("table", ["doubled", "single"])
@pytest.mark.parametrize("c", [16, 13, 8])
def test_signed_window_entries_plain(c, table, window_range):
    """(c, W) = (16, 16), (13, 20), (8, 32); the doubled table (sbit n, rows
    from 0), or the fixed base's single table (sbit 1 << 30, rows from a
    table base by n a window); all windows, or a proper slice of them."""
    cfg = MsmConfig(chunk_size=c)
    nw = cfg.num_windows
    assert nw == {16: 16, 13: 20, 8: 32}[c]
    ints = _scalars(c)
    n = len(ints)
    scalars = torch.from_numpy(ints_to_u32_words(ints).view(np.int32).copy())
    sbit, base, stride = (n, 0, 0) if table == "doubled" else (1 << 30, 5 * n, n)
    w0, wg = (0, nw) if window_range == "all" else (3, nw // 2)

    keys, idxs = D.signed_window_entries(scalars, cfg, sbit, base, stride, w0, wg)
    assert keys.dtype == idxs.dtype == torch.int32 and keys.shape == idxs.shape == (wg, n)

    digits = decompose_scalars_signed(scalars, cfg).T[w0:w0 + wg]
    want = D.window_entries(digits, cfg.num_buckets, sbit, base + w0 * stride, stride)
    assert torch.equal(keys, want[0]) and torch.equal(idxs, want[1])

    ref = np.array(mirror(ints, nw, c), dtype=np.int64).T[w0:w0 + wg]       # [wg, n]
    rows = base + (w0 + np.arange(wg))[:, None] * stride + np.arange(n)[None, :]
    np.testing.assert_array_equal(keys.numpy(),
                                  np.where(ref == 0, cfg.num_buckets, np.abs(ref) - 1))
    np.testing.assert_array_equal(idxs.numpy(), np.where(ref < 0, rows + sbit, rows))


def test_window_entries_is_the_bucket_sums_entries_step(monkeypatch):
    """window_group_bucket_sums hands entry_bucket_sums the entries of its
    digits: on the doubled table rows from 0 with sign n, in block mode rows
    from table_base with sign bit 30."""
    n, nb = 64, 128
    digits = torch.from_numpy(np.random.default_rng(3).integers(-nb, nb, size=(2, n))
                              .astype(np.int32))
    seen = []
    monkeypatch.setattr(MP, "entry_bucket_sums", lambda *a, **k: seen.append(a))
    MP.window_group_bucket_sums(torch.zeros((2 * n, 1), dtype=torch.int32), digits, nb)
    MP.window_group_bucket_sums(torch.zeros((n, 1), dtype=torch.int32), digits, nb,
                                table_base=640)
    for (_, keys, idxs, nb_, single, fused), sbit, base in zip(seen, (n, 1 << 30), (0, 640)):
        want = D.window_entries(digits, nb, sbit, base)
        assert torch.equal(keys, want[0]) and torch.equal(idxs, want[1])
        assert nb_ == nb and single == (sbit != n) and not fused


def test_merged_entries_are_the_merged_digits_entries():
    """The fixed base's entries, padded past W'*n to the block grid, are
    block by block what its digit stage's blocks give the bucket sums: key
    nb and the entry's own row in the padding."""
    cfg = MsmConfig(chunk_size=8, scalar_bits=253)
    ints = _scalars(8)[:64]
    scalars = torch.from_numpy(ints_to_u32_words(ints).view(np.int32).copy())
    nblk, blocks = 1024, 3
    keys, idxs = PRE._stage_merged_entries(scalars, cfg, nblk * blocks)
    digits = PRE._stage_merged_digits(scalars, cfg, nblk * blocks)
    assert keys.shape == idxs.shape == (nblk * blocks,)
    for b in range(blocks):
        blk = slice(b * nblk, (b + 1) * nblk)
        want = D.window_entries(digits[None, blk], cfg.num_buckets, 1 << 30, b * nblk)
        assert torch.equal(keys[None, blk], want[0]) and torch.equal(idxs[None, blk], want[1])
    assert int(keys[64 * 32:].min()) == cfg.num_buckets

