"""Fixed-base (precomputed SRS) MSM: the merged single-window pipeline.

Port of the JAX package's ops/precompute.py.  A prover runs many MSMs over
one point set; once per set, this precomputes the window-shifted points

    Q[j*n + i] = 2^(c*j) * P[i]        j = 0..W'-1  (window-major)

and their single table (no negations: W' times the points already), so that
each MSM is ONE merged window: entry (i, j) adds digit_j(k_i) * Q[j*n + i]
and all W'*n entries share one space of 2^(c-1) signed buckets.  Scalars
below the subgroup order need only 253 bits, W' = ceil(253 / c) windows.

Precompute: _to_mont_rows (torch ops), then per window double_rows (kernel,
c doublings) and normalize_rows (kernel, batch inversion) with the
un-Montgomery and word repack in torch ops, then build_table (kernel) over
the W'*n merged points.  Per MSM: the digits (torch ops), per entry block
window_group_bucket_sums in block mode (sort, hist, gather, the signed scan,
carries, extraction), the blocks' buckets added with masked_add_rows, and
bpr over the one window, whose sum is the total (no Horner fold).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.params import PARAMS, MsmConfig
from ..utils.runtime import device_memory_bytes
from . import convert as CV
from . import field as F
from .kernels.bpr import bpr
from .kernels.common import LP, int_to_limbs, to_i32
from .kernels.convert import build_table
from .kernels.ec import TW, double_rows, masked_add_rows
from .kernels.precompute import normalize_rows
from .kernels.scan import K, TWR
from .msm_pipeline import _STAGING_BYTES_PER_ENTRY, window_group_bucket_sums

#: Entry-block granularity: the bucket sums pad their entries to a multiple
#: of 128 fragments of K.
_BLK_UNIT = K * 128


def fixed_base_config(n: int) -> MsmConfig:
    """c = 16 over 253 bits (W' = 16), the JAX package's choice for every
    n; its re-derivation on the H100 is queued in ROADMAP.md."""
    return MsmConfig(chunk_size=16, scalar_bits=253)


# ---------------------------------------------------------------------------
# Precompute: the window-shifted point set.


def _pack_limb_cols(a: torch.Tensor) -> torch.Tensor:
    """[n, L] limbs -> [n, LP] packed words (two limbs each)."""
    return a[:, 0::2] | (a[:, 1::2] << 16)


def _unpack_limb_cols(a: torch.Tensor) -> torch.Tensor:
    """[n, LP] packed words -> [n, L] limbs."""
    return torch.stack([a & 0xFFFF, a >> 16], dim=-1).reshape(a.shape[0], -1)


def _to_mont_rows(coords: torch.Tensor) -> torch.Tensor:
    """[n, 2, 8] affine words -> [n, TW] int32 packed Montgomery (x, y, t, z)
    rows with z = R."""
    xm, ym, tm = CV.points_to_mont_limbs(coords)
    z = torch.from_numpy(int_to_limbs(PARAMS.r).astype(np.int64)).to(coords.device)
    rows = torch.cat([_pack_limb_cols(v) for v in (xm, ym, tm, z.expand_as(xm))], dim=1)
    pad = torch.zeros((rows.shape[0], TW - 4 * LP), dtype=torch.int64, device=rows.device)
    return to_i32(torch.cat([rows, pad], dim=1))


def _normalize_rows_to_coords(rows: torch.Tensor) -> torch.Tensor:
    """[n, TW] packed projective rows -> [n, 2, 8] int32 standard-form affine
    words: normalize_rows (kernel), then from_mont and the word repack."""
    norm = normalize_rows(rows).to(torch.int64) & 0xFFFFFFFF
    xy = torch.stack([_unpack_limb_cols(norm[:, 0:LP]), _unpack_limb_cols(norm[:, LP:2 * LP])])
    words = CV.limbs_to_u32_words(F.from_mont(xy))                   # [2, n, 8]
    return to_i32(words.permute(1, 0, 2))


def shifted_base_coords(coords: torch.Tensor, cfg: MsmConfig) -> torch.Tensor:
    """[n, 2, 8] affine words -> [W'*n, 2, 8] window-major shifted words:
    window j holds 2^(c*j) * P_i."""
    out = [coords]
    rows = _to_mont_rows(coords)
    for _ in range(cfg.num_windows - 1):
        rows = double_rows(rows, cfg.chunk_size)
        out.append(_normalize_rows_to_coords(rows))
    return torch.cat(out)


# ---------------------------------------------------------------------------
# Per-MSM stages.


def _stage_merged_digits(scalars: torch.Tensor, cfg: MsmConfig, pad_to: int) -> torch.Tensor:
    """[n, 8] scalars -> [pad_to] window-major signed digits (entry j*n + i
    is digit j of scalar i), zero-padded to the entry-block grid."""
    d = CV.decompose_scalars_signed(scalars, cfg).T.reshape(-1)
    if pad_to != d.shape[0]:
        d = torch.cat([d, torch.zeros(pad_to - d.shape[0], dtype=d.dtype, device=d.device)])
    return d


def _stage_merged_block(table: torch.Tensor, digits: torch.Tensor, b: int, nb: int,
                        nblk: int) -> torch.Tensor:
    """[nb, TW] bucket partial sums of entry block b: entry i of the block
    reads table row b*nblk + i."""
    d = digits[b * nblk:(b + 1) * nblk]
    return window_group_bucket_sums(table, d[None, :], nb, table_base=b * nblk)


def _stage_merged_accum(acc: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    """EC-add two [nb, TW] bucket arrays of disjoint entry blocks."""
    ones = torch.ones((acc.shape[0],), dtype=torch.int32, device=acc.device)
    return masked_add_rows(acc, part, ones)


def _stage_merged_total(buckets: torch.Tensor) -> torch.Tensor:
    """[nb, TW] merged buckets -> [1, TW] packed projective total: the one
    window's sum is the MSM."""
    return bpr(buckets, 1)


# ---------------------------------------------------------------------------
# The precomputed base and the per-MSM entry.


@dataclasses.dataclass
class PrecomputedBase:
    """The precomputed SRS on its device: the merged single table and the
    shape facts every MSM over it needs."""

    table: torch.Tensor       # [W'*n, TWR] int32 cached rows, window-major
    cfg: MsmConfig            # the merged window's c, 253 bits
    n: int                    # padded point count
    nblk: int                 # entries per streamed block
    blocks: int               # block count (nblk * blocks >= W'*n)

    @property
    def n_entries(self) -> int:
        return self.cfg.num_windows * self.n

    @property
    def table_bytes(self) -> int:
        return self.table.numel() * 4


def default_entry_block(n_entries: int, table_bytes: int, device=None) -> tuple[int, int]:
    """(nblk, blocks): the fewest blocks whose per-block staging (about
    _STAGING_BYTES_PER_ENTRY bytes per entry) fits 85% of the device's
    memory beside the merged table."""
    budget = max(int(0.85 * device_memory_bytes(device)) - table_bytes,
                 _BLK_UNIT * _STAGING_BYTES_PER_ENTRY)
    cap = max(budget // _STAGING_BYTES_PER_ENTRY, _BLK_UNIT)
    blocks = max(1, -(-n_entries // cap))
    per_block = -(-n_entries // blocks)
    nblk = -(-per_block // _BLK_UNIT) * _BLK_UNIT
    return nblk, -(-n_entries // nblk)


def precompute_fixed_base(coords: torch.Tensor, cfg: MsmConfig | None = None) -> PrecomputedBase:
    """The precomputed SRS of [n, 2, 8] int32 affine words (n a multiple of
    K), on their device.  Raises when the merged table would pass 60% of the
    device's memory."""
    n = coords.shape[0]
    if n % K:
        raise ValueError(f"n={n} must be a multiple of {K} (pad first)")
    if cfg is None:
        cfg = fixed_base_config(n)
    table_bytes = cfg.num_windows * n * TWR * 4
    if table_bytes > 0.6 * device_memory_bytes(coords.device):
        raise ValueError(
            f"merged fixed-base table ({table_bytes / 2**30:.1f} GiB at W'={cfg.num_windows}) "
            "exceeds 60% of device memory; use compute_msm for larger point sets")
    merged = shifted_base_coords(coords, cfg)
    table = build_table(merged)
    del merged
    nblk, blocks = default_entry_block(cfg.num_windows * n, table.numel() * 4, coords.device)
    return PrecomputedBase(table=table, cfg=cfg, n=n, nblk=nblk, blocks=blocks)


def fixed_base_total_rows(pre: PrecomputedBase, scalars: torch.Tensor) -> torch.Tensor:
    """One MSM against the precomputed base: [n, 8] int32 scalar words ->
    [1, TW] packed projective total."""
    if scalars.shape[0] != pre.n:
        raise ValueError(f"{scalars.shape[0]} scalars for {pre.n} points")
    nb = pre.cfg.num_buckets
    digits = _stage_merged_digits(scalars, pre.cfg, pre.nblk * pre.blocks)
    acc = None
    for b in range(pre.blocks):
        part = _stage_merged_block(pre.table, digits, b, nb, pre.nblk)
        acc = part if acc is None else _stage_merged_accum(acc, part)
    return _stage_merged_total(acc)
