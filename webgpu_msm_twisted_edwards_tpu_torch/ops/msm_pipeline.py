"""The MSM device pipeline: window sums, or the folded total, of
[n, 2, 8] affine point words and [n, 8] scalar words.

Port of the JAX package's ops/msm_pipeline.py:

    1. table + digits   build_prod_table: build_table_doubled (kernel), rows
                        n..2n-1 the negated points, or under MSM_SINGLE_TABLE
                        build_table (kernel), n rows;
                        decompose_scalars_signed (torch) the signed digits.
    2. per window group bucket sums (window_group_bucket_sums):
                        a sort of (bucket key, signed row) per window;
                        bucket_counts (kernel); a fragment scan (kernel, one
                        of the variants of ops/kernels/scan.py) that reads
                        the table rows by index, or under the quarter store
                        and the limb-major layout scans rows that row_gather
                        (kernel) or plain indexing copied into sorted order
                        first; the carry scan seg_carry_scan (kernels);
                        extraction at bucket ends through masked_add_rows
                        (kernel), or extract_reconstruct_rows (kernel) after
                        the quarter-store scan.
    3. bpr (kernels) to window sums, and horner_fold (kernel) to the total.

The switches below select among the JAX package's configurations of step 2.
Each is read from its environment variable once, at import, with the JAX
package's name and default, into a module attribute that the pipeline reads
at call time, so a caller may also set the attribute.  With none set, the
pipeline runs the doubled table, the row-major scan input (read by index
from the table inside the scan, keys compared in the kernel) and the stable
two-operand sort.

window_group_bucket_sums also serves the fixed-base path (ops/precompute.py):
given table_base, the digits are one block of a merged window-major single
table (no negations), the digit sign rides bit 30 of the sorted payload, and
the scan applies it.

Every stage matches the JAX package's output bit for bit on the same input,
in every configuration.
"""

from __future__ import annotations

import os

import torch

from ..utils.params import MsmConfig
from ..utils.runtime import device_memory_bytes
from .convert import decompose_scalars_signed
from .kernels.bpr import bpr, horner_fold
from .kernels.convert import build_table, build_table_doubled
from .kernels.ec import TW, extract_reconstruct_rows, identity_row, masked_add_rows
from .kernels.gather import row_gather, row_gather_flat
from .kernels.hist import bucket_counts
from .kernels.scan import (
    K,
    LBLK,
    TWR,
    keys_to_sames,
    msm_scan_fused,
    msm_scan_pret,
    msm_scan_rm_sames_q,
    msm_scan_sames,
    msm_scan_signed,
    msm_scan_table_signed,
    seg_carry_scan,
)

#: MSM_SCAN_SAMES: the limb-major scan takes hoisted same-segment bits
#: (msm_scan_sames); "0" compares the keys in the kernel (msm_scan_pret).
_SCAN_SAMES = os.environ.get("MSM_SCAN_SAMES", "1") == "1"
#: MSM_SINGLE_TABLE: an n-row table without negations; the scan applies the
#: digit signs (msm_scan_table_signed, msm_scan_signed).
_SINGLE_TABLE = os.environ.get("MSM_SINGLE_TABLE", "0") == "1"
#: MSM_SCAN_LAYOUT: "rm" scans the rows in row-major order (read by index
#: from the table, or gathered first under the quarter store); "pret"
#: gathers by indexing and permutes the rows into the limb-major
#: [NF//lblk, K, 64, lblk] layout first.
_SCAN_LAYOUT = os.environ.get("MSM_SCAN_LAYOUT", "rm")
#: MSM_DMA_GATHER: the quarter store (the one row-major scan that reads
#: gathered rows) gathers on the row-gather kernel from _DMA_GATHER_MIN_ROWS
#: rows per window group; "0" always indexes.
_DMA_GATHER = os.environ.get("MSM_DMA_GATHER", "1") == "1"
#: MSM_DMA_EXTRACT: the extraction gathers (scan rows, scan-input rows,
#: carries) go through the row-gather kernel instead of indexing.
_DMA_EXTRACT = os.environ.get("MSM_DMA_EXTRACT", "0") == "1"
#: MSM_SORT_I64: one sort of (key << 32) | row in int64 in place of the
#: stable sort of keys with rows; within a bucket, entries then come in row
#: order, so bucket sums are the same points in other representatives.
_SORT_I64 = os.environ.get("MSM_SORT_I64", "0") == "1"
#: MSM_SCAN_QSTORE: the row-major doubled-table scan stores only steps 4i+2
#: and 4i+3 (msm_scan_rm_sames_q); extraction replays the others
#: (extract_reconstruct_rows).
_SCAN_QSTORE = os.environ.get("MSM_SCAN_QSTORE", "0") == "1"
#: MSM_DMA_GATHER_MIN_ROWS: from this many gathered rows per window group
#: the quarter store gathers on the row-gather kernel.  The JAX package's
#: gate value, kept so the two paths split where they do there; its
#: re-derivation on the H100 is queued in ROADMAP.md.
_DMA_GATHER_MIN_ROWS = int(os.environ.get("MSM_DMA_GATHER_MIN_ROWS", 1 << 21))

#: Device memory per staged (window, point) entry of one window group that
#: default_window_group budgets for.  The JAX package's value, kept so the
#: window groups match; its re-derivation on the H100 is queued in
#: ROADMAP.md.
_STAGING_BYTES_PER_ENTRY = 1300


def build_full_table(coords: torch.Tensor) -> torch.Tensor:
    """[n, 2, 8] -> [2n, TWR]: rows 0..n-1 the points, rows n..2n-1 their
    negations, so a digit's sign rides the gather index (row + n)."""
    return build_table_doubled(coords)


def build_prod_table(coords: torch.Tensor) -> torch.Tensor:
    """The table of the configured layout: [2n, TWR] doubled rows, or
    [n, TWR] single-table rows under _SINGLE_TABLE."""
    return build_table(coords) if _SINGLE_TABLE else build_full_table(coords)


def _sort_entries(keys: torch.Tensor, idxs: torch.Tensor):
    """Per window, entries in (bucket key, ...) order: (keys_s, idxs_s)."""
    if _SORT_I64:
        # Both fields are non-negative and idx < 2^31, so int64 order is
        # (key, idx) order and the low word unpacks exactly.
        kv, _ = torch.sort((keys.to(torch.int64) << 32) | idxs.to(torch.int64), dim=1)
        return (kv >> 32).to(torch.int32), (kv & 0xFFFFFFFF).to(torch.int32)
    # Stable, as lax.sort: equal keys keep their order, so every bucket sums
    # its points in the JAX package's order.
    keys_s, perm = torch.sort(keys, dim=1, stable=True)
    return keys_s, torch.gather(idxs, 1, perm)


def _gathered_rows(table: torch.Tensor, flat_pidx: torch.Tensor, nf: int,
                   total: int) -> torch.Tensor:
    """The table rows of the entries in sorted order, [NF, K, TWR]: on the
    row-gather kernel from _DMA_GATHER_MIN_ROWS entries (total, padding
    not counted), else by indexing."""
    if _DMA_GATHER and total >= _DMA_GATHER_MIN_ROWS:
        rows = row_gather(table, flat_pidx.reshape(nf, K).T.contiguous())
    else:
        rows = table[flat_pidx.to(torch.int64)]
    return rows.reshape(nf, K, TWR)


def _pret_rows(table: torch.Tensor, flat_pidx: torch.Tensor, nf: int) -> torch.Tensor:
    """Gathered rows in the limb-major [NF//lblk, K, 64, lblk] layout: word i
    of entry f*K + j at [f // lblk, j, i, f % lblk], lblk = LBLK halved until
    it divides NF.  The permute is a copy of every row's first 64 words."""
    lblk = LBLK
    while nf % lblk:
        lblk //= 2
    rows = table[flat_pidx.to(torch.int64)]                          # [NF*K, TWR]
    return rows.reshape(nf // lblk, lblk, K, TWR)[..., :64].permute(0, 2, 3, 1).contiguous()


def window_group_bucket_sums(table: torch.Tensor, digits_g: torch.Tensor, nb: int,
                             table_base: int | None = None,
                             fused: bool = False) -> torch.Tensor:
    """digits_g: [Wg, n] signed digits of one group of windows; table:
    [2n, TWR] doubled rows (negations in rows n..2n-1), or [n, TWR]
    single-table rows (no negations; the scan applies the digit signs).
    Returns [Wg * nb, TW] packed bucket sums: bucket key b holds the sum of
    the points whose digit is +-(b+1), sign applied.

    table_base selects the fixed-base block mode: the table is a single
    table of any size and entry i reads row table_base + i.  Entries padded
    past the table's end (zero digits, so the sentinel bucket) read its last
    row, as the JAX package's clamping gather does, and are never extracted.

    The row-major scans other than the quarter store's read each entry's
    table row by index inside the scan, so no gathered copy of the rows is
    made: on the doubled table msm_scan_fused, which compares the keys in
    the kernel, on the single table msm_scan_table_signed.  The JAX package
    keeps its fused scan as an experiment, measured slower on the TPU, and
    gathers first; on an H100 the scan reads the 60 used words of each row
    where they lie, in under half the time of a gather kernel that copies
    whole rows and a scan that reads them back, and without the copy's
    memory (PERF.md).  msm_scan_table_sames, which reads hoisted same bits
    as the JAX default does, was as fast a kernel, but with the pass that
    hoists the bits it was slower end to end.  The quarter store's extraction
    replays steps from the scan's input rows, so it still gathers them, as
    the limb-major layouts do.

    fused=True runs msm_scan_fused (doubled table only) whatever the layout
    switches say.  The module's switches pick the other configurations."""
    wg, n = digits_g.shape
    if table_base is not None:
        single = True
    else:
        single = table.shape[0] == n
        if table.shape[0] not in (n, 2 * n):
            raise ValueError(f"table has {table.shape[0]} rows, expected {n} (single) "
                             f"or {2 * n} (doubled)")
    if fused and single:
        raise ValueError("fused=True needs the doubled table")
    dev = digits_g.device
    d = digits_g
    keys = torch.where(d == 0, nb, d.abs() - 1).to(torch.int32)      # [Wg, n]
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    if table_base is not None:
        idx = idx + table_base
    # Doubled table: the sign selects the negated half (row idx + n).
    # Single table: the sign rides payload bit 30 for the scan to apply.
    sbit = (1 << 30) if single else n
    idxs = torch.where(d < 0, idx + sbit, idx)
    keys_s, idxs_s = _sort_entries(keys, idxs)

    if nb % 128 == 0:
        counts = bucket_counts(keys, nb)                              # [Wg, nb]
        ends = torch.cumsum(counts, dim=1) - 1                        # int64
    else:
        # Windows of c < 8 bits, as the JAX package counts them: a binary
        # search of the sorted keys.
        queries = torch.arange(nb + 1, dtype=torch.int32, device=dev).expand(wg, -1)
        offsets = torch.searchsorted(keys_s.contiguous(), queries.contiguous(), side="left")
        counts = offsets[:, 1:] - offsets[:, :nb]
        ends = offsets[:, 1:] - 1

    # Flatten window-major and pad with sentinel entries to a multiple of
    # 128 fragments (their scan values and carries are never extracted).
    wofs = torch.arange(wg, dtype=torch.int32, device=dev)[:, None] * (nb + 2)
    flat_keys = keys_s.reshape(-1)
    flat_gkeys = (keys_s + wofs).reshape(-1)
    flat_pidx = idxs_s.reshape(-1)
    total = wg * n
    nf = -(-(total // K) // 128) * 128
    pad_e = nf * K - total
    if pad_e:
        def full(v):
            return torch.full((pad_e,), v, dtype=torch.int32, device=dev)
        flat_keys = torch.cat([flat_keys, full(nb)])
        flat_gkeys = torch.cat([flat_gkeys, full((wg - 1) * (nb + 2) + nb)])
        flat_pidx = torch.cat([flat_pidx, full(0)])

    keys_t = flat_keys.reshape(nf, K).T                               # [K, NF]
    if single:
        bits_t = keys_to_sames(keys_t) | ((flat_pidx >> 30).reshape(nf, K).T << 1)
        flat_pidx = (flat_pidx & ((1 << 30) - 1)).clamp(max=table.shape[0] - 1)
    # Entry f*K + j's row at [j, f]: a view, which the scans read in place.
    pidx_t = flat_pidx.reshape(nf, K).T
    quarter_rows = None                    # the scan input, kept by the quarter store
    if fused or (_SCAN_LAYOUT == "rm" and not single and not _SCAN_QSTORE):
        t_scan = msm_scan_fused(table, pidx_t, keys_t)
    elif _SCAN_LAYOUT == "rm" and single:
        t_scan = msm_scan_table_signed(table, pidx_t, bits_t)
    elif _SCAN_LAYOUT == "rm":
        quarter_rows = _gathered_rows(table, flat_pidx, nf, total)
        t_scan = msm_scan_rm_sames_q(quarter_rows, keys_to_sames(keys_t))
    else:
        rows_t = _pret_rows(table, flat_pidx, nf)
        if single:
            t_scan = msm_scan_signed(rows_t, bits_t)
        elif _SCAN_SAMES:
            t_scan = msm_scan_sames(rows_t, keys_to_sames(keys_t))
        else:
            t_scan = msm_scan_pret(rows_t, keys_t)
        del rows_t
    # t_scan: [NF, K//2, 2*TW], step pairs side by side per row; under the
    # quarter store [NF, K//4, 2*TW], steps (4i+2, 4i+3).

    # Carries across fragments; global keys keep runs inside their window.
    gk_frag = flat_gkeys.reshape(nf, K)
    fk = gk_frag[:, 0]
    lk = gk_frag[:, -1]
    fk_next = torch.cat([fk[1:], torch.full((1,), -7, dtype=torch.int32, device=dev)])
    cont = (lk == fk_next).to(torch.int32)
    one_key = (fk == lk).to(torch.int32)
    ident = identity_row(dev)
    b = torch.where((cont != 0)[:, None], t_scan[:, -1, TW:], ident[None, :])
    carries = seg_carry_scan(cont * one_key, b)                       # [NF, TW]

    # Extraction at bucket ends.
    xgather = row_gather_flat if _DMA_EXTRACT else (lambda t, i: t[i])
    ends_c = ends.clamp(0, n - 1)
    wrow = torch.arange(wg, dtype=torch.int64, device=dev)[:, None]
    flat_end = (wrow * n + ends_c).reshape(-1)
    gfrag = (wrow * (n // K) + ends_c // K).reshape(-1)
    cval = xgather(carries, gfrag)                                    # [Wg*nb, TW]
    fragstart_key = torch.gather(keys_s, 1, (ends_c // K) * K)        # [Wg, nb]
    bucket_ids = torch.arange(nb, dtype=torch.int32, device=dev)[None]
    mask_c = ((fragstart_key == bucket_ids) & (counts > 0)).reshape(-1).to(torch.int32)
    nonzero = (counts > 0).reshape(-1)
    if quarter_rows is not None:
        # Fragment-local step s = 4q + r.  r >= 2: stored (row q, half
        # r - 2).  r < 2: start from the stored step 4q - 1 (row q - 1, odd
        # half; a fragment's step 0 restarts, so row -1 is never read) and
        # replay steps 4q .. s in the extraction kernel.
        s = flat_end & (K - 1)
        q = s >> 2
        r = s & 3
        direct = r >= 2
        gq = (flat_end >> 6) * (K // 4) + q
        stored = xgather(t_scan.reshape(nf * (K // 4), 2 * TW),
                         torch.where(direct, gq, gq - 1).clamp(min=0))
        use_odd = torch.where(direct, r - 2, 1)
        base = torch.where((use_odd == 1)[:, None], stored[:, TW:], stored[:, :TW])
        # The scan-input rows of steps 4q and 4q+1: one row pair.
        fe0 = flat_end - r
        pair_in = xgather(quarter_rows.reshape(nf * K // 2, 2 * TWR), fe0 >> 1)
        del quarter_rows
        k0 = flat_keys[fe0]
        km1 = flat_keys[(fe0 - 1).clamp(min=0)]
        k1 = flat_keys[(fe0 + 1).clamp(0, flat_keys.shape[0] - 1)]
        same1 = (k0 == km1) & ((fe0 & (K - 1)) != 0)
        same2 = k1 == k0
        bits = ((r < 2).to(torch.int32)
                | ((r == 1).to(torch.int32) << 1)
                | (same1.to(torch.int32) << 2)
                | (same2.to(torch.int32) << 3)
                | (mask_c << 4))
        buckets = extract_reconstruct_rows(base, pair_in, bits, cval)
    else:
        # Entry e lives in pair row e//2, half e%2.
        pair_rows = xgather(t_scan.reshape(nf * (K // 2), 2 * TW), flat_end >> 1)
        odd = (flat_end & 1) == 1
        tval = torch.where(odd[:, None], pair_rows[:, TW:], pair_rows[:, :TW])
        buckets = masked_add_rows(tval, cval, mask_c)
    return torch.where(nonzero[:, None], buckets, ident[None, :])


def default_window_group(n: int, num_windows: int, device=None) -> int:
    """Largest divisor of num_windows whose per-group staging fits 85% of the
    device's memory next to the table."""
    tf = 1 if _SINGLE_TABLE else 2          # single or doubled table
    table_bytes = tf * n * TWR * 4
    budget = int(0.85 * device_memory_bytes(device)) - table_bytes
    cap = max(1, budget // (n * _STAGING_BYTES_PER_ENTRY))
    return max(d for d in range(1, num_windows + 1) if num_windows % d == 0 and d <= cap)


def _stage_table(coords: torch.Tensor) -> torch.Tensor:
    return build_prod_table(coords)


def _stage_digits_only(scalars: torch.Tensor, cfg: MsmConfig) -> torch.Tensor:
    return decompose_scalars_signed(scalars, cfg).T                   # [W, n]


def _stage_group(table, digits_t, g: int, nb: int, wg: int) -> torch.Tensor:
    return window_group_bucket_sums(table, digits_t[g * wg:(g + 1) * wg], nb)


def _stage_bpr(group_rows, w: int) -> torch.Tensor:
    return bpr(torch.cat(group_rows) if len(group_rows) > 1 else group_rows[0], w)


def _stage_combine(acc_rows: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """EC-add two [W, TW] packed window-sum arrays row by row."""
    ones = torch.ones((acc_rows.shape[0],), dtype=torch.int32, device=acc_rows.device)
    return masked_add_rows(acc_rows, rows, ones)


def _stage_fold(rows: torch.Tensor, cbits: int) -> torch.Tensor:
    return horner_fold(rows, cbits)


def msm_window_sums_staged(coords: torch.Tensor, scalars: torch.Tensor, cfg: MsmConfig,
                           window_group: int = 0, fold: bool = False) -> torch.Tensor:
    """[n, 2, 8], [n, 8] int32 -> [W, TW] packed window sums, or with
    fold=True the [1, TW] packed projective total, in one point block.
    Stages: table + digits, then one bucket-sum pass per window group, then
    BPR (and the fold).  window_group=0 takes default_window_group."""
    return msm_window_sums_batch(coords, [scalars], cfg, window_group=window_group,
                                 fold=fold, block=coords.shape[0])[0]


def msm_window_sums(coords: torch.Tensor, scalars: torch.Tensor, cfg: MsmConfig,
                    window_group: int = 0) -> torch.Tensor:
    """[n, 2, 8], [n, 8] int32 -> [W, TW] packed window sums (the staged
    pipeline without the fold)."""
    return msm_window_sums_staged(coords, scalars, cfg, window_group=window_group)


def default_block_size(n: int, device=None) -> int:
    """Largest power-of-two point block (>= 4096, <= n) whose table (doubled,
    or single under _SINGLE_TABLE) stays under 40% of device memory."""
    tf = 1 if _SINGLE_TABLE else 2
    cap_rows = int(0.4 * device_memory_bytes(device)) // (tf * TWR * 4)
    b = 4096
    while b * 2 <= cap_rows and b * 2 <= n:
        b *= 2
    return b


def msm_window_sums_blocked(coords: torch.Tensor, scalars: torch.Tensor, cfg: MsmConfig,
                            block: int = 0, window_group: int = 0,
                            fold: bool = False) -> torch.Tensor:
    """One MSM through :func:`msm_window_sums_batch`: streaming point blocks
    when the table would not fit, equal to the unblocked pipeline's result.
    block=0 takes default_block_size."""
    return msm_window_sums_batch(coords, [scalars], cfg, window_group=window_group,
                                 fold=fold, block=block)[0]


def msm_window_sums_batch(coords: torch.Tensor, scalars_list, cfg: MsmConfig,
                          window_group: int = 0, fold: bool = False,
                          block: int = 0) -> list[torch.Tensor]:
    """Many MSMs over one point set: [n, 2, 8] and k [n, 8] int32 -> k [W, TW]
    window sums, or with fold=True k [1, TW] totals.  The points stream in
    blocks of `block` (block=0 takes default_block_size; one block when n
    fits): each block's table is built once and read by all k MSMs, and
    each MSM's window sums add across blocks (window sums over disjoint
    points add), then fold once.  Nothing is read back, so the k MSMs
    queue back to back."""
    n = coords.shape[0]
    if n % K:
        raise ValueError(f"n={n} must be a multiple of the scan fragment size {K}")
    block = block or default_block_size(n, coords.device)
    if block % K:
        raise ValueError(f"block={block} must be a multiple of {K}")
    block = min(block, n)
    while n % block and block > K:
        block //= 2
    if n % block:
        raise ValueError(f"n={n} must be a multiple of the block size {block}")
    w, nb = cfg.num_windows, cfg.num_buckets
    if window_group == 0:
        window_group = default_window_group(block, w, coords.device)
    if w % window_group:
        raise ValueError(f"window_group={window_group} does not divide {w} windows")
    accs = [None] * len(scalars_list)
    for b0 in range(0, n, block):
        table = _stage_table(coords[b0:b0 + block])
        for i, sc in enumerate(scalars_list):
            digits_t = _stage_digits_only(sc[b0:b0 + block], cfg)
            rows = _stage_bpr([_stage_group(table, digits_t, g, nb, window_group)
                               for g in range(w // window_group)], w)
            accs[i] = rows if accs[i] is None else _stage_combine(accs[i], rows)
        del table
    return [_stage_fold(a, cfg.chunk_size) for a in accs] if fold else accs
