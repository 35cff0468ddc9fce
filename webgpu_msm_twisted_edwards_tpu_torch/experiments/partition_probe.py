"""Probe: move rows grouped by destination: does a partition into bins beat
the per-row gather?

Port of experiments/partition_probe.py.  Rows are routed to bins; bin b's
rows, in input order, fill the 64-row tiles out[b*cap + 64*t ..], cap =
2*n/bins, and only full tiles are written: a bin's tail and every tile past
cap are not (the TPU kernel would have written those over the next bin).  On
the card a stable counting partition in one call of three kernels
(csrc/probe_move.cu): per block of tblk rows its bin counts, their exclusive
sum over blocks, and a scatter that ranks rows stably and copies each row
of a full tile with one warp.  Against it, the pipeline's gather kernel
(ops/kernels/gather.py::row_gather) moving the same rows in a random order.

    python -m webgpu_msm_twisted_edwards_tpu_torch.experiments.partition_probe \
        [--n 1048576] [--bins 64] [--tblk 4096]
"""

from __future__ import annotations

import torch

from ..ops.kernels import _build
from ..ops.kernels import gather as G
from . import probe_parser, randint, setup, timed

ROWW = 128      # row width in u32 (the table row)
TILE = 64       # rows per tile


def _layout(bins: torch.Tensor, nbins: int):
    """(cap, per bin the rows it writes: its full tiles that fit in cap)."""
    cap = (bins.shape[0] // nbins) * 2
    ok = (bins >= 0) & (bins < nbins)
    counts = torch.bincount(bins[ok].to(torch.int64), minlength=nbins)
    return cap, torch.clamp(counts // TILE, max=cap // TILE) * TILE


def written(bins: torch.Tensor, nbins: int) -> torch.Tensor:
    """[nbins*cap] bool: the output rows that :func:`partition` writes."""
    cap, full = _layout(bins, nbins)
    return (torch.arange(cap, device=bins.device)[None, :] < full[:, None]).reshape(-1)


def partition_plain(rows: torch.Tensor, bins: torch.Tensor, nbins: int) -> torch.Tensor:
    """Plain version of :func:`partition` (a stable sort by bin); the rows
    it does not write are zero."""
    cap, full = _layout(bins, nbins)
    live = torch.nonzero((bins >= 0) & (bins < nbins)).squeeze(1)
    sb, order = torch.sort(bins[live].to(torch.int64), stable=True)
    order = live[order]
    counts = torch.bincount(sb, minlength=nbins)
    rank = torch.arange(sb.shape[0], device=rows.device) - (torch.cumsum(counts, 0) - counts)[sb]
    keep = rank < full[sb]
    out = torch.zeros((nbins * cap, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    out[sb[keep] * cap + rank[keep]] = rows[order[keep]]
    return out


def partition(rows: torch.Tensor, bins: torch.Tensor, nbins: int, tblk: int = 4096) -> torch.Tensor:
    """rows [n, ROWW] int32; bins [n] int32 in [0, nbins), nbins <= 256 (a
    row whose bin lies outside goes nowhere).  Returns [nbins*cap, ROWW]
    int32 with the rows of :func:`written` set.  tblk (rows a block; a power
    of two >= 32) shapes only the kernels.
    Launches csrc/probe_move.cu on CUDA tensors; CPU tensors take the plain
    version."""
    _build.capture("partition", rows, bins, nbins, tblk)
    if not _build.on_cuda(rows, bins):
        return partition_plain(rows, bins, nbins)
    n = rows.shape[0]
    if tblk < 32 or tblk & (tblk - 1) or not 0 < nbins <= 256:
        raise ValueError(f"tblk={tblk} must be a power of two >= 32 and nbins={nbins} in [1, 256]")
    rows = _build.check(rows, torch.int32, (n, ROWW), "rows")
    bins = _build.check(bins, torch.int32, (n,), "bins")
    cap = (n // nbins) * 2
    counts = torch.empty((-(-n // tblk), nbins), dtype=torch.int32, device=rows.device)
    full = torch.empty((nbins,), dtype=torch.int32, device=rows.device)
    out = torch.empty((nbins * cap, ROWW), dtype=torch.int32, device=rows.device)
    _build.launch("partition", "probe_move", "msm_probe_partition", rows, bins, counts, full, out,
                  n, tblk, nbins, cap)
    return out


def main(argv=None) -> dict:
    ap = probe_parser(__doc__)
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--bins", type=int, default=64)
    ap.add_argument("--tblk", type=int, default=4096)
    args = ap.parse_args(argv)
    dev, gen = setup(args)
    n, nbins = args.n, args.bins
    rows = randint(1 << 13, (n, ROWW), gen, dev)
    bins = randint(nbins, (n,), gen, dev)
    ms = {"partition": timed(lambda: partition(rows, bins, nbins, args.tblk), dev)}
    kept = int(written(bins, nbins).sum())
    # The gather kernel over the same rows in a random order (its [K, n/K]
    # index layout, n a multiple of TILE).
    perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    pidx_t = perm.reshape(-1, TILE).T.contiguous()
    ms["gather kernel"] = timed(lambda: G.row_gather(rows, pidx_t), dev)
    rate = {k: n / v / 1e3 for k, v in ms.items()}
    print(f"partition {n} rows into {nbins} bins ({kept} in full tiles): "
          f"{ms['partition']:.3f} ms -> {rate['partition']:.0f} M rows/s", flush=True)
    print(f"gather kernel, the same rows permuted: {ms['gather kernel']:.3f} ms -> "
          f"{rate['gather kernel']:.0f} M rows/s", flush=True)
    return {"ms": ms, "m_rows_per_s": rate, "rows_written": kept}


if __name__ == "__main__":
    main()
