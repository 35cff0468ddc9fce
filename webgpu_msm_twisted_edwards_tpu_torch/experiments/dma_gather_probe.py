"""Probe: the gather by the card's copy engine, and a scan that prefetches
its table rows.

Port of experiments/dma_gather_probe.py.  At the pipeline's size at 2^20
(2^23 entries over a table of 2^21 rows):

  1. the gather and the main path's scan timed apart: plain indexing, the
     pipeline's gather kernel (ops/kernels/gather.py::row_gather, one warp a
     row), and msm_scan_rm_sames on the gathered rows;
  2. dma-gather: the same rows moved by the bulk-copy engine, one
     cp.async.bulk load and one store a row (csrc/probe_move.cu), in
     M rows/s.  The card issues one bulk copy per row, so the JAX probe's
     descriptor-issue unroll (--unroll, --unrolls) has no counterpart and no
     flag here;
  3. dma-scan: the rm + sames scan reading table rows by index, each thread
     prefetching step j+1's row into shared memory with cp.async while step
     j's madd runs; against msm_scan_fused, the pipeline's scan that reads
     the same rows by index without prefetch (and compares keys).

With --check the dma-scan is first held against msm_scan_rm_sames on
gathered rows at a small size.

    python -m webgpu_msm_twisted_edwards_tpu_torch.experiments.dma_gather_probe \
        [--entries-log2 23] [--table-log2 21]
"""

from __future__ import annotations

import torch

from ..ops.kernels import _build
from ..ops.kernels import gather as G
from ..ops.kernels import scan as S
from ..ops.kernels.convert import TWR
from ..ops.kernels.ec import TW
from . import probe_parser, randint, setup, sorted_keys, timed

K = S.K


def dma_gather_plain(table: torch.Tensor, pidx_t: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`dma_gather`."""
    return table[pidx_t.T.reshape(-1).to(torch.int64)]


def dma_gather(table: torch.Tensor, pidx_t: torch.Tensor) -> torch.Tensor:
    """table [nt, TWR] int32; pidx_t [K, NF] int32 rows in [0, nt) (entry f
    of step j at [j, f]).  Returns [NF*K, TWR] rows in fragment-major order
    (f*K + j).  Launches csrc/probe_move.cu on CUDA tensors; CPU tensors take
    the plain version."""
    _build.capture("bulk_gather", table, pidx_t)
    if not _build.on_cuda(table, pidx_t):
        return dma_gather_plain(table, pidx_t)
    nf = pidx_t.shape[1]
    table = _build.check(table, torch.int32, (-1, TWR), "table")
    pidx_t = _build.check(pidx_t, torch.int32, (K, nf), "pidx_t")
    out = torch.empty((nf * K, TWR), dtype=torch.int32, device=table.device)
    _build.launch("bulk_gather", "probe_move", "msm_probe_bulk_gather", table, pidx_t, out, nf)
    return out


def msm_scan_dma_plain(table: torch.Tensor, pidx_t: torch.Tensor,
                       sames_t: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`msm_scan_dma`."""
    nf = pidx_t.shape[1]
    return S.msm_scan_rm_sames_plain(dma_gather_plain(table, pidx_t).reshape(nf, K, TWR), sames_t)


def msm_scan_dma(table: torch.Tensor, pidx_t: torch.Tensor, sames_t: torch.Tensor) -> torch.Tensor:
    """The rm + sames scan over table rows pidx_t[j, f] (table [nt, TWR],
    pidx_t and sames_t [K, NF] int32): equal to msm_scan_rm_sames on the
    gathered rows, [NF, K//2, 2*TW].  Launches csrc/probe_move.cu on CUDA
    tensors; CPU tensors take the plain version."""
    _build.capture("scan_dma", table, pidx_t, sames_t)
    if not _build.on_cuda(table, pidx_t, sames_t):
        return msm_scan_dma_plain(table, pidx_t, sames_t)
    nf = pidx_t.shape[1]
    table = _build.check(table, torch.int32, (-1, TWR), "table")
    pidx_t = _build.check(pidx_t, torch.int32, (K, nf), "pidx_t")
    sames_t = _build.check(sames_t, torch.int32, (K, nf), "sames_t")
    out = torch.empty((nf, K // 2, 2 * TW), dtype=torch.int32, device=table.device)
    _build.launch("scan_dma", "probe_move", "msm_probe_scan_dma", table, pidx_t, sames_t, out, nf)
    return out


def _inputs(nrows: int, nt: int, run: int, gen, dev):
    """table [nt, TWR], pidx_t, keys_t and sames_t [K, nrows/K]; keys in runs
    of about `run` entries (the bucket runs of c = 16 at 2^20 for 32)."""
    nf = nrows // K
    table = randint(1 << 13, (nt, TWR), gen, dev)
    pidx_t = randint(nt, (nf, K), gen, dev).T.contiguous()
    keys_t = sorted_keys(nrows // run, (nrows,), gen, dev).reshape(nf, K).T.contiguous()
    return table, pidx_t, keys_t, S.keys_to_sames(keys_t)


def _check(gen, dev) -> None:
    """dma-scan against msm_scan_rm_sames on gathered rows, at 2^15 entries
    over a table of 4096 rows."""
    table, pidx_t, _, sames_t = _inputs(1 << 15, 4096, 16, gen, dev)
    rows = dma_gather_plain(table, pidx_t).reshape(-1, K, TWR)
    if not torch.equal(msm_scan_dma(table, pidx_t, sames_t), S.msm_scan_rm_sames(rows, sames_t)):
        raise AssertionError("dma-scan differs from the rm + sames scan")
    print("check: dma-scan == rm+sames scan (bit-exact) OK", flush=True)


def main(argv=None) -> dict:
    ap = probe_parser(__doc__)
    ap.add_argument("--entries-log2", type=int, default=23,
                    help="gathered entries (8 windows x 2^20 = 2^23 is the group at 2^20)")
    ap.add_argument("--table-log2", type=int, default=21,
                    help="table rows (the doubled table at 2^20 is 2^21)")
    ap.add_argument("--skip-fused", action="store_true")
    ap.add_argument("--skip-xla", action="store_true",
                    help="skip the gather + scan baseline (XLA's gather on the TPU)")
    ap.add_argument("--check", action="store_true",
                    help="bit-exact check of dma-scan against msm_scan_rm_sames at a small size "
                         "first")
    args = ap.parse_args(argv)
    dev, gen = setup(args)
    if args.check:
        _check(gen, dev)
    nrows, nt = 1 << args.entries_log2, 1 << args.table_log2
    nf = nrows // K
    table, pidx_t, keys_t, sames_t = _inputs(nrows, nt, 32, gen, dev)
    ms = {}

    def rate(name, rows_ms):
        print(f"{name:36s} {rows_ms:8.3f} ms ({nrows / rows_ms / 1e3:.0f} M rows/s)", flush=True)

    if not args.skip_xla:
        flat = pidx_t.T.reshape(-1).to(torch.int64)
        ms["index gather"] = timed(lambda: table[flat], dev)
        rate(f"index gather [{nrows >> 20} M rows x {TWR * 4} B]", ms["index gather"])
        ms["gather kernel"] = timed(lambda: G.row_gather(table, pidx_t), dev)
        rate("gather kernel (row_gather)", ms["gather kernel"])
        rows = G.row_gather(table, pidx_t).reshape(nf, K, TWR)
        ms["scan"] = timed(lambda: S.msm_scan_rm_sames(rows, sames_t), dev)
        print(f"{'rm+sames scan (gathered rows)':36s} {ms['scan']:8.3f} ms "
              f"({ms['scan'] * 1e6 / nrows:.3f} ns/entry)", flush=True)
        print(f"  -> gather kernel + scan: {ms['gather kernel'] + ms['scan']:8.3f} ms", flush=True)
        del rows
    ms["dma-gather"] = timed(lambda: dma_gather(table, pidx_t), dev)
    rate("dma-gather (bulk copies)", ms["dma-gather"])
    if not args.skip_fused:
        ms["dma-scan"] = timed(lambda: msm_scan_dma(table, pidx_t, sames_t), dev)
        ms["table scan"] = timed(lambda: S.msm_scan_fused(table, pidx_t, keys_t), dev)
        for name in ("dma-scan", "table scan"):
            print(f"{name + ' (rows by index)':36s} {ms[name]:8.3f} ms "
                  f"({ms[name] * 1e6 / nrows:.3f} ns/entry)", flush=True)
    return {"ms": ms, "m_rows_per_s": {k: nrows / v / 1e3 for k, v in ms.items()}}


if __name__ == "__main__":
    main()
