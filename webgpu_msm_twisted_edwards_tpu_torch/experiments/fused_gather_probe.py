"""Probe: a gather staged in fast memory, fused with the scan: do the row
copies overlap the madds?

Port of experiments/fused_gather_probe.py.  Three kernels over the shapes of
the JAX probe (csrc/probe_move.cu):

  copy-only: each entry's table row copied into shared memory, steps in
             order; writes what the TPU kernel writes, out[:, 0, :] = the
             first 64 words of step 0's rows (the rest of out is not
             written).
  scan-only: the scan phase alone, scan_out_probe.py's out64 scan, over rows
             that a torch gather (stage_rows, not timed with it) has already
             put in step order.  The TPU kernel of that name read a scratch
             that nothing wrote; this is its defined counterpart.
  fused    : both phases in one kernel; equals out64 on the gathered rows.

If fused ~ copy + scan, the copies serialize with the madds; if
fused ~ max(copy, scan), they overlap.

    python -m webgpu_msm_twisted_edwards_tpu_torch.experiments.fused_gather_probe \
        [--ns 17] [--nf 4096]
"""

from __future__ import annotations

import torch

from ..ops.kernels import _build
from ..ops.kernels import scan as S
from ..ops.kernels.common import L, u32
from ..ops.kernels.convert import TWR
from ..ops.kernels.ec import TW
from . import probe_parser, randint, setup, signs, sorted_keys, timed

K = S.K


def stage_rows(table: torch.Tensor, pidx_t: torch.Tensor) -> torch.Tensor:
    """[K, NF, TWR]: table row pidx_t[j, f] at [j, f], the rows in the order
    the scan phase reads them."""
    return table[pidx_t.to(torch.int64)]


def gather_copy_plain(table: torch.Tensor, pidx_t: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gather_copy`; the rows it does not write are
    zero."""
    nf = pidx_t.shape[1]
    out = torch.zeros((nf, K, TW), dtype=torch.int32, device=table.device)
    out[:, 0] = table[pidx_t[0].to(torch.int64), :TW]
    return out


def gather_scan_plain(staged: torch.Tensor, keys_t: torch.Tensor,
                      sgn_t: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gather_scan`."""
    return S._scan_plain(lambda j: u32(staged[j, :, 0:3 * L]).T, keys_t, "keys_sgn", store=1,
                         sgn_t=sgn_t)


def gather_fused_plain(table: torch.Tensor, pidx_t: torch.Tensor, keys_t: torch.Tensor,
                       sgn_t: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gather_fused`."""
    return S._scan_plain(lambda j: u32(table[pidx_t[j].to(torch.int64), 0:3 * L]).T, keys_t,
                         "keys_sgn", store=1, sgn_t=sgn_t)


def _launch(name: str, fn: str, nf: int, device, *args) -> torch.Tensor:
    out = torch.empty((nf, K, TW), dtype=torch.int32, device=device)
    _build.launch(name, "probe_move", fn, *args, out, nf)
    return out


def gather_copy(table: torch.Tensor, pidx_t: torch.Tensor) -> torch.Tensor:
    """table [ns, TWR] int32; pidx_t [K, NF] int32 rows in [0, ns).  Returns
    [NF, K, TW] int32 of which only out[:, 0, :] (table[pidx_t[0], :TW]) is
    written.  Launches csrc/probe_move.cu on CUDA tensors; CPU tensors take
    the plain version."""
    _build.capture("gather_copy", table, pidx_t)
    if not _build.on_cuda(table, pidx_t):
        return gather_copy_plain(table, pidx_t)
    nf = pidx_t.shape[1]
    table = _build.check(table, torch.int32, (-1, TWR), "table")
    pidx_t = _build.check(pidx_t, torch.int32, (K, nf), "pidx_t")
    return _launch("gather_copy", "msm_probe_gather_copy", nf, table.device, table, pidx_t)


def gather_scan(staged: torch.Tensor, keys_t: torch.Tensor, sgn_t: torch.Tensor) -> torch.Tensor:
    """The out64 scan ([NF, K, TW] int32) over staged [K, NF, TWR] rows
    (stage_rows); keys_t, sgn_t [K, NF] int32.  Launches csrc/probe_move.cu
    on CUDA tensors; CPU tensors take the plain version."""
    _build.capture("gather_scan", staged, keys_t, sgn_t)
    if not _build.on_cuda(staged, keys_t, sgn_t):
        return gather_scan_plain(staged, keys_t, sgn_t)
    nf = keys_t.shape[1]
    staged = _build.check(staged, torch.int32, (K, nf, TWR), "staged")
    keys_t = _build.check(keys_t, torch.int32, (K, nf), "keys_t")
    sgn_t = _build.check(sgn_t, torch.int32, (K, nf), "sgn_t")
    return _launch("gather_scan", "msm_probe_gather_scan", nf, staged.device, staged, keys_t,
                   sgn_t)


def gather_fused(table: torch.Tensor, pidx_t: torch.Tensor, keys_t: torch.Tensor,
                 sgn_t: torch.Tensor) -> torch.Tensor:
    """The copy and scan phases in one kernel: the out64 scan ([NF, K, TW]
    int32) over table rows pidx_t[j, f].  Launches csrc/probe_move.cu on CUDA
    tensors; CPU tensors take the plain version."""
    _build.capture("gather_fused", table, pidx_t, keys_t, sgn_t)
    if not _build.on_cuda(table, pidx_t, keys_t, sgn_t):
        return gather_fused_plain(table, pidx_t, keys_t, sgn_t)
    nf = pidx_t.shape[1]
    table = _build.check(table, torch.int32, (-1, TWR), "table")
    pidx_t = _build.check(pidx_t, torch.int32, (K, nf), "pidx_t")
    keys_t = _build.check(keys_t, torch.int32, (K, nf), "keys_t")
    sgn_t = _build.check(sgn_t, torch.int32, (K, nf), "sgn_t")
    return _launch("gather_fused", "msm_probe_gather_fused", nf, table.device, table, pidx_t,
                   keys_t, sgn_t)


def main(argv=None) -> dict:
    ap = probe_parser(__doc__)
    ap.add_argument("--ns", type=int, default=17, help="log2 table slice rows")
    ap.add_argument("--nf", type=int, default=4096, help="fragments (x K entries)")
    args = ap.parse_args(argv)
    dev, gen = setup(args)
    ns, nf = 1 << args.ns, args.nf
    entries = nf * K
    table = randint(1 << 13, (ns, TWR), gen, dev)
    pidx = randint(ns, (K, nf), gen, dev)
    keys = sorted_keys(1 << 14, (K, nf), gen, dev)
    sgn = signs((K, nf), gen, dev)
    print(f"table slice 2^{args.ns} rows ({ns * TWR * 4 / 2**20:.0f} MB), "
          f"{entries / 1e6:.1f} M entries", flush=True)
    ms = {"staging gather": timed(lambda: stage_rows(table, pidx), dev)}
    staged = stage_rows(table, pidx)
    for name, fn in (("copy-only", lambda: gather_copy(table, pidx)),
                     ("scan-only", lambda: gather_scan(staged, keys, sgn)),
                     ("fused", lambda: gather_fused(table, pidx, keys, sgn))):
        ms[name] = timed(fn, dev)
        print(f"{name:10s} run {ms[name]:8.3f} ms ({entries / ms[name] / 1e3:.0f} M entries/s)",
              flush=True)
    print(f"(torch staging gather for scan-only: {ms['staging gather']:.3f} ms)", flush=True)
    serial, overlap = ms["copy-only"] + ms["scan-only"], max(ms["copy-only"], ms["scan-only"])
    print(f"fused {ms['fused']:.3f} ms against copy + scan {serial:.3f} ms and "
          f"max(copy, scan) {overlap:.3f} ms", flush=True)
    return {"ms": ms, "m_entries_per_s": {k: entries / v / 1e3 for k, v in ms.items()}}


if __name__ == "__main__":
    main()
