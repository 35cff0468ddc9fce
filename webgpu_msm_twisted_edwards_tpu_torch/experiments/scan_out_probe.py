"""Probe: does the scan's output width matter: every step in its own
64-word row, or two steps per 128-word row?

Port of experiments/scan_out_probe.py.  Both kernels run the same scan
(csrc/probe_scan.cu): row-major rows, keys compared, and a sign word per
entry that negates words 0..19 and 40..59 of its row (4p - v, swept):

  out64 : out [NF, K, 64], one row per step.
  out128: out [NF, K/2, 128], steps 2i and 2i+1 side by side (the layout of
          the pipeline's scans); out64 reshaped equals it.

    python -m webgpu_msm_twisted_edwards_tpu_torch.experiments.scan_out_probe [--nf 65536]
"""

from __future__ import annotations

import torch

from ..ops.kernels import _build
from ..ops.kernels import scan as S
from ..ops.kernels.convert import TWR
from ..ops.kernels.ec import TW
from . import probe_parser, randint, setup, signs, sorted_keys, timed

K = S.K


def scan_out_plain(rows: torch.Tensor, keys_t: torch.Tensor, sgn_t: torch.Tensor,
                   store: int) -> torch.Tensor:
    """Plain version of :func:`scan_out`."""
    return S._scan_plain(S._rm_reader(rows), keys_t, "keys_sgn", store=store, sgn_t=sgn_t)


def scan_out(rows: torch.Tensor, keys_t: torch.Tensor, sgn_t: torch.Tensor,
             store: int) -> torch.Tensor:
    """rows [NF, K, TWR] int32; keys_t, sgn_t [K, NF] int32.  Returns
    [NF, K, TW] int32 (store=1, out64) or [NF, K//2, 2*TW] (store=2,
    out128).  Launches csrc/probe_scan.cu on CUDA tensors; CPU tensors take
    the plain version."""
    if store not in (1, 2):
        raise ValueError(f"store={store}: expected 1 or 2")
    name = "scan_out64" if store == 1 else "scan_out128"
    _build.capture(name, rows, keys_t, sgn_t)
    if not _build.on_cuda(rows, keys_t, sgn_t):
        return scan_out_plain(rows, keys_t, sgn_t, store)
    nf = rows.shape[0]
    rows = _build.check(rows, torch.int32, (nf, K, TWR), "rows")
    keys_t = _build.check(keys_t, torch.int32, (K, nf), "keys_t")
    sgn_t = _build.check(sgn_t, torch.int32, (K, nf), "sgn_t")
    out = torch.empty((nf, K // store, store * TW), dtype=torch.int32, device=rows.device)
    _build.launch(name, "probe_scan", f"msm_probe_{name}", rows, keys_t, sgn_t, out, nf)
    return out


def main(argv=None) -> dict:
    ap = probe_parser(__doc__)
    ap.add_argument("--nf", type=int, default=65536)
    args = ap.parse_args(argv)
    dev, gen = setup(args)
    nf = args.nf
    entries = nf * K
    rows = randint(1 << 13, (nf, K, TWR), gen, dev)
    keys = sorted_keys(1 << 14, (K, nf), gen, dev)
    sgn = signs((K, nf), gen, dev)
    print(f"{entries / 1e6:.1f} M entries", flush=True)
    ms = {}
    for name, store in (("out64", 1), ("out128", 2)):
        ms[name] = timed(lambda: scan_out(rows, keys, sgn, store), dev)
        print(f"{name:6s} run {ms[name]:8.3f} ms ({entries / ms[name] / 1e3:.0f} M entries/s)",
              flush=True)
    same = torch.equal(scan_out(rows, keys, sgn, 1).reshape(nf, K // 2, 2 * TW),
                       scan_out(rows, keys, sgn, 2))
    print(f"out64 reshaped == out128: {same}", flush=True)
    if not same:
        raise AssertionError("out64 and out128 disagree")
    return {"ms": ms, "m_entries_per_s": {k: entries / v / 1e3 for k, v in ms.items()}}


if __name__ == "__main__":
    main()
