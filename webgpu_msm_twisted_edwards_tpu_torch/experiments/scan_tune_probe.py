"""Probe: the scan's input layout and two accumulators per thread.

Port of experiments/scan_tune_probe.py.  Against the key-compare scan of
the pipeline (msm_scan, row-major rows):

  pret   : the rows in the limb-major [NF/lblk, K, 64, lblk] layout
           (msm_scan_pret, csrc/scan_variants.cu), after a torch permute
           (pre_transpose, timed alone).
  dual   : each thread scans two fragments, f and f + NF/2, with two
           inlined madds a step (csrc/probe_scan.cu).
  dualf  : the same with the JAX probe's G8 form for both fragments, one
           add after the other (the JAX probe's fuse interleaves the two
           fragments' products; this kernel does not): its formula (8
           products, not madd's 7) gives other representatives than
           msm_scan's.
  pret+dual, and pret+sames (msm_scan_sames, the hoisted same bits).

With --check every output is held against msm_scan's (dualf against its
plain version).

    python -m webgpu_msm_twisted_edwards_tpu_torch.experiments.scan_tune_probe \
        [--nf 65536] [--lblk 256]
"""

from __future__ import annotations

import torch

from ..ops.kernels import _build
from ..ops.kernels import scan as S
from ..ops.kernels.common import Consts, add_many, fr_add_lazy, mont_many, sub_many
from ..ops.kernels.convert import TWR
from ..ops.kernels.ec import TW, Pt, madd
from . import probe_parser, randint, setup, sorted_keys, timed

K = S.K
msm_scan_pret = S.msm_scan_pret
msm_scan_sames = S.msm_scan_sames
keys_to_sames = S.keys_to_sames


def pre_transpose(rows: torch.Tensor, lblk: int) -> torch.Tensor:
    """[NF, K, TWR] -> [NF//lblk, K, 64, lblk] limb-major slabs."""
    nf = rows.shape[0]
    r = rows.reshape(nf // lblk, lblk, K, TWR)[:, :, :, :64]
    return r.permute(0, 2, 3, 1).contiguous()


def madd_g8(p1: Pt, x2, y2, td2, c: Consts) -> Pt:
    """The JAX probe's _madd2 with fuse, for one fragment: A = X1*x2,
    B = Y1*y2, C = T1*td2, E = (X1+Y1)*(x2+y2) - (A+B), F = Z1 - C,
    G = Z1 + C, H = A + B, (EF, GH, EH, FG).  Its products are grouped in
    fours as in the probe (the grouping changes no bit here)."""
    s11, s22 = add_many([(p1.x, p1.y), (x2, y2)])
    a, b, cc, e = mont_many([(p1.x, x2), (p1.y, y2), (p1.t, td2), (s11, s22)], c.p)
    h = fr_add_lazy(a, b)
    ex, f = sub_many([(e, h), (p1.z, cc)], c)
    g = fr_add_lazy(p1.z, cc)
    return Pt(*mont_many([(ex, f), (g, h), (ex, h), (f, g)], c.p))


def msm_scan_dual_plain(rows: torch.Tensor, keys_t: torch.Tensor, fuse: bool = False,
                        pret: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`msm_scan_dual`."""
    reader = S._pret_reader(rows) if pret else S._rm_reader(rows)
    out = S._scan_plain(reader, keys_t, "keys", add=madd_g8 if fuse else madd)
    half = out.shape[0] // 2
    return out[:half], out[half:]


def msm_scan_dual(rows: torch.Tensor, keys_t: torch.Tensor, fuse: bool = False,
                  pret: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """rows [NF, K, TWR] int32 (the limb-major [NF//lblk, K, 64, lblk] when
    pret); keys_t [K, NF] int32, NF even.  Returns the scans of fragments
    [0, NF/2) and [NF/2, NF), each [NF/2, K//2, 2*TW] (views of one output):
    msm_scan's halves unless fuse.  The JAX probe's lblk, its block of
    fragments, has no counterpart in the card's one thread a fragment pair:
    the pret layout carries its own (rows.shape[3]).  Launches
    csrc/probe_scan.cu on CUDA tensors (pret with fuse only on the CPU); CPU
    tensors take the plain version."""
    name = "scan_pret_dual" if pret else ("scan_dualf" if fuse else "scan_dual")
    _build.capture(name, rows, keys_t)
    if not _build.on_cuda(rows, keys_t):
        return msm_scan_dual_plain(rows, keys_t, fuse, pret)
    nf = keys_t.shape[1]
    if nf % 2:
        raise ValueError(f"NF={nf} must be even")
    if pret and fuse:
        raise NotImplementedError("no kernel for pret with fuse")
    keys_t = _build.check(keys_t, torch.int32, (K, nf), "keys_t")
    out = torch.empty((nf, K // 2, 2 * TW), dtype=torch.int32, device=rows.device)
    if pret:
        lb = rows.shape[3]
        rows = _build.check(rows, torch.int32, (nf // lb, K, 64, lb), "rows_t")
        _build.launch(name, "probe_scan", "msm_probe_scan_pret_dual", rows, keys_t, out, nf, lb)
    else:
        rows = _build.check(rows, torch.int32, (nf, K, TWR), "rows")
        _build.launch(name, "probe_scan", f"msm_probe_{name}", rows, keys_t, out, nf)
    return out[:nf // 2], out[nf // 2:]


def main(argv=None) -> dict:
    ap = probe_parser(__doc__)
    ap.add_argument("--nf", type=int, default=65536)
    ap.add_argument("--lblk", type=int, default=256)
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    dev, gen = setup(args)
    nf, lblk = args.nf, args.lblk
    entries = nf * K
    rows = randint(1 << 13, (nf, K, TWR), gen, dev)
    keys = sorted_keys(1 << 14, (K, nf), gen, dev)
    print(f"{entries / 1e6:.1f} M entries, lblk={lblk}", flush=True)
    ms = {}

    def run(name, fn, want=None):
        ms[name] = timed(fn, dev)
        print(f"{name:26s} run {ms[name]:8.3f} ms  ({ms[name] * 1e6 / entries:6.3f} ns/entry)",
              flush=True)
        if args.check:
            got = fn()
            got = torch.cat(got) if isinstance(got, tuple) else got
            ref = base if want is None else want
            if not torch.equal(got, ref):
                raise AssertionError(f"{name} differs")

    base = S.msm_scan(rows, keys) if args.check else None
    run("base (msm_scan)", lambda: S.msm_scan(rows, keys))
    ms["pre-transpose"] = timed(lambda: pre_transpose(rows, lblk), dev)
    print(f"{'torch pre-transpose alone':26s} run {ms['pre-transpose']:8.3f} ms", flush=True)
    rows_t = pre_transpose(rows, lblk)
    run("pret", lambda: msm_scan_pret(rows_t, keys))
    run("dual (2 madds)", lambda: msm_scan_dual(rows, keys))
    run("dualf (G8, both)", lambda: msm_scan_dual(rows, keys, fuse=True),
        torch.cat(msm_scan_dual_plain(rows, keys, fuse=True)) if args.check else None)
    run("pret+dual", lambda: msm_scan_dual(rows_t, keys, pret=True))
    sames = keys_to_sames(keys)
    run("pret+sames (hoisted mask)", lambda: msm_scan_sames(rows_t, sames))
    return {"ms": ms, "ns_per_entry": {k: v * 1e6 / entries for k, v in ms.items()}}


if __name__ == "__main__":
    main()
