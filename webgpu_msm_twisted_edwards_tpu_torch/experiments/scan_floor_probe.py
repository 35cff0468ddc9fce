"""Probe: split the scan's time into the segment select, the stores, the
per-step row reads and the bare madd chain.

Port of experiments/scan_floor_probe.py.  The main path's scan,
msm_scan_rm_sames (row-major rows, hoisted same bits, every step stored;
csrc/scan.cu), and its ablations.  The ablations are instantiations of the
probes' copy of that scan (probe_scan_kernel, csrc/probe_scan.cuh and
csrc/probe_scan.cu: the same inlined 26-bit madd, row loads and warp-staged
stores), held at the main scan's occupancy (its launch geometry and register
bound); control is that copy with no ablation, so each ablation's saving is
taken against control, and full - control is what the copy itself differs
by:

  full      : msm_scan_rm_sames itself.
  control   : the probes' copy of it, no ablation (same output).
  nosel     : the segment select dropped (the chain never restarts; wrong
              results, timing only).
  nowrite   : only pair 31 (steps 62 and 63) stored.
  hoistread : step 0's rows read once and used at every step.
  floor     : all three: the madd chain alone.

Defined outputs: all of full, control, nosel and hoistread; pair 31 of
nowrite and floor (the other rows are not written; the plain version zeroes
them).

    python -m webgpu_msm_twisted_edwards_tpu_torch.experiments.scan_floor_probe [--nf 65536]
"""

from __future__ import annotations

import torch

from ..ops.kernels import _build
from ..ops.kernels import scan as S
from ..ops.kernels.convert import TWR
from . import probe_parser, randint, setup, sorted_keys, timed

K = S.K

#: Variant -> (sel, write, perstep_read), as the JAX probe's flags (control
#: has full's flags and runs the probes' copy of the kernel).
VARIANTS = {
    "full": (True, True, True),
    "control": (True, True, True),
    "nosel": (False, True, True),
    "nowrite": (True, False, True),
    "hoistread": (True, True, False),
    "floor": (False, False, False),
}
_KERNELS = {flags: name for name, flags in VARIANTS.items() if name not in ("full", "control")}


def variant_plain(rows: torch.Tensor, sames_t: torch.Tensor, sel: bool = True, write: bool = True,
                  perstep_read: bool = True) -> torch.Tensor:
    """Plain version of :func:`variant`."""
    return S._scan_plain(S._rm_reader(rows), sames_t, "sames", sel=sel, write=write,
                         perstep_read=perstep_read)


def variant(rows: torch.Tensor, sames_t: torch.Tensor, sel: bool = True, write: bool = True,
            perstep_read: bool = True, control: bool = False) -> torch.Tensor:
    """msm_scan_rm_sames (rows [NF, K, TWR], sames_t [K, NF] int32 ->
    [NF, K//2, 2*TW] int32) with the JAX probe's ablations switched off:
    all three on is msm_scan_rm_sames itself, or with `control` the probes'
    copy of it.  Launches csrc/scan.cu or csrc/probe_scan.cu on CUDA tensors
    (the VARIANTS; the other three combinations run only on the CPU); CPU
    tensors take the plain version."""
    flags = (sel, write, perstep_read)
    if flags == VARIANTS["full"] and not control:
        return S.msm_scan_rm_sames(rows, sames_t)
    name = "control" if flags == VARIANTS["full"] else _KERNELS.get(flags, "other")
    _build.capture(f"scan_{name}", rows, sames_t)
    if not _build.on_cuda(rows, sames_t):
        return variant_plain(rows, sames_t, *flags)
    if name == "other":
        raise NotImplementedError(f"no kernel for sel={sel}, write={write}, "
                                  f"perstep_read={perstep_read}")
    return S._launch_rm(f"scan_{name}", "probe_scan", f"msm_probe_scan_{name}", rows, sames_t)


def defined(out: torch.Tensor, write: bool = True) -> torch.Tensor:
    """The rows of a variant's output that it writes."""
    return out if write else out[:, -1:]


def main(argv=None) -> dict:
    ap = probe_parser(__doc__)
    ap.add_argument("--nf", type=int, default=65536)
    args = ap.parse_args(argv)
    dev, gen = setup(args)
    nf = args.nf
    entries = nf * K
    rows = randint(1 << 13, (nf, K, TWR), gen, dev)
    sames = S.keys_to_sames(sorted_keys(1 << 14, (K, nf), gen, dev))
    print(f"{entries / 1e6:.1f} M entries", flush=True)
    ns = {}
    for name, flags in VARIANTS.items():
        ms = timed(lambda: variant(rows, sames, *flags, control=name == "control"), dev)
        ns[name] = ms * 1e6 / entries
        print(f"{name:10s} run {ms:8.3f} ms  ({ns[name]:6.3f} ns/entry)", flush=True)
    base = ns["control"]
    parts = {"select": base - ns["nosel"], "writes": base - ns["nowrite"],
             "row reads": base - ns["hoistread"], "madd floor": ns["floor"]}
    parts["unexplained"] = base - sum(parts.values())
    print("attribution of control (ns/entry): "
          + ", ".join(f"{k} {v:+.3f}" for k, v in parts.items())
          + f"; full - control {ns['full'] - base:+.3f}", flush=True)
    return {"ns_per_entry": ns, "attribution": parts, "full_minus_control": ns["full"] - base}


if __name__ == "__main__":
    main()
