#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
1. the card's name and power limit, the torch and CUDA versions;
2. build of every kernel from csrc/ (nvcc, in parallel), its seconds, and
   each kernel function's registers and spills;
3. the main path: compute_msm at 2^16 points (c=13, plain-index gather) and
   at 2^20 points (c=16, gather kernel) on inputs resident on the card (points
   from the native oracle's generator, scalars from a seeded numpy
   generator): kernel launch counts of one run, started from zero, then one
   warm and five timed runs, and the result checked against the C++ oracle;
4. each of the nine kernels replayed on the inputs of its largest call in the
   2^20 run, held bit for bit against its plain PyTorch version, and timed
   beside that version, the PyTorch library call that computes the same
   function (where one exists) and its bound.

It prints, on lines of their own before the last, the card line from
nvidia-smi and one JSON object {"kernels": [...]}, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np
import torch

#: Peaks of one H100 SXM (NVIDIA data sheet, 700 W): HBM bytes/s, and the
#: fp32 rate outside the tensor cores, against which a 32-bit integer
#: multiply-add counts as one FMA (2 operations).  The data sheet gives no
#: integer rate for these units; it is not higher than the fp32 FMA rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
#: 32-bit multiply-adds of one Montgomery product: 20 rounds of
#: (x_i*y_0, N0*t, 20 x_i*y_j, 20 q_i*p_j).
MONT = 20 * 42
MADD, FULL_ADD, DOUBLE = 7 * MONT, 9 * MONT, 8 * MONT

RUNS = 5
REPO = os.path.dirname(os.path.abspath(__file__))
JAX_REPLACES = "webgpu_msm_twisted_edwards_tpu/ops/pallas/"


def log(msg: str) -> None:
    print(msg, flush=True)


def main_path(n: int, capture: bool) -> dict:
    """Drive compute_msm at n points; returns its numbers."""
    from webgpu_msm_twisted_edwards_tpu_torch import compute_msm
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import _build
    from webgpu_msm_twisted_edwards_tpu_torch.utils import oracle
    from webgpu_msm_twisted_edwards_tpu_torch.utils.interop import from_numpy_u32
    from webgpu_msm_twisted_edwards_tpu_torch.utils.profiling import bench_inputs

    pts, sc = bench_inputs(n)
    coords = from_numpy_u32(pts.view(np.uint32).reshape(n, 2, 8), "cuda")
    scalars = from_numpy_u32(sc.view(np.uint32).reshape(n, 8), "cuda")
    torch.cuda.synchronize()

    _build.captures = {} if capture else None
    _build.reset_launch_counts()
    t0 = time.time()
    res = compute_msm(coords, scalars)
    first_ms = (time.time() - t0) * 1e3
    launches = dict(_build.launches)
    captures, _build.captures = _build.captures, None

    times = []
    for _ in range(RUNS):
        t0 = time.time()
        again = compute_msm(coords, scalars)
        times.append((time.time() - t0) * 1e3)
        if again != res:
            raise AssertionError(f"2^{n.bit_length() - 1}: runs disagree")
    t0 = time.time()
    want = oracle.msm_parallel(pts, sc, c=16)
    oracle_s = time.time() - t0
    if (res["x"], res["y"]) != want:
        raise AssertionError(f"2^{n.bit_length() - 1}: got {res}, oracle {want}")
    return {"n": n, "launches": launches, "first_ms": first_ms, "runs_ms": times,
            "median_ms": statistics.median(times), "oracle": "MATCH", "oracle_s": oracle_s,
            "captures": captures}


def cuda_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_kernel(fn) -> float:
    """Mean ms of fn() after one warm call, over enough calls to fill about
    0.2 s (at most 20)."""
    once = cuda_ms(fn, 1)
    return cuda_ms(fn, max(1, min(20, int(200 / max(once, 1e-3)))))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


def work(name: str, args, out) -> tuple[int, int]:
    """(bytes moved, 32-bit multiply-adds) that this call's data needs:
    each input read once and each output written once; data-dependent
    loops counted as these inputs run them."""
    outs = out if isinstance(out, tuple) else (out,)
    moved = nbytes(*args) + nbytes(*outs)
    if name == "convert":
        return moved, args[0].shape[0] * 4 * MONT
    if name in ("hist", "gather"):
        return moved, 0
    if name == "scan":
        return moved, args[0].shape[0] * args[0].shape[1] * MADD
    if name == "ab_scan":
        return moved, args[0].shape[0] * FULL_ADD
    if name == "masked_add":
        return moved, int((args[2] != 0).sum()) * FULL_ADD
    if name == "bpr1":
        return moved, args[0].shape[0] * 2 * FULL_ADD
    if name == "bpr2":
        m, _, cpw, chunk = args
        nc = m.shape[0]
        bits = max(1, int((cpw - 1) * chunk).bit_length())
        kfac = (np.arange(nc) % cpw) * chunk
        ones = sum(bin(int(k)).count("1") for k in kfac)
        return moved, nc * (bits * DOUBLE + FULL_ADD) + ones * FULL_ADD
    if name == "horner":
        w, cbits = args[0].shape[0], args[1]
        lanes = 1 << max(3, (w - 1).bit_length())
        dbl = sum(min(cbits * (w - 1), cbits * ln) for ln in range(lanes))
        return moved, dbl * DOUBLE + (lanes.bit_length() - 1) * lanes * FULL_ADD
    raise KeyError(name)


def kernels_phase(captures: dict, launches: dict) -> list[dict]:
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import bpr as B
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import convert as CV
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import ec as E
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import gather as G
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import hist as H
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import scan as S

    def lib_hist(keys, nb):
        wg = keys.shape[0]
        flat = (keys.to(torch.int64) + torch.arange(wg, device=keys.device)[:, None] * (nb + 1)
                ).reshape(-1)
        return lambda: torch.bincount(flat, minlength=wg * (nb + 1))

    def lib_gather(table, pidx_t):
        flat = pidx_t.T.reshape(-1).to(torch.int64)
        return lambda: torch.index_select(table, 0, flat)

    pkg = "webgpu_msm_twisted_edwards_tpu_torch/csrc/"
    specs = [  # name, wrapper, plain, source, JAX kernel body, library call
        ("convert", CV.build_table_doubled, CV.build_table_doubled_plain, "convert.cu",
         "convert.py:116", None),
        ("hist", H.bucket_counts, H.bucket_counts_plain, "hist.cu", "hist.py:36", lib_hist),
        ("gather", G.row_gather, G.row_gather_plain, "gather.cu", "gather.py:48", lib_gather),
        ("scan", S.msm_scan_rm_sames, S.msm_scan_rm_sames_plain, "scan.cu", "scan.py:337",
         None),
        ("ab_scan", S.ab_scan_level, S.ab_scan_level_plain, "scan.cu", "scan.py:409", None),
        ("masked_add", E.masked_add_rows, E.masked_add_rows_plain, "ec.cu", "ec.py:130", None),
        ("bpr1", B.bpr_stage1, B.bpr_stage1_plain, "bpr.cu", "bpr.py:42", None),
        ("bpr2", B.bpr_stage2, B.bpr_stage2_plain, "bpr.cu", "bpr.py:99", None),
        ("horner", B.horner_fold, B.horner_fold_plain, "bpr.cu", "bpr.py:189", None),
    ]
    rows = []
    for name, wrapper, plain, src, jax_kernel, library in specs:
        args = captures[name][1]
        shapes = [tuple(a.shape) if isinstance(a, torch.Tensor) else a for a in args]
        out = wrapper(*args)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain(*args)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        got = out if isinstance(out, tuple) else (out,)
        ref = want if isinstance(want, tuple) else (want,)
        errs = [0 if torch.equal(g, r) else int((g.to(torch.int64) - r.to(torch.int64)).abs().max())
                for g, r in zip(got, ref)]
        if any(g.shape != r.shape for g, r in zip(got, ref)) or any(errs):
            raise AssertionError(f"{name}: kernel differs from its plain version "
                                 f"(max abs err {max(errs)}) on {shapes}")
        del want, got, ref
        ms = time_kernel(lambda: wrapper(*args))
        library_ms = time_kernel(library(*args)) if library else None
        moved, imads = work(name, args, out)
        del out
        bound_bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
        bound_ops_ms = 2 * imads / PEAK_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": pkg + src,
            "replaces": JAX_REPLACES + jax_kernel,
            "launches": launches.get(name, 0), "max_abs_err": max(errs),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
            "library_ms": library_ms, "shapes": str(shapes),
        })
        log(f"kernel {name}: match, {ms:.4f} ms (plain {plain_ms:.1f} ms, library "
            f"{library_ms if library_ms is None else round(library_ms, 4)} ms, bound "
            f"{rows[-1]['bound_ms']:.4f} ms by {rows[-1]['bound_by']}) on {shapes}")
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from webgpu_msm_twisted_edwards_tpu_torch.ops.kernels import _build
    from webgpu_msm_twisted_edwards_tpu_torch.utils.runtime import card_info

    t_start = time.time()
    card = card_info()
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    build_s = _build.build_all()
    log(f"build: {build_s:.1f} s")
    for lib, lines in _build.ptxas_report().items():
        for ln in lines:
            log(f"ptxas {lib}: {ln}")

    e2e = {}
    for logn, capture, must_launch in ((16, False, 8), (20, True, 9)):
        r = main_path(1 << logn, capture)
        e2e[f"2^{logn}"] = r
        ran = [k for k, v in r["launches"].items() if v > 0]
        log(f"compute_msm 2^{logn}: median {r['median_ms']:.2f} ms of {RUNS} "
            f"{[round(t, 2) for t in r['runs_ms']]}, first run {r['first_ms']:.1f} ms, "
            f"oracle {r['oracle']} ({r['oracle_s']:.1f} s), launches {r['launches']}")
        if len(ran) < must_launch:
            raise AssertionError(f"2^{logn}: only {sorted(ran)} of the path's kernels launched")
    if sorted(e2e["2^20"]["launches"]) != sorted(
            ["convert", "hist", "gather", "scan", "ab_scan", "masked_add", "bpr1", "bpr2",
             "horner"]):
        raise AssertionError(f"2^20 launches: {e2e['2^20']['launches']}")
    if e2e["2^16"]["launches"].get("gather", 0) != 0:
        raise AssertionError("2^16 ran the gather kernel below its gate")

    kernels = kernels_phase(e2e["2^20"].pop("captures"), e2e["2^20"]["launches"])
    log(json.dumps({"e2e": {k: {"median_ms": v["median_ms"], "runs_ms": v["runs_ms"],
                                "first_ms": v["first_ms"], "launches": v["launches"],
                                "oracle": v["oracle"]} for k, v in e2e.items()},
                    "build_s": build_s, "total_s": time.time() - t_start}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
