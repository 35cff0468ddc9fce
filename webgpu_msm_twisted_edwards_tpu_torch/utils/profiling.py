"""Where one MSM spends its time on the card.

    python -m webgpu_msm_twisted_edwards_tpu_torch.utils.profiling [--log2n 20] [--fixed-base]
        [--n N] [--chunk-size C]

Runs compute_msm (with --fixed-base: compute_msm_precomputed over a base
that precompute_msm_base built first, untraced) once to warm up, then once
under torch.profiler, on the inputs chip_smoke.py uses (points from the
native oracle's generator, scalars from a seeded numpy generator, both
resident on the card).  --n and --chunk-size pick any size and window
width, e.g. --n 511 for the small-input path.  Prints one JSON object: the host wall time of the
traced run, the device time summed by kernel name and by family
(kernel_families), the card's busy time (the union of its kernel and copy
intervals) and its idle share of the wall time.
It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from collections import defaultdict

import numpy as np
import torch

SEED_POINTS = 20230923
SEED_SCALARS = 42


def bench_inputs(n: int):
    """([n, 8] uint64 points, [n, 4] uint64 scalars < 2^250): the inputs of
    the repository's MSM benchmarks."""
    from . import oracle

    pts = oracle.gen_points(n, seed=SEED_POINTS)
    rng = np.random.default_rng(SEED_SCALARS)
    sc = rng.integers(0, 1 << 62, size=(n, 4), dtype=np.uint64)
    sc[:, 3] &= (1 << 58) - 1                       # < 2^250 < the subgroup order
    return pts, sc


def kernel_families(kernels: list[dict]) -> dict[str, list]:
    """Device ms and launches of device_profile's kernels, summed by family:
    each of the port's kernels (msm::<name>) under its name; PyTorch's
    gathers, radix sorts, and copies and concatenations; every other
    PyTorch kernel, memset or copy as "other torch"."""
    fam: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for k in kernels:
        name = k["name"]
        if "msm::" in name:
            key = re.match(r"\w+", name.split("msm::", 1)[1]).group(0)
        elif "gather" in name:
            key = "torch gathers"
        elif "RadixSort" in name:
            key = "sort"
        elif "copy" in name or "Cat" in name or "Memcpy" in name:
            key = "torch copies and cat"
        else:
            key = "other torch"
        fam[key][0] += k["ms"]
        fam[key][1] += k["count"]
    return dict(sorted(fam.items(), key=lambda kv: -kv[1][0]))


def device_profile(fn) -> dict:
    """Run fn() once under torch.profiler; summarize its device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
    spans = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        by_name[ev.name][0] += end - start
        by_name[ev.name][1] += 1
        spans.append((start, end))
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    kernels = sorted(({"name": k[:120], "ms": v[0] / 1e3, "count": v[1]}
                      for k, v in by_name.items()), key=lambda r: -r["ms"])
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1 - busy_us / wall_us if spans else None,
            "device_events": len(spans), "families": kernel_families(kernels),
            "kernels": kernels}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2n", type=int, default=20)
    ap.add_argument("--fixed-base", action="store_true",
                    help="profile compute_msm_precomputed instead of compute_msm")
    ap.add_argument("--n", type=int, default=0, help="number of points (default 2^log2n)")
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="compute_msm's window width (default: its sizing rule)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiling: no CUDA device", file=sys.stderr)
        return 1
    from ..models.cuzk import compute_msm, compute_msm_precomputed, precompute_msm_base
    from .interop import from_numpy_u32

    n = args.n or 1 << args.log2n
    pts, sc = bench_inputs(n)
    coords = from_numpy_u32(pts.view(np.uint32).reshape(n, 2, 8), "cuda")
    scalars = from_numpy_u32(sc.view(np.uint32).reshape(n, 8), "cuda")
    if args.fixed_base:
        pre = precompute_msm_base(coords)
        run = lambda: compute_msm_precomputed(pre, scalars)   # noqa: E731
    else:
        run = lambda: compute_msm(coords, scalars, chunk_size=args.chunk_size)  # noqa: E731
    run()
    out = device_profile(run)
    out.update(n=n, chunk_size=args.chunk_size, fixed_base=args.fixed_base,
               device=torch.cuda.get_device_name(0))
    print(json.dumps(out))
    return 0 if out["device_events"] else 1


if __name__ == "__main__":
    sys.exit(main())
