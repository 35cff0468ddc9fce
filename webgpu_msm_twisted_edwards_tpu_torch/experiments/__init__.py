"""The measurement probes of the repository's experiments/, on the card.

Each module here mirrors the JAX probe of the same name: its kernels (in
csrc/probe_scan.cu and csrc/probe_move.cu, or the pipeline's own), their
plain PyTorch versions, and a main() with the JAX probe's flags and
defaults, run as

    python -m webgpu_msm_twisted_edwards_tpu_torch.experiments.<probe> [flags] [--device cpu]

On the card (the default; without one main() raises) every variant is timed
with CUDA events: one warm run, then the median of five.  `--device cpu`
runs the plain versions, timed by the host clock, which says nothing of the
card; give it small flags.  Inputs are random 13-bit limbs and indices from a
seeded torch generator on the device.  main() returns what it printed, as a
dict.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from ..utils.runtime import resolve_device

RUNS = 5
SEED = 0


def probe_parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default: the CUDA card")
    return ap


def setup(args) -> tuple[torch.device, torch.Generator]:
    """The device of a probe run and a seeded generator on it."""
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu (plain versions)"
    print(f"device: {name}", flush=True)
    return dev, torch.Generator(device=dev).manual_seed(SEED)


def timed(fn, dev: torch.device, runs: int = RUNS) -> float:
    """Median ms of `runs` calls of fn() after one warm call: CUDA events on
    the card, the host clock on the CPU."""
    fn()
    ts = []
    for _ in range(runs):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def randint(high: int, shape, gen: torch.Generator, dev: torch.device) -> torch.Tensor:
    """int32 values in [0, high)."""
    return torch.randint(0, high, shape, generator=gen, device=dev, dtype=torch.int32)


def sorted_keys(high: int, shape, gen: torch.Generator, dev: torch.device) -> torch.Tensor:
    """[K, NF] int32 keys in [0, high), sorted along the steps of each
    fragment (the JAX probes' keys)."""
    return randint(high, shape, gen, dev).sort(dim=0).values


def signs(shape, gen: torch.Generator, dev: torch.device) -> torch.Tensor:
    """int32 0/1 words, each 1 with probability 1/2."""
    return (torch.rand(shape, generator=gen, device=dev) < 0.5).to(torch.int32)
