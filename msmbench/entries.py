"""The system under test: the port's public entry points, as a cell calls
them.

A configuration with `"fixed_base": true` runs `precompute_msm_base` once in
set-up and then one `compute_msm_precomputed` a call; otherwise each call is
`compute_msm`, or `compute_msm_batch` where the traffic's `msms_per_call` is
over 1.  Every call returns the affine {x, y} of each MSM as Python
integers.
"""

from __future__ import annotations

import importlib
import time

import torch

from . import PORT


def sync(device: str) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.startswith("cuda"):
        torch.cuda.synchronize()


class PortSystem:
    """One cell's entry into the port, over points and scalar vectors that
    already lie on `device`.  `host_inputs` (the benchmark's own copy, with
    the points' logarithms) is not handed to the port."""

    def __init__(self, config: dict, traffic: dict, coords: torch.Tensor,
                 vectors: list[torch.Tensor], device: str, host_inputs=None):
        self.fixed_base = bool(config.get("fixed_base", False))
        self.batch = int(traffic["msms_per_call"]) > 1
        if self.fixed_base and self.batch:
            raise ValueError("no cell batches over a fixed base")
        self.coords, self.vectors, self.device = coords, vectors, device
        self.port = importlib.import_module(PORT)
        self.pre = None

    def load_kernels(self) -> float:
        """Build and load the port's kernel libraries on the card before
        anything is timed (ops/kernels/_build.py); the seconds spent."""
        if not self.device.startswith("cuda"):
            return 0.0
        build = importlib.import_module(PORT + ".ops.kernels._build")
        t0 = time.perf_counter()
        for name in build.SOURCES:
            build.library(name)
        return time.perf_counter() - t0

    def setup(self) -> dict:
        """The cell's one-time set-up: over a fixed base, its precompute,
        timed on the host clock up to a synchronize."""
        if not self.fixed_base:
            return {}
        sync(self.device)
        t0 = time.perf_counter()
        self.pre = self.port.precompute_msm_base(self.coords, device=self.device)
        sync(self.device)
        return {"precompute_s": time.perf_counter() - t0}

    def call(self, ids: list[int]) -> list[dict]:
        """One call of the cell's entry point over the scalar vectors `ids`."""
        vecs = [self.vectors[i] for i in ids]
        if self.fixed_base:
            return [self.port.compute_msm_precomputed(self.pre, vecs[0])]
        if self.batch:
            return self.port.compute_msm_batch(self.coords, vecs, device=self.device)
        return [self.port.compute_msm(self.coords, vecs[0], device=self.device)]

    def close(self) -> None:
        self.pre = self.coords = self.vectors = None
