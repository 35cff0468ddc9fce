"""Multi-card scaling: MSM time against the number of cards in the mesh.

mode="points" splits one MSM's points over k cards with compute_msm_sharded's
plan (the window size follows n/k) and its staged path: the speedup t(1)/t(k)
and the efficiency t(1)/(k t(k)).  mode="batch" runs k MSMs over one point
set, one whole MSM a card, with compute_msm_batch_sharded's plan (the window
size follows n) and path: ms a MSM, and the efficiency t(1)/t(k), which
stays 1 when the cards scale.

Mesh sizes 1, 2, 4, ... up to the number of distinct cards (default_mesh);
a one-card machine gives the k = 1 row only, and the CPU (device="cpu", the
kernels' plain versions) is one device.  Inputs: points from the native
oracle's walk (seed 20230923), scalars below 2^250 from numpy's
default_rng(42).  "compile (s)" is the first call's seconds, the kernel
libraries built before it (their build seconds are printed first); then
`runs` timed calls, each ending in a synchronize of the first card.
"""

from __future__ import annotations

import time
from functools import partial

import numpy as np
import torch

from ..parallel import sharded
from ..utils import oracle
from ..utils.runtime import resolve_device, to_device
from .timing import Table, force, median


def run(log2n: int = 18, runs: int = 3, mode: str = "points", device=None) -> Table:
    """The scaling table of one mode over mesh sizes 1, 2, 4, ...; each row
    is printed as it is measured."""
    dev = resolve_device(device)
    n = 1 << log2n
    coords = to_device(oracle.gen_points(n, seed=20230923).view(np.uint32).reshape(n, 2, 8), dev)
    rng = np.random.default_rng(42)

    def gen_scalars(count: int) -> list[torch.Tensor]:
        sc = rng.integers(0, 1 << 62, size=(count, n, 4), dtype=np.uint64)
        sc[:, :, 3] &= (1 << 58) - 1
        return [to_device(s.view(np.uint32).reshape(n, 8), dev) for s in sc]

    ndev = torch.cuda.device_count() if dev.type == "cuda" else 1
    if dev.type == "cuda":
        print(f"kernel build: {sharded.warmup_sharded_staged():.1f} s", flush=True)
    if ndev == 1:
        print(f"one {'card' if dev.type == 'cuda' else 'CPU device'}: the k = 1 row only; "
              f"scaling across cards needs a machine with more than one", flush=True)
    sizes = [k for k in (1, 2, 4, 8, 16, 32) if k <= ndev]
    if mode == "batch":
        table = Table(["chips", "batch k", "pipeline", "compile (s)", "median (ms)", "ms/MSM",
                       "efficiency"])
    else:
        table = Table(["chips", "pipeline", "c", "compile (s)", "median (ms)", "speedup",
                       "efficiency"])
        scalars = gen_scalars(1)[0]
    t1 = None
    for k in sizes:
        mesh = sharded.default_mesh(k, device=dev)
        if mode == "batch":
            # compute_msm_batch_sharded's dispatch: the window size follows
            # the full n, as every card holds all the points.
            cfg, pipeline = sharded.sharded_msm_plan(n, 1)
            batch = sharded.sharded_msm_batch_rows if pipeline == "kernels" else \
                sharded.sharded_msm_batch_sums
            fn = partial(batch, mesh=mesh, cfg=cfg)
            args = (coords, gen_scalars(k))
        else:
            # compute_msm_sharded's dispatch: the window size of a shard and
            # the staged path.
            cfg, pipeline = sharded.sharded_msm_plan(n, k)
            fn = (partial(sharded.sharded_window_sums_staged, mesh=mesh, cfg=cfg, fold=True)
                  if pipeline == "kernels" else partial(sharded.sharded_window_sums, mesh=mesh,
                                                        cfg=cfg))
            args = (coords, scalars)
        t0 = time.time()
        force(fn(*args))
        compile_s = time.time() - t0
        ts = []
        for _ in range(runs):
            t0 = time.time()
            force(fn(*args))
            ts.append((time.time() - t0) * 1e3)
        m = median(ts)
        t1 = m if t1 is None else t1
        if mode == "batch":
            table.add(k, k, pipeline, round(compile_s, 2), round(m, 2), round(m / k, 2),
                      round(t1 / m, 3))
        else:
            table.add(k, pipeline, cfg.chunk_size, round(compile_s, 2), round(m, 2),
                      round(t1 / m, 2), round(t1 / (k * m), 3))
        print(table.markdown().splitlines()[-1], flush=True)
    return table
