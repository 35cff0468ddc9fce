"""MSM implementations behind one entry signature, `(points, scalars,
device=None) -> {x, y}`, for the benchmarks to race (benchmarks dashboard).

Each function keeps the name of its JAX package counterpart
(models/baselines.py there); the registry's keys name what runs here.

| key | function | what runs |
|---|---|---|
| your_msm (cuda) | best_msm | compute_msm: the bucket pipeline on the CUDA kernels |
| precomputed_msm (cuda) | tpu_precomputed_msm | precompute_msm_base, then compute_msm_precomputed |
| pippenger (torch ops) | tpu_pippenger_msm | compute_msm(use_kernels=False): the small-input path's plain torch ops |
| naive_msm (u256, torch ops) | tpu_naive_msm | ops/u256.py: per-point double-and-add, tree sum |
| cpu_compute_msm (C++ oracle) | cpu_compute_msm | the native serial Pippenger |
| cpu_compute_msm_parallel (C++ oracle) | cpu_compute_msm_parallel | the native threaded Pippenger |

Every device entry runs on the CUDA card unless `device="cpu"` is given;
the oracle entries run on the host and ignore `device`.
"""

from __future__ import annotations

import numpy as np

from ..utils import oracle
from ..utils.limbs import ints_to_u32_words
from . import cuzk


def tpu_pippenger_msm(points, scalars, chunk_size: int | None = None,
                      device=None) -> dict[str, int]:
    """Signed Pippenger in plain torch ops, no kernel: compute_msm with
    use_kernels=False (the JAX package's pure-XLA pipeline)."""
    return cuzk.compute_msm(points, scalars, chunk_size=chunk_size, use_kernels=False,
                            device=device)


def tpu_naive_msm(points, scalars, bits: int = 256, device=None) -> dict[str, int]:
    """The naive MSM on the independent arithmetic of ops/u256.py: plain
    (non-Montgomery) 8 x 32-bit words, a shift-and-add field product,
    per-point double-and-add over `bits` scalar bits on every lane at once,
    a log-depth tree sum.  Slow by design; as it shares no limb layout,
    domain, product or reduction with the pipeline, its agreement is an
    independent check on the device."""
    from ..cpu.curve import ExtPoint
    from ..ops import u256 as U
    from ..utils import limbs as L
    from ..utils.params import PARAMS

    coords, sc = cuzk.prepare_inputs(points, scalars, device)
    x, y, t, z = (a[:, 0].cpu().numpy() for a in U.naive_msm_words(coords, sc, bits=bits))
    res = ExtPoint(*(L.words_le_to_int(v, 32) % PARAMS.p for v in (x, y, t, z)))
    ax, ay = res.to_affine()
    return {"x": ax, "y": ay}


def _oracle_inputs(points, scalars):
    """API inputs as the oracle's u64 buffers: points as (x, y) int pairs or
    [n, 2, 8] u32 words, scalars as ints or [n, 8] u32 words (the u32 LE
    words read as u64 LE words)."""
    if not isinstance(points, np.ndarray):
        points = np.stack([ints_to_u32_words([x for x, _ in points]),
                           ints_to_u32_words([y for _, y in points])], axis=1)
    if not isinstance(scalars, np.ndarray):
        scalars = ints_to_u32_words(scalars)
    n = points.shape[0]
    return (np.ascontiguousarray(points, dtype=np.uint32).view(np.uint64).reshape(n, 8),
            np.ascontiguousarray(scalars, dtype=np.uint32).view(np.uint64).reshape(n, 4))


def cpu_compute_msm(points, scalars, device=None) -> dict[str, int]:
    """The native serial CPU MSM (the C++ oracle)."""
    x, y = oracle.msm(*_oracle_inputs(points, scalars))
    return {"x": x, "y": y}


def cpu_compute_msm_parallel(points, scalars, device=None) -> dict[str, int]:
    """The native multi-threaded CPU MSM (one thread a window)."""
    x, y = oracle.msm_parallel(*_oracle_inputs(points, scalars))
    return {"x": x, "y": y}


def best_msm(points, scalars, device=None) -> dict[str, int]:
    """compute_msm, the port's production path."""
    return cuzk.compute_msm(points, scalars, device=device)


def tpu_precomputed_msm(points, scalars, device=None) -> dict[str, int]:
    """The fixed-base path, precompute then MSM in one call so that it fits
    the one signature: a correctness row, not a speed row (the precompute
    is paid once per point set in use)."""
    pre = cuzk.precompute_msm_base(points, device=device)
    return cuzk.compute_msm_precomputed(pre, scalars)


#: The benchmarks' registry: name -> entry.
ALL_MSM_FUNCTIONS = {
    "your_msm (cuda)": best_msm,
    "precomputed_msm (cuda)": tpu_precomputed_msm,
    "pippenger (torch ops)": tpu_pippenger_msm,
    "naive_msm (u256, torch ops)": tpu_naive_msm,
    "cpu_compute_msm (C++ oracle)": cpu_compute_msm,
    "cpu_compute_msm_parallel (C++ oracle)": cpu_compute_msm_parallel,
}
