"""Per-stage validation: the pipeline's stages on their device against the
python mirrors (cpu/mirrors.py).

`validate_pipeline(points, scalars)` returns {stage: "ok"} for the four
stages, or raises an AssertionError that names the first stage whose device
output differs from its mirror.
"""

from __future__ import annotations

import numpy as np

from ..cpu.curve import ExtPoint
from ..cpu.mirrors import (
    bucket_accumulation_signed,
    decompose_scalars_signed,
    horner,
    running_sum_bucket_reduction,
)
from ..utils.interop import to_numpy_u32
from ..utils.params import PARAMS, SUBGROUP_ORDER, MsmConfig
from ..utils.runtime import resolve_device
from . import convert as CV
from . import msm_pipeline as MP


def _same_point(a: ExtPoint, b: ExtPoint) -> bool:
    """Projective equality: x_a/z_a == x_b/z_b and y_a/z_a == y_b/z_b."""
    p = PARAMS.p
    return (a.x * b.z - b.x * a.z) % p == 0 and (a.y * b.z - b.y * a.z) % p == 0


def validate_pipeline(points, scalars, chunk_size: int = 16, device=None) -> dict[str, str]:
    """Run each stage on `device` (the CUDA card unless "cpu") and check it
    against its mirror: the signed digits; the table's converted rows
    ((y - x)*R at three points); every window's bucket sums, from
    window_group_bucket_sums over one group of all windows; and the
    compute_msm result against the mirrors' running-sum reduction and Horner
    fold of those buckets.  points: (x, y) int pairs, a multiple of the
    scan fragment size K in number; scalars: ints (the mirrors take them
    reduced mod the subgroup order, as the device does)."""
    from ..models import cuzk

    dev = resolve_device(device)
    cfg = MsmConfig(chunk_size=chunk_size)
    w, nb = cfg.num_windows, cfg.num_buckets
    coords, sc = cuzk.prepare_inputs(points, scalars, dev)
    n = coords.shape[0]
    if n % MP.K:
        raise ValueError(f"n={n} must be a multiple of the scan fragment size {MP.K}")
    status = {}

    digits_dev = CV.decompose_scalars_signed(sc, cfg)
    digits_cpu = decompose_scalars_signed([int(s) % SUBGROUP_ORDER for s in scalars], w,
                                          chunk_size)
    if not np.array_equal(digits_dev.cpu().numpy(), np.array(digits_cpu, dtype=np.int32)):
        raise AssertionError("stage 1 decompose mismatch")
    status["decompose"] = "ok"

    # Table rows hold the cached form (y - x, y + x, 2*d*t) in 13-bit limbs,
    # one u32 word each; words 0..19 are (y - x)*R.
    table = MP.build_full_table(coords)
    for i in (0, n // 2, n - 1):
        x, y = points[i]
        row = to_numpy_u32(table[i])
        got = sum(int(row[j]) << (j * PARAMS.word_size) for j in range(PARAMS.num_words))
        if got % PARAMS.p != PARAMS.to_mont((y - x) % PARAMS.p):
            raise AssertionError(f"stage 1 convert mismatch at point {i}")
    status["convert"] = "ok"

    pts = [ExtPoint.from_affine(x, y) for x, y in points]
    want = bucket_accumulation_signed(pts, digits_cpu, w, chunk_size)
    rows = MP.window_group_bucket_sums(table, digits_dev.T, nb)
    got = cuzk.packed_rows_to_extpoints(to_numpy_u32(rows))
    for wi in range(w):
        for b in range(nb):
            if not _same_point(got[wi * nb + b], want[wi][b]):
                raise AssertionError(f"stage 2/3 bucket mismatch window {wi} bucket {b}")
    status["buckets (transpose+smvp)"] = "ok"
    del table, rows, got

    res = cuzk.compute_msm(coords, sc, chunk_size=chunk_size, device=dev)
    total = horner([running_sum_bucket_reduction(b) for b in want], chunk_size)
    if (res["x"], res["y"]) != total.to_affine():
        raise AssertionError("stage 4/horner mismatch")
    status["bpr + horner"] = "ok"
    return status
