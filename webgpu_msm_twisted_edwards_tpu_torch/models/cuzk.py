"""The MSM entry points: compute_msm(points, scalars) -> {x, y}, and the
fixed-base trio precompute_msm_base / compute_msm_precomputed /
compute_msm_batch_precomputed.

Port of the Pallas path of the JAX package's models/cuzk.py: inputs are
packed into u32 words, scalars reduced below the subgroup order, the point
count padded to a multiple of 4096 (zero scalars, copies of point 0), and
the pipeline (ops/msm_pipeline.py, or ops/precompute.py over a precomputed
base) returns one packed projective point that the host decodes.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..cpu.curve import ExtPoint
from ..ops import msm_pipeline as MP
from ..ops import precompute as PRE
from ..ops.kernels import _build
from ..ops.kernels.common import LP, W as WBITS, u32
from ..utils import limbs as L
from ..utils.interop import from_numpy_u32, to_numpy_u32
from ..utils.params import (
    PARAMS,
    SUBGROUP_ORDER,
    MsmConfig,
    default_msm_config,
    tpu_msm_config,
)
from ..utils.runtime import resolve_device


def _as_u32_tensor(arr, device) -> torch.Tensor | None:
    """Pre-packed u32 input (a numpy uint32 array or an int32 tensor) as an
    int32 tensor on `device`; None for any other input."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype != torch.int32:
            raise TypeError(f"packed tensors must be int32 (u32 bits), got {arr.dtype}")
        return arr.to(device)
    if isinstance(arr, np.ndarray) and arr.dtype == np.uint32:
        return from_numpy_u32(arr, device)
    return None


def _pack_points(points, device: torch.device) -> torch.Tensor:
    coords = _as_u32_tensor(points, device)
    if coords is None:
        pts = [(p["x"], p["y"]) if isinstance(p, dict) else p for p in points]
        coords = from_numpy_u32(np.stack(
            [L.ints_to_u32_words([p[0] for p in pts]),
             L.ints_to_u32_words([p[1] for p in pts])], axis=1).reshape(len(pts), 2, 8), device)
    if coords.shape[1:] != (2, 8):
        raise ValueError(f"points must be [n, 2, 8] words, got {tuple(coords.shape)}")
    return coords


def _pack_scalars(scalars, device: torch.device) -> torch.Tensor:
    sc = _as_u32_tensor(scalars, device)
    if sc is None:
        sc = from_numpy_u32(L.ints_to_u32_words(list(scalars)), device)
    if sc.dim() != 2 or sc.shape[1] != 8:
        raise ValueError(f"scalars must be [n, 8] words, got {tuple(sc.shape)}")
    return reduce_scalars_mod_order(sc)


def prepare_inputs(points, scalars, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack affine points into [n, 2, 8] and scalars into [n, 8] int32
    tensors of LE u32 words on `device`, scalars reduced mod the subgroup
    order.  Points may be (x, y) tuples, dicts with "x"/"y" keys or a packed
    [n, 2, 8] array; scalars ints or a packed [n, 8] array (numpy uint32 or
    an int32 tensor, which may already lie on the device)."""
    device = resolve_device(device)
    coords, sc = _pack_points(points, device), _pack_scalars(scalars, device)
    if sc.shape[0] != coords.shape[0]:
        raise ValueError(f"{coords.shape[0]} points but {sc.shape[0]} scalars")
    return coords, sc


def reduce_scalars_mod_order(sc: torch.Tensor) -> torch.Tensor:
    """Reduce the scalars >= the subgroup order mod that order: for subgroup
    points k*P == (k mod r)*P, and the signed window decomposition would
    drop the final carry of a scalar >= about 2^255.  sc: [n, 8] int32 words;
    one compare on its device, and only rows that need it go to the host."""
    order = torch.from_numpy(
        L.ints_to_u32_words([SUBGROUP_ORDER])[0].astype(np.int64)).to(sc.device)
    s = u32(sc)
    ge = torch.ones(sc.shape[0], dtype=torch.bool, device=sc.device)
    gt = torch.zeros_like(ge)
    for i in range(sc.shape[1] - 1, -1, -1):
        gt = gt | (ge & (s[:, i] > order[i]))
        ge = ge & (s[:, i] == order[i])
    bad = (gt | ge).nonzero().flatten()
    if bad.numel() == 0:
        return sc
    fixed = [v % SUBGROUP_ORDER for v in L.u32_words_to_ints(to_numpy_u32(sc[bad]))]
    sc = sc.clone()
    sc[bad] = from_numpy_u32(L.ints_to_u32_words(fixed), sc.device)
    return sc


def _pad_points(coords: torch.Tensor, pad: int) -> torch.Tensor:
    """Append `pad` copies of point 0 (its padded digits are zero)."""
    return torch.cat([coords, coords[:1].expand(pad, 2, 8)])


def _pad_zero_scalars(sc: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([sc, torch.zeros((pad, 8), dtype=sc.dtype, device=sc.device)])


def packed_rows_to_extpoints(rows: np.ndarray) -> list[ExtPoint]:
    """[W, TW] uint32 packed (x, y, t, z) Montgomery rows -> python-int
    extended points."""
    out = []
    for r in rows:
        coords = []
        for ci in range(4):
            v = 0
            for i, u in enumerate(r[ci * LP:(ci + 1) * LP]):
                v |= (int(u) & 0xFFFF) << (2 * i * WBITS)
                v |= (int(u) >> 16) << ((2 * i + 1) * WBITS)
            coords.append(PARAMS.from_mont(v % PARAMS.p))
        out.append(ExtPoint(*coords))
    return out


def compute_msm(
    points: Sequence[tuple[int, int]] | np.ndarray | torch.Tensor,
    scalars: Sequence[int] | np.ndarray | torch.Tensor,
    log_result: bool = False,
    force_recompile: bool = False,
    chunk_size: int | None = None,
    device=None,
) -> dict[str, int]:
    """Q = sum_i k_i * P_i: the affine result {x, y} as python ints.

    Runs on the CUDA card unless `device="cpu"` is given, which runs the
    kernels' plain PyTorch versions.  Points are assumed to lie in the
    prime-order subgroup; scalars >= its order are reduced mod the order.
    The window size is c = chunk_size, else 13 below 2^19 points and 16 from
    2^19 (n >= 4096), else 4.  The bucket pipeline needs n >= 512 and c >= 8;
    other inputs raise NotImplementedError (the small-input path is ROADMAP
    A.8).  force_recompile deletes the built kernels, so the next launch
    rebuilds every one from its source."""
    dev = resolve_device(device)
    if force_recompile:
        _build.clear()
    coords, sc = prepare_inputs(points, scalars, dev)
    n = coords.shape[0]
    if chunk_size is not None:
        cfg = MsmConfig(chunk_size=chunk_size)
    else:
        cfg = tpu_msm_config(n) if n >= 4096 else default_msm_config(n)
    if n < 512 or cfg.chunk_size < 8:
        raise NotImplementedError(
            f"n={n}, c={cfg.chunk_size}: the port runs only the bucket pipeline "
            "(n >= 512 and c >= 8); the small-input path is ROADMAP A.8")
    target = max(4096, -(-n // 4096) * 4096)
    if target != n:
        coords = _pad_points(coords, target - n)
        sc = _pad_zero_scalars(sc, target - n)
    result = _affine_result(MP.msm_window_sums_blocked(coords, sc, cfg, fold=True))
    if log_result:
        print(result)
    return result


def _affine_result(rows: torch.Tensor) -> dict[str, int]:
    """[1, TW] packed projective total -> the affine {x, y}."""
    x, y = packed_rows_to_extpoints(to_numpy_u32(rows))[0].to_affine()
    return {"x": x, "y": y}


def precompute_msm_base(points, chunk_size: int | None = None, device=None) -> PRE.PrecomputedBase:
    """The one-time fixed-base (SRS) precompute for
    :func:`compute_msm_precomputed`: the merged window-shifted table
    Q[j*n + i] = 2^(c*j) * P_i on the device (ops/precompute.py).  Points
    are padded to a multiple of 4096; c is 16 over 253 bits unless
    `chunk_size` is given (c >= 8).  Runs on the CUDA card unless
    `device="cpu"` is given."""
    dev = resolve_device(device)
    coords = _pack_points(points, dev)
    n = coords.shape[0]
    target = max(4096, -(-n // 4096) * 4096)
    if target != n:
        coords = _pad_points(coords, target - n)
    cfg = (PRE.fixed_base_config(target) if chunk_size is None
           else MsmConfig(chunk_size=chunk_size, scalar_bits=253))
    return PRE.precompute_fixed_base(coords, cfg)


def compute_msm_precomputed(pre: PRE.PrecomputedBase, scalars) -> dict[str, int]:
    """sum_i k_i * P_i over a precomputed base (see
    :func:`precompute_msm_base`), on the base's device: the affine {x, y},
    equal to compute_msm(points, scalars)."""
    return compute_msm_batch_precomputed(pre, [scalars])[0]


def compute_msm_batch_precomputed(pre: PRE.PrecomputedBase, scalars_list) -> list[dict[str, int]]:
    """One MSM per scalar vector over a precomputed base; the totals are
    read back after the last MSM is queued."""
    rows_list = [_fixed_base_rows(pre, sc) for sc in scalars_list]
    return [_affine_result(rows) for rows in rows_list]


def _fixed_base_rows(pre: PRE.PrecomputedBase, scalars) -> torch.Tensor:
    """Pack the scalars on the base's device, reduce them mod the subgroup
    order, pad them with zeros to the base's point count and run one MSM:
    [1, TW] packed projective total."""
    sc = _pack_scalars(scalars, pre.table.device)
    if sc.shape[0] > pre.n:
        raise ValueError(f"{sc.shape[0]} scalars for a base of {pre.n} points")
    if sc.shape[0] != pre.n:
        sc = _pad_zero_scalars(sc, pre.n - sc.shape[0])
    return PRE.fixed_base_total_rows(pre, sc)
