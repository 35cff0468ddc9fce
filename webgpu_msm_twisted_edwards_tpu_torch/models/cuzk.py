"""The MSM entry points: compute_msm(points, scalars) -> {x, y}, the batch
compute_msm_batch over one point set, and the fixed-base trio
precompute_msm_base / compute_msm_precomputed /
compute_msm_batch_precomputed.

Port of the JAX package's models/cuzk.py.  Inputs are packed into u32
words and scalars reduced below the subgroup order.  Two paths:
- the bucket pipeline (n >= 512 and c >= 8): the point count padded to a
  multiple of 4096 (zero scalars, copies of point 0), and the kernels'
  pipeline (ops/msm_pipeline.py, or ops/precompute.py over a precomputed
  base) returns one packed projective point that the host decodes;
- the small-input path, every other input: msm_window_sums_device in plain
  torch ops (the JAX package's pure-XLA pipeline) returns the window sums,
  which the host folds by Horner's rule.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..cpu.curve import ExtPoint
from ..cpu.mirrors import horner
from ..ops import bpr as BPR
from ..ops import buckets as B
from ..ops import convert as CV
from ..ops import curve as C
from ..ops import field as F
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
from ..utils.tracing import HOST_DECODE, WAIT_GUARD, WAIT_RESULT, span, wait


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


def _pack_scalar_words(scalars, device: torch.device) -> torch.Tensor:
    sc = _as_u32_tensor(scalars, device)
    if sc is None:
        sc = from_numpy_u32(L.ints_to_u32_words(list(scalars)), device)
    if sc.dim() != 2 or sc.shape[1] != 8:
        raise ValueError(f"scalars must be [n, 8] words, got {tuple(sc.shape)}")
    return sc


def _pack_scalars(scalars, device: torch.device) -> torch.Tensor:
    return reduce_scalars_mod_order(_pack_scalar_words(scalars, device))


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
    one compare on its device, a wait for it, and only rows that need it go
    to the host."""
    order = torch.from_numpy(
        L.ints_to_u32_words([SUBGROUP_ORDER])[0].astype(np.int64)).to(sc.device)
    s = u32(sc)
    ge = torch.ones(sc.shape[0], dtype=torch.bool, device=sc.device)
    gt = torch.zeros_like(ge)
    for i in range(sc.shape[1] - 1, -1, -1):
        gt = gt | (ge & (s[:, i] > order[i]))
        ge = ge & (s[:, i] == order[i])
    flag = gt | ge
    wait(WAIT_GUARD, sc.device)
    bad = flag.nonzero().flatten()
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


def msm_window_sums_device(coords: torch.Tensor, scalars: torch.Tensor, cfg: MsmConfig,
                           bpr_chunks: int = 256) -> C.PointXYTZ:
    """The small-input path on the inputs' device: [n, 2, 8] and [n, 8]
    int32 words -> [W] window sums, Montgomery-form limbs.  Conversion,
    signed digits, sorted buckets (ops/buckets.py), their layered
    accumulation and the chunked reduction (ops/bpr.py) in plain torch ops;
    no kernel is launched."""
    xm, ym, tm = CV.points_to_mont_limbs(coords)
    points = C.PointXYTZ(xm, ym, tm, F.r_limbs(coords.device).expand_as(xm))
    digits = CV.decompose_scalars_signed(scalars, cfg)
    buckets = B.accumulate_buckets(points, B.sort_buckets(digits, cfg))
    return BPR.reduce_buckets(buckets, num_chunks=bpr_chunks)


def window_sums_to_extpoints(sums: C.PointXYTZ) -> list[ExtPoint]:
    """[W] Montgomery-limb window sums -> python-int extended points."""
    arrs = [u.cpu().numpy() for u in sums]
    return [ExtPoint(*(PARAMS.from_mont(L.words_le_to_int(a[i], PARAMS.word_size))
                       for a in arrs)) for i in range(arrs[0].shape[0])]


def _small_path_msm(coords: torch.Tensor, sc: torch.Tensor, cfg: MsmConfig,
                    bpr_chunks: int = 256) -> dict[str, int]:
    sums = msm_window_sums_device(coords, sc, cfg, bpr_chunks)
    x, y = horner(window_sums_to_extpoints(sums), cfg.chunk_size).to_affine()
    return {"x": x, "y": y}


def _config(n: int, chunk_size: int | None) -> MsmConfig:
    """c = chunk_size, else 13 below 2^19 points and 16 from 2^19 (n >=
    4096), else 4."""
    if chunk_size is not None:
        return MsmConfig(chunk_size=chunk_size)
    return tpu_msm_config(n) if n >= 4096 else default_msm_config(n)


def _pad_target(n: int) -> int:
    return max(4096, -(-n // 4096) * 4096)


def compute_msm(
    points: Sequence[tuple[int, int]] | np.ndarray | torch.Tensor,
    scalars: Sequence[int] | np.ndarray | torch.Tensor,
    log_result: bool = False,
    force_recompile: bool = False,
    chunk_size: int | None = None,
    bpr_chunks: int = 256,
    use_kernels: bool | None = None,
    device=None,
) -> dict[str, int]:
    """Q = sum_i k_i * P_i: the affine result {x, y} as python ints.

    Runs on the CUDA card unless `device="cpu"` is given, which runs the
    kernels' plain PyTorch versions.  Points are assumed to lie in the
    prime-order subgroup; scalars >= its order are reduced mod the order.
    The window size is c = chunk_size, else 13 below 2^19 points and 16 from
    2^19 (n >= 4096), else 4.  use_kernels=None takes the bucket pipeline
    on the kernels for n >= 512 and c >= 8 and the small-input path
    (msm_window_sums_device, bpr_chunks chunks a window in its reduction)
    for every other input; False takes the small-input path at any n, True
    the bucket pipeline (c >= 8).  force_recompile deletes the built
    kernels, so the next launch rebuilds every one from its source."""
    dev = resolve_device(device)
    if force_recompile:
        _build.clear()
    coords, sc = prepare_inputs(points, scalars, dev)
    n = coords.shape[0]
    cfg = _config(n, chunk_size)
    if use_kernels is None:
        use_kernels = n >= 512 and cfg.chunk_size >= 8
    if not use_kernels:
        result = _small_path_msm(coords, sc, cfg, bpr_chunks)
    elif cfg.chunk_size < 8:
        raise ValueError(f"c={cfg.chunk_size}: the bucket pipeline needs c >= 8")
    else:
        target = _pad_target(n)
        if target != n:
            coords = _pad_points(coords, target - n)
            sc = _pad_zero_scalars(sc, target - n)
        result = _affine_result(MP.msm_window_sums_blocked(coords, sc, cfg, fold=True))
    if log_result:
        print(result)
    return result


def compute_msm_batch(points, scalars_list, chunk_size: int | None = None,
                      device=None) -> list[dict[str, int]]:
    """One MSM per scalar vector over one point set (a prover's many MSMs
    over its SRS): element i equals compute_msm(points, scalars_list[i]).

    One compare on the device guards all k vectors against scalars >= the
    subgroup order (one host sync), the points are padded once, the table
    is built once (once per point block), and the results are read back
    after the last MSM is queued.  Inputs that compute_msm sends to the
    small-input path run it once per vector.  Runs on the CUDA card unless
    `device="cpu"` is given."""
    coords, scs = _pack_batch(points, scalars_list, resolve_device(device))
    if not scs:
        return []
    n = coords.shape[0]
    cfg = _config(n, chunk_size)
    if n < 512 or cfg.chunk_size < 8:
        return [_small_path_msm(coords, sc, cfg) for sc in scs]
    rows_list = MP.msm_window_sums_batch(*_pad_batch(coords, scs), cfg, fold=True)
    return [_affine_result(rows) for rows in rows_list]


def _pack_batch(points, scalars_list, device: torch.device):
    """(points [n, 2, 8], the scalar vectors [n, 8] each) as int32 tensors
    on `device`, all the vectors reduced mod the subgroup order by one
    compare."""
    coords = _pack_points(points, device)
    n = coords.shape[0]
    packed = [_pack_scalar_words(sc, device) for sc in scalars_list]
    if any(sc.shape[0] != n for sc in packed):
        raise ValueError(f"{n} points but scalar vectors of {[sc.shape[0] for sc in packed]}")
    if not packed:
        return coords, []
    return coords, list(reduce_scalars_mod_order(torch.cat(packed)).split(n))


def _pad_batch(coords: torch.Tensor, scs: list[torch.Tensor]):
    """The points and every scalar vector padded to the bucket pipeline's
    multiple of 4096 (copies of point 0, zero scalars)."""
    n = coords.shape[0]
    target = _pad_target(n)
    if target == n:
        return coords, scs
    return _pad_points(coords, target - n), [_pad_zero_scalars(sc, target - n) for sc in scs]


def _affine_result(rows: torch.Tensor) -> dict[str, int]:
    """[1, TW] packed projective total -> the affine {x, y}: a wait for the
    total, its copy to the host, then the host's decode."""
    wait(WAIT_RESULT, rows.device)
    words = to_numpy_u32(rows)
    with span(HOST_DECODE):
        x, y = packed_rows_to_extpoints(words)[0].to_affine()
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
