"""Multi-device MSMs in one process: the point axis of one MSM, or the batch
axis of many MSMs over one point set, split over a mesh of devices.

Port of the JAX package's parallel/sharded.py.  A mesh is a list of
torch.device: default_mesh gives the first k CUDA cards, or k entries of
the CPU device (the CPU counterpart of a virtual device mesh).  A caller may
pass a mesh that names one card more than once; those shards then run one
after another on that card.

Point axis (compute_msm_sharded): each shard runs the whole bucket pipeline
on its n/k points on its device and ends with its [W, TW] packed window
sums, a few KB.  Those are copied to the mesh's first device and folded
window by window (window sums over disjoint points add): by the per-window
reduce (log depth) for a power-of-two mesh, else by a chain of masked adds;
the Horner fold then runs once.  The staged order (the default) runs each
stage on every shard before the next, so that on k distinct cards the work
of all shards is queued at once; the pipeline has no host sync on its way
(ops/kernels/ec.py::identity_row keeps its row on each device, as a copy
from host memory would wait for the card).

Batch axis (compute_msm_batch_sharded): the points are copied to every
device, the scalar vectors split over the mesh, and each MSM runs whole on
one device, with no cross-device point arithmetic.

The pipeline names are "kernels" (the bucket pipeline on the CUDA kernels,
the JAX package's "pallas") and "small" (the small-input path of plain
torch ops, the JAX package's "xla").
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..cpu.mirrors import horner
from ..models import cuzk
from ..ops import curve as C
from ..ops import msm_pipeline as MP
from ..ops.convert import decompose_scalars_signed
from ..ops.kernels import _build
from ..ops.kernels.bpr import bpr, horner_fold, reduce_rows_per_window
from ..ops.kernels.ec import TW, masked_add_rows
from ..ops.kernels.scan import K
from ..utils.params import MsmConfig
from ..utils.runtime import resolve_device

PIPELINES = ("kernels", "small")


def default_mesh(num_devices: int | None = None, device=None) -> list[torch.device]:
    """The first `num_devices` CUDA cards (all of them by default), distinct;
    raises if more are asked for than torch.cuda.device_count().  With
    device="cpu", `num_devices` entries of the CPU device (one by
    default)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        k = count if num_devices is None else num_devices
        if not 1 <= k <= count:
            raise ValueError(f"a mesh of {k} cards asked for; this machine has {count}")
        return [torch.device("cuda", i) for i in range(k)]
    k = 1 if num_devices is None else num_devices
    if k < 1:
        raise ValueError(f"a mesh of {k} devices")
    return [dev] * k


def _mesh(mesh, device=None) -> list[torch.device]:
    """The mesh as torch.devices with an index on every card (the current
    device for a bare "cuda"); default_mesh(device=device) when None."""
    if mesh is None:
        return default_mesh(device=device)
    devs = [torch.device(d) for d in mesh]
    if not devs:
        raise ValueError("an empty mesh")
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]


def _check_shards(n: int, ndev: int) -> int:
    """Points a shard; raises unless each shard is a multiple of the scan's
    K-entry fragment (an unpadded remainder would be bucketed wrongly)."""
    if n % (ndev * K):
        raise ValueError(f"per-shard size {n}/{ndev} must be a multiple of {K}; pad with "
                         f"zero scalars (see compute_msm_sharded)")
    return n // ndev


def _shards(coords: torch.Tensor, scalars: torch.Tensor, mesh: list[torch.device]):
    """Shard i: points [i*n/k, (i+1)*n/k) and their scalars on mesh[i]."""
    n_loc = coords.shape[0] // len(mesh)
    return [(coords[i * n_loc:(i + 1) * n_loc].to(d), scalars[i * n_loc:(i + 1) * n_loc].to(d))
            for i, d in enumerate(mesh)]


def fold_window_sums(rows: list[torch.Tensor]) -> torch.Tensor:
    """The cross-shard fold: k [W, TW] packed window sums on one device ->
    their window-by-window sum [W, TW].  A power-of-two k folds in log depth
    on the per-window reduce over the window-major rows (one launch; none
    for k = 1), any other k by a chain of k - 1 masked adds."""
    ndev, w = len(rows), rows[0].shape[0]
    if ndev & (ndev - 1) == 0:
        return reduce_rows_per_window(torch.stack(rows, dim=1).reshape(w * ndev, TW), ndev)
    out = rows[0]
    ones = torch.ones((w,), dtype=torch.int32, device=out.device)
    for r in rows[1:]:
        out = masked_add_rows(out, r, ones)
    return out


def _gather_fold(rows: list[torch.Tensor], mesh: list[torch.device], cfg: MsmConfig,
                 fold: bool) -> torch.Tensor:
    out = fold_window_sums([r.to(mesh[0]) for r in rows])
    return horner_fold(out, cfg.chunk_size) if fold else out


def sharded_window_sums_staged(coords: torch.Tensor, scalars: torch.Tensor, mesh,
                               cfg: MsmConfig, window_group: int = 0,
                               fold: bool = False) -> torch.Tensor:
    """The staged point-axis path: [n, 2, 8] and [n, 8] int32 words (n a
    multiple of 64 a shard) -> the [W, TW] packed window sums of all n
    points on the mesh's first device, or with fold=True the [1, TW] packed
    projective total (the Horner fold, once).  Stage by stage across the
    shards: every shard's table and digits, then each window group on every
    shard, then every shard's BPR.  window_group=0 takes
    default_window_group of a shard on the first device (sized as if the
    shard had the card to itself)."""
    mesh = _mesh(mesh)
    n_loc = _check_shards(coords.shape[0], len(mesh))
    w, nb = cfg.num_windows, cfg.num_buckets
    if window_group == 0:
        window_group = MP.default_window_group(n_loc, w, mesh[0])
    if w % window_group:
        raise ValueError(f"window_group={window_group} does not divide {w} windows")
    shards = _shards(coords, scalars, mesh)
    tables = [MP.build_prod_table(c) for c, _ in shards]
    digits = [decompose_scalars_signed(s, cfg).T for _, s in shards]         # [W, n_loc]
    del shards
    groups = [[] for _ in mesh]
    for g in range(w // window_group):
        for i in range(len(mesh)):
            dg = digits[i][g * window_group:(g + 1) * window_group]
            groups[i].append(MP.window_group_bucket_sums(tables[i], dg, nb))
    del tables, digits
    rows = [bpr(torch.cat(gr) if len(gr) > 1 else gr[0], w) for gr in groups]
    return _gather_fold(rows, mesh, cfg, fold)


def sharded_window_sums_kernels(coords: torch.Tensor, scalars: torch.Tensor, mesh,
                                cfg: MsmConfig, fold: bool = False) -> torch.Tensor:
    """The point-axis path shard after shard, each shard's whole pipeline
    (ops/msm_pipeline.py::msm_window_sums) in turn (the JAX package's
    one-program sharded_window_sums_pallas): the result of
    sharded_window_sums_staged, bit for bit."""
    mesh = _mesh(mesh)
    _check_shards(coords.shape[0], len(mesh))
    rows = [MP.msm_window_sums(c, s, cfg) for c, s in _shards(coords, scalars, mesh)]
    return _gather_fold(rows, mesh, cfg, fold)


def _limb_stack(sums: C.PointXYTZ) -> torch.Tensor:
    return torch.stack([sums.x, sums.y, sums.t, sums.z], dim=1)              # [W, 4, L]


def _unstack(s: torch.Tensor) -> C.PointXYTZ:
    return C.PointXYTZ(s[..., 0, :], s[..., 1, :], s[..., 2, :], s[..., 3, :])


def sharded_window_sums(coords: torch.Tensor, scalars: torch.Tensor, mesh, cfg: MsmConfig,
                        bpr_chunks: int = 256) -> C.PointXYTZ:
    """The small-input path over the mesh: each shard's [W] window sums
    (models/cuzk.py::msm_window_sums_device, Montgomery limbs) on its device,
    stacked on the first device and summed over the shards pairwise
    (ops/curve.py::tree_reduce_axis).  n must divide by the mesh size."""
    mesh = _mesh(mesh)
    if coords.shape[0] % len(mesh):
        raise ValueError(f"n={coords.shape[0]} must be divisible by the mesh size {len(mesh)}")
    return fold_window_sum_stacks([
        _limb_stack(cuzk.msm_window_sums_device(c, s, cfg, bpr_chunks)).to(mesh[0])
        for c, s in _shards(coords, scalars, mesh)])


def fold_window_sum_stacks(stacks: list[torch.Tensor]) -> C.PointXYTZ:
    """The small path's cross-shard fold: k [W, 4, L] window-sum limb stacks
    on one device -> their [W] window-by-window sum, pairwise over the
    shards (ops/curve.py::tree_reduce_axis)."""
    return C.tree_reduce_axis(_unstack(torch.stack(stacks)), axis=0)


def sharded_msm_plan(n: int, ndev: int, chunk_size: int | None = None,
                     pipeline: str | None = None) -> tuple[MsmConfig, str]:
    """Window size and pipeline of an MSM of n points over ndev shards, by
    the shard's point count, as compute_msm sizes one device's MSM
    (models/cuzk.py::_config): c = chunk_size, else 13 below 2^19 points a
    shard and 16 from 2^19 (from 4096 points), else 4; "kernels" for c >= 8
    and at least 512 points a shard, else "small"."""
    n_shard = n // ndev
    cfg = cuzk._config(n_shard, chunk_size)
    if pipeline is None:
        pipeline = "kernels" if cfg.chunk_size >= 8 and n_shard >= 512 else "small"
    if pipeline not in PIPELINES:
        raise ValueError(f"pipeline={pipeline!r}: one of {PIPELINES}")
    if pipeline == "kernels" and cfg.chunk_size < 8:
        raise ValueError(f"c={cfg.chunk_size}: the bucket pipeline needs c >= 8")
    return cfg, pipeline


def _batch_split(scalars_k, mesh: list[torch.device]):
    """Device i's contiguous share of the k vectors ([n, 8] int32 each)."""
    k, ndev = len(scalars_k), len(mesh)
    if k % ndev:
        raise ValueError(f"batch size {k} must be divisible by the mesh size {ndev}")
    per = k // ndev
    return [[sc.to(d) for sc in scalars_k[i * per:(i + 1) * per]] for i, d in enumerate(mesh)]


def sharded_msm_batch_rows(coords: torch.Tensor, scalars_k, mesh, cfg: MsmConfig) -> torch.Tensor:
    """The batch axis on the kernels: the points copied to every device, the
    k scalar vectors (a sequence of [n, 8] int32, k divisible by the mesh
    size) split over the mesh; each device runs its MSMs over one table
    (msm_window_sums_batch with the fold).  Returns [k, TW] packed
    projective totals on the first device."""
    mesh = _mesh(mesh)
    if coords.shape[0] % K:
        raise ValueError(f"n={coords.shape[0]} must be a multiple of {K} "
                         f"(compute_msm_batch_sharded pads)")
    totals = [MP.msm_window_sums_batch(coords.to(d), scs, cfg, fold=True)
              for d, scs in zip(mesh, _batch_split(scalars_k, mesh))]
    return torch.cat([t.to(mesh[0]) for dev_totals in totals for t in dev_totals])


def sharded_msm_batch_sums(coords: torch.Tensor, scalars_k, mesh, cfg: MsmConfig,
                           bpr_chunks: int = 256) -> torch.Tensor:
    """The batch axis on the small-input path: [k, W, 4, L] window-sum limb
    stacks on the first device (the host's Horner fold finishes each)."""
    mesh = _mesh(mesh)
    out = []
    for d, scs in zip(mesh, _batch_split(scalars_k, mesh)):
        c = coords.to(d)
        out += [_limb_stack(cuzk.msm_window_sums_device(c, sc, cfg, bpr_chunks)).to(mesh[0])
                for sc in scs]
    return torch.stack(out)


def warmup_sharded_staged() -> float:
    """Build every kernel library that is missing (the JAX package compiles
    its stage programs here): the seconds spent, 0 when all are built."""
    return _build.build_all()


def _decode_small(sums: C.PointXYTZ, cfg: MsmConfig) -> dict[str, int]:
    x, y = horner(cuzk.window_sums_to_extpoints(sums), cfg.chunk_size).to_affine()
    return {"x": x, "y": y}


def compute_msm_batch_sharded(points, scalars_list: Sequence, mesh=None,
                              chunk_size: int | None = None, bpr_chunks: int = 256,
                              pipeline: str | None = None, device=None) -> list[dict[str, int]]:
    """k MSMs over one point set with the batch axis split over the mesh
    (default: default_mesh(device=device), every card, or the CPU with
    device="cpu"); element i equals compute_msm(points, scalars_list[i]).

    The window size and pipeline follow the full n (every device holds all
    points): sharded_msm_plan(n, 1, ...).  The kernels pipeline pads the
    points to a multiple of 4096; the batch is padded with zero vectors to a
    multiple of the mesh size and their results dropped.  Scalars >= the
    subgroup order are reduced mod the order (one compare for all k)."""
    mesh = _mesh(mesh, device)
    coords, scs = cuzk._pack_batch(points, scalars_list, mesh[0])
    if not scs:
        raise ValueError("need at least one scalar vector")
    k = len(scs)
    cfg, pipeline = sharded_msm_plan(coords.shape[0], 1, chunk_size, pipeline)
    if pipeline == "kernels":
        coords, scs = cuzk._pad_batch(coords, scs)
    kpad = -(-k // len(mesh)) * len(mesh)
    scs += [torch.zeros_like(scs[0])] * (kpad - k)
    if pipeline == "kernels":
        rows = sharded_msm_batch_rows(coords, scs, mesh, cfg)                # [kpad, TW]
        return [cuzk._affine_result(rows[i:i + 1]) for i in range(k)]
    sums = sharded_msm_batch_sums(coords, scs, mesh, cfg, bpr_chunks)        # [kpad, W, 4, L]
    return [_decode_small(_unstack(sums[i]), cfg) for i in range(k)]


def compute_msm_sharded(points, scalars, mesh=None, chunk_size: int | None = None,
                        bpr_chunks: int = 256, pipeline: str | None = None,
                        staged: bool = True, device=None) -> dict[str, int]:
    """compute_msm with the point axis split over the mesh (default:
    default_mesh(device=device), every card, or the CPU with device="cpu"):
    the same inputs and affine result {x, y}.  n must divide by the mesh
    size.

    pipeline: "kernels" (the bucket pipeline on the CUDA kernels; the CPU's
    plain versions on CPU tensors) or "small" (the small-input path); by
    default "kernels" for c >= 8 and shards of at least 512 points
    (sharded_msm_plan).  The kernels pipeline pads each shard with zero
    scalars to a multiple of 4096 points.  staged=True runs the stages
    across the shards (sharded_window_sums_staged), False one shard after
    another (sharded_window_sums_kernels): the same bits."""
    mesh = _mesh(mesh, device)
    ndev = len(mesh)
    coords, sc = cuzk.prepare_inputs(points, scalars, mesh[0])
    n = coords.shape[0]
    if n % ndev:
        raise ValueError(f"n={n} must be divisible by the mesh size {ndev}")
    cfg, pipeline = sharded_msm_plan(n, ndev, chunk_size, pipeline)
    if pipeline == "small":
        return _decode_small(sharded_window_sums(coords, sc, mesh, cfg, bpr_chunks), cfg)
    per = cuzk._pad_target(n // ndev)
    if per * ndev != n:
        coords = cuzk._pad_points(coords, per * ndev - n)
        sc = cuzk._pad_zero_scalars(sc, per * ndev - n)
    run = sharded_window_sums_staged if staged else sharded_window_sums_kernels
    return cuzk._affine_result(run(coords, sc, mesh, cfg, fold=True))
