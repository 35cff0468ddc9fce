"""MSMs over a torch.distributed job: one process (rank) a device.

Port of the JAX package's parallel/distributed.py.  initialize() starts the
process group (NCCL on CUDA cards, gloo on the CPU, unless the caller names
a backend) and gives each rank its card, rank % torch.cuda.device_count().

- compute_msm_multihost: every rank passes its own points and scalars (the
  same count on every rank) and runs the whole pipeline on its device, as a
  shard of compute_msm_sharded does; the [W, TW] window sums (a few KB) go
  to every rank through all_gather, and every rank folds them
  (parallel/sharded.py::fold_window_sums, then the Horner fold) and
  returns the same point.  NCCL exchanges them on the card; a gloo group
  exchanges them through host memory, while the compute stays on the
  rank's device.  NCCL refuses two ranks on one card, so such a job takes
  gloo.
- compute_msm_batch_multihost: every rank passes all the points and its
  own scalar vectors and computes its MSMs whole; no collective.

A rank that fails raises; the others then fail in the collective (or at the
group's timeout).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models import cuzk
from ..ops import msm_pipeline as MP
from ..ops.kernels.bpr import horner_fold
from ..ops.kernels.scan import K
from ..utils.runtime import resolve_device
from . import sharded


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None, device=None) -> None:
    """Start the default process group once (a second call does nothing).
    init_method is an address such as "tcp://localhost:29500" (None: the
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK environment variables).
    The backend defaults to NCCL on the card and gloo with device="cpu".
    On the card, the rank's device becomes cuda:(rank % device_count)."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {k: v for k, v in (("world_size", world_size), ("rank", rank)) if v is not None}
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def global_mesh() -> list[int]:
    """The ranks of the job, one device each."""
    return list(range(dist.get_world_size()))


def _device(device) -> torch.device:
    """The rank's device: its current card, or the CPU with device="cpu"."""
    return sharded._mesh([resolve_device(device)])[0]


def _all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's copy of `t` (the same shape on every rank), on t's
    device.  NCCL gathers on the card; any other backend through host
    memory."""
    src = t.contiguous() if dist.get_backend() == "nccl" else t.cpu()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(out, src)
    return [o.to(t.device) for o in out]


def _pad_local(coords: torch.Tensor, scalars: torch.Tensor, multiple: int):
    """Pad this rank's points with copies of its first point and zero
    scalars to a positive multiple of `multiple` (zero digits fall in the
    sentinel bucket and add nothing)."""
    n = coords.shape[0]
    target = max(multiple, -(-n // multiple) * multiple)
    if target == n:
        return coords, scalars
    return cuzk._pad_points(coords, target - n), cuzk._pad_zero_scalars(scalars, target - n)


def compute_msm_multihost(local_coords, local_scalars, chunk_size: int | None = None,
                          pipeline: str | None = None, device=None) -> dict[str, int]:
    """sum_i k_i * P_i over the points of every rank: each rank passes its
    [n_local, 2, 8] point words and [n_local, 8] scalar words (numpy uint32
    or int32 tensors, or the forms prepare_inputs takes), n_local equal on
    every rank, and every rank returns the same affine {x, y}.

    The window size and pipeline follow sharded_msm_plan over the ranks;
    each rank pads its points with zero scalars to 4096 on the kernels
    pipeline (64 on the small one).  Runs on the rank's card unless
    device="cpu" is given."""
    dev = _device(device)
    coords, sc = cuzk.prepare_inputs(local_coords, local_scalars, dev)
    world = dist.get_world_size()
    n_local = torch.tensor([coords.shape[0]], dtype=torch.int64, device=dev)
    counts = [int(c) for c in _all_gather(n_local)]
    if len(set(counts)) != 1:
        raise ValueError(f"ranks hold different point counts: {counts}")
    cfg, pipeline = sharded.sharded_msm_plan(counts[0] * world, world, chunk_size, pipeline)
    coords, sc = _pad_local(coords, sc, 4096 if pipeline == "kernels" else K)
    if pipeline == "kernels":
        rows = sharded.fold_window_sums(_all_gather(MP.msm_window_sums(coords, sc, cfg)))
        return cuzk._affine_result(horner_fold(rows, cfg.chunk_size))
    sums = sharded._limb_stack(cuzk.msm_window_sums_device(coords, sc, cfg))   # [W, 4, L]
    return sharded._decode_small(sharded.fold_window_sum_stacks(_all_gather(sums)), cfg)


def compute_msm_batch_multihost(points, local_scalars_list, chunk_size: int | None = None,
                                pipeline: str | None = None, device=None) -> list[dict[str, int]]:
    """This rank's share of a batch over one point set: every rank passes all
    the points and its own scalar vectors, and gets element i equal to
    compute_msm(points, local_scalars_list[i]).  Each MSM runs whole on the
    rank's device (compute_msm_batch_sharded over that one device); no rank
    waits for another."""
    return sharded.compute_msm_batch_sharded(points, local_scalars_list, mesh=[_device(device)],
                                             chunk_size=chunk_size, pipeline=pipeline)
