"""PyTorch/CUDA port of the ed-on-bls12-377 MSM engine.

`compute_msm(points, scalars)`, `compute_msm_batch(points, scalars_list)`,
and over a fixed point set
`compute_msm_precomputed(precompute_msm_base(points), scalars)`, run on an
NVIDIA Hopper card through CUDA kernels written for sm_90a (csrc/), built by
nvcc at first use; inputs below 512 points or with windows below 8 bits take
a path of plain torch ops.  Every kernel has a plain PyTorch version that CPU
tensors take (`device="cpu"`).  `validate_pipeline` checks each stage
against python mirrors.  `compute_msm_sharded` splits one MSM's points,
and `compute_msm_batch_sharded` a batch of MSMs, over several devices
(parallel/); parallel.distributed runs them over a torch.distributed job.
"""

from .models.cuzk import (
    compute_msm,
    compute_msm_batch,
    compute_msm_batch_precomputed,
    compute_msm_precomputed,
    precompute_msm_base,
    prepare_inputs,
)
from .ops.debug import validate_pipeline
from .parallel.sharded import compute_msm_batch_sharded, compute_msm_sharded
from .utils.params import SUBGROUP_ORDER, MsmConfig

__all__ = ["compute_msm", "compute_msm_batch", "compute_msm_batch_precomputed",
           "compute_msm_batch_sharded", "compute_msm_precomputed", "compute_msm_sharded",
           "precompute_msm_base", "prepare_inputs", "validate_pipeline", "MsmConfig",
           "SUBGROUP_ORDER"]
