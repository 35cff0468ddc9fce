"""PyTorch/CUDA port of the ed-on-bls12-377 MSM engine.

`compute_msm(points, scalars)`, and over a fixed point set
`compute_msm_precomputed(precompute_msm_base(points), scalars)`, run on an
NVIDIA Hopper card through CUDA kernels written for sm_90a (csrc/), built by
nvcc at first use.  Every kernel has a plain PyTorch version that CPU
tensors take (`device="cpu"`).
"""

from .models.cuzk import (
    compute_msm,
    compute_msm_batch_precomputed,
    compute_msm_precomputed,
    precompute_msm_base,
    prepare_inputs,
)
from .utils.params import SUBGROUP_ORDER, MsmConfig

__all__ = ["compute_msm", "compute_msm_batch_precomputed", "compute_msm_precomputed",
           "precompute_msm_base", "prepare_inputs", "MsmConfig", "SUBGROUP_ORDER"]
