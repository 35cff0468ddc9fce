"""PyTorch/CUDA port of the ed-on-bls12-377 MSM engine.

`compute_msm(points, scalars)` runs on an NVIDIA Hopper card through CUDA
kernels written for sm_90a (csrc/), built by nvcc at first use.  Every kernel
has a plain PyTorch version that CPU tensors take (`device="cpu"`).
"""

from .models.cuzk import compute_msm, prepare_inputs
from .utils.params import SUBGROUP_ORDER, MsmConfig

__all__ = ["compute_msm", "prepare_inputs", "MsmConfig", "SUBGROUP_ORDER"]
