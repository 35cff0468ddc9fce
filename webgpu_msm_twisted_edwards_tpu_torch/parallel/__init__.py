"""Multi-device MSMs: several devices of one process (`sharded`) and one
device per process of a torch.distributed job (`distributed`)."""

from . import distributed, sharded  # noqa: F401
from .sharded import compute_msm_batch_sharded, compute_msm_sharded  # noqa: F401
