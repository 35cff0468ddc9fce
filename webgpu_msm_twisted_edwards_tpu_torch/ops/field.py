"""Field glue over limb-last [..., L] tensors of 13-bit limbs, in plain torch
ops: the JAX package's ops/field.py leaves these to XLA.

Values are u32 limbs in int64 tensors.  The XLA Montgomery product is the
carry-free interleaved form with a final conditional subtraction, so it
equals the kernels' reduced product (ops/kernels/common.py::mont_mul with
reduce=True), which these functions run with the limb axis moved to dim -2.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.params import PARAMS
from .kernels import common as C


def _const(v: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(C.int_to_limbs(v).astype(np.int64)).to(like.device)


def mont_mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x*y*R^-1 mod p over [..., L] limbs (broadcasting), reduced below p."""
    x, y = torch.broadcast_tensors(C.u32(x), C.u32(y))
    shape = x.shape
    pv = _const(PARAMS.p, x)[:, None]
    out = C.mont_mul(x.reshape(-1, C.L).T, y.reshape(-1, C.L).T, pv)
    return out.T.reshape(shape)


def to_mont(x: torch.Tensor) -> torch.Tensor:
    """x*R mod p: the product with R^2."""
    return mont_mul(x, _const(PARAMS.r2, x))


def from_mont(x: torch.Tensor) -> torch.Tensor:
    """x*R^-1 mod p: the product with 1."""
    return mont_mul(x, _const(1, x))
