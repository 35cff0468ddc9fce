"""Signed window decomposition of the scalars, in plain torch ops (the JAX
package leaves it to XLA, ops/convert.py::decompose_scalars_signed)."""

from __future__ import annotations

import torch

from ..utils.params import MsmConfig
from .kernels.common import M32, u32


def decompose_scalars_signed(scalars: torch.Tensor, cfg: MsmConfig) -> torch.Tensor:
    """[n, 8] int32 LE scalar words -> [n, num_windows] int32 signed digits in
    [-2^(c-1), 2^(c-1) - 1] with scalar == sum(d_i * 2^(c*i)).  The final
    carry is 0 for scalars below the subgroup order and is dropped."""
    c = cfg.chunk_size
    size = 1 << c
    half = size >> 1
    s = u32(scalars)
    num_u32 = s.shape[-1]
    digits = []
    carry = torch.zeros(s.shape[:-1], dtype=torch.int64, device=s.device)
    for i in range(cfg.num_windows):
        b = i * c
        idx, off = b // 32, b % 32
        v = s[..., idx] >> off
        if off + c > 32 and idx + 1 < num_u32:
            v = v | ((s[..., idx + 1] << (32 - off)) & M32)
        d = (v & (size - 1)) + carry
        wrap = d >= half
        digits.append(torch.where(wrap, d - size, d))
        carry = wrap.to(torch.int64)
    return torch.stack(digits, dim=-1).to(torch.int32)
