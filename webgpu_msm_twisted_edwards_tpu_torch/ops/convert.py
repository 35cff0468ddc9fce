"""Scalar decomposition and coordinate word/limb conversion, in plain torch
ops (the JAX package leaves them to XLA, ops/convert.py)."""

from __future__ import annotations

import torch

from ..utils.params import MsmConfig
from . import field as F
from .kernels.common import L, M32, MASK, W, u32


def u32_words_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """[..., 8] LE u32 words -> [..., L] 13-bit limbs (int64)."""
    s = u32(words)
    num_u32 = s.shape[-1]
    limbs = []
    for i in range(L):
        b = i * W
        idx, off = b // 32, b % 32
        v = s[..., idx] >> off
        if off + W > 32 and idx + 1 < num_u32:
            v = v | ((s[..., idx + 1] << (32 - off)) & M32)
        limbs.append(v & MASK)
    return torch.stack(limbs, dim=-1)


def limbs_to_u32_words(limbs: torch.Tensor, num_u32: int = 8) -> torch.Tensor:
    """Inverse of :func:`u32_words_to_limbs`: [..., L] limbs -> [..., num_u32]
    u32 words (int64)."""
    words = []
    for j in range(num_u32):
        acc = torch.zeros(limbs.shape[:-1], dtype=torch.int64, device=limbs.device)
        for i in range(L):
            b = i * W
            if b + W <= j * 32 or b >= (j + 1) * 32:
                continue
            shift = b - j * 32
            if shift >= 0:
                acc = acc | ((limbs[..., i] << shift) & M32)
            else:
                acc = acc | (limbs[..., i] >> -shift)
        words.append(acc)
    return torch.stack(words, dim=-1)


def points_to_mont_limbs(coords: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[n, 2, 8] affine (x, y) u32 words -> Montgomery-form limbs (xm, ym,
    tm = xm*ym*R^-1), each [n, L] int64; z is R (affine 1)."""
    x = u32_words_to_limbs(coords[:, 0, :])
    y = u32_words_to_limbs(coords[:, 1, :])
    xm, ym = F.to_mont(torch.stack([x, y])).unbind(0)
    return xm, ym, F.mont_mul(xm, ym)


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
