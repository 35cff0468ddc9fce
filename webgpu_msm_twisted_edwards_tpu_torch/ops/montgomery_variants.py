"""Montgomery products across limb widths 12-16: the limb-width study.

The JAX package's ops/montgomery_variants.py in plain torch ops over
limb-last [..., L] int64 tensors of w-bit limbs (each product of two limbs
fits 32 bits, as the JAX version's uint32 arithmetic needs; no sum here
exceeds 32 bits either, so the limbs equal the JAX version's).  Three
families, chosen per width by the carry headroom nsafe = floor(2^32 /
2^(2w)) / 2:

- w <= 13 (nsafe >= num_words): the carry-free interleaved product;
- w in {14, 15} (0 < nsafe < num_words): "modified", a carry sweep every
  nsafe iterations;
- w == 16 (nsafe == 0): CIOS, carries split at every step.

These are benchmark and parity implementations; the pipeline's product is
the 13-bit kernels' (ops/kernels/common.py, csrc/).
"""

from __future__ import annotations

from functools import partial

import torch

from ..utils.params import FieldParams, compute_field_params


def _p_limbs(params: FieldParams, device) -> torch.Tensor:
    return torch.tensor([(params.p >> (i * params.word_size)) & params.mask
                         for i in range(params.num_words)], dtype=torch.int64, device=device)


def _sweep(s: torch.Tensor, w: int, mask: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Carry-normalize [..., n] limbs: (the limbs, the carry out of the top)."""
    out, c = [], None
    for i in range(s.shape[-1]):
        v = s[..., i] if c is None else s[..., i] + c
        out.append(v & mask)
        c = v >> w
    return torch.stack(out, dim=-1), c


def _cond_sub_p(s: torch.Tensor, params: FieldParams) -> torch.Tensor:
    """s - p where s >= p, else s, over normalized [..., L] limbs."""
    diff, borrow = _sweep(s - _p_limbs(params, s.device), params.word_size, params.mask)
    return torch.where((borrow == 0).unsqueeze(-1), diff, s)


def mont_mul_optimised(x: torch.Tensor, y: torch.Tensor, params: FieldParams) -> torch.Tensor:
    """The carry-free interleaved product; needs nsafe >= num_words."""
    assert params.nsafe >= params.num_words
    return _mont_interleaved(x, y, params, sweep_every=0)


def mont_mul_modified(x: torch.Tensor, y: torch.Tensor, params: FieldParams) -> torch.Tensor:
    """The interleaved product with a carry sweep every nsafe iterations."""
    assert params.nsafe >= 1
    return _mont_interleaved(x, y, params, sweep_every=max(1, params.nsafe))


def _mont_interleaved(x, y, params: FieldParams, sweep_every: int) -> torch.Tensor:
    """Per iteration i: s = (s + x_i*y + q_i*p) / 2^w with q_i making the low
    limb vanish; s's limbs carry no carries between sweeps."""
    L, w, mask = params.num_words, params.word_size, params.mask
    pl = _p_limbs(params, x.device)
    x, y = torch.broadcast_tensors(x, y)
    s = torch.zeros_like(x)
    hi = torch.zeros_like(x[..., 0])          # the limb above L-1
    for i in range(L):
        xi = x[..., i:i + 1]
        t = s[..., 0] + xi[..., 0] * y[..., 0]
        qi = (params.n0 * (t & mask)) & mask
        c = (t + qi * pl[0]) >> w
        ns = s[..., 1:] + xi * y[..., 1:] + qi.unsqueeze(-1) * pl[1:]
        ns[..., 0] += c
        s = torch.cat([ns, hi.unsqueeze(-1)], dim=-1)
        hi = torch.zeros_like(hi)
        if sweep_every and (i + 1) % sweep_every == 0 and i + 1 < L:
            s, hi = _sweep(s, w, mask)
    s, _ = _sweep(s, w, mask)
    return _cond_sub_p(s, params)


def mont_mul_cios(x: torch.Tensor, y: torch.Tensor, params: FieldParams) -> torch.Tensor:
    """CIOS with 16-bit limbs: every limb product fits 32 bits and its carry
    is split off at once.  Works for any w <= 16."""
    L, w, mask = params.num_words, params.word_size, params.mask
    n0 = params.n0
    pl = [(params.p >> (i * w)) & mask for i in range(L)]
    x, y = torch.broadcast_tensors(x, y)
    xs = [x[..., i] for i in range(L)]
    ys = [y[..., i] for i in range(L)]
    t = [torch.zeros_like(xs[0]) for _ in range(L + 2)]
    for i in range(L):
        xi = xs[i]
        c = torch.zeros_like(xi)
        for j in range(L):
            cs = t[j] + xi * ys[j] + c
            t[j] = cs & mask
            c = cs >> w
        cs = t[L] + c
        t[L] = cs & mask
        t[L + 1] = cs >> w
        m = (t[0] * n0) & mask
        cs = t[0] + m * pl[0]
        c = cs >> w
        for j in range(1, L):
            cs = t[j] + m * pl[j] + c
            t[j - 1] = cs & mask
            c = cs >> w
        cs = t[L] + c
        t[L - 1] = cs & mask
        t[L] = t[L + 1] + (cs >> w)
        t[L + 1] = torch.zeros_like(xi)
    return _cond_sub_p(torch.stack(t[:L], dim=-1), params)


def mont_mul_for_width(w: int):
    """(params, fn): the family the study picks for limb width w."""
    params = compute_field_params(word_size=w)
    if params.nsafe >= params.num_words:
        return params, partial(mont_mul_optimised, params=params)
    if params.nsafe >= 1:
        return params, partial(mont_mul_modified, params=params)
    return params, partial(mont_mul_cios, params=params)


def cost_loop(w: int, batch: int, chain: int):
    """The cost-model benchmark: (params, fn) where fn(x, y) runs `chain`
    dependent products r <- r*y per lane on [batch, L] limbs."""
    params, fn = mont_mul_for_width(w)

    def run(x, y):
        r = x
        for _ in range(chain):
            r = fn(r, y)
        return r

    return params, run
