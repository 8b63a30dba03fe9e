"""8-bit stochastic-rounding quantization with a per-tensor scale.

The tape residency store ``int8`` (``core.tape.store_record``) holds book-
kept records this way. Stochastic rounding keeps the dequantized record
unbiased. The draws come from an explicit ``torch.Generator``, so they are
not the JAX package's ``jax.random`` bits: the two agree in distribution,
not bitwise. (The JAX module's compressed cross-pod all-reduces belong to
the distributed slice and are not ported.)
"""
from __future__ import annotations

import torch


def quantize(x: torch.Tensor, gen: torch.Generator):
    """-> (int8 values, f32 scale). Stochastic rounding (unbiased)."""
    x32 = x.to(torch.float32)
    scale = torch.clamp(x32.abs().max(), min=1e-12) / 127.0
    y = x32 / scale
    lo = torch.floor(y)
    up = torch.rand(x.shape, generator=gen, device=x.device) < (y - lo)
    q = torch.clamp(lo + up.to(torch.float32), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32):
    """``scale`` may be a scalar or a leading-axes tensor (the (L,)
    per-layer scales of a stacked record)."""
    if scale.dim():
        scale = scale.reshape(*scale.shape, *(1,) * (q.dim() - scale.dim()))
    return (q.to(torch.float32) * scale).to(dtype)
