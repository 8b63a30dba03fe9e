"""8-bit stochastic-rounding quantization with a per-tensor scale, and
the compressed all-reduce built on it.

The tape residency store ``int8`` (``core.tape.store_record``) holds book-
kept records this way. Stochastic rounding keeps the dequantized record
unbiased. The draws come from an explicit ``torch.Generator``, so they are
not the JAX package's ``jax.random`` bits: the two agree in distribution,
not bitwise.

:func:`compressed_allreduce_mean` is the JAX package's cross-pod mean: each
rank's tensor quantized to int8 plus its f32 scale, both all-gathered over
the group, then dequantized and summed in rank order and divided by the
group's size, so every rank gets the same bits. The wire carries one byte
an element where a bf16 all-reduce moves two each way. Quantizing after
clipping and noise is post-processing, so the privacy guarantee holds. The
train step does not call it (neither does the reference's); wiring it into
a pod axis is ROADMAP B7b.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


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


def compressed_allreduce_mean(x: torch.Tensor, gen: torch.Generator,
                              group=None) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group`` (the world by default)
    by int8 all-gather: quantize (``gen`` draws the rounding), gather every
    rank's int8 values and scale, dequantize and sum them in rank order,
    divide by the group's size. -> a tensor of x's dtype, the same on every
    rank."""
    q, scale = quantize(x, gen)
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    if n == 1:
        qs, scales = [q], [scale.reshape(1)]
    else:
        qs = [torch.empty_like(q) for _ in range(n)]
        scales = [torch.empty(1, dtype=torch.float32, device=x.device)
                  for _ in range(n)]
        dist.all_gather(qs, q, group=group)
        dist.all_gather(scales, scale.reshape(1), group=group)
    total = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for qr, sr in zip(qs, scales):
        total += qr.to(torch.float32) * sr
    return (total / n).to(x.dtype)


def compressed_tree_allreduce_mean(tree: dict, gen: torch.Generator,
                                   group=None) -> dict:
    """:func:`compressed_allreduce_mean` of every leaf of a flat or nested
    dict, in sorted path order, one generator's draws after another."""
    from repro_torch.utils.tree import flatten, unflatten
    flat = flatten(tree)
    return unflatten({p: compressed_allreduce_mean(flat[p], gen, group)
                      for p in sorted(flat)})
