"""Synthetic batches: the JAX package's learnable structured-token recipe,
drawn bit for bit as the reference draws them.

Each sequence is an incrementing run (next = cur + 1 mod vocab) from a
random start, with ``OUTLIER_FRAC`` of the positions replaced by uniform
tokens. ``make_batch(cfg, B, T, seed, step)`` depends only on (seed, step),
so a resumed run sees the same batches.

The draws are JAX's threefry draws (``jax_threefry_partitionable``, the
default since jax 0.5), reproduced with ``core.noise.threefry2x32`` on int64
tensors of the target device: ``split(key, n)[i]`` is ``fold_in(key, i)``;
the bits of element i are ``y0 ^ y1`` of the block on counter (i >> 32,
i & 0xFFFFFFFF); :func:`uniform` keeps their top 23 bits as the mantissa of
a float in [1, 2), minus 1; :func:`randint` is JAX's two-word modulus. The
tokens equal the reference's ``make_batch`` bitwise.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.noise import M32, fold_in, prng_key, threefry2x32

OUTLIER_FRAC = 0.15   # per-position probability of a uniform-random token
_ONE_F32 = 0x3F800000


def split(key, n: int) -> list:
    """JAX's ``random.split(key, n)`` (partitionable threefry)."""
    return [fold_in(key, i) for i in range(n)]


def random_bits(key, shape, device) -> torch.Tensor:
    """JAX's 32-bit ``random_bits`` of ``shape``: uint32 values in int64."""
    n = 1
    for s in shape:
        n *= int(s)
    i = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(int(key[0]), int(key[1]), i >> 32, i & M32)
    return (y0 ^ y1).view(tuple(shape))


def uniform(key, shape, device) -> torch.Tensor:
    """JAX's ``random.uniform(key, shape)`` in [0, 1), float32."""
    bits = (random_bits(key, shape, device) >> 9) | _ONE_F32
    return bits.to(torch.int32).view(torch.float32) - 1.0


def randint(key, shape, maxval: int, device) -> torch.Tensor:
    """JAX's ``random.randint(key, shape, 0, maxval)`` (int32, 0 < maxval
    < 2^31): 64 random bits an element reduced modulo maxval in uint32
    arithmetic."""
    k1, k2 = split(key, 2)
    span = int(maxval)
    mult = ((2 ** 16 % span) ** 2 & M32) % span   # 0 past 2^16: it wraps
    hi = random_bits(k1, shape, device) % span
    lo = random_bits(k2, shape, device) % span
    return ((((hi * mult) & M32) + lo) & M32) % span


def structured_tokens(key, B: int, T: int, vocab: int, device,
                      outlier_frac: float = OUTLIER_FRAC) -> torch.Tensor:
    """(B, T) int32 learnable sequences on ``device``."""
    k_start, k_mask, k_rare = split(key, 3)
    start = randint(k_start, (B, 1), vocab, device)
    runs = (torch.arange(T, device=device)[None, :] + start) % vocab
    rare = randint(k_rare, (B, T), vocab, device)
    frac = torch.tensor(outlier_frac, dtype=torch.float32, device=device)
    keep_run = uniform(k_mask, (B, T), device) >= frac
    return torch.where(keep_run, runs, rare).to(torch.int32)


def make_batch(cfg: ModelConfig, B: int, T: int, seed: int = 0,
               step: int = 0, device="cuda") -> dict:
    """{'tokens': (B, T) int32} on ``device`` for (seed, step): the
    reference's batch for this family (its only input is tokens)."""
    ks = split(fold_in(prng_key(seed), step), 3)
    return {"tokens": structured_tokens(ks[0], B, T, cfg.vocab, device)}
