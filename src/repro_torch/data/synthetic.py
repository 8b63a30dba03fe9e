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
a float in [1, 2), minus 1; :func:`randint` is JAX's two-word modulus;
:func:`normal` is ``sqrt(2) * erfinv`` of JAX's uniform on
[nextafter(-1, 0), 1), erfinv by XLA's f32 polynomial (:func:`erfinv`).
The tokens equal the reference's ``make_batch`` bitwise; the encdec
family's frames take the same uniforms bitwise and lie within 3 f32 ulps
of its normals (XLA's ``log1p`` is not correctly rounded; torch's
``erfinv`` alone would be ~90 ulps off).
"""
from __future__ import annotations

import math

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


# XLA's f32 erf_inv (M. Giles' single-precision approximation): a degree-8
# polynomial in w - 2.5 for w = -log1p(-x^2) < 5, else in sqrt(w) - 3
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` of x in (-1, 1): each Horner step one fused
    multiply-add (the product exact in float64, one rounding to f32)."""
    w = (-torch.log1p(-(x * x).double())).float()
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.zeros_like(w)
    for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE):
        p = (torch.where(small, a, b) + p * w).float().double()
    return p.float() * x


def normal(key, shape, device) -> torch.Tensor:
    """JAX's ``random.normal(key, shape)`` (float32): the uniform on
    [lo, 1), lo = nextafter(-1, 0), as JAX scales it (u * (1 - lo) + lo,
    clamped below at lo; 1 - lo rounds to 2 in f32), then sqrt(2) *
    erfinv(u)."""
    lo = torch.tensor(float(torch.nextafter(torch.tensor(-1.0),
                                            torch.tensor(0.0))),
                      device=device)
    u = torch.maximum(uniform(key, shape, device) * 2.0 + lo, lo)
    return erfinv(u) * torch.tensor(math.sqrt(2), dtype=torch.float32,
                                    device=device)


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
    """The reference's batch for this family on ``device`` for (seed,
    step): {'tokens': (B, T) int32}; for ``encdec`` T counts audio frames,
    {'frames': (B, T, frame_dim) f32, 'tokens': (B, decoder_len) int32}.
    The reference draws its inputs in the sorted order of their names, the
    i-th from the i-th of three keys: frames from the first, tokens then
    from the second."""
    ks = split(fold_in(prng_key(seed), step), 3)
    if cfg.family == "encdec":
        return {"frames": normal(ks[0], (B, T, cfg.frame_dim or cfg.d_model),
                                 device),
                "tokens": structured_tokens(ks[1], B, cfg.decoder_len,
                                            cfg.vocab, device)}
    return {"tokens": structured_tokens(ks[0], B, T, cfg.vocab, device)}
