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
[nextafter(-1, 0), 1), erfinv by XLA's f32 polynomial (:func:`erfinv`)
over XLA's CPU ``log1p`` (:func:`log1p`: Cephes' rational and log, which
are not correctly rounded) and a correctly rounded square root. The tokens,
the encdec family's frames and the vlm family's patches equal the
reference's ``make_batch`` bitwise (torch's own ``erfinv`` would be ~90
ulps off, its ``log1p`` 3).
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


# XLA's f32 log1p on the CPU: below |x| < sqrt(2) - 1 Cephes' rational
# x - x^2/2 + x^3 P(x)/Q(x), else log(1 + x) by Cephes' f32 log: the
# mantissa m in [sqrt(1/2), sqrt(2)) - 1 and exponent e, a degree-8
# polynomial in m, e ln 2 in two parts (Q1 + Q2 = ln 2)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def _fma(a, b, c) -> torch.Tensor:
    """f32 a * b + c with one rounding (the product exact in float64); a
    Python float operand is first rounded to f32, as XLA's constants are."""
    a, b, c = (torch.as_tensor(t, dtype=torch.float32).double()
               if isinstance(t, float) else t.double() for t in (a, b, c))
    return (a * b + c).float()


def _log(v: torch.Tensor) -> torch.Tensor:
    """XLA's f32 log of v > 0 (normal) on the CPU."""
    m, e = torch.frexp(v)
    e = e.float()
    low = m < 0.707106781186547524
    e = e - low.float()
    m = (m - 1.0) + torch.where(low, m, 0.0)
    x2 = m * m
    x3 = x2 * m
    P = _LOG_P
    y, y1, y2 = (_fma(m, P[i], P[i + 1]) for i in (0, 3, 6))
    y, y1, y2 = (_fma(t, m, P[i]) for t, i in ((y, 2), (y1, 5), (y2, 8)))
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _LOG_Q1 * e)
    return ((m - x2 * 0.5) + y) + _LOG_Q2 * e


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log1p`` on the CPU (each Horner step of its rational a
    fused multiply-add), bitwise on the inputs ``erfinv`` gives it."""
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for a, b in zip(_LOG1P_NUM, _LOG1P_DEN):
        num, den = _fma(num, x, a), _fma(den, x, b)
    x2 = x * x
    small = x + (-0.5 * x2 + (x * x2) * (num / den))
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       _log(1.0 + x))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` of x in (-1, 1): each Horner step one fused
    multiply-add (the product exact in float64, one rounding to f32)."""
    w = -log1p(-(x * x))
    small = w < 5.0
    # the square root correctly rounded (torch's f32 one on the CPU is not)
    w = torch.where(small, w - 2.5,
                    torch.sqrt(w.double()).float() - 3.0).double()
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


def batch_spec(cfg: ModelConfig, B: int, T: int, dtype="float32") -> dict:
    """A batch's shapes and dtypes, as meta tensors (no memory): {'tokens':
    (B, T) int32}; ``vlm`` adds 'patches' (B, patch_tokens, vit_dim);
    ``encdec`` reads T as audio frames, {'frames': (B, T, frame_dim),
    'tokens': (B, decoder_len) int32}; the float inputs in ``dtype`` (the
    reference's ``batch_spec``; :func:`make_batch` draws them in f32)."""
    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    fdt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if cfg.family == "encdec":
        return {"frames": meta((B, T, cfg.frame_dim), fdt),
                "tokens": meta((B, cfg.decoder_len), torch.int32)}
    spec = {"tokens": meta((B, T), torch.int32)}
    if cfg.family == "vlm":
        spec["patches"] = meta((B, cfg.patch_tokens, cfg.vit_dim), fdt)
    return spec


def make_batch(cfg: ModelConfig, B: int, T: int, seed: int = 0,
               step: int = 0, device="cuda") -> dict:
    """The reference's batch for this family on ``device`` for (seed,
    step): {'tokens': (B, T) int32}; for ``encdec`` T counts audio frames,
    {'frames': (B, T, frame_dim) f32, 'tokens': (B, decoder_len) int32};
    for ``vlm`` {'patches': (B, patch_tokens, vit_dim) f32, 'tokens': (B, T)
    int32}. The reference draws its inputs in the sorted order of their
    names, the i-th from the i-th of three keys: frames or patches from the
    first, tokens then from the second (so a vlm batch's tokens are not the
    dense batch's at the same seed)."""
    ks = split(fold_in(prng_key(seed), step), 3)
    if cfg.family == "encdec":
        return {"frames": normal(ks[0], (B, T, cfg.frame_dim or cfg.d_model),
                                 device),
                "tokens": structured_tokens(ks[1], B, cfg.decoder_len,
                                            cfg.vocab, device)}
    if cfg.family == "vlm":
        return {"patches": normal(ks[0], (B, cfg.patch_tokens, cfg.vit_dim),
                                  device),
                "tokens": structured_tokens(ks[1], B, T, cfg.vocab, device)}
    return {"tokens": structured_tokens(ks[0], B, T, cfg.vocab, device)}
