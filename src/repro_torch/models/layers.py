"""Tap-aware layer library (plain PyTorch, no nn.Module state).

Params are nested dicts of tensors. Generalized-linear ops (linear /
embedding) route through the Tape; every other parameter (bias, norm scale)
may arrive with a leading per-sample batch axis when the DP engine is
differentiating it — layers align such params with ``align``.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


# ---------------------------------------------------------------------- init
def normal_init(gen: torch.Generator, shape, dtype, stddev: float):
    return (torch.randn(tuple(shape), generator=gen, device=gen.device,
                        dtype=F32) * stddev).to(dtype)


def zeros_init(gen: torch.Generator, shape, dtype):
    return torch.zeros(tuple(shape), dtype=dtype, device=gen.device)


def ones_init(gen: torch.Generator, shape, dtype):
    return torch.ones(tuple(shape), dtype=dtype, device=gen.device)


# ------------------------------------------------------------ psp alignment
def align(p: torch.Tensor, x: torch.Tensor, feature_ndim: int = 1) -> torch.Tensor:
    """Align a vector param to x for broadcasting.

    p is either its declared shape (feature_ndim trailing dims) or that shape
    with a leading per-sample batch axis (DP psp route). x has batch first.
    """
    if p.dim() == feature_ndim:
        return p
    ones = (1,) * (x.dim() - 1 - feature_ndim)
    return p.reshape(p.shape[0], *ones, *p.shape[1:])


# -------------------------------------------------------------------- linear
def linear_init(gen, d_in, d_out, dtype, bias=False, scale=None, layers=()):
    """``layers`` = (L,) prepends a stacked layer axis."""
    p = {"w": normal_init(gen, (*layers, d_in, d_out), dtype,
                          scale if scale is not None else 1.0 / math.sqrt(d_in))}
    if bias:
        p["b"] = zeros_init(gen, (*layers, d_out), dtype)
    return p


def linear(tape, name, p, x):
    """x (B, ..., T, d) @ w (d, p) [+ b]. Tap + record on the matmul output."""
    s = torch.matmul(x, p["w"])
    s = tape.record(name, "mm", s, x)
    if "b" in p:
        s = s + align(p["b"], s)
    return s


# ----------------------------------------------------------------- embedding
def embedding_init(gen, vocab, d, dtype):
    return {"w": normal_init(gen, (vocab, d), dtype, 1.0)}


def embedding(tape, name, p, ids):
    """ids (B, T) int32 -> (B, T, d); the ghost-norm record is the ids."""
    s = torch.nn.functional.embedding(ids, p["w"])
    return tape.record(name, "emb", s, ids)


# --------------------------------------------------------------------- norms
def rmsnorm_init(gen, d, dtype, layers=()):
    return {"g": ones_init(gen, (*layers, d), dtype)}


def rmsnorm(p, x, eps: float = 1e-6):
    x32 = x.to(F32)
    nrm = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (nrm * align(p["g"], x).to(F32)).to(x.dtype)


def layernorm_init(gen, d, dtype, layers=()):
    return {"g": ones_init(gen, (*layers, d), dtype),
            "b": zeros_init(gen, (*layers, d), dtype)}


def layernorm(p, x, eps: float = 1e-5):
    x32 = x.to(F32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    nrm = (x32 - mu) * torch.rsqrt(var + eps)
    return (nrm * align(p["g"], x).to(F32)
            + align(p["b"], x).to(F32)).to(x.dtype)


# ---------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, max_T: int, theta: float, device):
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=F32,
                                        device=device) / head_dim))
    t = torch.arange(max_T, dtype=F32, device=device)
    freqs = torch.outer(t, inv)  # (T, hd/2)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x, cos, sin, positions=None):
    """x (B, T, H, hd); cos/sin (maxT, hd/2); positions (B, T) optional."""
    if positions is not None:
        cos, sin = cos[positions][:, :, None, :], sin[positions][:, :, None, :]
    else:
        T = x.shape[1]
        cos, sin = cos[None, :T, None, :], sin[None, :T, None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- loss heads
def lm_per_sample_loss(logits, labels, mask=None):
    """Mean token cross-entropy per sample. logits (B,T,V), labels (B,T)."""
    logits = logits.to(F32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold  # (B,T)
    if mask is None:
        return nll.mean(-1)
    mask = mask.to(F32)
    return (nll * mask).sum(-1) / torch.clamp(mask.sum(-1), min=1.0)
