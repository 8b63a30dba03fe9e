"""Attention math (param-free; projections live in the blocks).

GQA, the causal mask and q-chunking, in plain PyTorch ops, and one-step
decode against a KV cache. The
softmax statistics are float32 and masked with NEG_INF = -1e30 (not -inf),
as the JAX package's ``_attend`` has them; the normalized probabilities are
cast back to the model dtype before the PV product.
"""
from __future__ import annotations

import torch

F32 = torch.float32
NEG_INF = -1e30


def _mask(q_pos, k_pos):
    """Causal: q_pos (Tq,), k_pos (Tk,) -> bool (Tq, Tk)."""
    return q_pos[:, None] >= k_pos[None, :]


def _attend(q, k, v, mask):
    """q (B,Tq,K,G,h), k/v (B,Tk,K,h), mask (Tq,Tk) -> (B,Tq,K,G,h).

    bf16 operands are widened to f32 before each product: exact, and the
    same arithmetic as the JAX package's bf16 products accumulated in f32."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("btkgh,bskh->bkgts", q.to(F32), k.to(F32)) * scale
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", probs.to(F32), v.to(F32))
    return out.to(v.dtype)


def multihead_attention(q, k, v, *, chunk=0):
    """Causal attention. q (B,Tq,H,h), k/v (B,Tk,K,h) with H = K*G (GQA)
    -> (B,Tq,H,h). ``chunk`` > 0 runs the queries in chunks of that size."""
    B, T, H, h = q.shape
    Tk, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, T, K, G, h)
    q_pos = torch.arange(T, device=q.device)
    k_pos = torch.arange(Tk, device=q.device)

    if chunk and T % chunk == 0 and T > chunk:
        outs = [_attend(qg[:, c:c + chunk], k, v,
                        _mask(q_pos[c:c + chunk], k_pos))
                for c in range(0, T, chunk)]
        return torch.cat(outs, dim=1).reshape(B, T, H, h)

    return _attend(qg, k, v, _mask(q_pos, k_pos)).reshape(B, T, H, h)


def decode_attention(q, k_cache, v_cache, pos: int):
    """One-step decode. q (B,1,H,h); caches (B,S,K,h); ``pos`` the index of
    the current token (cache[pos] holds its k/v) -> (B,1,H,h)."""
    B, _, H, h = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    valid = torch.arange(S, device=q.device)[None, :] <= pos     # (1, S)
    return _attend(q.reshape(B, 1, K, H // K, h), k_cache, v_cache,
                   valid).reshape(B, 1, H, h)


def update_cache(cache_k, cache_v, k_new, v_new, pos: int):
    """Write k/v (B,1,K,h) at index ``pos`` of the caches (B,S,K,h), in
    place (the JAX package's functional update gives the same values).
    -> the caches."""
    cache_k[:, pos:pos + 1] = k_new.to(cache_k.dtype)
    cache_v[:, pos:pos + 1] = v_new.to(cache_v.dtype)
    return cache_k, cache_v
