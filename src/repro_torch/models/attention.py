"""Attention math (param-free; projections live in the blocks).

GQA, the causal mask and q-chunking, in plain PyTorch ops. The
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
