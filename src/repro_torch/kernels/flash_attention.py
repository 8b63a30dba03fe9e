"""flash_attention: causal or bidirectional GQA attention with an online
softmax, as a CUDA kernel (the serving prefill's attention).

    o = softmax(q k^T / sqrt(h) [causal mask]) v,   q (B,T,H,h), k/v (B,S,K,h)

Replaces the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention``. Source: ``csrc/flash_attention.cu``, which also says what
bounds it on the H100. One CTA per (b, head, 64-query tile) loops over key
tiles with (m, l, acc) in registers; no (T,S) matrix reaches device memory.
T and S may be any length; h is a multiple of 8, at most 128. The
probabilities stay f32 up to P.V (the JAX package's ``_attend`` rounds them
to the model dtype first; both are within the bf16 tolerance).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

F32 = torch.float32
NEG_INF = -1e30


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          causal: bool = True) -> torch.Tensor:
    """The plain version (``repro.kernels.ref.flash_attention_ref``): f32
    softmax over the whole row, output in q's dtype. What a CPU tensor runs,
    and what the kernel is held to."""
    B, T, H, h = q.shape
    S, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, T, K, H // K, h).to(F32)
    logits = torch.einsum("btkgh,bskh->bkgts", qg, k.to(F32)) / (h ** 0.5)
    if causal:
        mask = (torch.arange(T, device=q.device)[:, None]
                >= torch.arange(S, device=q.device)[None, :])
        logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskh->btkgh", p, v.to(F32))
    return out.reshape(B, T, H, h).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (B,T,H,h), k/v (B,S,K,h) with H = K*G -> (B,T,H,h) in q's dtype."""
    if q.device.type == "cpu":
        return plain(q, k, v, causal)
    bf16 = build.check_inputs("flash_attention", (q, k, v))
    B, T, H, h = q.shape
    S, K = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, S, K, h) or tuple(v.shape) != (B, S, K, h):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if H % K or h % 8 or h > 128:
        raise ValueError(f"flash_attention: needs H a multiple of K and h a "
                         f"multiple of 8 up to 128, got H={H} K={K} h={h}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: operands must be 16-byte aligned")
    out = torch.empty_like(q)
    lib = build.load()
    build.check(lib.dp_flash_attention(q.data_ptr(), k.data_ptr(),
                                       v.data_ptr(), out.data_ptr(), B, T, S,
                                       H, K, h, int(causal), int(bf16),
                                       build.stream_ptr(q)),
                "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
