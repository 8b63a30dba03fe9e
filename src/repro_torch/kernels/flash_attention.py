"""flash_attention: causal or bidirectional GQA attention with an online
softmax, as a CUDA kernel (the serving prefill's attention).

    o = softmax(q k^T / sqrt(h) [causal mask]) v,   q (B,T,H,h), k/v (B,S,K,h)

Replaces the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention``. Two kernels, chosen by :func:`route`; each source says
what bounds it on the H100. No (T,S) matrix reaches device memory in either,
and T and S may be any length.

- bf16 with h = 64 or 128 (qwen2-1.5b's prefill): ``csrc/
  flash_attention_wgmma.cu``, tensor cores fed by TMA. Persistent CTAs
  walk (b, head, 128-query tile) items, longest first, two warpgroups of
  64 rows taking turns on 128-key tiles. The probabilities are rounded to
  bf16 before P.V, as the JAX package's ``_attend`` rounds them to the
  model dtype.
- f32, or other h (a multiple of 8 up to 128): ``csrc/flash_attention.cu``,
  f32 SIMT cores, one CTA per (b, head, 64-query tile); the probabilities
  stay f32 up to P.V.

Both are within the bf16 tolerance of the plain version, which keeps P f32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

F32 = torch.float32
NEG_INF = -1e30
ROUTES = ("wgmma", "simt")


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


def route(dtype: torch.dtype, h: int) -> str:
    """The kernel a CUDA call takes: 'wgmma' for bf16 with h = 64 or 128
    (whole 128-byte swizzled rows), else 'simt'."""
    return "wgmma" if dtype == torch.bfloat16 and h in (64, 128) else "simt"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    kernel: str | None = None) -> torch.Tensor:
    """q (B,T,H,h), k/v (B,S,K,h) with H = K*G -> (B,T,H,h) in q's dtype.
    One launch of the kernel :func:`route` names (``kernel`` forces one,
    for comparing the two; the wgmma kernel raises on inputs it does not
    take)."""
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
    kernel = kernel or route(q.dtype, h)
    if kernel not in ROUTES:
        raise ValueError(f"flash_attention: kernel {kernel!r} not in {ROUTES}")
    out = torch.empty_like(q)
    lib = build.load()
    if kernel == "wgmma":
        if route(q.dtype, h) != "wgmma":
            raise ValueError(f"flash_attention: the wgmma kernel takes bf16 "
                             f"with h = 64 or 128, got {q.dtype}, h={h}")
        build.check(lib.dp_flash_attention_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T,
            S, H, K, h, int(causal), build.stream_ptr(q)),
            "flash_attention (wgmma)")
        flash_attention.wgmma_launches += 1
    else:
        build.check(lib.dp_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T,
            S, H, K, h, int(causal), int(bf16), build.stream_ptr(q)),
            "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0          # every launch, either kernel
flash_attention.wgmma_launches = 0    # launches of the wgmma kernel
