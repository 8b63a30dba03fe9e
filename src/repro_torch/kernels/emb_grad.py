"""emb_clipped_grad: the clip-weighted gradient of an embedding tap, as a
CUDA kernel.

    G_l[v] = sum_b C_b sum_t 1[id_lbt == v] g_lbt

Replaces the TPU kernel ``repro/kernels/emb_grad.py::emb_clipped_grad``
without its one-hot matmul over vocab tiles. Source: ``csrc/emb_grad.cu``,
which also says what bounds it on the H100. Every output row is written
once, in (b, t) order, with no atomics; ids outside [0, vocab) are dropped.
"""
from __future__ import annotations

import torch

from repro_torch.core import ghost
from repro_torch.kernels import build

# a CTA stages one layer's B*T ids in shared memory (227 KB a block)
MAX_SMEM_BYTES = 227 * 1024


def plain(ids: torch.Tensor, C: torch.Tensor, ds: torch.Tensor,
          vocab: int) -> torch.Tensor:
    """The plain version (f32 output, like the kernel): what a CPU tensor
    runs, and what the kernel is held to."""
    return ghost.weighted_grad_emb(ids, C, ds, vocab, torch.float32)


def emb_clipped_grad(ids: torch.Tensor, C: torch.Tensor, ds: torch.Tensor,
                     vocab: int) -> torch.Tensor:
    """ids (L,B,T) or (B,T) int32, C (B,) f32, ds (L,B,T,d) or (B,T,d)
    -> (L,vocab,d) or (vocab,d) f32."""
    if ids.device.type == "cpu":
        return plain(ids, C, ds, vocab)
    stacked = ids.dim() == 3
    if not stacked:
        ids, ds = ids[None], ds[None]
    C = C.to(torch.float32).contiguous()
    bf16 = build.check_inputs("emb_clipped_grad", (ds,), (ids,), (C,))
    L, B, T = ids.shape
    d = ds.shape[-1]
    if ds.dim() != 4 or tuple(ds.shape[:3]) != (L, B, T) or \
            tuple(C.shape) != (B,):
        raise ValueError(f"emb_clipped_grad: ids {tuple(ids.shape)}, C "
                         f"{tuple(C.shape)}, ds {tuple(ds.shape)} disagree")
    lib = build.load()
    if lib.dp_emb_grad_smem_bytes(B, T) > MAX_SMEM_BYTES:
        raise ValueError(f"emb_clipped_grad: B*T={B * T} ids do not fit one "
                         "block's shared memory; use a smaller microbatch")
    out = torch.empty(L, vocab, d, dtype=torch.float32, device=ds.device)
    build.check(lib.dp_emb_grad(ids.data_ptr(), C.data_ptr(), ds.data_ptr(),
                                out.data_ptr(), L, B, T, d, vocab, int(bf16),
                                build.stream_ptr(ds)), "emb_clipped_grad")
    emb_clipped_grad.launches += 1
    return out if stacked else out[0]


emb_clipped_grad.launches = 0
