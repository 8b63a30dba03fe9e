"""emb_ghost_norm: per-sample squared norms of an embedding tap, as a CUDA
kernel.

    n_b = sum_l sum_{t,t'} 1[id_lbt == id_lbt'] (g_lbt . g_lbt')

Replaces the TPU kernel ``repro/kernels/emb_norm.py::emb_ghost_norm``.
Source: ``csrc/emb_norm.cu``, which also says what bounds it on the H100.
Only id-matching pairs are dotted; partials are summed in a fixed order.
"""
from __future__ import annotations

import torch

from repro_torch.core import ghost
from repro_torch.kernels import build

# the plain version: what a CPU tensor runs, and what the kernel is held to
plain = ghost.sq_norm_emb


def emb_ghost_norm(ids: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """ids (L,B,T) or (B,T) int32, ds (L,B,T,d) or (B,T,d) -> (B,) f32."""
    if ids.device.type == "cpu":
        return plain(ids, ds)
    if ids.dim() == 2:
        ids, ds = ids[None], ds[None]
    bf16 = build.check_inputs("emb_ghost_norm", (ds,), (ids,))
    L, B, T = ids.shape
    if ds.dim() != 4 or tuple(ds.shape[:3]) != (L, B, T):
        raise ValueError(f"emb_ghost_norm: ids {tuple(ids.shape)} and ds "
                         f"{tuple(ds.shape)} disagree")
    lib = build.load()
    partial = torch.empty(B, L * lib.dp_emb_norm_nparts(T),
                          dtype=torch.float32, device=ds.device)
    out = torch.empty(B, dtype=torch.float32, device=ds.device)
    build.check(lib.dp_emb_norm(ids.data_ptr(), ds.data_ptr(),
                                partial.data_ptr(), out.data_ptr(),
                                L, B, T, ds.shape[-1], int(bf16),
                                build.stream_ptr(ds)), "emb_ghost_norm")
    emb_ghost_norm.launches += 1
    return out


emb_ghost_norm.launches = 0
