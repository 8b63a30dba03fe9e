"""ghost_norm: per-sample squared norms of a matmul tap, as a CUDA kernel.

    n_b = sum_l sum_{t,t'} (a_lbt . a_lbt') (g_lbt . g_lbt')

Replaces the TPU kernel ``repro/kernels/ghost_norm.py::ghost_norm`` (and its
``tri_table``, whose packed lower triangle the CUDA kernel enumerates from
the linear block index). Source: ``csrc/ghost_norm.cu``, which also says what
bounds it on the H100. No (B,T,T) Gram is written to device memory; partials
are summed in a fixed order, so the result is deterministic.
"""
from __future__ import annotations

import torch

from repro_torch.core import ghost
from repro_torch.kernels import build

# the plain version: what a CPU tensor runs, and what the kernel is held to
plain = ghost.sq_norm_mm_ghost


def ghost_norm(a: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """a (L,B,T,d) or (B,T,d), ds (L,B,T,p) or (B,T,p) -> (B,) f32."""
    if a.device.type == "cpu":
        return plain(a, ds)
    a4, d4 = ghost._norm4(a, ds)
    bf16 = build.check_inputs("ghost_norm", (a4, d4))
    L, B, T, d = a4.shape
    if tuple(d4.shape[:3]) != (L, B, T):
        raise ValueError(f"ghost_norm: a {tuple(a.shape)} and ds "
                         f"{tuple(ds.shape)} disagree on (L, B, T)")
    p = d4.shape[-1]
    lib = build.load()
    partial = torch.empty(B, L * lib.dp_ghost_norm_nparts(T),
                          dtype=torch.float32, device=a.device)
    out = torch.empty(B, dtype=torch.float32, device=a.device)
    build.check(lib.dp_ghost_norm(a4.data_ptr(), d4.data_ptr(),
                                  partial.data_ptr(), out.data_ptr(),
                                  L, B, T, d, p, int(bf16),
                                  build.stream_ptr(a)), "ghost_norm")
    ghost_norm.launches += 1
    return out


ghost_norm.launches = 0
