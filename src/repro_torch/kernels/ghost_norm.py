"""ghost_norm: per-sample squared norms of a matmul tap, as a CUDA kernel.

    n_b = sum_l sum_{t,t'} (a_lbt . a_lbt') (g_lbt . g_lbt')

Replaces the TPU kernel ``repro/kernels/ghost_norm.py::ghost_norm`` (and its
``tri_table``, whose packed lower triangle the CUDA kernels enumerate from
the item index). Two kernels, chosen by :func:`route`: bf16 records whose d
and p are multiples of 8 (every mm tap of the train paths) take
``csrc/ghost_norm_wgmma.cu`` (tensor cores, TMA-fed, the wider record's
width split into chunks where the items cannot fill the card); f32 records
and unaligned widths take ``csrc/ghost_norm.cu`` (f32 SIMT cores). Each
source says what bounds it on the H100. No (B,T,T) Gram is written to
device memory; partials are summed in a fixed order, so the result is
deterministic.
"""
from __future__ import annotations

import torch

from repro_torch.core import ghost
from repro_torch.kernels import build

ROUTES = ("wgmma", "simt")

# the plain version: what a CPU tensor runs, and what the kernel is held to
plain = ghost.sq_norm_mm_ghost


def route(dtype: torch.dtype, d: int, p: int) -> str:
    """The kernel a CUDA call takes: 'wgmma' for bf16 records with d and p
    multiples of 8 (TMA's 16-byte strides), else 'simt'."""
    return ("wgmma" if dtype == torch.bfloat16 and d % 8 == 0 and p % 8 == 0
            else "simt")


def ghost_norm(a: torch.Tensor, ds: torch.Tensor,
               kernel: str | None = None) -> torch.Tensor:
    """a (L,B,T,d) or (B,T,d), ds (L,B,T,p) or (B,T,p) -> (B,) f32. One
    launch (and its fixed-order partial sum) of the kernel :func:`route`
    names (``kernel`` forces one, for comparing the two; the wgmma kernel
    raises on records it does not take)."""
    if a.device.type == "cpu":
        return plain(a, ds)
    a4, d4 = ghost._norm4(a, ds)
    bf16 = build.check_inputs("ghost_norm", (a4, d4))
    L, B, T, d = a4.shape
    if tuple(d4.shape[:3]) != (L, B, T):
        raise ValueError(f"ghost_norm: a {tuple(a.shape)} and ds "
                         f"{tuple(ds.shape)} disagree on (L, B, T)")
    p = d4.shape[-1]
    kernel = kernel or route(a4.dtype, d, p)
    if kernel not in ROUTES:
        raise ValueError(f"ghost_norm: kernel {kernel!r} not in {ROUTES}")
    lib = build.lib_for(a)
    out = torch.empty(B, dtype=torch.float32, device=a.device)
    if kernel == "wgmma":
        if route(a4.dtype, d, p) != "wgmma":
            raise ValueError(f"ghost_norm: the wgmma kernel takes bf16 "
                             f"records with d, p multiples of 8, got "
                             f"{a4.dtype}, d={d}, p={p}")
        if any(t.data_ptr() % 16 for t in (a4, d4)):
            raise ValueError("ghost_norm: TMA operands must be 16-byte "
                             "aligned")
        partial = torch.empty(B, lib.dp_ghost_norm_wgmma_nparts(L, B, T, d,
                                                                p),
                              dtype=torch.float32, device=a.device)
        build.check(lib.dp_ghost_norm_wgmma(
            a4.data_ptr(), d4.data_ptr(), partial.data_ptr(), out.data_ptr(),
            L, B, T, d, p, build.stream_ptr(a)), "ghost_norm (wgmma)")
        ghost_norm.wgmma_launches += build.counted(lib)
    else:
        partial = torch.empty(B, L * lib.dp_ghost_norm_nparts(T),
                              dtype=torch.float32, device=a.device)
        build.check(lib.dp_ghost_norm(a4.data_ptr(), d4.data_ptr(),
                                      partial.data_ptr(), out.data_ptr(),
                                      L, B, T, d, p, int(bf16),
                                      build.stream_ptr(a)), "ghost_norm")
    ghost_norm.launches += build.counted(lib)
    return out


ghost_norm.launches = 0          # every launch, either kernel
ghost_norm.wgmma_launches = 0    # launches of the wgmma kernel
