"""grad_norm_direct: per-sample squared norms of a matmul tap by
instantiation, as CUDA kernels.

    n_b = sum_l || a_lb^T g_lb ||_F^2

Replaces the TPU kernel ``repro/kernels/grad_norm_direct.py::
grad_norm_direct``. Two kernels, chosen by :func:`route` (the rule of
``moe_ghost.route``); each source says what bounds it on the H100:
``csrc/grad_norm_direct_wgmma.cu`` (tensor cores, TMA-fed: the direct-norm
loop of ``csrc/wgmma_grad.cuh`` that ``moe_direct_norm`` runs, unmasked) for
bf16 records, and ``csrc/grad_norm_direct.cu`` (f32 SIMT cores) for f32
records and unaligned widths. The per-sample gradient is formed one (d,p)
tile at a time in registers, so no (B,d,p) buffer exists; partials are
summed in a fixed order, so the result is deterministic.
"""
from __future__ import annotations

import torch

from repro_torch.core import ghost
from repro_torch.kernels import build
from repro_torch.kernels.moe_ghost import ROUTES, route

# the plain version: what a CPU tensor runs, and what the kernels are held to
plain = ghost.sq_norm_mm_direct


def grad_norm_direct(a: torch.Tensor, ds: torch.Tensor,
                     kernel: str | None = None) -> torch.Tensor:
    """a (L,B,T,d) or (B,T,d), ds (L,B,T,p) or (B,T,p) -> (B,) f32. One
    launch of the kernel :func:`route` names; ``kernel`` forces one."""
    if a.device.type == "cpu":
        return plain(a, ds)
    a4, d4 = ghost._norm4(a, ds)
    bf16 = build.check_inputs("grad_norm_direct", (a4, d4))
    L, B, T, d = a4.shape
    if tuple(d4.shape[:3]) != (L, B, T):
        raise ValueError(f"grad_norm_direct: a {tuple(a.shape)} and ds "
                         f"{tuple(ds.shape)} disagree on (L, B, T)")
    p = d4.shape[-1]
    aligned = a4.data_ptr() % 16 == 0 and d4.data_ptr() % 16 == 0
    want = route(a4.dtype, d, p, aligned)
    kernel = kernel or want
    if kernel not in ROUTES:
        raise ValueError(f"grad_norm_direct: kernel {kernel!r} not in "
                         f"{ROUTES}")
    if kernel == "wgmma" and want != "wgmma":
        raise ValueError(f"grad_norm_direct: the wgmma kernel takes bf16 "
                         f"records with d, p multiples of 8 and 16-byte "
                         f"aligned bases, got {a4.dtype}, d={d}, p={p}, "
                         f"aligned={aligned}")
    lib = build.load()
    out = torch.empty(B, dtype=torch.float32, device=a.device)
    if kernel == "wgmma":
        partial = torch.empty(B, L * lib.dp_grad_norm_direct_wgmma_nparts(d),
                              dtype=torch.float32, device=a.device)
        build.check(lib.dp_grad_norm_direct_wgmma(
            a4.data_ptr(), d4.data_ptr(), partial.data_ptr(), out.data_ptr(),
            L, B, T, d, p, build.stream_ptr(a)), "grad_norm_direct (wgmma)")
        grad_norm_direct.wgmma_launches += 1
    else:
        partial = torch.empty(B, L * lib.dp_grad_norm_direct_nparts(d, p),
                              dtype=torch.float32, device=a.device)
        build.check(lib.dp_grad_norm_direct(
            a4.data_ptr(), d4.data_ptr(), partial.data_ptr(), out.data_ptr(),
            L, B, T, d, p, int(bf16), build.stream_ptr(a)),
            "grad_norm_direct")
    grad_norm_direct.launches += 1
    return out


grad_norm_direct.launches = 0         # every launch, either kernel
grad_norm_direct.wgmma_launches = 0   # launches of the wgmma kernel
