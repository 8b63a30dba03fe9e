"""grad_norm_direct: per-sample squared norms of a matmul tap by
instantiation, as a CUDA kernel.

    n_b = sum_l || a_lb^T g_lb ||_F^2

Replaces the TPU kernel ``repro/kernels/grad_norm_direct.py::
grad_norm_direct``. Source: ``csrc/grad_norm_direct.cu``, which also says
what bounds it on the H100. The per-sample gradient is formed one (d,p)
tile at a time in registers, so no (B,d,p) buffer exists; partials are
summed in a fixed order, so the result is deterministic.
"""
from __future__ import annotations

import torch

from repro_torch.core import ghost
from repro_torch.kernels import build

# the plain version: what a CPU tensor runs, and what the kernel is held to
plain = ghost.sq_norm_mm_direct


def grad_norm_direct(a: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """a (L,B,T,d) or (B,T,d), ds (L,B,T,p) or (B,T,p) -> (B,) f32."""
    if a.device.type == "cpu":
        return plain(a, ds)
    a4, d4 = ghost._norm4(a, ds)
    bf16 = build.check_inputs("grad_norm_direct", (a4, d4))
    L, B, T, d = a4.shape
    if tuple(d4.shape[:3]) != (L, B, T):
        raise ValueError(f"grad_norm_direct: a {tuple(a.shape)} and ds "
                         f"{tuple(ds.shape)} disagree on (L, B, T)")
    p = d4.shape[-1]
    lib = build.load()
    partial = torch.empty(B, L * lib.dp_grad_norm_direct_nparts(d, p),
                          dtype=torch.float32, device=a.device)
    out = torch.empty(B, dtype=torch.float32, device=a.device)
    build.check(lib.dp_grad_norm_direct(a4.data_ptr(), d4.data_ptr(),
                                        partial.data_ptr(), out.data_ptr(),
                                        L, B, T, d, p, int(bf16),
                                        build.stream_ptr(a)),
                "grad_norm_direct")
    grad_norm_direct.launches += 1
    return out


grad_norm_direct.launches = 0
