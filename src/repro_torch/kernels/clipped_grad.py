"""clipped_grad: the clip-weighted gradient of a matmul tap, as a CUDA
kernel (BK Algorithm 1 line 9).

    G_l = sum_b C_b a_lb^T g_lb

Replaces the TPU kernel ``repro/kernels/clipped_grad.py::clipped_grad``.
Source: ``csrc/clipped_grad.cu``, which also says what bounds it on the H100.
C is applied in registers (no weighted copy of ds) and every output tile is
written once, with no atomics.
"""
from __future__ import annotations

import torch

from repro_torch.core import ghost
from repro_torch.kernels import build


def plain(a: torch.Tensor, C: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """The plain version (f32 output, like the kernel): what a CPU tensor
    runs, and what the kernel is held to."""
    return ghost.weighted_grad_mm(a, C, ds, torch.float32)


def clipped_grad(a: torch.Tensor, C: torch.Tensor,
                 ds: torch.Tensor) -> torch.Tensor:
    """a (L,B,T,d) or (B,T,d), C (B,) f32, ds likewise -> (L,d,p) or (d,p)
    f32. One launch either way."""
    if a.device.type == "cpu":
        return plain(a, C, ds)
    a4, d4 = ghost._norm4(a, ds)
    C = C.to(torch.float32).contiguous()
    bf16 = build.check_inputs("clipped_grad", (a4, d4), f32=(C,))
    L, B, T, d = a4.shape
    p = d4.shape[-1]
    if tuple(d4.shape[:3]) != (L, B, T) or tuple(C.shape) != (B,):
        raise ValueError(f"clipped_grad: a {tuple(a.shape)}, C "
                         f"{tuple(C.shape)}, ds {tuple(ds.shape)} disagree")
    out = torch.empty(L, d, p, dtype=torch.float32, device=a.device)
    build.check(build.load().dp_clipped_grad(
        a4.data_ptr(), C.data_ptr(), d4.data_ptr(), out.data_ptr(),
        L, B, T, d, p, int(bf16), build.stream_ptr(a)), "clipped_grad")
    clipped_grad.launches += 1
    return out if a.dim() == 4 else out[0]


clipped_grad.launches = 0
