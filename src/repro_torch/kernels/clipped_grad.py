"""clipped_grad: the clip-weighted gradient of a matmul tap, as a CUDA
kernel (BK Algorithm 1 line 9).

    G_l = sum_b C_b a_lb^T g_lb

Replaces the TPU kernel ``repro/kernels/clipped_grad.py::clipped_grad``.
Two kernels, chosen by :func:`route`: bf16 records whose d and p are
multiples of 8 (every mm tap of the train paths) take
``csrc/clipped_grad_wgmma.cu`` (tensor cores, TMA-fed); f32 records and
unaligned widths take ``csrc/clipped_grad.cu`` (f32 SIMT cores). Each source
says what bounds it on the H100. Both apply C in f32 (no weighted copy of
ds) and write every output tile once, with no atomics.
"""
from __future__ import annotations

import torch

from repro_torch.core import ghost
from repro_torch.kernels import build

ROUTES = ("wgmma", "simt")


def plain(a: torch.Tensor, C: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """The plain version (f32 output, like the kernel): what a CPU tensor
    runs, and what the kernel is held to."""
    return ghost.weighted_grad_mm(a, C, ds, torch.float32)


def route(dtype: torch.dtype, d: int, p: int) -> str:
    """The kernel a CUDA call takes: 'wgmma' for bf16 records with d and p
    multiples of 8 (TMA's 16-byte strides; wgmma's transposed operands exist
    for 16-bit types only), else 'simt'."""
    return ("wgmma" if dtype == torch.bfloat16 and d % 8 == 0 and p % 8 == 0
            else "simt")


def clipped_grad(a: torch.Tensor, C: torch.Tensor, ds: torch.Tensor,
                 kernel: str | None = None) -> torch.Tensor:
    """a (L,B,T,d) or (B,T,d), C (B,) f32, ds likewise -> (L,d,p) or (d,p)
    f32. One launch either way, of the kernel :func:`route` names
    (``kernel`` forces one, for comparing the two; the wgmma kernel raises
    on records it does not take)."""
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
    kernel = kernel or route(a4.dtype, d, p)
    if kernel not in ROUTES:
        raise ValueError(f"clipped_grad: kernel {kernel!r} not in {ROUTES}")
    out = torch.empty(L, d, p, dtype=torch.float32, device=a.device)
    lib = build.load()
    if kernel == "wgmma":
        if route(a4.dtype, d, p) != "wgmma":
            raise ValueError(f"clipped_grad: the wgmma kernel takes bf16 "
                             f"records with d, p multiples of 8, got "
                             f"{a4.dtype}, d={d}, p={p}")
        if any(t.data_ptr() % 16 for t in (a4, d4)):
            raise ValueError("clipped_grad: TMA operands must be 16-byte "
                             "aligned")
        build.check(lib.dp_clipped_grad_wgmma(
            a4.data_ptr(), C.data_ptr(), d4.data_ptr(), out.data_ptr(),
            L, B, T, d, p, build.stream_ptr(a)), "clipped_grad (wgmma)")
        clipped_grad.wgmma_launches += 1
    else:
        build.check(lib.dp_clipped_grad(
            a4.data_ptr(), C.data_ptr(), d4.data_ptr(), out.data_ptr(),
            L, B, T, d, p, int(bf16), build.stream_ptr(a)), "clipped_grad")
    clipped_grad.launches += 1
    return out if a.dim() == 4 else out[0]


clipped_grad.launches = 0          # every launch, either kernel
clipped_grad.wgmma_launches = 0    # launches of the wgmma kernel
