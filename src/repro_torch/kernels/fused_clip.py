"""fused_clip_grad: per-sample norm, clip factor and clip-weighted gradient
of a single-tap clip unit (scope='layer') in one pass, as a CUDA kernel.

    g_b = a_b^T ds_b;  sq_b = ||g_b||^2;  C_b = clip(sqrt(sq_b)) w_b;
    G = sum_b C_b g_b

Replaces the TPU kernel ``repro/kernels/fused_clip.py::fused_clip_grad``.
Source: ``csrc/fused_clip.cu``, which also says what bounds it on the H100.
The Pallas kernel keeps each sample's whole gradient in VMEM; the CUDA
kernel writes it tile by tile to a device scratch of L*d*p f32 (allocated
here, reused across samples, freed on return), so the contraction still
runs once. C stays f32, as in the Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import ghost
from repro_torch.core.clipping import get_clip_fn
from repro_torch.kernels import build

F32 = torch.float32
# the clip functions, in the order of the kernel's enum
CLIPS = ("abadi", "automatic", "normalize", "flat")


def plain(a: torch.Tensor, ds: torch.Tensor, w: torch.Tensor, clipping: str,
          R: float, gamma: float):
    """The plain version, step for step the Pallas kernel's body: one
    sample at a time (O(L d p) memory), f32 throughout. What a CPU tensor
    runs, and what the kernel is held to."""
    kw = {"gamma": gamma} if clipping == "automatic" else {}
    clip = get_clip_fn(clipping, R, **kw)
    a4, d4 = ghost._norm4(a, ds)
    L, B, _, d = a4.shape
    G = torch.zeros(L, d, d4.shape[-1], dtype=F32, device=a.device)
    sq = torch.empty(B, dtype=F32, device=a.device)
    for b in range(B):
        g = torch.einsum("ltd,ltp->ldp", a4[:, b].to(F32), d4[:, b].to(F32))
        s = torch.sum(g * g)
        c = clip(torch.sqrt(s)).to(F32) * w[b].to(F32)
        sq[b] = s
        G += c * g
    return (G if a.dim() == 4 else G[0]), sq


def fused_clip_grad(a: torch.Tensor, ds: torch.Tensor, w: torch.Tensor,
                    clipping: str, R: float, gamma: float):
    """a (L,B,T,d) or (B,T,d), ds likewise (last dim p), w (B,) per-sample
    weight -> (G (L,d,p) or (d,p) f32, sq (B,) f32). One call launches 2B
    kernels (counted once)."""
    if clipping not in CLIPS:
        raise ValueError(f"fused_clip_grad: clipping must be one of {CLIPS}, "
                         f"got {clipping!r}")
    if a.device.type == "cpu":
        return plain(a, ds, w, clipping, R, gamma)
    a4, d4 = ghost._norm4(a, ds)
    w = w.to(F32).contiguous()
    bf16 = build.check_inputs("fused_clip_grad", (a4, d4), f32=(w,))
    L, B, T, d = a4.shape
    p = d4.shape[-1]
    if tuple(d4.shape[:3]) != (L, B, T) or tuple(w.shape) != (B,):
        raise ValueError(f"fused_clip_grad: a {tuple(a.shape)}, ds "
                         f"{tuple(ds.shape)}, w {tuple(w.shape)} disagree")
    lib = build.load()
    scratch = torch.empty(L, d, p, dtype=F32, device=a.device)
    partial = torch.empty(L * lib.dp_fused_clip_nparts(d, p), dtype=F32,
                          device=a.device)
    G = torch.zeros(L, d, p, dtype=F32, device=a.device)
    sq = torch.empty(B, dtype=F32, device=a.device)
    build.check(lib.dp_fused_clip_grad(
        a4.data_ptr(), d4.data_ptr(), w.data_ptr(), scratch.data_ptr(),
        partial.data_ptr(), G.data_ptr(), sq.data_ptr(), L, B, T, d, p,
        int(bf16), CLIPS.index(clipping), float(R), float(gamma),
        build.stream_ptr(a)), "fused_clip_grad")
    fused_clip_grad.launches += 1
    return (G if a.dim() == 4 else G[0]), sq


fused_clip_grad.launches = 0
