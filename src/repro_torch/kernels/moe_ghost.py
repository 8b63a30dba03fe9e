"""The MoE expert-tap kernels over the per-(sample, expert) capacity layout
of ``models.moe``, as CUDA kernels:

    a (L,B,E,C,d)  mask (L,B,E,C) f32  ds (L,B,E,C,p)     (or without L)

  moe_ghost_norm    n_b  = sum_{l,e} < am am^T , dm dm^T >_F
  moe_direct_norm   n_b  = sum_{l,e} || a_e^T dm_e ||_F^2
  moe_clipped_grad  G_le = sum_b C_b a_be^T dm_be          -> (L,E,d,p) f32

with am, dm the records with the slot mask applied to each row. They replace
the TPU kernels of ``repro/kernels/moe_ghost.py`` of the same names. Sources:
``csrc/moe_{ghost_norm,direct_norm,clipped_grad}.cu`` (f32 SIMT cores), and
on the tensor cores (TMA-fed) ``csrc/moe_ghost_norm_wgmma.cu`` (both C x C
Grams of a (sample, expert) by m64n64k16, the mask weighting the finished
Gram's entries, :func:`ghost_model`) and
``csrc/moe_{direct_norm,clipped_grad}_wgmma.cu`` (the loop of
``csrc/wgmma_grad.cuh``, and a pre-pass that flags each block of 64 slots,
``csrc/slot_flags.cuh``), chosen by :func:`route`; each source says what
bounds it on the H100. The mask is applied on the way to the products or
to their sums (in registers, or on the a tile in shared memory where the
records are not zero at empty slots already), so no masked copy, no
(B,E,C,C) Gram and no (B,E,d,p) per-sample grad exists in device memory;
reductions run in a fixed order (deterministic).
"""
from __future__ import annotations

import torch

from repro_torch.core import ghost
from repro_torch.kernels import build

F32 = torch.float32
ROUTES = ("wgmma", "simt")


def route(dtype: torch.dtype, d: int, p: int, aligned: bool = True) -> str:
    """The kernel a CUDA call of any of the three takes: 'wgmma' for bf16
    records with d and p multiples of 8 and 16-byte
    aligned bases (TMA's strides and addresses; wgmma's transposed operands
    exist for 16-bit types only), else 'simt'."""
    return ("wgmma" if dtype == torch.bfloat16 and d % 8 == 0 and p % 8 == 0
            and aligned else "simt")


def _slot_flags(a5) -> torch.Tensor:
    """Scratch of the wgmma kernels' pre-pass: 16 bytes per 64-slot block
    of each (l, b, e)'s capacity slots."""
    L, B, E, Cap, _ = a5.shape
    return torch.empty(L * B * E * -(-Cap // 64) * 4, dtype=torch.int32,
                       device=a5.device)


def _route(name, kernel, a5, d5, d, p):
    """-> the route a call takes: ``kernel`` if given (raising where the
    wgmma kernel does not take the records), else :func:`route`'s."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (a5, d5))
    want = route(a5.dtype, d, p, aligned)
    kernel = kernel or want
    if kernel not in ROUTES:
        raise ValueError(f"{name}: kernel {kernel!r} not in {ROUTES}")
    if kernel == "wgmma" and want != "wgmma":
        raise ValueError(f"{name}: the wgmma kernel takes bf16 records with "
                         f"d, p multiples of 8 and 16-byte aligned bases, "
                         f"got {a5.dtype}, d={d}, p={p}, aligned={aligned}")
    return kernel


def _operands(name, a, mask, ds, C=None):
    """-> (a5, mask5, ds5, C, bf16, (L, B, E, Cap, d, p)), validated."""
    a5, m5, d5 = ghost._moe5(a, mask, ds)
    m5 = m5.to(F32).contiguous()
    f32 = (m5,) if C is None else (m5, C.to(F32).contiguous())
    bf16 = build.check_inputs(name, (a5, d5), f32=f32)
    L, B, E, Cap, d = a5.shape
    p = d5.shape[-1]
    if tuple(d5.shape[:4]) != (L, B, E, Cap) or \
            tuple(m5.shape) != (L, B, E, Cap) or \
            (C is not None and tuple(C.shape) != (B,)):
        raise ValueError(f"{name}: a {tuple(a.shape)}, mask "
                         f"{tuple(mask.shape)}, ds {tuple(ds.shape)} "
                         "disagree")
    return a5, m5, d5, f32[-1], bf16, (L, B, E, Cap, d, p)


# ------------------------------------------------------------- ghost norm
def moe_ghost_norm(a: torch.Tensor, mask: torch.Tensor, ds: torch.Tensor,
                   kernel: str | None = None) -> torch.Tensor:
    """-> (B,) f32. One launch (and its fixed-order partial sum) of the
    kernel :func:`route` names; ``kernel`` forces one."""
    if a.device.type == "cpu":
        return ghost.sq_norm_moe_ghost(a, mask, ds)
    a5, m5, d5, _, bf16, (L, B, E, Cap, d, p) = _operands(
        "moe_ghost_norm", a, mask, ds)
    kernel = _route("moe_ghost_norm", kernel, a5, d5, d, p)
    lib = build.load()
    out = torch.empty(B, dtype=F32, device=a.device)
    args = (a5.data_ptr(), m5.data_ptr(), d5.data_ptr())
    if kernel == "wgmma":
        partial = torch.empty(
            B, L * E * lib.dp_moe_ghost_norm_wgmma_nparts(Cap), dtype=F32,
            device=a.device)
        build.check(lib.dp_moe_ghost_norm_wgmma(
            *args, partial.data_ptr(), out.data_ptr(), L, B, E, Cap, d, p,
            build.stream_ptr(a)), "moe_ghost_norm (wgmma)")
        moe_ghost_norm.wgmma_launches += 1
    else:
        partial = torch.empty(B, L * E, dtype=F32, device=a.device)
        build.check(lib.dp_moe_ghost_norm(
            *args, partial.data_ptr(), out.data_ptr(), L, B, E, Cap, d, p,
            int(bf16), build.stream_ptr(a)), "moe_ghost_norm")
    moe_ghost_norm.launches += 1
    return out


def ghost_model(a, mask, ds) -> torch.Tensor:
    """The wgmma kernel's form of the ghost norm
    (``csrc/moe_ghost_norm_wgmma.cu``) in plain torch, in float64 (nothing
    but the tests runs it): per (l, b, e) and pair i >= j of 64-slot tiles
    (zero rows past C), the two unmasked Grams' tiles A_i A_j^T and
    G_i G_j^T, the first weighted entry by entry by (m_r m_c)^2 (the mask
    on the accumulators, not on the operands), their products summed, an
    off-diagonal pair twice. a (L,B,E,C,d) or (B,E,C,d), mask (..,C), ds
    (..,C,p) -> (B,)."""
    a5, m5, d5 = (x.double() for x in ghost._moe5(a, mask, ds))
    C, tile = a5.shape[3], 64
    nt = -(-C // tile)

    def tiles(x):       # (L,B,E,nt,tile,..), slots past C zero
        pad = nt * tile - C
        x = torch.cat([x, x.new_zeros(*x.shape[:3], pad, *x.shape[4:])], 3)
        return x.reshape(*x.shape[:3], nt, tile, *x.shape[4:])

    at, gt, mt = tiles(a5), tiles(d5), tiles(m5)
    out = torch.zeros(a5.shape[1], dtype=torch.float64, device=a5.device)
    for i in range(nt):
        for j in range(i + 1):
            ga = torch.einsum("lbexd,lbeyd->lbexy", at[..., i, :, :],
                              at[..., j, :, :])
            gg = torch.einsum("lbexp,lbeyp->lbexy", gt[..., i, :, :],
                              gt[..., j, :, :])
            w = (mt[..., i, :, None] * mt[..., j, None, :]) ** 2
            out += (1.0 if i == j else 2.0) * (w * ga * gg).sum((0, 2, 3, 4))
    return out


# ------------------------------------------------------------ direct norm
def moe_direct_norm(a: torch.Tensor, mask: torch.Tensor, ds: torch.Tensor,
                    kernel: str | None = None) -> torch.Tensor:
    """-> (B,) f32. One launch (and its fixed-order partial sum) of the
    kernel :func:`route` names; ``kernel`` forces one."""
    if a.device.type == "cpu":
        return ghost.sq_norm_moe_direct(a, mask, ds)
    a5, m5, d5, _, bf16, (L, B, E, Cap, d, p) = _operands(
        "moe_direct_norm", a, mask, ds)
    kernel = _route("moe_direct_norm", kernel, a5, d5, d, p)
    lib = build.load()
    out = torch.empty(B, dtype=F32, device=a.device)
    args = (a5.data_ptr(), m5.data_ptr(), d5.data_ptr())
    if kernel == "wgmma":
        partial = torch.empty(
            B, L * E * lib.dp_moe_direct_norm_wgmma_nparts(d), dtype=F32,
            device=a.device)
        flags = _slot_flags(a5)
        build.check(lib.dp_moe_direct_norm_wgmma(
            *args, flags.data_ptr(), partial.data_ptr(), out.data_ptr(), L,
            B, E, Cap, d, p, build.stream_ptr(a)), "moe_direct_norm (wgmma)")
        moe_direct_norm.wgmma_launches += 1
    else:
        partial = torch.empty(B, L * lib.dp_moe_direct_norm_nparts(d, p),
                              dtype=F32, device=a.device)
        build.check(lib.dp_moe_direct_norm(
            *args, partial.data_ptr(), out.data_ptr(), L, B, E, Cap, d, p,
            int(bf16), build.stream_ptr(a)), "moe_direct_norm")
    moe_direct_norm.launches += 1
    return out


# ----------------------------------------------------------- clipped grad
def plain_clipped_grad(a, mask, C, ds):
    """The plain version (f32 output, like the kernel)."""
    return ghost.weighted_grad_moe(a, mask, C, ds, F32)


def moe_clipped_grad(a: torch.Tensor, mask: torch.Tensor, C: torch.Tensor,
                     ds: torch.Tensor, kernel: str | None = None
                     ) -> torch.Tensor:
    """C (B,) -> (L,E,d,p) f32, or (E,d,p) for unstacked records. One launch
    of the kernel :func:`route` names; ``kernel`` forces one."""
    if a.device.type == "cpu":
        return plain_clipped_grad(a, mask, C, ds)
    a5, m5, d5, C, bf16, (L, B, E, Cap, d, p) = _operands(
        "moe_clipped_grad", a, mask, ds, C)
    kernel = _route("moe_clipped_grad", kernel, a5, d5, d, p)
    out = torch.empty(L, E, d, p, dtype=F32, device=a.device)
    args = (a5.data_ptr(), m5.data_ptr(), C.data_ptr(), d5.data_ptr())
    dims = (out.data_ptr(), L, B, E, Cap, d, p)
    lib = build.load()
    if kernel == "wgmma":
        flags = _slot_flags(a5)
        build.check(lib.dp_moe_clipped_grad_wgmma(
            *args, flags.data_ptr(), *dims, build.stream_ptr(a)),
            "moe_clipped_grad (wgmma)")
        moe_clipped_grad.wgmma_launches += 1
    else:
        build.check(lib.dp_moe_clipped_grad(
            *args, *dims, int(bf16), build.stream_ptr(a)), "moe_clipped_grad")
    moe_clipped_grad.launches += 1
    return out if a.dim() == 5 else out[0]


moe_ghost_norm.launches = 0        # every launch, either kernel
moe_ghost_norm.wgmma_launches = 0    # launches of the wgmma kernel
moe_direct_norm.launches = 0       # every launch, either kernel
moe_direct_norm.wgmma_launches = 0   # launches of the wgmma kernel
moe_clipped_grad.launches = 0
moe_clipped_grad.wgmma_launches = 0
