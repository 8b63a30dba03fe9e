"""Ghost-norm / direct-norm / weighted-gradient math (plain PyTorch).

The paper's modules on book-kept tensors:

  module 3  (ghost norm):      ||g_i||_F^2 = < a_i a_i^T , ds_i ds_i^T >_F
  module 4  (direct norm):     instantiate g_i = a_i^T ds_i, take ||.||_F^2
  module 2b' (weighted grad):  G = a^T diag(C) ds

Layouts (see core.tape):
  mm   a (B,T,d)  ds (B,T,p)      stacked: (L,B,T,d) / (L,B,T,p)
  emb  ids (B,T)  ds (B,T,d)      stacked: (L,B,T)   / (L,B,T,d)
  moe  a (B,E,C,d)  mask (B,E,C)  ds (B,E,C,p)   stacked: leading L axis

All accumulation is float32: low-precision records are widened to f32 before
each contraction, which is exact and matches the JAX package's
``preferred_element_type=float32``. These functions are the engine's path
when ``use_kernels`` is off, and the plain versions the CUDA kernels in
``repro_torch.kernels`` are held against.
"""
from __future__ import annotations

import torch

F32 = torch.float32

# Above this many elements for the would-be intermediate (Grams / per-sample
# grads) the norm is computed one (layer, sample) at a time, so only ONE
# intermediate is live (the JAX package's lax.map rule).
MAP_THRESHOLD = 1 << 24


def _norm4(a: torch.Tensor, ds: torch.Tensor):
    """Canonicalize mm records to (G, B, T, d) with G = stacked layers."""
    if a.dim() == 3:
        return a[None], ds[None]
    if a.dim() == 4:
        return a, ds
    raise ValueError(f"mm record must be 3D or 4D, got {tuple(a.shape)}")


# =============================================================== matmul (mm)
def sq_norm_mm_ghost(a: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """Ghost norm for s = a W. Returns per-sample squared norms (B,) f32."""
    a, ds = _norm4(a, ds)
    G, B, T, _ = a.shape
    if G * B * T * T <= MAP_THRESHOLD:
        a32, d32 = a.to(F32), ds.to(F32)
        ga = torch.einsum("gbtd,gbsd->gbts", a32, a32)
        gg = torch.einsum("gbtp,gbsp->gbts", d32, d32)
        return torch.einsum("gbts,gbts->b", ga, gg)
    out = torch.zeros(G, B, dtype=F32, device=a.device)
    for g in range(G):
        for b in range(B):
            ab, db = a[g, b].to(F32), ds[g, b].to(F32)
            out[g, b] = torch.sum((ab @ ab.T) * (db @ db.T))
    return out.sum(0)


def sq_norm_mm_direct(a: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """Per-sample-grad instantiation norm (Opacus module 4). (B,) f32."""
    a, ds = _norm4(a, ds)
    G, B, _, d = a.shape
    p = ds.shape[-1]
    if G * B * d * p <= MAP_THRESHOLD:
        g = torch.einsum("gbtd,gbtp->gbdp", a.to(F32), ds.to(F32))
        return torch.einsum("gbdp,gbdp->b", g, g)
    out = torch.zeros(G, B, dtype=F32, device=a.device)
    for gi in range(G):
        for b in range(B):
            g = a[gi, b].to(F32).T @ ds[gi, b].to(F32)
            out[gi, b] = torch.sum(g * g)
    return out.sum(0)


def weighted_grad_mm(a: torch.Tensor, C: torch.Tensor, ds: torch.Tensor,
                     out_dtype=None) -> torch.Tensor:
    """G = a^T diag(C) ds  -> (d,p) or (L,d,p). Like the JAX reference, C is
    rounded to the record dtype before the contraction."""
    out_dtype = out_dtype or a.dtype
    c = C.to(a.dtype).to(F32)
    if a.dim() == 3:
        g = torch.einsum("btd,b,btp->dp", a.to(F32), c, ds.to(F32))
    elif a.dim() == 4:
        g = torch.einsum("lbtd,b,lbtp->ldp", a.to(F32), c, ds.to(F32))
    else:
        raise ValueError(f"mm record must be 3D or 4D, got {tuple(a.shape)}")
    return g.to(out_dtype)


# =========================================================== embedding (emb)
def sq_norm_emb(ids: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """Ghost norm for an embedding lookup (Li et al. 2021):
    ||g_i||^2 = sum_{t,t'} 1[id_t == id_t'] (ds_t . ds_t'). Returns (B,)."""
    if ids.dim() == 3:  # (L,B,T) stacked
        return sum(sq_norm_emb(ids[l], ds[l]) for l in range(ids.shape[0]))
    B, T = ids.shape
    if B * T * T <= MAP_THRESHOLD:
        eq = (ids[:, :, None] == ids[:, None, :]).to(F32)
        d32 = ds.to(F32)
        gram = torch.einsum("btd,bsd->bts", d32, d32)
        return torch.einsum("bts,bts->b", eq, gram)
    out = torch.zeros(B, dtype=F32, device=ds.device)
    for b in range(B):
        eq = (ids[b][:, None] == ids[b][None, :]).to(F32)
        db = ds[b].to(F32)
        out[b] = torch.sum(eq * (db @ db.T))
    return out


def weighted_grad_emb(ids: torch.Tensor, C: torch.Tensor, ds: torch.Tensor,
                      vocab: int, out_dtype=None) -> torch.Tensor:
    """G = sum_i C_i sum_t onehot(id_it) ds_it -> (V,d) or (L,V,d), as one
    scatter-add. Ids outside [0, vocab) are dropped (the JAX stacked path's
    semantics; its unstacked path wraps negative ids instead)."""
    out_dtype = out_dtype or ds.dtype
    stacked = ids.dim() == 3
    if not stacked:
        ids, ds = ids[None], ds[None]
    L, d = ids.shape[0], ds.shape[-1]
    w = (ds.to(F32) * C.to(F32)[None, :, None, None]).reshape(-1, d)
    off = torch.arange(L, device=ids.device)[:, None, None] * vocab
    valid = ((ids >= 0) & (ids < vocab)).reshape(-1)
    flat_ids = (ids.long() + off).reshape(-1)
    out = torch.zeros(L * vocab, d, dtype=F32, device=ds.device)
    out.index_add_(0, flat_ids[valid], w[valid])
    out = out.reshape(L, vocab, d).to(out_dtype)
    return out if stacked else out[0]


# ================================================================= MoE (moe)
def _moe5(a, mask, ds):
    """Canonicalize moe records to (G, B, E, C, .) with G = stacked layers."""
    if a.dim() == 4:
        return a[None], mask[None], ds[None]
    if a.dim() == 5:
        return a, mask, ds
    raise ValueError(f"moe record must be 4D or 5D, got {tuple(a.shape)}")


def sq_norm_moe_ghost(a: torch.Tensor, mask: torch.Tensor,
                      ds: torch.Tensor) -> torch.Tensor:
    """Ghost norm over capacity-gathered expert slots: a per-(sample,
    expert) Gram over the C slots, rows masked, summed over experts (the
    expert weights are disjoint parameters). Returns (B,) f32."""
    a, mask, ds = _moe5(a, mask, ds)
    G, B, E, C, _ = a.shape
    if G * B * E * C * C <= MAP_THRESHOLD:
        m = mask.to(F32)[..., None]
        am, dm = a.to(F32) * m, ds.to(F32) * m
        ga = torch.einsum("gbecd,gbefd->gbecf", am, am)
        gg = torch.einsum("gbecp,gbefp->gbecf", dm, dm)
        return torch.einsum("gbecf,gbecf->b", ga, gg)
    out = torch.zeros(G, B, dtype=F32, device=a.device)
    for g in range(G):
        for b in range(B):
            m = mask[g, b].to(F32)[..., None]
            am, dm = a[g, b].to(F32) * m, ds[g, b].to(F32) * m
            out[g, b] = torch.sum(am @ am.transpose(1, 2)
                                  * (dm @ dm.transpose(1, 2)))
    return out.sum(0)


def sq_norm_moe_direct(a: torch.Tensor, mask: torch.Tensor,
                       ds: torch.Tensor) -> torch.Tensor:
    """Per-(sample, expert) gradient instantiation g_be = a_be^T (m ds_be),
    squared and summed over experts. Returns (B,) f32."""
    a, mask, ds = _moe5(a, mask, ds)
    G, B, E, _, d = a.shape
    p = ds.shape[-1]
    if G * B * E * d * p <= MAP_THRESHOLD:
        dm = ds.to(F32) * mask.to(F32)[..., None]
        g = torch.einsum("gbecd,gbecp->gbedp", a.to(F32), dm)
        return torch.einsum("gbedp,gbedp->b", g, g)
    out = torch.zeros(G, B, dtype=F32, device=a.device)
    for gi in range(G):
        for b in range(B):
            dm = ds[gi, b].to(F32) * mask[gi, b].to(F32)[..., None]
            g = a[gi, b].to(F32).transpose(1, 2) @ dm
            out[gi, b] = torch.sum(g * g)
    return out.sum(0)


def weighted_grad_moe(a: torch.Tensor, mask: torch.Tensor, C: torch.Tensor,
                      ds: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """G_e = sum_b C_b a_be^T (m ds_be) -> (E,d,p) or (L,E,d,p). Like the
    JAX reference, C and the mask are rounded to the record dtype first."""
    out_dtype = out_dtype or a.dtype
    c = C.to(a.dtype).to(F32)
    dm = ds.to(F32) * mask.to(ds.dtype).to(F32)[..., None]
    if a.dim() == 4:
        g = torch.einsum("becd,b,becp->edp", a.to(F32), c, dm)
    elif a.dim() == 5:
        g = torch.einsum("lbecd,b,lbecp->ledp", a.to(F32), c, dm)
    else:
        raise ValueError(f"moe record must be 4D or 5D, got {tuple(a.shape)}")
    return g.to(out_dtype)


# ====================================================== hybrid decision rule
def prefer_ghost(T: int, d: int, p: int) -> bool:
    """Paper Sec. 3.2 layerwise rule: ghost norm iff 2 T^2 < p d."""
    return 2 * T * T < d * p
