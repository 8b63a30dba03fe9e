"""Mamba2-style selective SSM head (a scalar A a head, B and C shared by
the heads), the parallel SSM branch of the Hymba blocks:

    h_t = exp(A dt_t) h_{t-1} + dt_t (x_t ⊗ B_t)     h (heads, hd, N)
    y_t = h_t C_t + D x_t,   gated by silu(z_t)

The projections xz and bcdt are tapped; A_log, D and dt_bias are vector
params (on the psp route under BK, (B, heads)). softplus, exp and the
recurrence run in f32.

The JAX package runs the recurrence token by token (``lax.scan``).
``ssm_apply`` runs its chunked (SSD) form instead, on the CPU and on the
card alike, in a fixed number of products whatever T is: chunks of
``cfg.ssm_chunk`` tokens; inside a chunk the outputs as one masked product
whose decays are exp of segment sums of A dt (each decay a sum of its own
terms, never a quotient of cumulative products, which loses the recurrence
once a product underflows); the state entering each chunk from the chunk
states before it by the same segment sums over the chunks.
``ssm_decode`` is one step of the recurrence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

F32 = torch.float32


def ssm_init(gen, cfg: ModelConfig, dt, layers=()):
    d, heads, hd, N = cfg.d_model, cfg.ssm_heads, cfg.hd, cfg.ssm_state
    return {
        "xz": L.linear_init(gen, d, 2 * heads * hd, dt, layers=layers),
        "bcdt": L.linear_init(gen, d, 2 * N + heads, dt, layers=layers),
        "A_log": L.zeros_init(gen, (*layers, heads), dt),
        "D": L.ones_init(gen, (*layers, heads), dt),
        "dt_bias": L.zeros_init(gen, (*layers, heads), dt),
    }


def _inputs(p, tape, xn, cfg: ModelConfig):
    """-> xs (B,T,heads,hd), z (B,T,heads*hd) in the model dtype; B_, C_
    (B,T,N), dt (B,T,heads) and the log decay a = A dt (B,T,heads), f32."""
    heads, hd, N = cfg.ssm_heads, cfg.hd, cfg.ssm_state
    B, T, _ = xn.shape
    xs, z = torch.chunk(L.linear(tape, "xz", p["xz"], xn), 2, dim=-1)
    xs = xs.reshape(B, T, heads, hd)
    bcdt = L.linear(tape, "bcdt", p["bcdt"], xn).to(F32)
    B_, C_, dtr = torch.split(bcdt, [N, N, heads], dim=-1)
    dtv = F.softplus(dtr + L.align(p["dt_bias"], dtr).to(F32))
    A = -torch.exp(L.align(p["A_log"], dtv).to(F32))
    return xs, z, B_, C_, dtv, A * dtv


def segsum(a):
    """a (..., c) -> (..., c, c): out[i, j] = a_{j+1} + ... + a_i for
    i >= j (0 on the diagonal), as masked running sums of the terms
    themselves; 0 above the diagonal."""
    c = a.shape[-1]
    strict = torch.ones(c, c, dtype=torch.bool, device=a.device).tril(-1)
    rows = torch.where(strict, a[..., :, None], 0.0)   # [i, j] = a_i, i > j
    return torch.cumsum(rows, dim=-2)


def ssd(x, a, Bm, Cm, dt, chunk: int):
    """The recurrence in chunks. x (B,T,H,P), a / dt (B,T,H), Bm / Cm
    (B,T,N), all f32 (float64 in, float64 out) -> y_t = h_t C_t
    (B,T,H,P), from h_0 = 0."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-T) % chunk
    if pad:      # a = dt = 0 at the pad: nothing flows into or out of it
        x, a, Bm, Cm, dt = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                            for t in (x, a, Bm, Cm, dt))
    nc = x.shape[1] // chunk
    x = x.reshape(Bsz, nc, chunk, H, P)
    xdt = x * dt.reshape(Bsz, nc, chunk, H)[..., None]       # (B,z,c,H,P)
    a = a.reshape(Bsz, nc, chunk, H).permute(0, 3, 1, 2)    # (B,H,z,c)
    Bm, Cm = Bm.reshape(Bsz, nc, chunk, N), Cm.reshape(Bsz, nc, chunk, N)
    lower = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=x.device).tril()
    # decay from j to i inside a chunk: exp(a_{j+1} + ... + a_i), i >= j
    decay = torch.where(lower, torch.exp(segsum(a)), 0.0)   # (B,H,z,c,c)
    # inside the chunks: y_i = sum_{j<=i} decay_ij (C_i . B_j) dt_j x_j
    cb = torch.einsum("bzin,bzjn->bzij", Cm, Bm)
    y = torch.einsum("bhzij,bzjhp->bzihp", decay * cb[:, None], xdt)
    # each chunk's own contribution to the state at its end
    states = torch.einsum("bhzj,bzjn,bzjhp->bzhpn", decay[..., -1, :], Bm,
                          xdt)
    # the state entering chunk z: the chunk states of z' < z, each decayed
    # by the whole chunks z'+1 .. z-1 (segment sums over the chunks)
    whole = F.pad(a.sum(-1), (1, 0))                          # (B,H,z+1)
    lower_z = torch.ones(nc + 1, nc + 1, dtype=torch.bool,
                         device=x.device).tril()
    carry = torch.where(lower_z, torch.exp(segsum(whole)), 0.0)
    entering = torch.einsum("bhzy,byhpn->bzhpn", carry[..., :nc, 1:], states)
    # from the state entering a chunk to its position i: exp(a_0 + .. + a_i)
    y = y + torch.einsum("bzin,bzhpn,bhzi->bzihp", Cm, entering,
                         torch.exp(torch.cumsum(a, -1)))
    return y.reshape(Bsz, nc * chunk, H, P)[:, :T]


def ssm_apply(p, tape, xn, cfg: ModelConfig):
    """xn (B,T,d) -> (B,T,heads*hd) in xn's dtype, the recurrence by
    :func:`ssd` in chunks of ``cfg.ssm_chunk``."""
    heads, hd = cfg.ssm_heads, cfg.hd
    B, T, _ = xn.shape
    xs, z, B_, C_, dtv, a = _inputs(p, tape, xn, cfg)
    x32 = xs.to(F32)
    y = ssd(x32, a, B_, C_, dtv, cfg.ssm_chunk)
    y = y + L.align(p["D"], dtv).to(F32)[..., None] * x32
    y = y * F.silu(z.to(F32)).reshape(B, T, heads, hd)
    return y.reshape(B, T, heads * hd).to(xn.dtype)


def ssm_decode(p, tape, xn, h, cfg: ModelConfig):
    """One token. xn (B,1,d); h (B,heads,hd,N) f32 -> (y (B,1,heads*hd),
    the new state h', f32)."""
    heads, hd = cfg.ssm_heads, cfg.hd
    B = xn.shape[0]
    xs, z, B_, C_, dtv, a = _inputs(p, tape, xn, cfg)
    x_t = xs.to(F32)[:, 0]
    h = (torch.exp(a[:, 0])[:, :, None, None] * h.to(F32)
         + dtv[:, 0, :, None, None] * (x_t[..., None]
                                       * B_[:, 0, None, None, :]))
    y = torch.einsum("bhpn,bn->bhp", h, C_[:, 0])
    y = y + p["D"].to(F32)[..., None] * x_t     # decode never runs the psp route
    y = y * F.silu(z.to(F32)).reshape(B, heads, hd)
    return y.reshape(B, 1, heads * hd).to(xn.dtype), h
