"""Mixture-of-Experts with per-(sample, expert) capacity dispatch.

As in the JAX package, capacity is allocated per (sample, expert): routing,
drops and therefore per-sample gradients are functions of the sample alone,
which DP-SGD's per-sample sensitivity needs (GShard-style capacity shared
across the batch would let one sample's routing drop another's tokens). The
per-(b, e) slot groups are the unit of the MoE ghost norm.

The combine gathers only each token's top-k expert outputs, (B,T,k,d),
where the JAX package gathers all E of them, (B,T,E,d), and weights the
unselected ones by zero: the same sum without the zero terms, and an
(E/k)-times smaller tensor for autograd to keep (1.07 GB -> 0.10 GB per
layer at deepseek-moe-16b, B=8, T=512, bf16).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

F32 = torch.float32


def capacity(cfg: ModelConfig, T: int) -> int:
    cap = int(math.ceil(cfg.capacity_factor * cfg.top_k * T / cfg.n_experts))
    return max(1, min(cap, T))


def moe_init(gen, cfg: ModelConfig, dt, layers=()):
    from repro_torch.models.transformer import mlp_init  # avoid a cycle
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    p = {"router": L.linear_init(gen, d, E, dt, layers=layers),
         "experts": {
             "up": {"w": L.normal_init(gen, (*layers, E, d, 2 * ff), dt,
                                       1.0 / math.sqrt(d))},
             "down": {"w": L.normal_init(gen, (*layers, E, ff, d), dt,
                                         1.0 / math.sqrt(ff))}}}
    if cfg.n_shared:
        p["shared"] = mlp_init(gen, cfg, dt, layers, d_ff=cfg.n_shared * ff)
    return p


def moe_linear(tape, name, p, xg, valid):
    """Tapped expert matmul xg (B,E,C,din) @ w (E,din,dout); the record is
    (xg, slot-validity mask), the unit of the per-(sample, expert) norm."""
    s = torch.einsum("becd,edf->becf", xg, p["w"])
    return tape.record(name, "moe", s, {"a": xg, "mask": valid})


def moe_apply(p, tape, x, cfg: ModelConfig):
    """x (B,T,d) -> (B,T,d)."""
    from repro_torch.models.transformer import mlp_apply  # avoid a cycle
    B, T, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, T)

    logits = L.linear(tape, "router", p["router"], x).to(F32)
    probs = torch.softmax(logits, dim=-1)                        # (B,T,E)
    topv, topi = torch.topk(probs, k, dim=-1)                    # (B,T,k)
    if cfg.renorm_topk:
        topv = topv / torch.sum(topv, dim=-1, keepdim=True)
    sel = F.one_hot(topi, E).to(F32).sum(2)                      # (B,T,E)

    # --- per-(b,e) slot assignment: token t takes slot pos of expert e;
    # past capacity it is dropped (scattered into a spare slot cut off below)
    pos = (torch.cumsum(sel, dim=1) - 1.0).to(torch.int64)       # (B,T,E)
    keep = (sel > 0) & (pos < cap)
    slot_pos = torch.where(keep, pos, cap).transpose(1, 2)       # (B,E,T)
    t_ix = torch.arange(T, device=x.device).expand(B, E, T)
    slot_t = torch.zeros(B, E, cap + 1, dtype=torch.int64, device=x.device
                         ).scatter_(2, slot_pos, t_ix)[..., :cap]
    valid = torch.zeros(B, E, cap + 1, dtype=F32, device=x.device
                        ).scatter_(2, slot_pos, 1.0)[..., :cap]

    b_ix = torch.arange(B, device=x.device)[:, None, None]
    xg = x[b_ix, slot_t] * valid[..., None].to(x.dtype)          # (B,E,C,d)

    # --- expert FFN (tapped) ---------------------------------------------
    with tape.scope("experts"):
        ep = p["experts"]
        g, u = torch.chunk(moe_linear(tape, "up", ep["up"], xg, valid), 2,
                           dim=-1)
        h = F.silu(g) * u * valid[..., None].to(x.dtype)
        out = moe_linear(tape, "down", ep["down"], h, valid)
        out = out * valid[..., None].to(out.dtype)

    # --- combine: each token's top-k slots --------------------------------
    pos_k = torch.gather(pos, 2, topi).clamp(0, cap - 1)         # (B,T,k)
    keep_k = torch.gather(keep, 2, topi)
    per_k = out[b_ix, topi, pos_k]                               # (B,T,k,d)
    w_eff = (topv * keep_k.to(F32)).to(per_k.dtype)
    y = torch.einsum("btkd,btk->btd", per_k, w_eff)

    if cfg.n_shared:
        with tape.scope("shared"):
            y = y + mlp_apply(p["shared"], tape, x)
    return y.to(x.dtype)
