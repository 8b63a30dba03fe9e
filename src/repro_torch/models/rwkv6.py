"""RWKV6 "Finch" (arXiv:2404.05892): an attention-free LM with
data-dependent per-channel decay, trained under DP and served. Time-mix
recurrence:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with w_t = exp(-exp(w0 + tanh(x_w A) B)) (decay LoRA) and dynamic token-shift
mixing (5-way lerp deltas through a small tanh bottleneck). Params are the
JAX package's flat keys, blocks stacked (L, ...); its ``lax.scan`` over the
blocks is a Python loop over layer slices here.

``apply`` (the BK step's forward, per-sample losses) runs the blocks under
``tape.stacked("blocks")``, as the JAX package scans them, each
rematerialized under ``cfg.remat`` (``Tape.block``; so on the card a step
runs the wkv6 forward twice a layer, its recompute included): the taps
tm_w1, tm_w2_{0..4}, wa, wb, r, k, v, g, o (att) and key, value,
receptance (ffn), with embed and head; every vector (maa_*, w0, u, lnx_g/b,
the layernorms) takes the psp route, so u reaches the recurrence per
sample, (B,H,h).
On the card the recurrence runs through the wkv6 kernels: under grad
``kernels.wkv6.Wkv6Fn`` (the chunked forward, whose chunk states it saves,
and the ``wkv6_backward`` kernel), else the forward kernel alone
(``prefill``). On the CPU it takes the JAX package's own route
(``wkv6_chunked`` at T >= 2 * ``ssm_chunk``, ``wkv6_ref`` below),
differentiated by autograd, so that a CPU step equals the reference's.
``decode_step`` is O(1) state per token (``wkv6_step``) and updates the
cache of ``init_cache`` in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tape import Tape
from repro_torch.kernels.wkv6 import Wkv6Fn
from repro_torch.kernels.wkv6 import wkv6 as wkv6_kernel
from repro_torch.models import layers as L

F32 = torch.float32
TM_DIM = 32       # token-shift bottleneck (TIME_MIX_EXTRA_DIM)
DECAY_DIM = 64    # decay LoRA rank (TIME_DECAY_EXTRA_DIM)
HEAD_DIM = 64


def _shift(x):
    """Previous-token shift along T, zeros at t=0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


# ------------------------------------------------------------- recurrence
def wkv6_step(S, r, k, v, w, u):
    """Single step. r,k,v,w (B,H,h); u (H,h) or (B,H,h); S (B,H,h,h)
    -> (new S, out (B,H,h)), f32 (float64 for float64 inputs)."""
    dt = torch.promote_types(r.dtype, F32)
    r, k, v, w, S = (t.to(dt) for t in (r, k, v, w, S))
    out = (torch.einsum("bhi,bhij->bhj", r, S)
           + torch.sum(r * u.to(dt) * k, -1, keepdim=True) * v)
    return w[..., :, None] * S + k[..., :, None] * v[..., None, :], out


def wkv6_ref(r, k, v, w, u):
    """Reference recurrence, token by token. r,k,v,w (B,T,H,h); u (H,h) or
    (B,H,h) -> (B,T,H,h) f32 (float64 for float64 inputs). Functional (the
    steps stacked), so that ``torch.func.vmap`` runs it."""
    B, T, H, h = r.shape
    S = torch.zeros(B, H, h, h, dtype=torch.promote_types(r.dtype, F32),
                    device=r.device)
    outs = []
    for t in range(T):
        S, o = wkv6_step(S, r[:, t], k[:, t], v[:, t], w[:, t], u)
        outs.append(o)
    return torch.stack(outs, 1) if outs else S.new_zeros(B, 0, H, h)


def wkv6_chunked(r, k, v, w, u, chunk: int = 32):
    """Chunked recurrence (the JAX package's, and its Pallas kernel's, math):
    intra-chunk matmul form through k / P, P the in-chunk cumulative product
    of the decays, and an inter-chunk state scan. It loses the recurrence
    once P underflows f32 (strong decay); ``wkv6_ref`` and the kernel do
    not."""
    B, T, H, h = r.shape
    pad = (chunk - T % chunk) % chunk
    if pad:
        r, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    nc = r.shape[1] // chunk
    u_b = u.to(F32).expand(B, H, h)

    def ch(x):                                   # (nc, B, H, c, h)
        return x.to(F32).reshape(B, nc, chunk, H, h).permute(1, 0, 3, 2, 4)

    strict = torch.tril(torch.ones(chunk, chunk, dtype=F32,
                                   device=r.device), -1)
    S = torch.zeros(B, H, h, h, dtype=F32, device=r.device)
    outs = []
    for rb, kb, vb, wb in zip(ch(r), ch(k), ch(v), ch(w)):
        logw = torch.log(torch.clamp_min(wb, 1e-30))
        cum = torch.cumsum(logw, dim=2)          # inclusive
        P = torch.exp(cum)
        rt = rb * torch.exp(cum - logw)
        kt = kb / torch.clamp_min(P, 1e-30)
        A = torch.einsum("bhik,bhjk->bhij", rt, kt) * strict
        diag = torch.einsum("bhik,bhik->bhi", rb * u_b[:, :, None, :], kb)
        outs.append(torch.einsum("bhij,bhjk->bhik", A, vb)
                    + diag[..., None] * vb
                    + torch.einsum("bhik,bhkj->bhij", rt, S))
        Pc = P[:, :, -1]                         # (B,H,h)
        S = (Pc[..., None] * S
             + torch.einsum("bhik,bhij->bhkj", kt * Pc[:, :, None, :], vb))
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, -1, H, h)
    return out[:, :T]


# -------------------------------------------------------------------- block
def block_init(gen, cfg: ModelConfig, dt, layers=()):
    d, ff = cfg.d_model, cfg.d_ff
    H = d // HEAD_DIM

    def lin(a, b, scale=None):
        return L.linear_init(gen, a, b, dt, scale=scale, layers=layers)

    def vec(shape, val=0.0):
        return torch.full((*layers, *shape), val, dtype=dt, device=gen.device)

    att = {
        **{f"maa_{n}": vec((d,)) for n in "xwkvrg"},
        "tm_w1": lin(d, 5 * TM_DIM, 0.01),
        **{f"tm_w2_{i}": lin(TM_DIM, d, 0.01) for i in range(5)},
        "w0": vec((d,), -5.0),
        "wa": lin(d, DECAY_DIM, 0.01), "wb": lin(DECAY_DIM, d, 0.01),
        **{n: lin(d, d) for n in "rkvgo"},
        "u": vec((H, HEAD_DIM), 0.5),
        "lnx_g": vec((d,), 1.0), "lnx_b": vec((d,)),
    }
    ffn = {"maa_fk": vec((d,)), "maa_fr": vec((d,)),
           "key": lin(d, ff), "value": lin(ff, d), "receptance": lin(d, d)}
    return {"ln1": L.layernorm_init(gen, d, dt, layers), "att": att,
            "ln2": L.layernorm_init(gen, d, dt, layers), "ffn": ffn}


def _group_norm(xf, g, b, H, eps=64e-5):
    B, T, d = xf.shape
    xh = xf.reshape(B, T, H, -1).to(F32)
    mu = torch.mean(xh, -1, keepdim=True)
    var = torch.mean(torch.square(xh - mu), -1, keepdim=True)
    nrm = ((xh - mu) * torch.rsqrt(var + eps)).reshape(B, T, d)
    return (nrm * L.align(g, nrm).to(F32)
            + L.align(b, nrm).to(F32)).to(xf.dtype)


def _mix(xn, sx, maa, delta=None):
    m = L.align(maa, xn)
    if delta is not None:
        m = m + delta
    return xn + sx * m


def _time_mix_inputs(p, tape, xn, sx):
    """Dynamic 5-way token-shift mixing -> (xw, xk, xv, xr, xg)."""
    z = torch.tanh(L.linear(tape, "tm_w1", p["tm_w1"],
                            _mix(xn, sx, p["maa_x"])))
    zs = torch.chunk(z, 5, dim=-1)
    return tuple(_mix(xn, sx, p[f"maa_{n}"],
                      L.linear(tape, f"tm_w2_{i}", p[f"tm_w2_{i}"], zs[i]))
                 for i, n in enumerate("wkvrg"))


def _decay(p, tape, xw):
    ww = L.linear(tape, "wb", p["wb"],
                  torch.tanh(L.linear(tape, "wa", p["wa"], xw)))
    logw = L.align(p["w0"], ww).to(F32) + ww.to(F32)
    return torch.exp(-torch.exp(logw))


def _att_proj(p, tape, xn, sx):
    xw, xk, xv, xr, xg = _time_mix_inputs(p, tape, xn, sx)
    r = L.linear(tape, "r", p["r"], xr)
    k = L.linear(tape, "k", p["k"], xk)
    v = L.linear(tape, "v", p["v"], xv)
    g = F.silu(L.linear(tape, "g", p["g"], xg))
    return r, k, v, g, _decay(p, tape, xw)


def _heads(t, H):
    B, T, _ = t.shape
    return t.reshape(B, T, H, HEAD_DIM)


def _wkv(r, k, v, w, u, cfg: ModelConfig):
    """(B,T,H,h) -> (B,T,H,h) f32. On the card the wkv6 kernels: under grad
    ``Wkv6Fn`` (the forward, its saved chunk states, the backward kernel),
    else the forward alone. On the CPU the JAX package's route,
    differentiated by autograd. On the meta device (a plan) the card's
    route, against the kernels' meta stand-in."""
    if r.device.type != "cpu":
        if torch.is_grad_enabled():
            return Wkv6Fn.apply(r, k, v, w, u)[0]
        return wkv6_kernel(r, k, v, w, u)
    if r.shape[1] >= 2 * cfg.ssm_chunk:
        return wkv6_chunked(r, k, v, w, u, chunk=cfg.ssm_chunk)
    return wkv6_ref(r, k, v, w, u)


def _channel_mix(fp, tape, xn2, sx2):
    kk = torch.square(F.relu(L.linear(tape, "key", fp["key"],
                                      _mix(xn2, sx2, fp["maa_fk"]))))
    rr = torch.sigmoid(L.linear(tape, "receptance", fp["receptance"],
                                _mix(xn2, sx2, fp["maa_fr"])))
    return rr * L.linear(tape, "value", fp["value"], kk)


def block_apply(p, tape, x, cfg: ModelConfig):
    H = cfg.d_model // HEAD_DIM
    # --- time mix ---------------------------------------------------------
    xn = L.layernorm(p["ln1"], x)
    with tape.scope("att"):
        r, k, v, g, w = _att_proj(p["att"], tape, xn, _shift(xn) - xn)
        # the decay in the activation dtype, as the JAX package casts it
        wkv = _wkv(_heads(r, H), _heads(k, H), _heads(v, H),
                   _heads(w.to(x.dtype), H), p["att"]["u"], cfg)
        out = _group_norm(wkv.reshape(x.shape).to(x.dtype),
                          p["att"]["lnx_g"], p["att"]["lnx_b"], H)
        x = x + L.linear(tape, "o", p["att"]["o"], out * g)
    # --- channel mix --------------------------------------------------------
    xn2 = L.layernorm(p["ln2"], x)
    with tape.scope("ffn"):
        return x + _channel_mix(p["ffn"], tape, xn2, _shift(xn2) - xn2)


def block_decode(p, tape, x, cache, cfg: ModelConfig):
    """x (B,1,d); cache {'S': (B,H,h,h), 'att_sx': (B,d), 'ffn_sx': (B,d)}
    -> x, the new cache entries."""
    H = cfg.d_model // HEAD_DIM
    xn = L.layernorm(p["ln1"], x)
    sx = cache["att_sx"][:, None, :].to(xn.dtype) - xn
    with tape.scope("att"):
        r, k, v, g, w = _att_proj(p["att"], tape, xn, sx)
        S, out1 = wkv6_step(cache["S"], _heads(r, H)[:, 0],
                            _heads(k, H)[:, 0], _heads(v, H)[:, 0],
                            _heads(w.to(x.dtype), H)[:, 0], p["att"]["u"])
        out = _group_norm(out1[:, None].reshape(x.shape).to(x.dtype),
                          p["att"]["lnx_g"], p["att"]["lnx_b"], H)
        x = x + L.linear(tape, "o", p["att"]["o"], out * g)
    xn2 = L.layernorm(p["ln2"], x)
    sx2 = cache["ffn_sx"][:, None, :].to(xn2.dtype) - xn2
    with tape.scope("ffn"):
        x = x + _channel_mix(p["ffn"], tape, xn2, sx2)
    return x, {"S": S, "att_sx": xn[:, 0], "ffn_sx": xn2[:, 0]}


# ----------------------------------------------------------------------- LM
class Rwkv6LM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init(self, seed: int = 0, device="cuda") -> dict:
        """Random params from ``seed`` (a torch.Generator on ``device``), in
        the JAX package's flat keys and layouts."""
        cfg = self.cfg
        gen = L.generator(seed, device)
        dt = getattr(torch, cfg.param_dtype)
        d = cfg.d_model
        return {"embed": L.embedding_init(gen, cfg.vocab, d, dt),
                "ln_in": L.layernorm_init(gen, d, dt),
                "blocks": block_init(gen, cfg, dt, layers=(cfg.n_layers,)),
                "final_norm": L.layernorm_init(gen, d, dt),
                "head": L.linear_init(gen, d, cfg.vocab, dt)}

    def apply(self, params, batch, tape: Tape):
        """batch {'tokens': (B,T) int32 [, 'mask']} -> per-sample losses
        (B,): the blocks under ``tape.stacked("blocks")``, as the JAX
        package scans them."""
        cfg, tokens = self.cfg, batch["tokens"]
        x = L.embedding(tape, "embed", params["embed"], tokens)
        x = L.layernorm(params["ln_in"], x)
        with tape.stacked("blocks"):
            for l in range(cfg.n_layers):
                x = tape.block(block_apply,
                               tape.layer_params("blocks", params["blocks"],
                                                 l), tape, x, cfg,
                               remat=cfg.remat)
        x = L.layernorm(params["final_norm"], x)
        logits = L.linear(tape, "head", params["head"], x)
        mask = batch.get("mask")
        mask = mask[:, 1:] if mask is not None else None
        return L.lm_per_sample_loss(logits[:, :-1], tokens[:, 1:], mask)

    @torch.no_grad()
    def prefill(self, params, tokens):
        """Serving prefill: tokens (B,T) -> last-position logits (B,V)."""
        cfg, tape = self.cfg, Tape.null()
        x = L.embedding(tape, "embed", params["embed"], tokens)
        x = L.layernorm(params["ln_in"], x)
        for l in range(cfg.n_layers):
            x = block_apply(tape.layer_params("blocks", params["blocks"], l),
                            tape, x, cfg)
        x = L.layernorm(params["final_norm"], x)
        return L.linear(tape, "head", params["head"], x[:, -1:, :])[:, 0]

    def init_cache(self, B, S=0, dtype=None, device="cuda"):
        """Zero decode state: {'S': (L,B,H,h,h) f32, 'att_sx', 'ffn_sx':
        (L,B,d)}; ``S`` (the cache length) is unused: the state is O(1)."""
        cfg = self.cfg
        dt = getattr(torch, dtype or cfg.param_dtype)
        Lc, H = cfg.n_layers, cfg.d_model // HEAD_DIM
        return {"S": torch.zeros(Lc, B, H, HEAD_DIM, HEAD_DIM, dtype=F32,
                                 device=device),
                "att_sx": torch.zeros(Lc, B, cfg.d_model, dtype=dt,
                                      device=device),
                "ffn_sx": torch.zeros(Lc, B, cfg.d_model, dtype=dt,
                                      device=device)}

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, pos=None):
        """tokens (B,) int -> logits (B,V), the cache (updated in place)."""
        cfg, tape = self.cfg, Tape.null()
        x = L.embedding(tape, "embed", params["embed"], tokens[:, None])
        x = L.layernorm(params["ln_in"], x)
        for l in range(cfg.n_layers):
            x, new = block_decode(
                tape.layer_params("blocks", params["blocks"], l), tape, x,
                {n: c[l] for n, c in cache.items()}, cfg)
            for n, c in cache.items():
                c[l] = new[n]
        x = L.layernorm(params["final_norm"], x)
        return L.linear(tape, "head", params["head"], x)[:, 0], cache
