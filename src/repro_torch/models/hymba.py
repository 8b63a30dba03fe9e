"""Hymba (arXiv:2411.13676): hybrid-head blocks that run attention and a
Mamba-style SSM (``models.ssm``) in parallel on the same input, their
outputs mean-fused after a norm each and projected by one ``fuse_o``, plus
learnable meta tokens prepended to the sequence.

Layer layout as the paper's: sliding-window attention everywhere except
three global layers (first, middle, last), so the params are the segments
g0 | swa_a | g_mid | swa_b | g_last, the two sliding-window segments
stacked (L, ...) as the JAX package scans them (a Python loop over layer
slices here, each under its own ``tape.stacked`` scope, each block
rematerialized under ``cfg.remat``: ``Tape.block``; the global layers are
not, as in the reference). Params are the JAX package's flat keys and
layouts.

``apply`` (the BK step's forward, per-sample losses): the meta tokens
``meta/m`` (128, d) have no tap, so BK broadcasts them per sample (the psp
route) and they are concatenated in front of the embedded tokens; the
head's record keeps all T + meta rows and the loss drops the meta rows
after the head. The global layers attend by ``multihead_attention``, the
sliding-window layers by ``banded_attention``.

Serving: ``prefill`` runs the global layers' attention through the
``flash_attention`` kernel, the sliding-window layers' through
``banded_attention``; ``decode_step`` runs one token against the cache of
``init_cache`` (KV in the model dtype, the SSM state in f32), in place. As
in the JAX package, decode never prepends the meta tokens (prefill does), so
its logits are not the prefill's.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tape import Tape
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.attention import (banded_attention, decode_attention,
                                          multihead_attention, update_cache)
from repro_torch.models.transformer import _flash, _qkv, attn_init, mlp_apply, \
    mlp_init

F32 = torch.float32
SEGMENTS = ("g0", "swa_a", "g_mid", "swa_b", "g_last")


def block_init(gen, cfg: ModelConfig, dt, layers=()):
    d, d_inner = cfg.d_model, cfg.ssm_heads * cfg.hd
    attn = attn_init(gen, cfg, dt, layers)
    del attn["o"]   # the fused output projection replaces each branch's o
    return {"ln1": L.rmsnorm_init(gen, d, dt, layers),
            "attn": attn,
            "ssm": S.ssm_init(gen, cfg, dt, layers),
            "na": L.rmsnorm_init(gen, d_inner, dt, layers),
            "ns": L.rmsnorm_init(gen, d_inner, dt, layers),
            "fuse_o": L.linear_init(gen, d_inner, d, dt, layers=layers),
            "ln2": L.rmsnorm_init(gen, d, dt, layers),
            "mlp": mlp_init(gen, cfg, dt, layers)}


def _fuse(p, tape, x, a, s):
    fused = 0.5 * (L.rmsnorm(p["na"], a) + L.rmsnorm(p["ns"], s))
    x = x + L.linear(tape, "fuse_o", p["fuse_o"], fused)
    with tape.scope("mlp"):
        return x + mlp_apply(p["mlp"], tape, L.rmsnorm(p["ln2"], x))


def block_apply(p, tape, x, cfg: ModelConfig, cos, sin, window: int,
                attend=None):
    """``window``: 0 for a global layer; ``attend(q, k, v)``: a global
    layer's attention (None: training's ``multihead_attention``)."""
    B, T = x.shape[0], x.shape[1]
    xn = L.rmsnorm(p["ln1"], x)
    with tape.scope("attn"):
        q, k, v = _qkv(p["attn"], tape, xn, cfg, cos, sin)
        if window:
            a = banded_attention(q, k, v, window=window, chunk=cfg.attn_chunk)
        elif attend is not None:
            a = attend(q, k, v)
        else:
            a = multihead_attention(q, k, v, chunk=cfg.attn_chunk)
        a = a.reshape(B, T, -1)
    with tape.scope("ssm"):
        s = S.ssm_apply(p["ssm"], tape, xn, cfg)
    return _fuse(p, tape, x, a, s)


def block_decode(p, tape, x, cache, pos: int, cfg: ModelConfig, cos, sin,
                 window: int):
    """x (B,1,d); cache {'k','v'} (B,S,K,h), {'h'} (B,heads,hd,N) f32, all
    written in place -> x."""
    B = x.shape[0]
    xn = L.rmsnorm(p["ln1"], x)
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(p["attn"], tape, xn, cfg, cos, sin, positions)
    ck, cv = update_cache(cache["k"], cache["v"], k, v, pos)
    a = decode_attention(q, ck, cv, pos, window).reshape(B, 1, -1)
    s, h = S.ssm_decode(p["ssm"], tape, xn, cache["h"], cfg)
    cache["h"].copy_(h)
    return _fuse(p, tape, x, a, s)


class HymbaLM:
    """Segments g0 | swa_a (stacked) | g_mid | swa_b (stacked) | g_last."""

    def __init__(self, cfg: ModelConfig):
        n = cfg.n_layers
        fa = sorted(cfg.full_attn_layers) or [0, n // 2, n - 1]
        if len(fa) != 3 or fa[0] != 0 or fa[2] != n - 1:
            raise ValueError(f"hymba needs three global layers, the first, "
                             f"one between and the last, got {fa}")
        self.cfg = cfg
        self.glob = fa
        self.depth = {"swa_a": fa[1] - 1, "swa_b": n - fa[1] - 2}

    def init(self, seed: int = 0, device="cuda") -> dict:
        """Random params from ``seed`` (a torch.Generator on ``device``), in
        the JAX package's flat keys and layouts."""
        cfg = self.cfg
        gen = L.generator(seed, device)
        dt = getattr(torch, cfg.param_dtype)
        params = {"embed": L.embedding_init(gen, cfg.vocab, cfg.d_model, dt)}
        for name in SEGMENTS:
            depth = self.depth.get(name)
            params[name] = block_init(gen, cfg, dt,
                                      () if depth is None else (depth,))
        params["final_norm"] = L.rmsnorm_init(gen, cfg.d_model, dt)
        params["head"] = L.linear_init(gen, cfg.d_model, cfg.vocab, dt)
        if cfg.meta_tokens:
            params["meta"] = {"m": L.normal_init(
                gen, (cfg.meta_tokens, cfg.d_model), dt, 0.02)}
        return params

    def _trunk(self, params, tape: Tape, x, attend=None):
        cfg = self.cfg
        cos, sin = L.rope_freqs(cfg.hd, x.shape[1], cfg.rope_theta, x.device)
        for name in SEGMENTS:
            if name in self.depth:
                with tape.stacked(name):
                    for l in range(self.depth[name]):
                        x = tape.block(block_apply,
                                       tape.layer_params(name, params[name],
                                                         l), tape, x, cfg,
                                       cos, sin, cfg.window,
                                       remat=cfg.remat)
            else:
                with tape.scope(name):
                    x = block_apply(params[name], tape, x, cfg, cos, sin, 0,
                                    attend)
        return L.rmsnorm(params["final_norm"], x)

    def _embed(self, params, tape: Tape, tokens):
        """-> (the meta tokens and the embedded tokens (B, meta + T, d), the
        number of meta rows)."""
        x = L.embedding(tape, "embed", params["embed"], tokens)
        if not self.cfg.meta_tokens:
            return x, 0
        meta = params["meta"]["m"]
        if meta.dim() == 2:          # (M, d); (B, M, d) on the psp route
            meta = meta.expand(tokens.shape[0], *meta.shape)
        return torch.cat([meta.to(x.dtype), x], dim=1), meta.shape[1]

    def apply(self, params, batch, tape: Tape):
        """batch {'tokens': (B,T) int32 [, 'mask']} -> per-sample losses
        (B,)."""
        tokens = batch["tokens"]
        x, n_meta = self._embed(params, tape, tokens)
        x = self._trunk(params, tape, x)
        logits = L.linear(tape, "head", params["head"], x)[:, n_meta:]
        mask = batch.get("mask")
        mask = mask[:, 1:] if mask is not None else None
        return L.lm_per_sample_loss(logits[:, :-1], tokens[:, 1:], mask)

    # --------------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, params, tokens):
        """Serving prefill: tokens (B,T) -> last-position logits (B,V), the
        meta tokens in front, the global layers' attention through the
        flash_attention kernel."""
        tape = Tape.null()
        x, _ = self._embed(params, tape, tokens)
        x = self._trunk(params, tape, x, attend=_flash)
        return L.linear(tape, "head", params["head"], x[:, -1:, :])[:, 0]

    def init_cache(self, B, S, dtype=None, device="cuda"):
        """Zero caches for S positions, a segment each: {'k','v'}
        (B,S,K,h) in the model dtype and {'h'} (B,heads,hd,N) f32, with a
        leading layer axis in the stacked segments."""
        cfg = self.cfg
        dt = getattr(torch, dtype or cfg.param_dtype)

        def seg(*lead):
            kv = (*lead, B, S, cfg.n_kv_heads, cfg.hd)
            return {"k": torch.zeros(kv, dtype=dt, device=device),
                    "v": torch.zeros(kv, dtype=dt, device=device),
                    "h": torch.zeros(*lead, B, cfg.ssm_heads, cfg.hd,
                                     cfg.ssm_state, dtype=F32,
                                     device=device)}

        return {name: seg(*((self.depth[name],) if name in self.depth
                            else ())) for name in SEGMENTS}

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, pos: int):
        """tokens (B,) int; ``pos`` the index being written (no meta tokens:
        the JAX package's decode) -> logits (B,V), the cache (updated in
        place)."""
        cfg = self.cfg
        tape = Tape.null()
        cos, sin = L.rope_freqs(cfg.hd, cache["g0"]["k"].shape[1],
                                cfg.rope_theta, tokens.device)
        x = L.embedding(tape, "embed", params["embed"], tokens[:, None])
        for name in SEGMENTS:
            if name in self.depth:
                for l in range(self.depth[name]):
                    x = block_decode(
                        tape.layer_params(name, params[name], l), tape, x,
                        {n: c[l] for n, c in cache[name].items()}, pos, cfg,
                        cos, sin, cfg.window)
            else:
                x = block_decode(params[name], tape, x, cache[name], pos, cfg,
                                 cos, sin, 0)
        x = L.rmsnorm(params["final_norm"], x)
        return L.linear(tape, "head", params["head"], x)[:, 0], cache
