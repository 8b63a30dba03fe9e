"""Decoder-only transformer, dense and MoE: the qwen2 / llama block
(RMSNorm, GQA attention with rope and optional QKV bias, SwiGLU MLP), with
the DeepSeekMoE feed-forward (``models.moe``) in the ``moe`` family. Block
params are stacked (L, ...) under ``blocks`` as in the JAX package; its
``lax.scan`` over blocks is a Python loop over layer slices here, and the
tape stacks the records to (L, B, T, .) under ``.s`` keys. The MoE family's
``first_k_dense`` leading dense layers are unstacked, at ``dense0_{i}``.
Rematerialization (the JAX config's ``remat``) is not ported.

Serving: ``prefill`` runs the trunk with its attention through the
``flash_attention`` kernel (training's ``apply`` keeps
``multihead_attention``, as in the JAX package); ``decode_step`` runs one
token against the KV cache of ``init_cache``, which it updates in place.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tape import Tape
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.attention import (decode_attention,
                                          multihead_attention, update_cache)


# ------------------------------------------------------------------ attention
def attn_init(gen, cfg: ModelConfig, dt, layers=()):
    d, H, K, h = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"qkv": L.linear_init(gen, d, (H + 2 * K) * h, dt,
                                 bias=cfg.qkv_bias, layers=layers),
            "o": L.linear_init(gen, H * h, d, dt, layers=layers)}


def _qkv(p, tape, x, cfg: ModelConfig, cos, sin, positions=None):
    B, T = x.shape[0], x.shape[1]
    H, K, h = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    qkv = L.linear(tape, "qkv", p["qkv"], x)
    q, k, v = torch.split(qkv, [H * h, K * h, K * h], dim=-1)
    q = L.apply_rope(q.reshape(B, T, H, h), cos, sin, positions)
    k = L.apply_rope(k.reshape(B, T, K, h), cos, sin, positions)
    return q, k, v.reshape(B, T, K, h)


def _flash(q, k, v):
    """Prefill's attention: the causal flash_attention kernel."""
    return flash_attention(q, k, v.contiguous())


def attn_apply(p, tape, x, cfg: ModelConfig, cos, sin, attend=None):
    """``attend(q, k, v)``: the attention (None: training's
    ``multihead_attention``)."""
    B, T = x.shape[0], x.shape[1]
    q, k, v = _qkv(p, tape, x, cfg, cos, sin)
    out = (multihead_attention(q, k, v, chunk=cfg.attn_chunk)
           if attend is None else attend(q, k, v))
    return L.linear(tape, "o", p["o"], out.reshape(B, T, -1))


def attn_decode(p, tape, x, cfg: ModelConfig, cos, sin, cache, pos: int):
    """x (B,1,d); cache {'k','v'} (B,S,K,h), written in place at ``pos``.
    -> out, cache."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(p, tape, x, cfg, cos, sin, positions)
    ck, cv = update_cache(cache["k"], cache["v"], k, v, pos)
    out = decode_attention(q, ck, cv, pos)
    return (L.linear(tape, "o", p["o"], out.reshape(B, 1, -1)),
            {"k": ck, "v": cv})


# ------------------------------------------------------------------------ mlp
def mlp_init(gen, cfg: ModelConfig, dt, layers=(), d_ff=0):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {"up": L.linear_init(gen, d, 2 * ff, dt, layers=layers),
            "down": L.linear_init(gen, ff, d, dt, layers=layers)}


def mlp_apply(p, tape, x):
    g, u = torch.chunk(L.linear(tape, "up", p["up"], x), 2, dim=-1)
    return L.linear(tape, "down", p["down"], torch.nn.functional.silu(g) * u)


# --------------------------------------------------------------- dense block
def dense_block_init(gen, cfg: ModelConfig, dt, layers=(), use_moe=False):
    return {"ln1": L.rmsnorm_init(gen, cfg.d_model, dt, layers),
            "attn": attn_init(gen, cfg, dt, layers),
            "ln2": L.rmsnorm_init(gen, cfg.d_model, dt, layers),
            "mlp": (M.moe_init(gen, cfg, dt, layers) if use_moe
                    else mlp_init(gen, cfg, dt, layers))}


def _ffn(p, tape, h, cfg: ModelConfig, use_moe):
    return M.moe_apply(p, tape, h, cfg) if use_moe else mlp_apply(p, tape, h)


def dense_block_apply(p, tape, x, cfg: ModelConfig, cos, sin, use_moe=False,
                      attend=None):
    with tape.scope("attn"):
        x = x + attn_apply(p["attn"], tape, L.rmsnorm(p["ln1"], x), cfg, cos,
                           sin, attend)
    with tape.scope("mlp"):
        x = x + _ffn(p["mlp"], tape, L.rmsnorm(p["ln2"], x), cfg, use_moe)
    return x


def dense_block_decode(p, tape, x, cfg: ModelConfig, cos, sin, cache,
                       pos: int, use_moe=False):
    a, cache = attn_decode(p["attn"], tape, L.rmsnorm(p["ln1"], x), cfg, cos,
                           sin, cache, pos)
    x = x + a
    return x + _ffn(p["mlp"], tape, L.rmsnorm(p["ln2"], x), cfg,
                    use_moe), cache


# ------------------------------------------------------------------ LM model
class TransformerLM:
    """Decoder-only LM (dense and moe families)."""

    def __init__(self, cfg: ModelConfig):
        if (cfg.norm, cfg.act) != ("rmsnorm", "swiglu"):
            raise NotImplementedError(
                f"the port's transformer block is RMSNorm + SwiGLU, got "
                f"norm={cfg.norm!r} act={cfg.act!r}")
        self.cfg = cfg
        self.use_moe = cfg.family == "moe"

    def init(self, seed: int = 0, device="cuda") -> dict:
        """Random params from ``seed`` (a torch.Generator on ``device``), in
        the JAX package's flat keys and layouts."""
        cfg = self.cfg
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        dt = getattr(torch, cfg.param_dtype)
        params = {
            "embed": L.embedding_init(gen, cfg.vocab, cfg.d_model, dt),
            "final_norm": L.rmsnorm_init(gen, cfg.d_model, dt),
            # mu-P-style small readout, as the JAX package initializes it
            "head": L.linear_init(gen, cfg.d_model, cfg.vocab, dt,
                                  scale=0.1 / math.sqrt(cfg.d_model)),
        }
        for i in range(cfg.first_k_dense):
            params[f"dense0_{i}"] = dense_block_init(gen, cfg, dt)
        params["blocks"] = dense_block_init(
            gen, cfg, dt, layers=(cfg.n_layers - cfg.first_k_dense,),
            use_moe=self.use_moe)
        return params

    def _trunk(self, params, tape: Tape, x, attend=None):
        cfg = self.cfg
        cos, sin = L.rope_freqs(cfg.hd, x.shape[1], cfg.rope_theta, x.device)
        for i in range(cfg.first_k_dense):
            with tape.scope(f"dense0_{i}"):
                x = dense_block_apply(params[f"dense0_{i}"], tape, x, cfg,
                                      cos, sin, attend=attend)
        with tape.stacked("blocks"):
            for l in range(cfg.n_layers - cfg.first_k_dense):
                p_l = tape.layer_params("blocks", params["blocks"], l)
                x = dense_block_apply(p_l, tape, x, cfg, cos, sin,
                                      use_moe=self.use_moe, attend=attend)
        return L.rmsnorm(params["final_norm"], x)

    def apply(self, params, batch, tape: Tape):
        """batch {'tokens': (B,T) int32 [, 'mask']} -> per-sample losses (B,)."""
        tokens = batch["tokens"]
        x = L.embedding(tape, "embed", params["embed"], tokens)
        x = self._trunk(params, tape, x)
        logits = L.linear(tape, "head", params["head"], x)
        labels = tokens[:, 1:]
        mask = batch.get("mask")
        mask = mask[:, 1:] if mask is not None else None
        return L.lm_per_sample_loss(logits[:, :-1], labels, mask)

    # --------------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, params, tokens):
        """Serving prefill: tokens (B,T) -> last-position logits (B,V), the
        attention through the flash_attention kernel."""
        tape = Tape.null()
        x = L.embedding(tape, "embed", params["embed"], tokens)
        x = self._trunk(params, tape, x, attend=_flash)
        return L.linear(tape, "head", params["head"], x[:, -1:, :])[:, 0]

    def init_cache(self, B, S, dtype=None, device="cuda"):
        """Zero KV caches for S positions: {'blocks': {'k','v'}
        (L,B,S,K,h)} and {'k','v'} (B,S,K,h) per unstacked dense layer."""
        cfg = self.cfg
        dt = getattr(torch, dtype or cfg.param_dtype)

        def kv(*lead):
            return {n: torch.zeros(*lead, B, S, cfg.n_kv_heads, cfg.hd,
                                   dtype=dt, device=device)
                    for n in ("k", "v")}

        cache = {"blocks": kv(cfg.n_layers - cfg.first_k_dense)}
        for i in range(cfg.first_k_dense):
            cache[f"dense0_{i}"] = kv()
        return cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, pos: int):
        """tokens (B,) int; ``pos`` the index being written. -> logits
        (B,V), the cache (updated in place)."""
        cfg = self.cfg
        tape = Tape.null()
        blocks = cache["blocks"]
        cos, sin = L.rope_freqs(cfg.hd, blocks["k"].shape[2], cfg.rope_theta,
                                tokens.device)
        x = L.embedding(tape, "embed", params["embed"], tokens[:, None])
        for i in range(cfg.first_k_dense):
            name = f"dense0_{i}"
            x, cache[name] = dense_block_decode(params[name], tape, x, cfg,
                                                cos, sin, cache[name], pos)
        for l in range(cfg.n_layers - cfg.first_k_dense):
            p_l = tape.layer_params("blocks", params["blocks"], l)
            x, _ = dense_block_decode(p_l, tape, x, cfg, cos, sin,
                                      {"k": blocks["k"][l],
                                       "v": blocks["v"][l]}, pos,
                                      use_moe=self.use_moe)
        x = L.rmsnorm(params["final_norm"], x)
        return L.linear(tape, "head", params["head"], x)[:, 0], cache
