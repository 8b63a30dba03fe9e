"""Dense decoder-only transformer: the qwen2 / llama block (RMSNorm, GQA
attention with rope and optional QKV bias, SwiGLU MLP). Block params are
stacked (L, ...) under ``blocks`` as in the JAX package; its ``lax.scan``
over blocks is a Python loop over layer slices here, and the tape stacks the
records to (L, B, T, .) under ``.s`` keys. Rematerialization (the JAX
config's ``remat``) is not ported.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tape import Tape
from repro_torch.models import layers as L
from repro_torch.models.attention import multihead_attention


# ------------------------------------------------------------------ attention
def attn_init(gen, cfg: ModelConfig, dt, layers=()):
    d, H, K, h = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"qkv": L.linear_init(gen, d, (H + 2 * K) * h, dt,
                                 bias=cfg.qkv_bias, layers=layers),
            "o": L.linear_init(gen, H * h, d, dt, layers=layers)}


def attn_apply(p, tape, x, cfg: ModelConfig, cos, sin):
    B, T = x.shape[0], x.shape[1]
    H, K, h = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    qkv = L.linear(tape, "qkv", p["qkv"], x)
    q, k, v = torch.split(qkv, [H * h, K * h, K * h], dim=-1)
    q = L.apply_rope(q.reshape(B, T, H, h), cos, sin)
    k = L.apply_rope(k.reshape(B, T, K, h), cos, sin)
    out = multihead_attention(q, k, v.reshape(B, T, K, h),
                              chunk=cfg.attn_chunk)
    return L.linear(tape, "o", p["o"], out.reshape(B, T, -1))


# ------------------------------------------------------------------------ mlp
def mlp_init(gen, cfg: ModelConfig, dt, layers=()):
    d, ff = cfg.d_model, cfg.d_ff
    return {"up": L.linear_init(gen, d, 2 * ff, dt, layers=layers),
            "down": L.linear_init(gen, ff, d, dt, layers=layers)}


def mlp_apply(p, tape, x):
    g, u = torch.chunk(L.linear(tape, "up", p["up"], x), 2, dim=-1)
    return L.linear(tape, "down", p["down"], torch.nn.functional.silu(g) * u)


# --------------------------------------------------------------- dense block
def dense_block_init(gen, cfg: ModelConfig, dt, layers=()):
    return {"ln1": L.rmsnorm_init(gen, cfg.d_model, dt, layers),
            "attn": attn_init(gen, cfg, dt, layers),
            "ln2": L.rmsnorm_init(gen, cfg.d_model, dt, layers),
            "mlp": mlp_init(gen, cfg, dt, layers)}


def dense_block_apply(p, tape, x, cfg: ModelConfig, cos, sin):
    with tape.scope("attn"):
        x = x + attn_apply(p["attn"], tape, L.rmsnorm(p["ln1"], x), cfg, cos,
                           sin)
    with tape.scope("mlp"):
        x = x + mlp_apply(p["mlp"], tape, L.rmsnorm(p["ln2"], x))
    return x


# ------------------------------------------------------------------ LM model
class TransformerLM:
    """Decoder-only LM (dense family)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init(self, seed: int = 0, device="cuda") -> dict:
        """Random params from ``seed`` (a torch.Generator on ``device``), in
        the JAX package's flat keys and layouts."""
        cfg = self.cfg
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        dt = getattr(torch, cfg.param_dtype)
        return {
            "embed": L.embedding_init(gen, cfg.vocab, cfg.d_model, dt),
            "final_norm": L.rmsnorm_init(gen, cfg.d_model, dt),
            # mu-P-style small readout, as the JAX package initializes it
            "head": L.linear_init(gen, cfg.d_model, cfg.vocab, dt,
                                  scale=0.1 / math.sqrt(cfg.d_model)),
            "blocks": dense_block_init(gen, cfg, dt, layers=(cfg.n_layers,)),
        }

    def _trunk(self, params, tape: Tape, x):
        cfg = self.cfg
        cos, sin = L.rope_freqs(cfg.hd, x.shape[1], cfg.rope_theta, x.device)
        with tape.stacked("blocks"):
            for l in range(cfg.n_layers):
                p_l = tape.layer_params("blocks", params["blocks"], l)
                x = dense_block_apply(p_l, tape, x, cfg, cos, sin)
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
