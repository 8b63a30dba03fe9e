"""Whisper-style encoder-decoder (arXiv:2212.04356), the ``encdec`` family.

The conv audio frontend is a stub, as in the JAX package: the batch holds
precomputed frame embeddings (B, Tf, frame_dim) and a tapped linear with a
bias (``frontend``) projects them into the encoder. Encoder: bidirectional
pre-LN blocks over sinusoidal positions. Decoder: learned positions
(``pos/e``), causal self-attention, then cross-attention over the encoder's
output. LayerNorm and GELU throughout, no rope. Both stacks are stacked (L,
...) as the JAX package scans them (``enc_blocks``, ``dec_blocks``), a
Python loop over layer slices here, each under its own ``tape.stacked``
scope. Params are the JAX package's flat keys and layouts.

Taps, the JAX package's letter for letter: ``frontend``,
``enc_blocks/{attn/qkv, attn/o, mlp/up, mlp/down}``, ``embed``,
``dec_blocks/{attn/qkv, attn/o, xattn/q, xattn/kv, xattn/o, mlp/up,
mlp/down}`` and ``head``. ``dec_blocks/xattn/kv`` is recorded at the
layer's root with the encoder's output as its record (T = Tf, while the
group's other taps have T = Td): every layer records the same ``enc``,
stacked L times. ``pos/e``, the LayerNorms and ``frontend/b`` have no tap:
BK hands them in per sample (the psp route; ``pos/e`` as (B, Td, d)).

Serving: ``prefill`` (frames and tokens -> the last position's logits)
runs every attention through the ``flash_attention`` kernel: the encoder's
and the cross-attention bidirectional (the latter with Tq = Td over S = Tf
keys), the decoder's self-attention causal; training's ``apply`` keeps
``multihead_attention``, as the JAX package does. ``prefill_cross``
encodes the audio (flash too) and fills the cross caches of
``init_cache``; ``decode_step`` runs one token against the self-attention
cache (written in place) and the cross caches, in plain torch ops.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tape import Tape
from repro_torch.models import layers as L
from repro_torch.models.attention import (decode_attention,
                                          multihead_attention, update_cache)
from repro_torch.models.transformer import (_flash, _qkv, attn_init,
                                            mlp_apply, mlp_init)

F32 = torch.float32


def _sinusoid(T: int, d: int, device="cpu") -> torch.Tensor:
    """(T, d) f32: sin of pos / 10000^(2i/d) in the first half, cos in the
    second."""
    pos = torch.arange(T, dtype=F32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=F32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2.0 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# -------------------------------------------------------------------- blocks
def enc_block_init(gen, cfg: ModelConfig, dt, layers=()):
    d = cfg.d_model
    return {"ln1": L.layernorm_init(gen, d, dt, layers),
            "attn": attn_init(gen, cfg, dt, layers),
            "ln2": L.layernorm_init(gen, d, dt, layers),
            "mlp": mlp_init(gen, cfg, dt, layers)}


def enc_block_apply(p, tape, x, cfg: ModelConfig, attend=None):
    """``attend(q, k, v, causal)``: the attention (None: training's
    ``multihead_attention``)."""
    B, T = x.shape[0], x.shape[1]
    with tape.scope("attn"):
        q, k, v = _qkv(p["attn"], tape, L.layernorm(p["ln1"], x), cfg, None,
                       None)
        a = (multihead_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
             if attend is None else attend(q, k, v, False))
        x = x + L.linear(tape, "o", p["attn"]["o"], a.reshape(B, T, -1))
    with tape.scope("mlp"):
        x = x + mlp_apply(p["mlp"], tape, L.layernorm(p["ln2"], x), cfg.act)
    return x


def dec_block_init(gen, cfg: ModelConfig, dt, layers=()):
    d, H, h = cfg.d_model, cfg.n_heads, cfg.hd
    return {"ln1": L.layernorm_init(gen, d, dt, layers),
            "attn": attn_init(gen, cfg, dt, layers),
            "lnx": L.layernorm_init(gen, d, dt, layers),
            "xattn": {"q": L.linear_init(gen, d, H * h, dt, layers=layers),
                      "kv": L.linear_init(gen, d, 2 * H * h, dt,
                                          layers=layers),
                      "o": L.linear_init(gen, H * h, d, dt, layers=layers)},
            "ln2": L.layernorm_init(gen, d, dt, layers),
            "mlp": mlp_init(gen, cfg, dt, layers)}


def _cross_kv(p, tape, enc, cfg: ModelConfig):
    """The layer's cross keys and values from the encoder's output: the
    ``xattn/kv`` tap at the layer's root -> k, v (B, Tf, H, h)."""
    B, Tf = enc.shape[0], enc.shape[1]
    kv = L.linear(tape, "xattn/kv", p["xattn"]["kv"], enc)
    k, v = torch.chunk(kv, 2, dim=-1)
    return (k.reshape(B, Tf, cfg.n_heads, cfg.hd),
            v.reshape(B, Tf, cfg.n_heads, cfg.hd))


def dec_block_apply_pre(p, tape, x, enc_k, enc_v, cfg: ModelConfig,
                        attend=None):
    """Decoder block with the layer's cross K/V computed ahead;
    ``attend(q, k, v, causal)`` as in :func:`enc_block_apply`."""
    B, Td = x.shape[0], x.shape[1]
    H, h = cfg.n_heads, cfg.hd
    with tape.scope("attn"):
        q, k, v = _qkv(p["attn"], tape, L.layernorm(p["ln1"], x), cfg, None,
                       None)
        a = (multihead_attention(q, k, v, causal=True) if attend is None
             else attend(q, k, v, True))
        x = x + L.linear(tape, "o", p["attn"]["o"], a.reshape(B, Td, -1))
    with tape.scope("xattn"):
        xn = L.layernorm(p["lnx"], x)
        q = L.linear(tape, "q", p["xattn"]["q"], xn).reshape(B, Td, H, h)
        out = (multihead_attention(q, enc_k, enc_v, causal=False)
               if attend is None else attend(q, enc_k, enc_v, False))
        x = x + L.linear(tape, "o", p["xattn"]["o"], out.reshape(B, Td, -1))
    with tape.scope("mlp"):
        x = x + mlp_apply(p["mlp"], tape, L.layernorm(p["ln2"], x), cfg.act)
    return x


def cross_attn_decode(p, tape, x, enc_k, enc_v, cfg: ModelConfig):
    """x (B,1,d) against the cross caches (B,Tf,H,h) -> (B,1,d)."""
    B = x.shape[0]
    q = L.linear(tape, "q", p["q"], x).reshape(B, 1, cfg.n_heads, cfg.hd)
    out = multihead_attention(q, enc_k, enc_v, causal=False)
    return L.linear(tape, "o", p["o"], out.reshape(B, 1, -1))


# ------------------------------------------------------------------------ LM
class WhisperLM:
    """Encoder (``enc_blocks``) and decoder (``dec_blocks``), both stacked."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.n_enc = cfg.encoder_layers or cfg.n_layers

    def init(self, seed: int = 0, device="cuda") -> dict:
        """Random params from ``seed`` (a torch.Generator on ``device``), in
        the JAX package's flat keys and layouts."""
        cfg = self.cfg
        gen = L.generator(seed, device)
        dt = getattr(torch, cfg.param_dtype)
        d = cfg.d_model
        return {
            "frontend": L.linear_init(gen, cfg.frame_dim or d, d, dt,
                                      bias=True),
            "enc_blocks": enc_block_init(gen, cfg, dt, (self.n_enc,)),
            "enc_norm": L.layernorm_init(gen, d, dt),
            "embed": L.embedding_init(gen, cfg.vocab, d, dt),
            "pos": {"e": L.normal_init(gen, (cfg.decoder_len, d), dt, 0.01)},
            "dec_blocks": dec_block_init(gen, cfg, dt, (cfg.n_layers,)),
            "final_norm": L.layernorm_init(gen, d, dt),
            "head": L.linear_init(gen, d, cfg.vocab, dt),
        }

    # ---------------------------------------------------------------- encode
    def encode(self, params, tape: Tape, frames, attend=None):
        """frames (B, Tf, frame_dim) -> the encoder's output (B, Tf, d)."""
        cfg = self.cfg
        x = L.linear(tape, "frontend", params["frontend"],
                     frames.to(getattr(torch, cfg.param_dtype)))
        x = x + _sinusoid(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
        with tape.stacked("enc_blocks"):
            for l in range(self.n_enc):
                x = enc_block_apply(tape.layer_params(
                    "enc_blocks", params["enc_blocks"], l), tape, x, cfg,
                    attend)
        return L.layernorm(params["enc_norm"], x)

    # ---------------------------------------------------------------- decode
    def _dec_embed(self, params, tape: Tape, tokens, pos0: int = 0):
        """tokens (B, T) at positions pos0.. -> embeddings + positions;
        ``pos/e`` is (decoder_len, d), or (B, decoder_len, d) per sample."""
        x = L.embedding(tape, "embed", params["embed"], tokens)
        pe = params["pos"]["e"]
        T = tokens.shape[1]
        pos = pe[:, pos0:pos0 + T] if pe.dim() == 3 else \
            pe[pos0:pos0 + T][None]
        return x + pos.to(x.dtype)

    def _dec_blocks(self, params, tape: Tape, x, enc, attend=None):
        cfg = self.cfg
        with tape.stacked("dec_blocks"):
            for l in range(cfg.n_layers):
                p_l = tape.layer_params("dec_blocks", params["dec_blocks"], l)
                k, v = _cross_kv(p_l, tape, enc, cfg)
                x = dec_block_apply_pre(p_l, tape, x, k, v, cfg, attend)
        return x

    # ------------------------------------------------------------------ train
    def apply(self, params, batch, tape: Tape):
        """batch {'frames': (B,Tf,frame_dim), 'tokens': (B,Td) [, 'mask']}
        -> per-sample losses (B,)."""
        enc = self.encode(params, tape, batch["frames"])
        tokens = batch["tokens"]
        x = self._dec_embed(params, tape, tokens)
        x = self._dec_blocks(params, tape, x, enc)
        x = L.layernorm(params["final_norm"], x)
        logits = L.linear(tape, "head", params["head"], x)
        mask = batch.get("mask")
        mask = mask[:, 1:] if mask is not None else None
        return L.lm_per_sample_loss(logits[:, :-1], tokens[:, 1:], mask)

    # --------------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, params, frames, tokens):
        """Encode the frames, run the whole decoder over ``tokens`` (B,Td)
        -> the last position's logits (B,V); every attention through the
        flash_attention kernel."""
        tape = Tape.null()
        enc = self.encode(params, tape, frames, attend=_flash)
        x = self._dec_embed(params, tape, tokens)
        x = self._dec_blocks(params, tape, x, enc, attend=_flash)
        x = L.layernorm(params["final_norm"], x)
        return L.linear(tape, "head", params["head"], x[:, -1:, :])[:, 0]

    def init_cache(self, B, S, Tf=0, dtype=None, device="cuda"):
        """Zero caches: self-attention {'k','v'} (L,B,decoder_len,H,h), cross
        {'xk','xv'} (L,B,Tf,H,h) with Tf = S where not given (the JAX
        package's: ``generate`` decodes against zero cross caches)."""
        cfg = self.cfg
        dt = getattr(torch, dtype or cfg.param_dtype)
        lead = (cfg.n_layers, B)
        Tf = Tf or S

        def zeros(T):
            return torch.zeros(*lead, T, cfg.n_heads, cfg.hd, dtype=dt,
                               device=device)

        return {"k": zeros(cfg.decoder_len), "v": zeros(cfg.decoder_len),
                "xk": zeros(Tf), "xv": zeros(Tf)}

    @torch.no_grad()
    def prefill_cross(self, params, frames, cache):
        """Encode the audio once (flash_attention) and fill the cross
        caches -> the cache with 'xk', 'xv' (L,B,Tf,H,h) in its dtype."""
        cfg = self.cfg
        tape = Tape.null()
        enc = self.encode(params, tape, frames, attend=_flash)
        xk, xv = zip(*(_cross_kv(tape.layer_params(
            "dec_blocks", params["dec_blocks"], l), tape, enc, cfg)
            for l in range(cfg.n_layers)))
        return dict(cache, xk=torch.stack(xk).to(cache["xk"].dtype),
                    xv=torch.stack(xv).to(cache["xv"].dtype))

    @torch.no_grad()
    def decode_step(self, params, cache, tokens, pos: int):
        """tokens (B,) int; ``pos`` the index being written (below
        ``decoder_len``) -> logits (B,V), the cache (self-attention caches
        updated in place)."""
        cfg = self.cfg
        if not 0 <= pos < cfg.decoder_len:
            raise ValueError(f"whisper decodes positions below its "
                             f"decoder_len {cfg.decoder_len}, got {pos}")
        tape = Tape.null()
        x = self._dec_embed(params, tape, tokens[:, None], pos0=pos)
        B = x.shape[0]
        for l in range(cfg.n_layers):
            p_l = tape.layer_params("dec_blocks", params["dec_blocks"], l)
            q, k, v = _qkv(p_l["attn"], tape, L.layernorm(p_l["ln1"], x), cfg,
                           None, None)
            ck, cv = update_cache(cache["k"][l], cache["v"][l], k, v, pos)
            a = decode_attention(q, ck, cv, pos)
            x = x + L.linear(tape, "o", p_l["attn"]["o"], a.reshape(B, 1, -1))
            x = x + cross_attn_decode(p_l["xattn"], tape,
                                      L.layernorm(p_l["lnx"], x),
                                      cache["xk"][l], cache["xv"][l], cfg)
            x = x + mlp_apply(p_l["mlp"], tape, L.layernorm(p_l["ln2"], x),
                              cfg.act)
        x = L.layernorm(params["final_norm"], x)
        return L.linear(tape, "head", params["head"], x)[:, 0], cache
