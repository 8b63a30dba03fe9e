"""Architecture registry: ``--arch <id>`` -> ModelConfig, plus named
PrivacyPolicy presets. The port registers every config of the JAX package:
qwen2-1.5b, qwen2.5-3b, qwen3-14b and llama3-405b (dense), deepseek-moe-16b
and moonshot-v1-16b-a3b (moe), rwkv6-3b (ssm), hymba-1.5b (hybrid),
whisper-small (encdec) and internvl2-26b (vlm); policies for qwen2-1.5b
and deepseek-moe-16b, as the JAX package registers them."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

from repro_torch.configs.base import ModelConfig

_REGISTRY: dict = {}
_POLICIES: dict = {}


def register(fn: Callable[[], ModelConfig]):
    cfg = fn()
    _REGISTRY[cfg.name] = fn
    return fn


def register_policy(name: str):
    """Decorator: register ``fn() -> PrivacyPolicy`` as preset ``name``."""
    def deco(fn):
        _POLICIES[name] = fn
        return fn
    return deco


def get_policy(name: str, **overrides):
    """Named PrivacyPolicy preset, with engine-level field overrides
    (mode=..., sigma=..., use_kernels=...)."""
    try:
        policy = _POLICIES[name]()
    except KeyError:
        raise KeyError(f"no policy preset for {name!r}; known: "
                       f"{sorted(_POLICIES)}")
    return dataclasses.replace(policy, **overrides) if overrides else policy


def has_policy(name: str) -> bool:
    return name in _POLICIES


def list_policies():
    return sorted(_POLICIES)


def get_config(name: str) -> ModelConfig:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")


def list_archs():
    return sorted(_REGISTRY)


def build(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models.transformer import TransformerLM
        return TransformerLM(cfg)
    if cfg.family == "ssm":
        from repro_torch.models.rwkv6 import Rwkv6LM
        return Rwkv6LM(cfg)
    if cfg.family == "hybrid":
        from repro_torch.models.hymba import HymbaLM
        return HymbaLM(cfg)
    if cfg.family == "encdec":
        from repro_torch.models.whisper import WhisperLM
        return WhisperLM(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")


def cut_depth(cfg: ModelConfig, layers: int) -> ModelConfig:
    """``cfg`` at full width cut to ``layers`` layers (0: as it is): a
    hybrid config keeps its first, middle and last layers global, an
    encoder-decoder config cuts both stacks."""
    if not layers or layers == cfg.n_layers:
        return cfg
    if cfg.family == "hybrid":
        return cfg.with_(n_layers=layers,
                         full_attn_layers=(0, layers // 2, layers - 1))
    if cfg.family == "encdec":
        return cfg.with_(n_layers=layers, encoder_layers=layers)
    return cfg.with_(n_layers=layers)


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (the JAX rule)."""
    cfg = get_config(name)
    kw = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
              d_ff=48, vocab=64)
    if cfg.family == "moe":
        kw.update(n_experts=4, top_k=2, moe_d_ff=16,
                  first_k_dense=min(1, cfg.first_k_dense),
                  n_shared=min(1, cfg.n_shared))
    if cfg.family == "ssm":
        kw.update(d_model=128, n_heads=2, head_dim=64)  # rwkv head size 64
    if cfg.family == "hybrid":
        kw.update(n_layers=5, ssm_heads=4, ssm_state=4, window=8,
                  full_attn_layers=(0, 2, 4), meta_tokens=4)
    if cfg.family == "encdec":
        kw.update(encoder_layers=2, decoder_len=16, frame_dim=24,
                  n_kv_heads=4)
    if cfg.family == "vlm":
        kw.update(patch_tokens=4, vit_dim=16)
    return cfg.with_(**kw)


# import arch modules so registration runs
for _m in ("whisper_small", "qwen2_1_5b", "deepseek_moe_16b", "rwkv6_3b",
           "hymba_1_5b", "qwen3_14b", "qwen2_5_3b", "llama3_405b",
           "moonshot_v1_16b_a3b", "internvl2_26b"):
    importlib.import_module(f"repro_torch.configs.{_m}")
