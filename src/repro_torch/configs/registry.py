"""Architecture registry: ``--arch <id>`` -> ModelConfig, plus named
PrivacyPolicy presets. The port registers qwen2-1.5b (dense),
deepseek-moe-16b (moe) and rwkv6-3b (ssm)."""
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
    if cfg.family in ("dense", "moe"):
        from repro_torch.models.transformer import TransformerLM
        return TransformerLM(cfg)
    if cfg.family == "ssm":
        from repro_torch.models.rwkv6 import Rwkv6LM
        return Rwkv6LM(cfg)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 B8)")


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
    return cfg.with_(**kw)


# import arch modules so registration runs
for _m in ("qwen2_1_5b", "deepseek_moe_16b", "rwkv6_3b"):
    importlib.import_module(f"repro_torch.configs.{_m}")
