"""Architecture registry: ``--arch <id>`` -> ModelConfig, plus named
PrivacyPolicy presets. Only qwen2-1.5b is registered in the port so far."""
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
    if cfg.family == "dense":
        from repro_torch.models.transformer import TransformerLM
        return TransformerLM(cfg)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 item 9)")


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (the JAX rule)."""
    cfg = get_config(name)
    return cfg.with_(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                     head_dim=8, d_ff=48, vocab=64)


# import arch modules so registration runs
for _m in ("qwen2_1_5b",):
    importlib.import_module(f"repro_torch.configs.{_m}")
