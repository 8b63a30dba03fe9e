"""LR schedules as step -> lr functions (host floats)."""
from __future__ import annotations

import math


def constant(lr: float):
    return lambda step: float(lr)


def warmup_cosine(lr: float, warmup: int, total: int, final_frac: float = 0.1):
    def fn(step):
        if step < warmup:
            return lr * min(1.0, (step + 1.0) / max(1.0, float(warmup)))
        prog = min(max((step - warmup) / max(1.0, total - warmup), 0.0), 1.0)
        return lr * (final_frac + (1 - final_frac) * 0.5 *
                     (1.0 + math.cos(math.pi * prog)))

    return fn


def warmup_linear(lr: float, warmup: int, total: int):
    def fn(step):
        if step < warmup:
            return lr * min(1.0, (step + 1.0) / max(1.0, float(warmup)))
        return lr * min(max(1.0 - (step - warmup) / max(1.0, total - warmup),
                            0.0), 1.0)

    return fn


def make_schedule(name: str, lr: float, warmup: int = 0, total: int = 1):
    if name == "cosine":
        return warmup_cosine(lr, warmup, total)
    if name == "linear":
        return warmup_linear(lr, warmup, total)
    return constant(lr)
