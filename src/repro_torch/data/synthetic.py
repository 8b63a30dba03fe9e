"""Synthetic batches: the JAX package's learnable structured-token recipe,
drawn from a ``torch.Generator``.

Each sequence is an incrementing run (next = cur + 1 mod vocab) from a
random start, with ``OUTLIER_FRAC`` of the positions replaced by uniform
tokens. ``make_batch(cfg, B, T, seed, step)`` depends only on (seed, step),
so a resumed run sees the same batches. The bits differ from the JAX
package's threefry draws; tests hand both packages one numpy batch.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.noise import path_seed

OUTLIER_FRAC = 0.15   # per-position probability of a uniform-random token


def structured_tokens(gen: torch.Generator, B: int, T: int, vocab: int,
                      outlier_frac: float = OUTLIER_FRAC) -> torch.Tensor:
    """(B, T) int32 learnable sequences (on the generator's device)."""
    dev = gen.device
    start = torch.randint(0, vocab, (B, 1), generator=gen, device=dev)
    runs = (torch.arange(T, device=dev)[None, :] + start) % vocab
    rare = torch.randint(0, vocab, (B, T), generator=gen, device=dev)
    keep_run = torch.rand((B, T), generator=gen, device=dev) >= outlier_frac
    return torch.where(keep_run, runs, rare).to(torch.int32)


def make_batch(cfg: ModelConfig, B: int, T: int, seed: int = 0,
               step: int = 0, device="cuda") -> dict:
    """{'tokens': (B, T) int32} on ``device`` for (seed, step)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(path_seed(seed, step, "batch"))
    return {"tokens": structured_tokens(gen, B, T, cfg.vocab)}
