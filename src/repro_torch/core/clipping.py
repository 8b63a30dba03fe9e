"""Per-sample clipping factor functions C(||g_i||; R) from Eq. (1).

All return the factor C_i such that the clipped per-sample gradient is
``C_i * g_i`` and the sum has L2 sensitivity at most R.
"""
from __future__ import annotations

from functools import partial

import torch

_EPS = 1e-12


def abadi(norms: torch.Tensor, R: float) -> torch.Tensor:
    """Abadi et al. 2016: C_i = min(R/||g_i||, 1)."""
    return torch.clamp(R / (norms + _EPS), max=1.0)


def automatic(norms: torch.Tensor, R: float, gamma: float = 0.01) -> torch.Tensor:
    """Bu et al. 2022b automatic clipping: C_i = R/(||g_i|| + gamma)."""
    return R / (norms + gamma)


def normalize(norms: torch.Tensor, R: float) -> torch.Tensor:
    """Gradient normalization: C_i = R/||g_i||."""
    return R / (norms + _EPS)


def flat(norms: torch.Tensor, R: float) -> torch.Tensor:
    """Bu et al. 2021b indicator clipping: C_i = 1[||g_i|| <= R]."""
    return (norms <= R).to(norms.dtype)


CLIP_FNS = {
    "abadi": abadi,
    "automatic": automatic,
    "normalize": normalize,
    "flat": flat,
}


def get_clip_fn(name: str, R: float, **kw):
    try:
        fn = CLIP_FNS[name]
    except KeyError:
        raise ValueError(f"unknown clipping fn {name!r}; options: {sorted(CLIP_FNS)}")
    return partial(fn, R=R, **kw)
