"""Phase-4 noise: the Gaussian mechanism, per leaf.

    private leaf = (G + sigma * scale * xi) / B,    xi ~ N(0, I)

xi comes from a ``torch.Generator`` on the leaf's device, seeded by a pure
function of (seed, step, crc32(path)), so a run that restarts at step s
draws the same noise it would have drawn. The bits differ from the JAX
package's threefry draws; bitwise agreement with them is ROADMAP work.
"""
from __future__ import annotations

import zlib

import torch

_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer: a bijective avalanche on 64-bit ints."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _M64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _M64
    return x ^ (x >> 31)


def path_seed(seed: int, step: int, path: str) -> int:
    """Generator seed of one leaf's draw at one step (a non-negative int63)."""
    x = _mix64((seed & _M64) ^ 0x9E3779B97F4A7C15)
    x = _mix64(x ^ (step & _M64))
    x = _mix64(x ^ zlib.crc32(path.encode()))
    return x >> 1


def gaussian(path: str, shape, seed: int, step: int, device) -> torch.Tensor:
    """Standard normal f32 draw for ``path`` at ``step``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(path_seed(seed, step, path))
    return torch.randn(tuple(shape), generator=gen, device=device,
                       dtype=torch.float32)


class GaussianMechanism:
    """Per-step independent Gaussian noise — the DP-SGD default.
    ``draw(path, shape)``, when given, replaces the generator's draw."""
    name = "gaussian"

    def __init__(self, draw=None):
        self.draw = draw

    def add_leaf(self, path: str, g: torch.Tensor, seed: int, sigma: float,
                 scale: float, denom: float, step: int = 0) -> torch.Tensor:
        if sigma > 0.0:
            xi = (self.draw(path, tuple(g.shape)) if self.draw is not None
                  else gaussian(path, g.shape, seed, step, g.device))
            g = g + (sigma * scale) * xi.to(device=g.device, dtype=g.dtype)
        return g / denom
