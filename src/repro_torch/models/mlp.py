"""MLP classifier: the paper's Figure 2 / Figure 9 ablation model, and the
smallest end-to-end exercise of the tap machinery. Counterpart of
``repro/models/mlp.py``; the same flat param keys and layouts."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import layers as L

F32 = torch.float32


@dataclass(frozen=True)
class MLPConfig:
    d_in: int = 32
    width: int = 64
    depth: int = 3
    n_classes: int = 10
    bias: bool = True
    dtype: str = "float32"


class MLP:
    def __init__(self, cfg: MLPConfig):
        self.cfg = cfg

    def init(self, seed: int = 0, device="cuda") -> dict:
        """Random params from ``seed`` (a torch.Generator on ``device``)."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        gen = L.generator(seed, device)
        params, d = {}, cfg.d_in
        for i in range(cfg.depth):
            params[f"l{i}"] = L.linear_init(gen, d, cfg.width, dt,
                                            bias=cfg.bias)
            d = cfg.width
        params["head"] = L.linear_init(gen, d, cfg.n_classes, dt,
                                       bias=cfg.bias)
        return params

    def apply(self, params, batch, tape):
        """batch: {'x': (B, d_in), 'y': (B,)} -> per-sample losses (B,)."""
        x = batch["x"][:, None, :]  # (B, 1, d): the T=1 canonical layout
        for i in range(self.cfg.depth):
            x = torch.relu(L.linear(tape, f"l{i}", params[f"l{i}"], x))
        logits = L.linear(tape, "head", params["head"], x)[:, 0, :].to(F32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, batch["y"][:, None].long())[:, 0]
        return logz - gold
