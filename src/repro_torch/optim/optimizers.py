"""Optimizers with a fused per-leaf update: SGD(m) and AdamW.

    opt = make_optimizer("adamw", lr_fn, weight_decay=...)
    state = opt.init(params)
    params, state = opt.update_leaves(grad_for, state, params, step)
    params, state = opt.update(grads, state, params, step)

``update_leaves`` takes ``grad_for(path, param) -> grad leaf`` and walks the
leaves ONCE, producing each gradient immediately before its update, so a
second full-size gradient tree is never live next to the optimizer state.
A grad leaf is a tensor, or a ``core.noise.NoisedLeaf`` (the clipped sum
with its phase-4 noise not yet drawn, ``core.policy.noise_leaf_fn(...,
out="deferred")``). Each leaf's update is one ``kernels.noise_update`` call:
on the card one launch that draws the noise and applies the step, on the
CPU its plain version (the noise by ``counter_noise``'s plain version, then
the torch chain of the step). ``update`` takes a materialized gradient tree
(the baseline modes'), and delegates to ``update_leaves``, so the two
cannot diverge. State is float32. Unlike the JAX package's functional
updates, the port updates the state and the params IN PLACE (the returned
dicts are the ones passed in).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.kernels.noise_update import AdamW, SGD, noise_update
from repro_torch.utils.tree import flatten, unflatten

F32 = torch.float32


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    # (grad_for, state, params, step) -> (params, state)
    update_leaves: Callable
    # (grads, state, params, step) -> (params, state)
    update: Callable


def _materialized(update_leaves) -> Callable:
    """The materialized-tree contract over the one body, update_leaves."""
    def update(grads, state, params, step):
        fg = flatten(grads)
        return update_leaves(lambda path, p: fg[path], state, params, step)

    return update


def _zeros_f32(params):
    return unflatten({k: torch.zeros_like(v, dtype=F32)
                      for k, v in flatten(params).items()})


# ---------------------------------------------------------------------- sgd
def sgd(lr_fn, momentum: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": _zeros_f32(params)}

    def update_leaves(grad_for, state, params, step):
        hp = SGD(lr_fn(step), momentum, weight_decay)
        fm = flatten(state["m"])
        for path, p in flatten(params).items():
            noise_update(grad_for(path, p), p, fm[path], None, hp)
        return params, state

    return Optimizer(init, update_leaves, _materialized(update_leaves))


# --------------------------------------------------------------------- adam
def adamw(lr_fn, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": _zeros_f32(params), "v": _zeros_f32(params)}

    def update_leaves(grad_for, state, params, step):
        t = step + 1
        hp = AdamW(lr_fn(step), b1, b2, eps, 1.0 - b1 ** t, 1.0 - b2 ** t,
                   weight_decay)
        fm, fv = flatten(state["m"]), flatten(state["v"])
        for path, p in flatten(params).items():
            noise_update(grad_for(path, p), p, fm[path], fv[path], hp)
        return params, state

    return Optimizer(init, update_leaves, _materialized(update_leaves))


# ----------------------------------------------------------------- registry
def make_optimizer(name: str, lr_fn, weight_decay: float = 0.0,
                   **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr_fn, weight_decay=weight_decay, **kw)
    if name == "adamw":
        return adamw(lr_fn, weight_decay=weight_decay, **kw)
    raise NotImplementedError(
        f"optimizer {name!r} is not ported yet (ported: sgd, adamw; "
        "ROADMAP Queue 1 items 6 and 10)")
