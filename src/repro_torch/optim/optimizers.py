"""Optimizers with a fused per-leaf update: SGD(m) and AdamW.

    opt = make_optimizer("adamw", lr_fn, weight_decay=...)
    state = opt.init(params)
    params, state = opt.update_leaves(grad_for, state, params, step)
    params, state = opt.update(grads, state, params, step)

``update_leaves`` takes ``grad_for(path, param) -> grad leaf`` and walks the
leaves ONCE, producing each gradient (e.g. clipped sum + noise,
``core.policy.noise_leaf_fn``) immediately before its update, so a second
full-size gradient tree is never live next to the optimizer state.
``update`` takes a materialized gradient tree (the baseline modes'), and
delegates to ``update_leaves``, so the two cannot diverge. State is
float32. Unlike the JAX package's functional updates, the port updates the
state and the params IN PLACE (the returned dicts are the ones passed in),
which keeps the peak at one leaf's f32 temporaries.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

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


def _apply(p: torch.Tensor, upd: torch.Tensor, lr: float,
           weight_decay: float) -> None:
    """p <- p - lr * (upd + wd * p), computed in f32, stored in p's dtype."""
    p32 = p.to(F32)
    if weight_decay:
        upd.add_(p32, alpha=weight_decay)
    p.copy_(p32.sub_(upd, alpha=lr))


# ---------------------------------------------------------------------- sgd
def sgd(lr_fn, momentum: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": _zeros_f32(params)}

    def update_leaves(grad_for, state, params, step):
        lr = lr_fn(step)
        fm = flatten(state["m"])
        for path, p in flatten(params).items():
            m = fm[path]
            m.mul_(momentum).add_(grad_for(path, p).to(F32))
            _apply(p, m.clone(), lr, weight_decay)
        return params, state

    return Optimizer(init, update_leaves, _materialized(update_leaves))


# --------------------------------------------------------------------- adam
def adamw(lr_fn, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": _zeros_f32(params), "v": _zeros_f32(params)}

    def update_leaves(grad_for, state, params, step):
        lr = lr_fn(step)
        t = step + 1
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        fm, fv = flatten(state["m"]), flatten(state["v"])
        for path, p in flatten(params).items():
            g = grad_for(path, p).to(F32)
            m, v = fm[path], fv[path]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            del g
            upd = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
            _apply(p, upd, lr, weight_decay)
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
