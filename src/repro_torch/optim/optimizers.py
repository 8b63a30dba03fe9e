"""Optimizers with a fused per-leaf update: SGD(m), AdamW, LAMB, Adafactor
and DP-FTRL (``optim.ftrl``), as the JAX package's ``repro/optim``.

    opt = make_optimizer("adamw", lr_fn, weight_decay=...)
    state = opt.init(params)
    params, state = opt.update_leaves(grad_for, state, params, step)
    params, state = opt.update(grads, state, params, step)

``update_leaves`` takes ``grad_for(path, param) -> grad leaf`` and walks the
leaves ONCE, producing each gradient immediately before its update, so a
second full-size gradient tree is never live next to the optimizer state.
A grad leaf is a tensor, or a ``core.noise.NoisedLeaf`` (the clipped sum
with its phase-4 noise not yet drawn, ``core.policy.noise_leaf_fn(...,
out="deferred")``).

- sgd, adamw and ftrl: each leaf's update is one ``kernels.noise_update``
  call: on the card one launch that draws the noise and applies the step,
  on the CPU its plain version (the noise by ``counter_noise``'s plain
  version, then the torch chain of the step).
- lamb and adafactor (which the reference also writes outside any Pallas
  kernel): a noised leaf's draw is one ``kernels.counter_noise`` launch
  over the clipped sum in place (its plain version on the CPU), then the
  step is a torch chain; their per-leaf norms and factored moments need
  reductions over the whole leaf.

``update`` takes a materialized gradient tree (the baseline modes') and
delegates to ``update_leaves``, so the two cannot diverge. State is
float32. Unlike the JAX package's functional updates, the port updates the
state and the params IN PLACE (the returned dicts are the ones passed in).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.noise import NoisedLeaf
from repro_torch.kernels.counter_noise import counter_noise
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


def private_grad(g) -> torch.Tensor:
    """A grad leaf as a tensor: a ``NoisedLeaf``'s noise drawn and added
    over its clipped sum in place (one ``counter_noise`` launch on the card,
    its plain version on the CPU); a tensor as given."""
    if not isinstance(g, NoisedLeaf):
        return g
    return counter_noise(g.g, g.hi_keys, g.lo_keys, g.alpha, g.denom,
                         inplace=True)


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


# --------------------------------------------------------------------- lamb
def lamb(lr_fn, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         weight_decay: float = 0.01) -> Optimizer:
    """AdamW's moments, then the step scaled by the layer-wise trust ratio
    ||p|| / ||u|| (1 where either is 0)."""
    def init(params):
        return {"m": _zeros_f32(params), "v": _zeros_f32(params)}

    def update_leaves(grad_for, state, params, step):
        lr, t = lr_fn(step), step + 1
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        fm, fv = flatten(state["m"]), flatten(state["v"])
        for path, p in flatten(params).items():
            g = private_grad(grad_for(path, p)).to(F32)
            m, v = fm[path], fv[path]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            del g
            p32 = p.to(F32)
            u = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
            u.add_(p32, alpha=weight_decay)
            pn, un = p32.square().sum().sqrt(), u.square().sum().sqrt()
            trust = torch.where((pn > 0) & (un > 0), pn / un,
                                torch.ones_like(pn))
            p.copy_(p32 - u.mul_(trust * lr))
        return params, state

    return Optimizer(init, update_leaves, _materialized(update_leaves))


# ---------------------------------------------------------------- adafactor
def adafactor(lr_fn, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Factored second moments for params of two or more dims: O(d + p)
    state instead of O(dp). State keys ``<param>/vr`` and ``<param>/vc``
    (a stacked (L, d, p) weight: vr (L, d), vc (L, p)), else ``<param>/v``,
    as the reference's."""
    def init(params):
        out = {}
        for path, p in flatten(params).items():
            if p.dim() >= 2:
                out[path + "/vr"] = torch.zeros(p.shape[:-1], dtype=F32,
                                                device=p.device)
                out[path + "/vc"] = torch.zeros(
                    p.shape[:-2] + p.shape[-1:], dtype=F32, device=p.device)
            else:
                out[path + "/v"] = torch.zeros_like(p, dtype=F32)
        return {"s": unflatten(out)}

    def update_leaves(grad_for, state, params, step):
        lr, t = lr_fn(step), step + 1.0
        beta = 1.0 - t ** -decay
        fs = flatten(state["s"])
        for path, p in flatten(params).items():
            g = private_grad(grad_for(path, p)).to(F32)
            g2 = g.square().add_(eps)
            if p.dim() >= 2:
                vr, vc = fs[path + "/vr"], fs[path + "/vc"]
                vr.mul_(beta).add_(g2.mean(-1), alpha=1 - beta)
                vc.mul_(beta).add_(g2.mean(-2), alpha=1 - beta)
                denom = (vr / vr.mean(-1, keepdim=True))[..., None] \
                    * vc[..., None, :]
            else:
                v = fs[path + "/v"]
                denom = v.mul_(beta).add_(g2, alpha=1 - beta)
            del g2
            u = g * torch.rsqrt(denom + eps)
            del g, denom
            rms = u.square().mean().sqrt()
            u.div_(torch.clamp(rms / clip_threshold, min=1.0))
            p32 = p.to(F32)
            if weight_decay:
                u.add_(p32, alpha=weight_decay)
            p.copy_(p32 - u.mul_(lr))
        return params, state

    return Optimizer(init, update_leaves, _materialized(update_leaves))


# ----------------------------------------------------------------- registry
def make_optimizer(name: str, lr_fn, weight_decay: float = 0.0,
                   **kw) -> Optimizer:
    """``kw`` passes optimizer-specific knobs through (e.g. DP-FTRL's
    ``momentum`` / ``restart_every``)."""
    if name == "sgd":
        return sgd(lr_fn, weight_decay=weight_decay, **kw)
    if name == "adamw":
        return adamw(lr_fn, weight_decay=weight_decay, **kw)
    if name == "lamb":
        return lamb(lr_fn, weight_decay=weight_decay, **kw)
    if name == "adafactor":
        return adafactor(lr_fn, weight_decay=weight_decay, **kw)
    if name == "ftrl":
        from repro_torch.optim.ftrl import ftrl
        return ftrl(lr_fn, weight_decay=weight_decay, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
