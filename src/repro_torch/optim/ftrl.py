"""Momentum DP-FTRL (Kairouz et al. 2021, "Practical and Private (Deep)
Learning without Sampling or Shuffling") in gradient-prefix + tree-noise-
prefix form (counterpart of ``repro/optim/ftrl.py``):

    S_t     = sum_{s<=t} (g_s + [N(s) - N(s-1)])   # = G_t + N(t)
    m_t     = beta * m_{t-1} + S_t                 # momentum over prefixes
    theta_t = theta_0 - lr_t * m_t

With the 'tree' noise mechanism each gradient already carries the per-step
increment N(t) - N(t-1), so the running sum is exactly G_t + N(t).

Epoch restarts (``restart_every=E``): at step t with t % E == 0 (t > 0,
BEFORE consuming that step's gradient) the optimizer rebases: theta_0 <-
theta_{t-1}, S <- 0, m <- 0. Pair it with ``PrivacyPolicy.
noise_restart_every=E`` so the tree restarts at the same boundary. The
step is a Python int, so the restart test runs on the host.

State is three param-shaped f32 trees (sum / m / theta0). Each leaf's step
is one ``kernels.noise_update`` call with the ``FTRL`` record: on the card
one launch that draws the leaf's (tree) noise and applies the step, on the
CPU its plain version. Like every optimizer of the port, it updates the
state and the params in place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.noise_update import FTRL, noise_update
from repro_torch.optim.optimizers import Optimizer, _materialized, _zeros_f32
from repro_torch.utils.tree import flatten, unflatten

F32 = torch.float32


def epoch_of(step: int, restart_every: int) -> int:
    """Which restart epoch (tree index) absolute ``step`` falls in: a pure
    function of the absolute step, so resuming mid-epoch needs no extra
    state."""
    return int(step) // restart_every if restart_every > 0 else 0


def ftrl(lr_fn, momentum: float = 0.0, restart_every: int = 0,
         weight_decay: float = 0.0) -> Optimizer:
    """Momentum DP-FTRL. ``weight_decay`` must be 0: FTRL's iterate is an
    anchor-plus-prefix form with no decoupled-decay analogue."""
    if weight_decay:
        raise ValueError("DP-FTRL has no decoupled weight decay "
                         f"(got weight_decay={weight_decay}); use 0")
    if restart_every < 0:
        raise ValueError(f"restart_every must be >= 0, got {restart_every}")

    def init(params):
        # a copy even for f32 params: the anchor must never alias p, which
        # the step overwrites in place
        return {"sum": _zeros_f32(params), "m": _zeros_f32(params),
                "theta0": unflatten({k: v.detach().to(F32, copy=True)
                                     for k, v in flatten(params).items()})}

    def update_leaves(grad_for, state, params, step):
        step = int(step)
        restart = restart_every > 0 and step > 0 and \
            step % restart_every == 0
        hp = FTRL(lr_fn(step), momentum, restart)
        fs, fm, ft = (flatten(state["sum"]), flatten(state["m"]),
                      flatten(state["theta0"]))
        for path, p in flatten(params).items():
            noise_update(grad_for(path, p), p, fs[path], fm[path], hp,
                         t0=ft[path])
        return params, state

    return Optimizer(init, update_leaves, _materialized(update_leaves))
