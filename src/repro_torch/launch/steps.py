"""The train step for one device: ``TrainState`` + ``make_train_step``.

``step_fn(state, batch) -> (state, loss)`` runs BK over the logical batch
(microbatched when asked), then the noise-add and the optimizer update in
ONE pass over the leaves (``noise_leaf_fn`` inside ``update_leaves``), so no
second full-size gradient tree is live. The baseline modes (nonprivate,
opacus, ghostclip, ...) take their private gradient tree
(``accumulated_private_grad``), then ``Optimizer.update``. Noise at step s
is a pure function of (state.seed, s), the same in every mode, so a resumed
run replays the same draws. Shardings and buffer donation (the JAX step's
mesh lowering) are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.bk import BK_MODES
from repro_torch.core.noise import path_seed
from repro_torch.core.policy import as_policy, noise_leaf_fn, resolve_policy
from repro_torch.optim.accumulate import (accumulated_clipped_sum,
                                          accumulated_private_grad)
from repro_torch.utils.tree import flatten


@dataclass
class TrainState:
    """Everything a step consumes and produces. ``seed`` is the base noise
    seed; each step mixes its own index in."""
    params: dict
    opt_state: dict
    step: int
    seed: int


def make_train_step(apply_fn, params_like, opt, dp, microbatch: int = 0,
                    noise_draw=None):
    """-> step_fn(state, batch) -> (new_state, loss tensor).

    ``noise_draw(step)``, when given, returns the ``draw(path, shape)`` the
    noise mechanism uses at that step instead of its generator (tests feed
    the JAX package's draws through it)."""
    policy = as_policy(dp)
    res = resolve_policy(policy, flatten(params_like))

    def step_fn(state: TrainState, batch):
        draw = noise_draw(state.step) if noise_draw is not None else None
        if policy.mode not in BK_MODES:
            grads, aux = accumulated_private_grad(
                apply_fn, state.params, batch, state.seed, policy, microbatch,
                state.step, draw)
            params, opt_state = opt.update(grads, state.opt_state,
                                           state.params, state.step)
            return TrainState(params, opt_state, state.step + 1,
                              state.seed), aux["loss"]
        sums, aux, B = accumulated_clipped_sum(
            apply_fn, state.params, batch, policy, microbatch,
            path_seed(state.seed, state.step, "tape"))
        leaf = noise_leaf_fn(policy, res, state.seed, float(B), state.step,
                             draw)
        # each clipped sum is dropped as soon as its leaf is updated
        params, opt_state = opt.update_leaves(
            lambda path, p: leaf(path, sums.pop(path)),
            state.opt_state, state.params, state.step)
        return TrainState(params, opt_state, state.step + 1,
                          state.seed), aux["loss"]

    return step_fn
