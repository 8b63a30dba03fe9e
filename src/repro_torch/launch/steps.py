"""The train step for one device: ``TrainState`` + ``make_train_step``.

``step_fn(state, batch) -> (state, loss)`` runs BK over the logical batch
(microbatched when asked), then the noise-add and the optimizer update in
ONE pass over the leaves (``noise_leaf_fn`` inside ``update_leaves``), so no
second full-size gradient tree is live; on the card each leaf's noise is
one ``counter_noise`` launch, written over its clipped sum. The baseline
modes (nonprivate, opacus, ghostclip, ...) take their private gradient
tree (``accumulated_private_grad``), then ``Optimizer.update``. Step s
draws under ``fold_in(state.rng, s)``, as the JAX package's step does, so
its noise is the reference's and a resumed run replays the same draws.
Shardings and buffer donation (the JAX step's mesh lowering) are not
ported.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.bk import BK_MODES
from repro_torch.core.noise import fold_in, tape_seed
from repro_torch.core.policy import as_policy, noise_leaf_fn, resolve_policy
from repro_torch.optim.accumulate import (accumulated_clipped_sum,
                                          accumulated_private_grad)
from repro_torch.utils.tree import flatten


@dataclass
class TrainState:
    """Everything a step consumes and produces. ``rng`` is the base key, a
    (k0, k1) pair (``core.noise.prng_key``); each step folds its own index
    in."""
    params: dict
    opt_state: dict
    step: int
    rng: tuple


def make_train_step(apply_fn, params_like, opt, dp, microbatch: int = 0):
    """-> step_fn(state, batch) -> (new_state, loss tensor)."""
    policy = as_policy(dp)
    res = resolve_policy(policy, flatten(params_like))

    def step_fn(state: TrainState, batch):
        rng = fold_in(state.rng, state.step)
        if policy.mode not in BK_MODES:
            grads, aux = accumulated_private_grad(
                apply_fn, state.params, batch, rng, policy, microbatch,
                state.step)
            params, opt_state = opt.update(grads, state.opt_state,
                                           state.params, state.step)
            return TrainState(params, opt_state, state.step + 1,
                              state.rng), aux["loss"]
        sums, aux, B = accumulated_clipped_sum(
            apply_fn, state.params, batch, policy, microbatch,
            tape_seed(rng))
        leaf = noise_leaf_fn(policy, res, rng, float(B), state.step,
                             inplace=True)
        # each clipped sum is dropped as soon as its leaf is updated (the
        # noise kernel writes over it)
        params, opt_state = opt.update_leaves(
            lambda path, p: leaf(path, sums.pop(path)),
            state.opt_state, state.params, state.step)
        return TrainState(params, opt_state, state.step + 1,
                          state.rng), aux["loss"]

    return step_fn
