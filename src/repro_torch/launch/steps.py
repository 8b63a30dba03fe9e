"""The train step: ``TrainState`` + ``make_train_step``, on one device or
over a mesh of processes.

``step_fn(state, batch) -> (state, loss)`` runs BK over the logical batch
(microbatched when asked), then the noise-add and the optimizer update in
ONE pass over the leaves (``noise_leaf_fn(..., out="deferred")`` inside
``update_leaves``), so no second full-size gradient tree is live; on the
card each leaf's noise and update are one ``noise_update`` launch. The
baseline modes (nonprivate, opacus, ghostclip, ...) take their private
gradient tree (``accumulated_private_grad``), then ``Optimizer.update``
(one ``noise_update`` launch a leaf, without noise). The profiler ranges
``bk_phases_1_3`` (``core.bk``) and ``phase4_update`` attribute a step's
device time. Step s draws under ``fold_in(state.rng, s)``, as the JAX
package's step does, so its noise is the reference's and a resumed run
replays the same draws.

Over a mesh (``launch.mesh.Mesh``; ``make_train_step(..., mesh=,
opt_name=)``): at rest each rank holds only its block of every param and
optimizer-state leaf, by ``launch.sharding.state_pspecs`` (``shard_tree``
cuts whole leaves). A step gathers the whole params (FSDP-style, one
all-gather a sharded leaf), runs BK on the rank's rows of the global batch
(``core.bk``: one all-reduce a weighted grad over the batch axes), keeps
its block of each all-reduced sum, draws that block's noise shard-local and
updates its blocks of p and the state in one ``noise_update`` launch a leaf
(the kernel's block route). Replicated leaves get the same sum and the same
noise on every rank, so they stay bitwise equal. The 'model' axis shards
storage only: the ranks of one model group compute the same rows with the
same gathered weights, and tensor-parallel matmuls are not ported (ROADMAP
B7b). The baseline modes compute the whole batch on every rank. SGD, AdamW
and DP-FTRL update blocks; LAMB's trust ratio and Adafactor's factored
moments need whole-leaf reductions and refuse a sharded leaf.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.bk import BK_MODES
from repro_torch.core.noise import fold_in, tape_seed
from repro_torch.core.policy import as_policy, noise_leaf_fn, resolve_policy
from repro_torch.optim.accumulate import (accumulated_clipped_sum,
                                          accumulated_private_grad)
from repro_torch.utils.tree import flatten

# optimizers whose update is elementwise in p and the state, so a rank can
# step its blocks alone
BLOCKWISE = ("sgd", "adamw", "ftrl")


@dataclass
class TrainState:
    """Everything a step consumes and produces. ``rng`` is the base key, a
    (k0, k1) pair (``core.noise.prng_key``); each step folds its own index
    in. Over a mesh, params and opt_state hold the rank's blocks."""
    params: dict
    opt_state: dict
    step: int
    rng: tuple


def make_train_step(apply_fn, params_like, opt, dp, microbatch: int = 0,
                    mesh=None, opt_name: str = ""):
    """-> step_fn(state, batch) -> (new_state, loss tensor). With ``mesh``
    the state holds blocks (``opt_name`` names the optimizer, whose state
    the rules table shards) and ``batch`` is the global batch; on a mesh of
    one rank the step is the one-device step, op for op."""
    policy = as_policy(dp)
    res = resolve_policy(policy, flatten(params_like))
    if mesh is None:
        gather, pspecs = (lambda params: params), None
    else:
        from repro_torch.launch import sharding as sh
        pspecs = sh.flat_param_pspecs(params_like, mesh)
        shapes = {p: tuple(v.shape) for p, v in flatten(params_like).items()}
        sharded = [p for p, s in pspecs.items()
                   if mesh.axis_size(sh.spec_axes(s)) > 1]
        if opt_name not in BLOCKWISE and sharded:
            raise NotImplementedError(
                f"{opt_name or 'this optimizer'} over a mesh that shards "
                f"{sharded[0]}: its update reduces over whole leaves; "
                f"sharded steps take {BLOCKWISE} (ROADMAP B7b)")

        def gather(params):
            return sh.gather_tree(params, pspecs, shapes, mesh)

    def step_fn(state: TrainState, batch):
        rng = fold_in(state.rng, state.step)
        params = gather(state.params)
        if policy.mode not in BK_MODES:
            grads, aux = accumulated_private_grad(
                apply_fn, params, batch, rng, policy, microbatch,
                state.step, mesh, pspecs)
            del params
            with torch.profiler.record_function("phase4_update"):
                new_p, opt_state = opt.update(grads, state.opt_state,
                                              state.params, state.step)
            return TrainState(new_p, opt_state, state.step + 1,
                              state.rng), aux["loss"]
        sums, aux, B = accumulated_clipped_sum(
            apply_fn, params, batch, policy, microbatch, tape_seed(rng),
            mesh)
        del params
        leaf = noise_leaf_fn(policy, res, rng, float(B), state.step,
                             out="deferred", mesh=mesh, pspecs=pspecs)
        # each clipped sum is dropped as soon as its leaf is updated (its
        # noise is drawn inside the update's pass)
        with torch.profiler.record_function("phase4_update"):
            new_p, opt_state = opt.update_leaves(
                lambda path, p: leaf(path, sums.pop(path)),
                state.opt_state, state.params, state.step)
        return TrainState(new_p, opt_state, state.step + 1,
                          state.rng), aux["loss"]

    return step_fn
