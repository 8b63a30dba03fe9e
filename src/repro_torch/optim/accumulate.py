"""Gradient accumulation with DP semantics (paper footnote 2): the LOGICAL
batch determines accuracy and privacy accounting; the PHYSICAL (micro) batch
only determines memory. Per-sample clipping happens inside each microbatch,
the clipped sums accumulate across microbatches, and noise is added ONCE
per logical batch: by the caller for BK's sums (``core.policy.noise_leaf_fn``
fused into ``Optimizer.update_leaves``), or here for the baseline modes
(``accumulated_private_grad``).

Under a mesh (``launch.mesh.Mesh``) each microbatch is split over the
batch axes (``core.bk.bk_clipped_sum`` takes the rank's rows of it and
all-reduces each weighted grad of the microbatch, in f32), and the reduced
sums accumulate as on one rank; the baseline modes compute the whole batch
on every rank."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.blocks import take_block
from repro_torch.core.bk import (BK_MODES, batch_size_of, bk_clipped_sum,
                                 bk_private_grad)
from repro_torch.core.noise import tape_seed
from repro_torch.core.policy import (as_policy, finalize_noise,
                                     resolve_policy)
from repro_torch.utils.tree import flatten, unflatten


def _microbatches(batch, microbatch: int):
    B = batch_size_of(batch)
    if B % microbatch:
        raise ValueError(f"microbatch {microbatch} must divide batch {B}")
    for lo in range(0, B, microbatch):
        yield lo, {k: v[lo:lo + microbatch] for k, v in batch.items()}


def accumulated_baseline_grad(apply_fn, params, batch, rng, cfg,
                              microbatch: int, step=None, mesh=None,
                              pspecs=None):
    """Microbatched accumulation for the non-BK modes (nonprivate,
    ghostclip, opacus, ...): each microbatch's grad, taken at sigma = 0, is
    scaled back to its sum and accumulated in the params' dtypes; then
    noise once (``finalize_noise``, denominator B), or for nonprivate the
    mean. -> (grads tree, {'loss'}). ``mesh``/``pspecs``: every rank
    computes the whole batch and keeps its blocks."""
    from repro_torch.core.engine import make_grad_fn   # engine imports bk
    policy = as_policy(cfg)
    B = batch_size_of(batch)
    if microbatch <= 0 or microbatch >= B:
        return make_grad_fn(apply_fn, policy, mesh, pspecs)(params, batch,
                                                            rng, step)
    nonprivate = policy.mode == "nonprivate"
    grad_fn = make_grad_fn(apply_fn, policy if nonprivate else
                           dataclasses.replace(policy, sigma=0.0))
    sums, losses = None, []
    for _, mb in _microbatches(batch, microbatch):
        g, aux = grad_fn(params, mb, rng, step)
        g = flatten(g)
        if sums is None:
            sums = {k: torch.zeros_like(v) for k, v in g.items()}
        for k, v in g.items():
            sums[k] = sums[k] + v.to(sums[k].dtype) * float(microbatch)
        losses.append(aux["loss"])
        del g
    if nonprivate:
        grads = {k: s / float(B) for k, s in sums.items()}
        if mesh is not None and pspecs is not None:
            grads = {k: take_block(g, pspecs[k], mesh)[0]
                     for k, g in grads.items()}
    else:
        res = resolve_policy(policy, flatten(params))
        grads = finalize_noise(policy, res, sums, rng, float(B), step, mesh,
                               pspecs)
    return unflatten(grads), {"loss": torch.stack(losses).mean()}


def accumulated_private_grad(apply_fn, params, batch, rng, cfg,
                             microbatch: int, step=None, mesh=None,
                             pspecs=None):
    """The private gradient of the logical batch in any mode, microbatched:
    -> (grads tree, aux), in distribution the full-batch call's. ``rng`` is
    the step's key (``core.noise``). BK modes accumulate clipped sums
    (:func:`accumulated_clipped_sum`) and noise once; the others go through
    :func:`accumulated_baseline_grad`. ``mesh`` lowers BK batch-sharded;
    ``pspecs`` gives each rank its blocks, their noise drawn shard-local."""
    policy = as_policy(cfg)
    if policy.mode not in BK_MODES:
        return accumulated_baseline_grad(apply_fn, params, batch, rng,
                                         policy, microbatch, step, mesh,
                                         pspecs)
    B = batch_size_of(batch)
    if microbatch <= 0 or microbatch >= B:
        return bk_private_grad(apply_fn, params, batch, rng, policy, step,
                               mesh=mesh, pspecs=pspecs)
    sums, aux, _ = accumulated_clipped_sum(apply_fn, params, batch, policy,
                                           microbatch, tape_seed(rng), mesh)
    res = resolve_policy(policy, flatten(params))
    return unflatten(finalize_noise(policy, res, sums, rng, float(B),
                                    step, mesh, pspecs)), aux


def accumulated_clipped_sum(apply_fn, params, batch, cfg, microbatch: int,
                            seed: int = 0, mesh=None):
    """Phases 1-3 over the logical batch -> (flat_sums, aux, B_logical).
    One microbatch's book-keeping is live at a time. ``seed`` keys the int8
    tape store's rounding (offset by each microbatch's first row). Under
    ``mesh`` each rank computes its rows of each microbatch and the sums
    of each microbatch are all-reduced over the batch axes (in f32, then
    cast), as the reference's scan psums each microbatch's sums."""
    policy = as_policy(cfg)
    if policy.mode not in BK_MODES:
        raise ValueError(f"mode must be one of {BK_MODES}, got "
                         f"{policy.mode!r}")
    B = batch_size_of(batch)
    if microbatch <= 0 or microbatch >= B:
        sums, aux = bk_clipped_sum(apply_fn, params, batch, policy, seed,
                                   mesh=mesh)
        return sums, aux, B
    sums, losses, norms = None, [], []
    for lo, mb in _microbatches(batch, microbatch):
        s, aux = bk_clipped_sum(apply_fn, params, mb, policy, seed + lo,
                                mesh=mesh)
        if sums is None:
            sums = s
        else:
            for k in sums:
                sums[k] = sums[k] + s[k]
        losses.append(aux["loss"])
        norms.append(aux["per_sample_norms"])
    aux = {"loss": torch.stack(losses).mean(),
           "per_sample_norms": torch.cat(norms)}
    return sums, aux, B
