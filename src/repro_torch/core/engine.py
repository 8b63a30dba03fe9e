"""PrivacyEngine: one entry point for all eight DP implementations.

Choose a mode and get back a gradient function with the signature of
non-private training (counterpart of ``repro/core/engine.py``):

    engine = PrivacyEngine(model.apply, DPConfig(mode="bk-mixopt", sigma=...))
    grads, aux = engine.grad(params, batch, rng)

or hand it a :class:`repro_torch.core.policy.PrivacyPolicy` for
per-parameter-group DP (group-wise clipping, frozen groups, per-group
noise scales, the tree mechanism). ``rng`` is the step's key, a (k0, k1)
pair of uint32 ints (``core.noise.prng_key`` / ``fold_in``): every mode
draws the same phase-4 noise for the same (rng, step, path), the JAX
package's noise (``core.policy.finalize_noise`` / ``noise_leaf_fn``).

Modes: 'nonprivate' | 'tfprivacy' | 'opacus' | 'fastgradclip' | 'ghostclip'
     | 'bk' | 'bk-mixghost' | 'bk-mixopt'

``PrivacyEngine(..., target_epsilon=...)`` calibrates sigma by
``core.accounting.budget_for`` and keeps the budget as ``.budget``.
``make_grad_fn(..., mesh, pspecs)`` runs the BK modes batch-sharded over a
``launch.mesh.Mesh`` (``core.bk``), the baselines on the whole batch on
every rank; with ``pspecs`` every mode returns the rank's blocks.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Callable

from repro_torch.core import baselines
from repro_torch.core.accounting import budget_for
from repro_torch.core.bk import BK_MODES, bk_private_grad, plan_report
from repro_torch.core.blocks import take_block
from repro_torch.core.policy import as_policy
from repro_torch.utils.tree import flatten, unflatten

_BASELINES = {
    "nonprivate": baselines.nonprivate_grad,
    "tfprivacy": baselines.tfprivacy_grad,
    "opacus": baselines.opacus_grad,
    "fastgradclip": baselines.fastgradclip_grad,
    "ghostclip": baselines.ghostclip_grad,
}

ALL_MODES = tuple(_BASELINES) + BK_MODES


def make_grad_fn(apply_fn: Callable, cfg, mesh=None,
                 pspecs=None) -> Callable:
    """-> fn(params, batch, rng, step=None) -> (grads, aux). ``cfg`` is a
    DPConfig or a PrivacyPolicy; ``step`` feeds stateful noise mechanisms
    (the tree raises without it). ``mesh``: the BK modes split the batch
    over its batch axes (one all-reduce a weighted grad); ``pspecs``
    ({path: spec}): each grad is the calling rank's block of its leaf."""
    policy = as_policy(cfg)
    if policy.mode in BK_MODES:
        def grad(params, batch, rng, step=None):
            return bk_private_grad(apply_fn, params, batch, rng, policy,
                                   step, mesh=mesh, pspecs=pspecs)
        return grad
    if policy.mode not in _BASELINES:
        raise ValueError(f"unknown mode {policy.mode!r}; options: "
                         f"{ALL_MODES}")
    fn = _BASELINES[policy.mode]

    def grad(params, batch, rng, step=None):
        grads, aux = fn(apply_fn, params, batch, rng, policy, step)
        if mesh is not None and pspecs is not None:
            grads = unflatten({p: take_block(g, pspecs[p], mesh)[0]
                               for p, g in flatten(grads).items()})
        return grads, aux

    return grad


class PrivacyEngine:
    """A gradient function and its kernel plans for one model and policy;
    with ``target_epsilon`` > 0, sigma calibrated to the (epsilon, delta)
    budget of ``epochs`` over ``dataset_size`` samples in batches of
    ``batch_size`` (the SGM accountant), kept as ``.budget``."""

    def __init__(self, apply_fn: Callable, cfg, batch_size: int = 0,
                 dataset_size: int = 0, epochs: float = 0.0,
                 target_epsilon: float = 0.0, delta: float = 1e-5):
        if target_epsilon > 0.0:
            budget = budget_for(target_epsilon, delta, batch_size,
                                dataset_size, epochs)
            cfg = replace(cfg, sigma=budget.sigma)
            self.budget = budget
        else:
            self.budget = None
        self.cfg = cfg
        self.policy = as_policy(cfg)
        self.apply_fn = apply_fn
        self.grad = make_grad_fn(apply_fn, cfg)

    def kernel_report(self, params, batch) -> dict:
        """Per-tap plans (norm, fused, grad, tape) for this model and batch
        shape: ``core.bk.plan_report``, one forward on the meta device, no
        compute. Frozen-group taps are absent."""
        return plan_report(self.apply_fn, params, batch, self.cfg)
