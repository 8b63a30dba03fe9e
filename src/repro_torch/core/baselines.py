"""The DP implementations the paper compares BK against (its Table 2).

Each computes the SAME private gradient as BK (same math, another time /
space trade) and honours the whole PrivacyPolicy: per-group clip units,
frozen groups and method overrides. Counterpart of
``repro/core/baselines.py``:

  nonprivate    one backward, no clipping                   (reference point)
  tfprivacy     B single-sample backward passes, a Python loop
  opacus        torch.func.vmap(torch.func.grad(...)): all B per-sample
                grads instantiated
  fastgradclip  per-sample norms from B single-sample backward passes
                (grads discarded), then one backward per clip unit
  ghostclip     ghost norms from one tapped backward (no per-sample weight
                grads), then one backward per clip unit

Group-wise clipping gives each clip unit u its own factor C_i^(u), so the
reweighted-loss trick of fastgradclip / ghostclip (one backward of
sum_i C_i L_i) becomes one backward of the per-sample loss VECTOR per unit
with cotangent C^(u), over one forward whose graph is kept until the last
unit: still no per-sample weight gradient.

Every function is ``fn(apply_fn, params, batch, rng, cfg, step=None) ->
(grads tree, aux)``, ``rng`` the step's key (``core.noise``); phase 4 is
``core.policy.finalize_noise``, the noise ``bk_private_grad`` draws.
"""
from __future__ import annotations

import torch

from repro_torch.core.bk import (batch_size_of, record_sq_norm,
                                 split_param_paths, tapped_backward)
from repro_torch.core.policy import (as_policy, finalize_noise, norm_aux,
                                     resolve_policy, unit_clip_factors)
from repro_torch.core.tape import Tape, parse_key, tap_w
from repro_torch.utils.tree import flatten, unflatten

F32 = torch.float32


def _loss_all(apply_fn, params, batch):
    return apply_fn(params, batch, Tape.null())  # (B,) per-sample losses


def _single(apply_fn, params, sample):
    return _loss_all(apply_fn, params, {k: v[None] for k, v in
                                        sample.items()})[0]


def _detached(params) -> dict:
    return {k: v.detach() for k, v in flatten(params).items()}


def _trainable(flat_params: dict, res) -> list:
    return [p for p in flat_params if p not in res.frozen]


def _leaves(flat_params: dict, names) -> dict:
    """The flat params with the leaves ``names`` made fresh leaves that
    require grad (every other one stays a constant)."""
    return {p: v.detach().requires_grad_() if p in names else v
            for p, v in flat_params.items()}


def _unit_sq_norms(flat_grads, res, B, leading_batch: bool, device):
    """Per-clip-unit per-sample (or scalar) squared norms from a flat grad
    dict; frozen leaves are excluded."""
    sq = [torch.zeros((B,) if leading_batch else (), dtype=F32,
                      device=device) for _ in res.units]
    for p, g in flat_grads.items():
        if p in res.frozen:
            continue
        g = g.to(F32)
        g2 = (g * g).reshape(B, -1).sum(-1) if leading_batch else \
            torch.sum(g * g)
        u = res.unit_of[p]
        sq[u] = sq[u] + g2
    return sq


def _sample_grads(apply_fn, flat_params, names, sample):
    """(loss, {path: grad}) of one sample (batch leaves with B = 1) with
    respect to the leaves ``names``."""
    with torch.enable_grad():
        leaves = _leaves(flat_params, names)
        loss = _loss_all(apply_fn, unflatten(leaves), sample)[0]
        gs = torch.autograd.grad(loss, [leaves[p] for p in names],
                                 allow_unused=True, materialize_grads=True)
    return loss.detach(), dict(zip(names, gs))


def _clip_sum_noise(per_sample, losses, rng, policy, res, flat_params, B,
                    step):
    """The shared tail: per-unit norms -> C^(u) -> weighted sum -> noise.
    ``per_sample`` has a leading B on every trainable leaf."""
    sq = _unit_sq_norms(per_sample, res, B, True, losses.device)
    unit_norms, unit_C = unit_clip_factors(res, sq)
    summed = {}
    for p, v in flat_params.items():
        if p in res.frozen:
            summed[p] = torch.zeros_like(v)
        else:
            summed[p] = torch.einsum("b...,b->...", per_sample.pop(p).to(F32),
                                     unit_C[res.unit_of[p]]).to(v.dtype)
    summed = finalize_noise(policy, res, summed, rng, float(B), step)
    return unflatten(summed), norm_aux(res, losses, sq, unit_norms, unit_C)


def _unit_weighted_grads(apply_fn, flat_params, batch, res, unit_C):
    """sum_i C_i^(u(p)) g_i[p] for every param WITHOUT per-sample grads:
    one forward, then per clip unit one backward of the per-sample loss
    vector with cotangent C^(u), taking that unit's leaves only (the graph
    is kept until the last unit). Frozen leaves come back zero."""
    names = _trainable(flat_params, res)
    out = {}
    with torch.enable_grad():
        leaves = _leaves(flat_params, names)
        losses = _loss_all(apply_fn, unflatten(leaves), batch)
        for u, (unit, C) in enumerate(zip(res.units, unit_C)):
            gs = torch.autograd.grad(
                losses, [leaves[p] for p in unit.paths],
                grad_outputs=C.detach().to(losses.dtype),
                retain_graph=u < len(res.units) - 1, allow_unused=True,
                materialize_grads=True)
            out.update(zip(unit.paths, gs))
    del leaves
    return losses.detach(), {p: out[p] if p in out else torch.zeros_like(v)
                             for p, v in flat_params.items()}


# ----------------------------------------------------------------- baselines
def nonprivate_grad(apply_fn, params, batch, rng, cfg, step=None):
    """The gradient of the mean loss: no clipping, no noise. Frozen groups
    still take no grad (they come back zero)."""
    policy = as_policy(cfg)
    flat = _detached(params)
    res = resolve_policy(policy, flat)
    names = _trainable(flat, res)
    with torch.enable_grad():
        leaves = _leaves(flat, names)
        loss = _loss_all(apply_fn, unflatten(leaves), batch).mean()
        gs = dict(zip(names, torch.autograd.grad(
            loss, [leaves[p] for p in names], allow_unused=True,
            materialize_grads=True)))
    grads = {p: gs[p] if p in gs else torch.zeros_like(v)
             for p, v in flat.items()}
    return unflatten(grads), {"loss": loss.detach()}


def opacus_grad(apply_fn, params, batch, rng, cfg, step=None):
    """vmap(grad): all B per-sample gradients instantiated at once."""
    policy = as_policy(cfg)
    B = batch_size_of(batch)
    flat = _detached(params)
    res = resolve_policy(policy, flat)
    frozen = {p: v for p, v in flat.items() if p in res.frozen}

    def single(train, sample):
        return _single(apply_fn, unflatten({**frozen, **train}), sample)

    train = {p: flat[p] for p in _trainable(flat, res)}
    per_g = torch.func.vmap(torch.func.grad(single), in_dims=(None, 0))(
        train, batch)
    with torch.no_grad():
        losses = _loss_all(apply_fn, unflatten(flat), batch)
    return _clip_sum_noise(per_g, losses, rng, policy, res, flat, B, step)


def tfprivacy_grad(apply_fn, params, batch, rng, cfg, step=None):
    """B sequential single-sample backward passes (memory-light, slow)."""
    policy = as_policy(cfg)
    B = batch_size_of(batch)
    flat = _detached(params)
    res = resolve_policy(policy, flat)
    names = _trainable(flat, res)
    losses, per = [], {p: [] for p in names}
    for b in range(B):
        loss, g = _sample_grads(apply_fn, flat, names,
                                {k: v[b:b + 1] for k, v in batch.items()})
        losses.append(loss)
        for p in names:
            per[p].append(g[p])
    per_g = {p: torch.stack(v) for p, v in per.items()}
    del per
    return _clip_sum_noise(per_g, torch.stack(losses), rng, policy, res,
                           flat, B, step)


def fastgradclip_grad(apply_fn, params, batch, rng, cfg, step=None):
    """Lee & Kifer 2020: per-sample norms (the grads discarded), then a
    second backward of the reweighted loss, one per clip unit."""
    policy = as_policy(cfg)
    B = batch_size_of(batch)
    flat = _detached(params)
    res = resolve_policy(policy, flat)
    names = _trainable(flat, res)
    device = next(iter(batch.values())).device
    rows = []
    for b in range(B):
        _, g = _sample_grads(apply_fn, flat, names,
                             {k: v[b:b + 1] for k, v in batch.items()})
        rows.append(torch.stack(_unit_sq_norms(g, res, B, False, device)))
        del g
    sq_rows = torch.stack(rows)                       # (B, units)
    sq = [sq_rows[:, u] for u in range(len(res.units))]
    unit_norms, unit_C = unit_clip_factors(res, sq)
    losses, summed = _unit_weighted_grads(apply_fn, flat, batch, res, unit_C)
    summed = finalize_noise(policy, res, summed, rng, float(B), step)
    return unflatten(summed), norm_aux(res, losses, sq, unit_norms, unit_C)


def ghostclip_grad(apply_fn, params, batch, rng, cfg, step=None):
    """Li et al. 2021 / Bu et al. 2022a: ghost norms from a tapped first
    backward (no per-sample weight grads; mode 'bk''s rule, so a ParamGroup
    'direct' override is the only direct norm), then a second backward per
    clip unit."""
    policy = as_policy(cfg)
    B = batch_size_of(batch)
    flat = _detached(params)
    res = resolve_policy(policy, flat)
    psp_active = sorted(p for p in flat
                        if not p.endswith("/w") and p not in res.frozen)
    _, tape, grads = tapped_backward(apply_fn, flat, batch, res, psp_active)
    split_param_paths(flat, tape.acts)      # validates the tap/param map
    device = next(iter(batch.values())).device
    sq = [torch.zeros(B, dtype=F32, device=device) for _ in res.units]
    i = 0
    with torch.no_grad():
        for key in sorted(tape.outs):
            out = tape.outs[key]
            n = len(out) if isinstance(out, list) else 1
            ds = torch.stack(grads[i:i + n]) if parse_key(key)[2] \
                else grads[i].contiguous()
            grads[i:i + n] = [None] * n
            i += n
            wpath = tap_w(key)
            nk, _ = record_sq_norm(key, tape.acts.pop(key), ds, "bk",
                                   policy.use_kernels, res.method_for(wpath))
            u = res.unit_of[wpath]
            sq[u] = sq[u] + nk
            del ds
        tape.outs.clear()
        for p, g in zip(psp_active, grads[i:]):
            g = g.to(F32)
            u = res.unit_of[p]
            sq[u] = sq[u] + torch.sum(g * g, dim=tuple(range(1, g.dim())))
    del grads, tape
    unit_norms, unit_C = unit_clip_factors(res, sq)
    losses, summed = _unit_weighted_grads(apply_fn, flat, batch, res, unit_C)
    summed = finalize_noise(policy, res, summed, rng, float(B), step)
    return unflatten(summed), norm_aux(res, losses, sq, unit_norms, unit_C)
