"""The Book-Keeping (BK) engine — Algorithm 1 of the paper, in PyTorch.

One ``torch.autograd.grad`` with respect to (taps, per-sample params)
yields, in a SINGLE back-propagation and without instantiating per-sample
weight gradients:

  * every layer's output gradient dL/ds_(l)      (tap cotangents — book-keeping)
  * per-sample gradients of vector params (B,..) (psp cotangents)

and because the weights themselves do not require grad, autograd never
computes the parameter-gradient matmuls (ghost differentiation).

Phases:
  1. forward + output-grad backward            — modules 1 + 2a
  2. per-sample squared norms per tapped op    — module 3 (ghost) or 4 (direct)
     + vector-param norms; per clip unit; clip factors C_i
  3. weighted gradients G_l = a^T diag(C) ds   — module 2b'/5
  4. Gaussian noise, scale by 1/B (``bk_private_grad``)

Modes:
  'bk'           ghost norm everywhere (base BK)
  'bk-mixghost'  layerwise ghost-vs-direct for the *norm* only
  'bk-mixopt'    layerwise for norm AND weighted grad (reuses instantiated
                 per-sample grads for module 5 when direct is chosen)

With ``use_kernels`` the norms and weighted grads of CUDA records go
through the hand-written kernels (``repro_torch.kernels``); a plan that
needs a kernel not yet ported raises NotImplementedError on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import ghost
from repro_torch.core.policy import (as_policy, norm_aux, resolve_policy,
                                     unit_clip_factors)
from repro_torch.core.tape import Tape, parse_key, tap_w
from repro_torch.kernels import dispatch
from repro_torch.kernels.clipped_grad import clipped_grad
from repro_torch.kernels.emb_grad import emb_clipped_grad
from repro_torch.kernels.emb_norm import emb_ghost_norm
from repro_torch.kernels.ghost_norm import ghost_norm
from repro_torch.utils.tree import flatten, unflatten

F32 = torch.float32

BK_MODES = ("bk", "bk-mixghost", "bk-mixopt")


@dataclass(frozen=True)
class DPConfig:
    clipping: str = "automatic"      # clipping fn name (core.clipping)
    R: float = 1.0                   # clipping threshold / normalizer
    sigma: float = 0.0               # noise multiplier (0 = clipping only)
    mode: str = "bk"                 # 'bk' | 'bk-mixghost' | 'bk-mixopt'
    use_kernels: bool = True         # CUDA kernels (plain torch if False)
    gamma: float = 0.01              # automatic-clipping stability constant


# --------------------------------------------------------------------- utils
def batch_size_of(batch: dict) -> int:
    return next(iter(batch.values())).shape[0]


def tap_act_structs(apply_fn, params, batch):
    """-> ({tap key: (shape, dtype)}, {record key: (shape, dtype)}) from one
    forward on the meta device: shapes only, no compute, no memory."""
    meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
    p_meta = unflatten({k: meta(v) for k, v in flatten(params).items()})
    b_meta = {k: meta(v) for k, v in batch.items()}
    tape = Tape(active=lambda key: True)
    with torch.no_grad():
        apply_fn(p_meta, b_meta, tape)

    def struct(x):
        if isinstance(x, list):
            return (torch.Size((len(x), *x[0].shape)), x[0].dtype)
        return (x.shape, x.dtype)

    return ({k: struct(v) for k, v in tape.outs.items()},
            {k: struct(v) for k, v in tape.acts.items()})


def split_param_paths(flat_params: dict, tap_keys):
    """-> (ghost_w_paths, psp_paths). Ghost leaves are '<tap path>/w'."""
    tapped = {tap_w(k) for k in tap_keys}
    ghost_paths = sorted(p for p in flat_params if p in tapped)
    psp_paths = sorted(p for p in flat_params if p not in tapped)
    missing = tapped - set(flat_params)
    if missing:
        raise ValueError(f"tapped ops without matching '<path>/w' param: "
                         f"{sorted(missing)}")
    dead = [p for p in psp_paths if p.endswith("/w")]
    if dead:
        raise ValueError(
            "untapped weight params (dead or mis-named tap — every '/w' leaf "
            f"must belong to a tapped generalized-linear op): {dead}")
    return ghost_paths, psp_paths


# ------------------------------------------------------------- norm dispatch
def record_sq_norm(key: str, act, ds, mode: str, use_kernels: bool,
                   method: str = "", allow_cache: bool = True):
    """Per-sample squared norm for one tapped op -> (sq (B,), cached).

    The plan fixes ghost-vs-direct (mode 'bk' forces ghost; a ParamGroup
    ``method`` override wins). ``cached`` optionally carries the
    instantiated per-sample grads for mixopt's phase-3 reuse."""
    _, kind, _ = parse_key(key)
    if kind == "mm":
        plan = dispatch.norm_plan("mm", act.shape, ds.shape, mode, method)
        if plan.method == "ghost":
            if use_kernels:
                return ghost_norm(act, ds), None
            return ghost.sq_norm_mm_ghost(act, ds), None
        B, d, p = act.shape[-3], act.shape[-1], ds.shape[-1]
        L = act.shape[0] if act.dim() == 4 else 1
        if mode == "bk-mixopt" and allow_cache and \
                L * B * d * p <= ghost.MAP_THRESHOLD:
            # mixopt's defining move (paper Sec 3.3): instantiate once,
            # reuse for module 5 in phase 3 (only when cheap to keep)
            eq = "lbtd,lbtp->lbdp" if act.dim() == 4 else "btd,btp->bdp"
            g = torch.einsum(eq, act.to(F32), ds.to(F32))
            axes = tuple(i for i in range(g.dim())
                         if i != (1 if g.dim() == 4 else 0))
            return torch.sum(g * g, dim=axes), g
        if use_kernels and act.device.type != "cpu":
            raise NotImplementedError(
                f"tap {key!r} takes the direct norm, which needs the "
                "grad_norm_direct kernel: no CUDA port yet (ROADMAP Queue 2 "
                "item 1); run with use_kernels=False or on the CPU")
        return ghost.sq_norm_mm_direct(act, ds), None
    if kind == "emb":
        if use_kernels:
            return emb_ghost_norm(act, ds), None
        return ghost.sq_norm_emb(act, ds), None
    raise ValueError(f"unknown tap kind in key {key!r}")


def record_weighted_grad(key: str, act, ds, C, cached, use_kernels: bool,
                         out_dtype, vocab: int = 0):
    """Phase-3 weighted gradient G = a^T diag(C) ds for one tap."""
    _, kind, _ = parse_key(key)
    if kind == "mm":
        if cached is not None:  # mixopt module-5 reuse: sum_i C_i g_i
            eq = "lbdp,b->ldp" if cached.dim() == 4 else "bdp,b->dp"
            return torch.einsum(eq, cached, C.to(F32)).to(out_dtype)
        if use_kernels:
            return clipped_grad(act, C, ds).to(out_dtype)
        return ghost.weighted_grad_mm(act, C, ds, out_dtype)
    if kind == "emb":
        if use_kernels:
            return emb_clipped_grad(act, C, ds, vocab).to(out_dtype)
        return ghost.weighted_grad_emb(act, C, ds, vocab, out_dtype)
    raise ValueError(f"unknown tap kind in key {key!r}")


# ------------------------------------------------------------------- BK core
def bk_clipped_sum(apply_fn, params, batch, cfg):
    """Phases 1-3 of BK: the pre-noise clipped gradient SUM (flat dict of
    tensors in the params' dtypes) and the aux dict (loss, per-sample norms,
    per-unit norms and clip factors).

    ``cfg`` is a DPConfig or PrivacyPolicy; each clipping unit of the
    resolved policy gets its own per-sample norm accumulator and clip factor
    C_i^(u). Frozen-group params take no grad and come back as zeros. This
    is the accumulation unit for the physical/logical batch split: sum over
    microbatches, then noise once per logical batch."""
    policy = as_policy(cfg)
    if policy.mode not in BK_MODES:
        raise ValueError(f"mode must be one of {BK_MODES}, got "
                         f"{policy.mode!r}")
    B = batch_size_of(batch)
    # detached: no weight may require grad, or autograd would bring back
    # the parameter-gradient matmuls the ghost trick removes
    flat_params = {k: v.detach() for k, v in flatten(params).items()}
    res = resolve_policy(policy, flat_params)
    psp_active = sorted(p for p in flat_params
                        if not p.endswith("/w") and p not in res.frozen)

    # ---- phase 1: one forward with the vector params broadcast per sample
    # (leaves that require grad, the psp route), then ONE autograd.grad for
    # the tap cotangents and the per-sample vector-param grads
    with torch.enable_grad():
        psp0 = {p: flat_params[p].expand(B, *flat_params[p].shape)
                .clone().requires_grad_() for p in psp_active}
        merged = dict(flat_params)
        merged.update(psp0)
        tape = Tape(active=lambda key: tap_w(key) not in res.frozen,
                    per_sample=psp0)
        losses = apply_fn(unflatten(merged), batch, tape)
        active_taps = sorted(tape.outs)
        targets = []
        for key in active_taps:
            out = tape.outs[key]
            targets.extend(out if isinstance(out, list) else [out])
        grads = list(torch.autograd.grad(
            losses.sum(), targets + [psp0[p] for p in psp_active],
            allow_unused=True, materialize_grads=True))
    with torch.no_grad():
        return _book_kept_sums(policy, res, flat_params, psp_active, tape,
                               losses.detach(), grads)


def _book_kept_sums(policy, res, flat_params, psp_active, tape, losses,
                    grads):
    """Phases 2-3 of :func:`bk_clipped_sum` on the phase-1 records and
    cotangents (``grads``: the stacked taps' per-layer pieces in tape order,
    then the psp grads)."""
    B = losses.shape[0]
    active_taps = sorted(tape.outs)
    tape.outs.clear()
    split_param_paths(flat_params, tape.acts)   # validates the tap/param map
    acts = {k: tape.acts[k] for k in active_taps}
    ds_taps, i = {}, 0
    for key in active_taps:
        if parse_key(key)[2]:
            # stacked taps: the per-layer cotangents are copied once into
            # the (L,B,T,p) layout the kernels read — the one extra copy of
            # the cotangents the engine makes; each tap's per-layer pieces
            # are released as soon as its stack exists
            n = acts[key].shape[0]
            ds_taps[key] = torch.stack(grads[i:i + n])
            grads[i:i + n] = [None] * n
            i += n
        else:
            ds_taps[key] = grads[i].contiguous()
            i += 1
    g_psp = dict(zip(psp_active, grads[i:]))
    del grads

    # ---- phase 2: per-unit per-sample norms + clip factors -----------------
    sq = [torch.zeros(B, dtype=F32, device=losses.device) for _ in res.units]
    cache = {}
    for key in active_taps:
        wpath = tap_w(key)
        nk, cache[key] = record_sq_norm(key, acts[key], ds_taps[key],
                                        policy.mode, policy.use_kernels,
                                        res.method_for(wpath))
        u = res.unit_of[wpath]
        sq[u] = sq[u] + nk
    for p in psp_active:
        g = g_psp[p].to(F32)
        u = res.unit_of[p]
        sq[u] = sq[u] + torch.sum(g * g, dim=tuple(range(1, g.dim())))
    unit_norms, unit_C = unit_clip_factors(res, sq)

    # ---- phase 3: weighted gradients (records dropped as they are used) ----
    flat_grads = {}
    for key in active_taps:
        path, kind, _ = parse_key(key)
        wpath = path + "/w"
        w = flat_params[wpath]
        vocab = w.shape[-2] if kind == "emb" else 0
        flat_grads[wpath] = record_weighted_grad(
            key, acts.pop(key), ds_taps.pop(key), unit_C[res.unit_of[wpath]],
            cache.pop(key), policy.use_kernels, w.dtype, vocab)
    for p in psp_active:
        g = g_psp.pop(p)
        flat_grads[p] = torch.einsum("b...,b->...", g.to(F32),
                                     unit_C[res.unit_of[p]]).to(
                                         flat_params[p].dtype)
    for p in res.frozen:
        flat_grads[p] = torch.zeros_like(flat_params[p])
    return flat_grads, norm_aux(res, losses, sq, unit_norms, unit_C)


def bk_private_grad(apply_fn, params, batch, seed: int, cfg, step: int = 0,
                    draw=None):
    """Private gradient via Book-Keeping: clipped sum + noise + 1/B scale.
    Returns (grads matching the params tree, aux)."""
    from repro_torch.core.policy import noise_leaf_fn
    policy = as_policy(cfg)
    B = batch_size_of(batch)
    flat_sums, aux = bk_clipped_sum(apply_fn, params, batch, policy)
    res = resolve_policy(policy, flatten(params))
    leaf = noise_leaf_fn(policy, res, seed, float(B), step, draw)
    return unflatten({p: leaf(p, g) for p, g in flat_sums.items()}), aux
