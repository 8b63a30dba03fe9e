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
through the hand-written kernels (``repro_torch.kernels``).

Streaming: a clip unit of scope 'layer' closes over ONE tap, so its phases
2 and 3 run at that tap: one ``fused_clip_grad`` launch (the contraction
a^T ds once, for the norm and the weighted grad), or the composed norm ->
clip -> weighted grad where ``kernels.dispatch.fused_plan`` says 'split'.
Nothing of the tap is held between the phases. ``REPRO_STREAM=0`` turns
streaming off (the two-phase flow everywhere; parity tests diff the two).

Tape residency: every other tap's book-kept state (its activation record
and its cotangent) is held between the phases as ``tape_policy`` and the
ParamGroup ``tape`` overrides say (``core.tape.TAPE_POLICIES``): native,
bf16, int8, or not at all ('recompute': the cotangent dies at its norm and
phase 3 re-derives the unit's weighted gradients with a reweighted-loss
backward, ``tape_chunks`` chunks per unit).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from repro_torch.core import ghost
from repro_torch.core.noise import path_seed, tape_seed
from repro_torch.core.policy import (as_policy, norm_aux, resolve_policy,
                                     unit_clip_factors)
from repro_torch.core.tape import (Tape, load_record, parse_key,
                                   store_record, tap_w)
from repro_torch.kernels import dispatch
from repro_torch.kernels.clipped_grad import clipped_grad
from repro_torch.kernels.emb_grad import emb_clipped_grad
from repro_torch.kernels.emb_norm import emb_ghost_norm
from repro_torch.kernels.fused_clip import fused_clip_grad
from repro_torch.kernels.ghost_norm import ghost_norm
from repro_torch.kernels.grad_norm_direct import grad_norm_direct
from repro_torch.kernels.moe_ghost import (moe_clipped_grad, moe_direct_norm,
                                           moe_ghost_norm)
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
    tape_policy: str = "native"      # tap-record residency between phases
                                     # 2-3 (core.tape.TAPE_POLICIES)
    tape_chunks: int = 1             # phase-3 re-derivation chunks (recompute)


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
    return ({k: _struct(v) for k, v in tape.outs.items()},
            {k: _struct(v) for k, v in tape.acts.items()})


def _struct(x):
    """A tap output or record -> (shape, dtype); a stacked tap's per-layer
    list gets its (L, ...) shape, a dict record one struct per entry."""
    if isinstance(x, list):
        return (torch.Size((len(x), *x[0].shape)), x[0].dtype)
    if isinstance(x, dict):          # moe record {'a', 'mask'}
        return {k: _struct(v) for k, v in x.items()}
    return (x.shape, x.dtype)


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
def norm_route(kind: str, act_shape, ds_shape, mode: str, method: str = "",
               allow_cache: bool = True) -> str:
    """How :func:`record_sq_norm` takes a tap's norm: 'ghost', 'direct', or
    'cache' (bk-mixopt instantiates a direct mm tap's per-sample grads and
    reuses them in phase 3, when they fit ``ghost.MAP_THRESHOLD``)."""
    plan = dispatch.norm_plan(kind, act_shape, ds_shape, mode, method)
    if kind != "mm" or plan.method == "ghost":
        return plan.method
    B, d, p = act_shape[-3], act_shape[-1], ds_shape[-1]
    L = act_shape[0] if len(act_shape) == 4 else 1
    if mode == "bk-mixopt" and allow_cache and \
            L * B * d * p <= ghost.MAP_THRESHOLD:
        return "cache"
    return "direct"


def record_sq_norm(key: str, act, ds, mode: str, use_kernels: bool,
                   method: str = "", allow_cache: bool = True):
    """Per-sample squared norm for one tapped op -> (sq (B,), cached).

    The route (:func:`norm_route`) fixes ghost-vs-direct (mode 'bk' forces
    ghost; a ParamGroup ``method`` override wins). ``cached`` optionally
    carries the instantiated per-sample grads for mixopt's phase-3 reuse."""
    _, kind, _ = parse_key(key)
    if kind == "mm":
        route = norm_route("mm", act.shape, ds.shape, mode, method,
                           allow_cache)
        if route == "ghost":
            if use_kernels:
                return ghost_norm(act, ds), None
            return ghost.sq_norm_mm_ghost(act, ds), None
        if route == "cache":
            # mixopt's defining move (paper Sec 3.3): instantiate once,
            # reuse for module 5 in phase 3 (only when cheap to keep)
            eq = "lbtd,lbtp->lbdp" if act.dim() == 4 else "btd,btp->bdp"
            g = torch.einsum(eq, act.to(F32), ds.to(F32))
            axes = tuple(i for i in range(g.dim())
                         if i != (1 if g.dim() == 4 else 0))
            return torch.sum(g * g, dim=axes), g
        if use_kernels:
            return grad_norm_direct(act, ds), None
        return ghost.sq_norm_mm_direct(act, ds), None
    if kind == "emb":
        if use_kernels:
            return emb_ghost_norm(act, ds), None
        return ghost.sq_norm_emb(act, ds), None
    if kind == "moe":
        a, mask = act["a"], act["mask"]
        if norm_route("moe", a.shape, ds.shape, mode, method) == "ghost":
            fn = moe_ghost_norm if use_kernels else ghost.sq_norm_moe_ghost
        else:
            fn = moe_direct_norm if use_kernels else ghost.sq_norm_moe_direct
        return fn(a, mask, ds), None
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
    if kind == "moe":
        if use_kernels:
            return moe_clipped_grad(act["a"], act["mask"], C,
                                    ds).to(out_dtype)
        return ghost.weighted_grad_moe(act["a"], act["mask"], C, ds,
                                       out_dtype)
    raise ValueError(f"unknown tap kind in key {key!r}")


# ------------------------------------------------------------ tape residency
def resolve_tape(policy, res, tap_struct, act_struct) -> dict:
    """Per active tap, its residency store: the ParamGroup ``tape``
    override, else the policy's ``tape_policy``, with 'auto' resolved by
    ``kernels.dispatch.tape_plan``. Structs are (shape, dtype) as
    :func:`tap_act_structs` gives them."""
    out = {}
    for key in sorted(tap_struct):
        wpath = tap_w(key)
        if wpath in res.frozen:
            continue
        pol = res.group_of[wpath].tape or policy.tape_policy
        if pol == "auto":
            kind = parse_key(key)[1]
            a = act_struct[key]["a"] if kind == "moe" else act_struct[key]
            shape, dtype = tap_struct[key]
            pol = dispatch.tape_plan(kind, a[0], shape,
                                     itemsize=dtype.itemsize).store
        out[key] = pol
    return out


def _streamed_taps(res, active_taps) -> frozenset:
    """Taps whose clip unit streams: scope='layer' units, each of which
    closes over exactly this one tap's cotangent. A flat or group unit that
    happens to own one tap keeps the two-phase flow. ``REPRO_STREAM=0``
    turns streaming off everywhere."""
    if os.environ.get("REPRO_STREAM", "1") == "0":
        return frozenset()
    out = set()
    for key in active_taps:
        wpath = tap_w(key)
        if res.group_of[wpath].scope == "layer" and \
                res.units[res.unit_of[wpath]].paths == (wpath,):
            out.add(key)
    return frozenset(out)


def plan_report(apply_fn, params, batch, cfg) -> dict:
    """Per active tap, from one forward on the meta device (no compute):
    {'norm': dispatch.Plan, 'fused': dispatch.Plan (streamed taps only),
    'grad': what computes its weighted gradient, 'tape': dispatch.TapePlan
    (a streamed tap's store is 'stream', with nothing held)}.

    'grad' is 'fused_clip_grad', 'cache' (bk-mixopt's instantiated
    per-sample grads), 'reweighted_backward' (a 'recompute' tap), the
    weighted-grad kernel's name, or 'plain' when ``use_kernels`` is off."""
    policy = as_policy(cfg)
    taps, acts = tap_act_structs(apply_fn, params, batch)
    res = resolve_policy(policy, flatten(params))
    active = sorted(k for k in taps if tap_w(k) not in res.frozen)
    tape_pol = resolve_tape(policy, res, {k: taps[k] for k in active}, acts)
    stream = _streamed_taps(res, active)
    report = {}
    for key in active:
        kind = parse_key(key)[1]
        method = res.method_for(tap_w(key))
        a_shape = (acts[key]["a"] if kind == "moe" else acts[key])[0]
        ds_shape, ds_dtype = taps[key]
        plans = {"norm": dispatch.norm_plan(kind, a_shape, ds_shape,
                                            policy.mode, method)}
        store = "stream" if key in stream else tape_pol[key]
        if key in stream:
            fused = _fused(kind, a_shape, ds_shape, policy, method)
            plans["fused"] = dispatch.Plan("fused" if fused else "split")
        if "fused" in plans and plans["fused"].method == "fused":
            grad = "fused_clip_grad"
        elif store == "recompute":
            grad = "reweighted_backward"
        elif kind == "mm" and norm_route(
                kind, a_shape, ds_shape, policy.mode, method,
                allow_cache=store in ("native", "stream")) == "cache":
            grad = "cache"
        elif not policy.use_kernels:
            grad = "plain"
        else:
            grad = f"{'' if kind == 'mm' else kind + '_'}clipped_grad"
        plans["grad"] = grad
        plans["tape"] = dispatch.tape_plan(kind, a_shape, ds_shape, store,
                                           itemsize=ds_dtype.itemsize)
        report[key] = plans
    return report


def _fused(kind, a_shape, ds_shape, policy, method) -> bool:
    """Whether a streamed tap takes one ``fused_clip_grad`` launch (what
    runs, so the kernels must be on), or the composed route."""
    return policy.use_kernels and dispatch.fused_plan(
        kind, a_shape, ds_shape, policy.mode, method).method == "fused"


def _gen(device, seed: int, path: str) -> torch.Generator:
    """The int8 store's rounding draws for one path (``noise.path_seed``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(path_seed(seed, 0, path))
    return gen


# ------------------------------------------------------------------- BK core
def bk_clipped_sum(apply_fn, params, batch, cfg, seed: int = 0):
    """Phases 1-3 of BK: the pre-noise clipped gradient SUM (flat dict of
    tensors in the params' dtypes) and the aux dict (loss, per-sample norms,
    per-unit norms and clip factors).

    ``cfg`` is a DPConfig or PrivacyPolicy; each clipping unit of the
    resolved policy gets its own per-sample norm accumulator and clip factor
    C_i^(u). Frozen-group params take no grad and come back as zeros. This
    is the accumulation unit for the physical/logical batch split: sum over
    microbatches, then noise once per logical batch. ``seed`` keys the int8
    store's stochastic rounding."""
    policy = as_policy(cfg)
    if policy.mode not in BK_MODES:
        raise ValueError(f"mode must be one of {BK_MODES}, got "
                         f"{policy.mode!r}")
    # detached: no weight may require grad, or autograd would bring back
    # the parameter-gradient matmuls the ghost trick removes
    flat_params = {k: v.detach() for k, v in flatten(params).items()}
    res = resolve_policy(policy, flat_params)
    psp_active = sorted(p for p in flat_params
                        if not p.endswith("/w") and p not in res.frozen)

    def act_store(key):
        # recompute / auto keep activations native: they are the standard
        # tape, which the reweighted backward does not read either
        g = res.group_of.get(tap_w(key))
        pol = (g.tape if g is not None else "") or policy.tape_policy
        return "native" if pol in ("recompute", "auto") else pol

    int8 = "int8" in (policy.tape_policy, *(g.tape for g in policy.groups))
    device = next(iter(batch.values())).device
    # a profiler range (chip_smoke's profiles read its device time)
    with torch.profiler.record_function("bk_phases_1_3"):
        losses, tape, grads = tapped_backward(
            apply_fn, flat_params, batch, res, psp_active, act_store,
            _gen(device, seed, "acts") if int8 else None)
        with torch.no_grad():
            return _book_kept_sums(apply_fn, batch, policy, res,
                                   flat_params, psp_active, tape, losses,
                                   grads, seed)


def tapped_backward(apply_fn, flat_params, batch, res, psp_active,
                    store=None, gen=None):
    """Phase 1: one forward with the vector params ``psp_active`` broadcast
    per sample (leaves that require grad, the psp route) and a tap on every
    active op, then ONE autograd.grad for the tap cotangents and the
    per-sample vector-param grads. Records take their residency form
    (``store``, ``gen``: :class:`Tape`) as they are recorded. -> (losses
    (B,), detached; the tape; the grads: the stacked taps' per-layer pieces
    in sorted-key order, then the psp grads)."""
    B = batch_size_of(batch)
    with torch.enable_grad():
        psp0 = {p: flat_params[p].expand(B, *flat_params[p].shape)
                .clone().requires_grad_() for p in psp_active}
        merged = dict(flat_params)
        merged.update(psp0)
        tape = Tape(active=lambda key: tap_w(key) not in res.frozen,
                    per_sample=psp0, store=store, gen=gen)
        losses = apply_fn(unflatten(merged), batch, tape)
        targets = []
        for key in sorted(tape.outs):
            out = tape.outs[key]
            targets.extend(out if isinstance(out, list) else [out])
        grads = list(torch.autograd.grad(
            losses.sum(), targets + [psp0[p] for p in psp_active],
            allow_unused=True, materialize_grads=True))
    return losses.detach(), tape, grads


def _book_kept_sums(apply_fn, batch, policy, res, flat_params, psp_active,
                    tape, losses, grads, seed):
    """Phases 2-3 of :func:`bk_clipped_sum` on the phase-1 records and
    cotangents (``grads``: the stacked taps' per-layer pieces in tape order,
    then the psp grads)."""
    B, device = losses.shape[0], losses.device
    mode, use_kernels = policy.mode, policy.use_kernels
    active_taps = sorted(tape.outs)
    tap_struct = {k: _struct(v) for k, v in tape.outs.items()}
    tape.outs.clear()
    split_param_paths(flat_params, tape.acts)   # validates the tap/param map
    acts = {k: tape.acts[k] for k in active_taps}
    tape_pol = resolve_tape(policy, res, tap_struct,
                            {k: _struct(v) for k, v in acts.items()})
    stream_keys = _streamed_taps(res, active_taps)
    n_tap = sum(tap_struct[k][0][0] if parse_key(k)[2] else 1
                for k in active_taps)          # per-layer pieces count
    g_psp = dict(zip(psp_active, grads[n_tap:]))
    del grads[n_tap:]

    # ---- phase 2: per-unit per-sample norms, one tap at a time; streamed
    # taps also emit their weighted grad here, and every cotangent is
    # dropped or stored the moment its norm is taken
    sq = [torch.zeros(B, dtype=F32, device=device) for _ in res.units]
    held, cache, flat_grads = {}, {}, {}
    i = 0
    for key in active_taps:
        path, kind, stacked = parse_key(key)
        wpath = path + "/w"
        if stacked:
            # the per-layer cotangents are copied once into the (L,B,T,p)
            # layout the kernels read — the one extra copy of the
            # cotangents the engine makes; the pieces die with the stack
            n = tap_struct[key][0][0]
            ds = torch.stack(grads[i:i + n])
            grads[i:i + n] = [None] * n
            i += n
        else:
            ds = grads[i].contiguous()
            grads[i] = None
            i += 1
        method, u = res.method_for(wpath), res.unit_of[wpath]
        stored = acts.pop(key)
        # a stored record is loaded back to the cotangent's dtype (a tap's
        # input and output share the model dtype), so each kernel reads one
        # record dtype; int8 records are dequantized here
        act = load_record(stored, ds.dtype)
        if key in stream_keys:
            flat_grads[wpath] = _stream_unit(key, act, ds, res.units[u], sq,
                                             u, policy, method,
                                             flat_params[wpath])
            continue
        pol = tape_pol[key]
        nk, cache[key] = record_sq_norm(key, act, ds, mode, use_kernels,
                                        method, allow_cache=(pol == "native"))
        sq[u] = sq[u] + nk
        if pol != "recompute":
            held[key] = (stored, store_record(
                ds, pol, _gen(device, seed, key + "/ds")
                if pol == "int8" else None), ds.dtype)
        del act, ds, stored
    for p in psp_active:
        g = g_psp[p].to(F32)
        u = res.unit_of[p]
        sq[u] = sq[u] + torch.sum(g * g, dim=tuple(range(1, g.dim())))
    unit_norms, unit_C = unit_clip_factors(res, sq)

    # ---- phase 3: weighted gradients of the held taps (records dropped as
    # they are used), then the reweighted backward of the recompute taps
    for key in active_taps:
        if key not in held:
            continue
        path, kind, _ = parse_key(key)
        wpath = path + "/w"
        w = flat_params[wpath]
        stored_act, stored_ds, dtype = held.pop(key)
        flat_grads[wpath] = record_weighted_grad(
            key, load_record(stored_act, dtype), load_record(stored_ds, dtype),
            unit_C[res.unit_of[wpath]], cache.pop(key), use_kernels, w.dtype,
            w.shape[-2] if kind == "emb" else 0)
    rec = [tap_w(k) for k in active_taps
           if k not in stream_keys and tape_pol[k] == "recompute"]
    flat_grads.update(_reweighted_grads(apply_fn, batch, flat_params, res,
                                        rec, unit_C, policy.tape_chunks))
    for p in psp_active:
        g = g_psp.pop(p)
        flat_grads[p] = torch.einsum("b...,b->...", g.to(F32),
                                     unit_C[res.unit_of[p]]).to(
                                         flat_params[p].dtype)
    for p in res.frozen:
        flat_grads[p] = torch.zeros_like(flat_params[p])
    return flat_grads, norm_aux(res, losses, sq, unit_norms, unit_C)


def _stream_unit(key, act, ds, unit, sq, u, policy, method, w):
    """Phases 2+3 of a streamed single-tap unit ``u`` at its tap: adds the
    tap's norm into ``sq[u]`` and returns the weighted gradient. One
    ``fused_clip_grad`` where ``fused_plan`` says so (and the kernels are
    on); else the composed route, op for op the two-phase flow's."""
    kind = parse_key(key)[1]
    B = sq[u].shape[0]
    a_shape = act["a"].shape if kind == "moe" else act.shape
    if _fused(kind, a_shape, ds.shape, policy, method):
        G, nk = fused_clip_grad(act, ds,
                                torch.ones(B, dtype=F32, device=ds.device),
                                unit.clipping, unit.R, unit.gamma)
        sq[u] = sq[u] + nk
        return G.to(w.dtype)
    nk, cached = record_sq_norm(key, act, ds, policy.mode, policy.use_kernels,
                                method, allow_cache=True)
    sq[u] = sq[u] + nk
    C = unit.clip_fn()(torch.sqrt(sq[u])).to(F32)
    return record_weighted_grad(key, act, ds, C, cached, policy.use_kernels,
                                w.dtype, w.shape[-2] if kind == "emb" else 0)


def _reweighted_grads(apply_fn, batch, flat_params, res, wpaths, unit_C,
                      chunks: int) -> dict:
    """Phase 3 of the 'recompute' taps (weight paths ``wpaths``): for clip
    unit u, grad_w sum_i C_i^(u) L_i = sum_i C_i^(u) g_i[w]. Per unit, in
    ``chunks`` chunks: one fresh forward through an untapped Tape in which
    only the chunk's weights require grad (every other weight stays
    detached, so autograd builds no other weight-gradient matmul), and one
    ``torch.autograd.grad`` of sum(losses * C_u), C_u a constant."""
    out = {}
    for u in range(len(res.units)):
        mine = [p for p in wpaths if res.unit_of[p] == u]
        if not mine:
            continue
        size = -(-len(mine) // max(1, min(chunks, len(mine))))
        C_u = unit_C[u].detach()
        for lo in range(0, len(mine), size):
            group = mine[lo:lo + size]
            with torch.enable_grad():
                merged = dict(flat_params)
                for p in group:
                    merged[p] = flat_params[p].detach().requires_grad_()
                losses = apply_fn(unflatten(merged), batch, Tape.null())
                gw = torch.autograd.grad(torch.sum(losses * C_u),
                                         [merged[p] for p in group])
            for p, g in zip(group, gw):
                out[p] = g.to(flat_params[p].dtype)
            del merged, losses, gw
    return out


def bk_private_grad(apply_fn, params, batch, rng, cfg, step=None):
    """Private gradient via Book-Keeping: clipped sum + noise + 1/B scale.
    ``rng`` is the step's key ((k0, k1), ``core.noise``); ``step`` feeds
    stateful noise mechanisms (the tree raises without it). Returns (grads
    matching the params tree, aux)."""
    from repro_torch.core.policy import noise_leaf_fn
    policy = as_policy(cfg)
    B = batch_size_of(batch)
    flat_sums, aux = bk_clipped_sum(apply_fn, params, batch, policy,
                                    seed=tape_seed(rng))
    res = resolve_policy(policy, flatten(params))
    leaf = noise_leaf_fn(policy, res, rng, float(B), step, out="inplace")
    return unflatten({p: leaf(p, g) for p, g in flat_sums.items()}), aux
