"""noise_update: phase-4 noise and the optimizer step of one leaf in one CUDA
pass.

    gn = (g + alpha * (sum_hi z(key) - sum_lo z(key))) / denom
    AdamW: m, v, p <- the step on gn;  SGD (momentum): m, p <- the step on gn
    FTRL:  s, m, theta0, p <- the DP-FTRL step on gn (restart steps rebase)

``g`` is a leaf's clipped sum given as a :class:`core.noise.NoisedLeaf`
(the record a mechanism's ``add_leaf(..., out="deferred")`` returns: the sum,
its keys, alpha and denom and where it lies in the whole tensor, not yet
drawn; a rank's block under a mesh takes the kernel's block route, its
counters walked along the block's rows) or as a tensor taken as it is
(frozen leaves, sigma = 0, the baseline modes' materialized trees). The
state and p are updated in place. The draw is ``counter_noise``'s, bit for
bit (the record's keys as ``counter_noise.key_plan``: each distinct key
drawn once); the step is the JAX package's ``repro/optim/optimizers.py``
sgd and adamw, or its ``repro/optim/ftrl.py`` (s, m and theta0 bitwise the
plain version's chain on the card).
Source: ``csrc/noise_update.cu`` (a warp's 32 runs of 8 elements drawn
together, then each lane's operands loaded, stepped and stored) with the
warp draw of
``csrc/counter_normal.cuh``; the source says what bounds it on the H100. It
replaces no TPU kernel: the JAX package writes phase 4 and the update in
jnp.

The wrapper runs :func:`plain` for a CPU parameter only (the record's
``counter_noise.plain``, then the torch chain of the update, which is what
the port ran before the kernel); a CUDA parameter launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.core import noise
from repro_torch.kernels import build
from repro_torch.kernels import counter_noise as cn

F32 = torch.float32


@dataclass(frozen=True)
class AdamW:
    """One AdamW step's scalars (bias corrections of step t = step + 1)."""
    lr: float
    b1: float
    b2: float
    eps: float
    bc1: float
    bc2: float
    weight_decay: float = 0.0


@dataclass(frozen=True)
class SGD:
    """One SGD-with-momentum step's scalars."""
    lr: float
    momentum: float
    weight_decay: float = 0.0


@dataclass(frozen=True)
class FTRL:
    """One DP-FTRL step's scalars: ``restart`` rebases the step (s and m
    restart from 0, theta0 takes p) before the gradient is consumed."""
    lr: float
    momentum: float
    restart: bool = False


# the C entry's ``opt`` code of each hyper-parameter record
OPT = {SGD: 0, AdamW: 1, FTRL: 2}


def _apply(p: torch.Tensor, upd: torch.Tensor, lr: float,
           weight_decay: float) -> None:
    """p <- p - lr * (upd + wd * p), computed in f32, stored in p's dtype."""
    p32 = p.to(F32)
    if weight_decay:
        upd.add_(p32, alpha=weight_decay)
    p.copy_(p32.sub_(upd, alpha=lr))


def gradient(g) -> torch.Tensor:
    """The leaf's private gradient: a record's noise drawn and added by
    ``counter_noise``'s plain version, or the tensor as given."""
    if isinstance(g, noise.NoisedLeaf):
        return cn.plain(g.g, g.hi_keys, g.lo_keys, g.alpha, g.denom,
                        g.start, g.trail, g.dims, g.strides)
    return g


def plain(g, p: torch.Tensor, m: torch.Tensor, v, hp, t0=None) -> None:
    """The kernel's function in plain torch, in place: :func:`gradient`,
    then the optimizer's torch chain (FTRL: m is the prefix sum s, v the
    momentum m, t0 the anchor theta0)."""
    g = gradient(g).to(F32)
    if isinstance(hp, FTRL):
        keep = 0.0 if hp.restart else 1.0
        if hp.restart:
            t0.copy_(p)
        m.mul_(keep).add_(g)
        v.mul_(hp.momentum * keep).add_(m)
        p.copy_(torch.sub(t0, v, alpha=hp.lr))
        return
    if isinstance(hp, SGD):
        m.mul_(hp.momentum).add_(g)
        _apply(p, m.clone(), hp.lr, hp.weight_decay)
        return
    m.mul_(hp.b1).add_(g, alpha=1 - hp.b1)
    v.mul_(hp.b2).addcmul_(g, g, value=1 - hp.b2)
    del g
    upd = (m / hp.bc1).div_((v / hp.bc2).sqrt_().add_(hp.eps))
    _apply(p, upd, hp.lr, hp.weight_decay)


def noise_update(g, p: torch.Tensor, m: torch.Tensor, v, hp,
                 t0=None) -> None:
    """One leaf's phase 4 and optimizer step, in place over the state and
    p: AdamW m, v; SGD m (v None); FTRL the prefix sum s as ``m``, the
    momentum as ``v`` and the anchor theta0 as ``t0``. ``g``: a
    ``NoisedLeaf`` or a tensor (no noise); g and p each f32 or bf16, the
    state f32, all contiguous. One launch on a CUDA parameter; the plain
    version on a CPU one."""
    if p.device.type == "cpu":
        plain(g, p, m, v, hp, t0)
        return
    rec = g if isinstance(g, noise.NoisedLeaf) else None
    leaf = rec.g if rec is not None else g
    opt = OPT[type(hp)]
    if opt == OPT[FTRL] and t0 is None:
        raise ValueError("noise_update: an FTRL step needs its anchor t0")
    state = (m,) + ((v,) if opt != OPT[SGD] else ()) + \
        ((t0,) if opt == OPT[FTRL] else ())
    g_bf16 = build.check_inputs("noise_update", (leaf,), f32=state)
    p_bf16 = build.check_inputs("noise_update", (p,), f32=(m,))
    if any(t.numel() != p.numel() for t in (leaf, *state)):
        raise ValueError(f"noise_update: the leaf, p and the state must "
                         f"match in size, got {leaf.shape}, {p.shape}, "
                         + ", ".join(str(t.shape) for t in state))
    hi, lo = (list(rec.hi_keys), list(rec.lo_keys)) if rec else ([], [])
    keys, sides, n_keys = cn.plan_args(hi, lo, "noise_update")
    if p.numel() == 0:
        return
    if rec is not None:
        alpha = cn._scalar(rec.alpha, leaf.dtype)
        denom = cn._scalar(rec.denom, leaf.dtype)
        start, trail = rec.start, rec.trail
    else:
        alpha, denom, start, trail = 0.0, 1.0, 0, 1
    if isinstance(hp, AdamW):
        scal = (hp.lr, hp.b1, 1 - hp.b1, hp.b2, 1 - hp.b2, hp.eps, hp.bc1,
                hp.bc2)
    elif isinstance(hp, FTRL):
        keep = 0.0 if hp.restart else 1.0
        scal = (hp.lr, hp.momentum * keep, keep, 0.0, 0.0, 0.0, 1.0, 1.0)
    else:
        scal = (hp.lr, hp.momentum, 1.0, 0.0, 0.0, 0.0, 1.0, 1.0)
    hyper = (ctypes.c_float * 11)(alpha, denom, *scal,
                                    getattr(hp, "weight_decay", 0.0))
    ptrs = (leaf.data_ptr(), p.data_ptr(), m.data_ptr(),
            v.data_ptr() if opt != OPT[SGD] else 0, ctypes.addressof(keys),
            ctypes.addressof(sides), n_keys)
    tail = (p.numel(), int(g_bf16), int(p_bf16), opt,
            ctypes.addressof(hyper),
            t0.data_ptr() if opt == OPT[FTRL] else 0, build.stream_ptr(p))
    lib = build.lib_for(p)
    if rec is None or not rec.dims:
        build.check(lib.dp_noise_update(
            *ptrs, int(rec is not None), start, trail, *tail),
            "noise_update")
    else:
        # a rank's block: the block route (its geometry, always noised)
        where = cn.geometry_args(rec.geometry)
        build.check(lib.dp_noise_update_block(
            *ptrs, ctypes.addressof(where), trail, *tail), "noise_update")
        noise_update.block_launches += build.counted(lib)
    noise_update.launches += build.counted(lib)


noise_update.launches = 0
noise_update.block_launches = 0     # those of the block route
