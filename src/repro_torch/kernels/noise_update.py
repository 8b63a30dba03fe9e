"""noise_update: phase-4 noise and the optimizer step of one leaf in one CUDA
pass.

    gn = (g + alpha * (sum_hi z(key) - sum_lo z(key))) / denom
    AdamW: m, v, p <- the step on gn;  SGD (momentum): m, p <- the step on gn

``g`` is a leaf's clipped sum given as a :class:`core.noise.NoisedLeaf`
(the record a mechanism's ``add_leaf(..., out="deferred")`` returns: the sum,
its keys, alpha and denom, not yet drawn) or as a tensor taken as it is
(frozen leaves, sigma = 0, the baseline modes' materialized trees). m, v
and p are updated in place. The draw is ``counter_noise``'s, bit for bit;
the step is the JAX package's ``repro/optim/optimizers.py`` sgd and adamw.
Source: ``csrc/noise_update.cu`` with the warp draw of
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
                        g.start, g.trail)
    return g


def plain(g, p: torch.Tensor, m: torch.Tensor, v, hp) -> None:
    """The kernel's function in plain torch, in place: :func:`gradient`,
    then the optimizer's torch chain."""
    g = gradient(g).to(F32)
    if isinstance(hp, SGD):
        m.mul_(hp.momentum).add_(g)
        _apply(p, m.clone(), hp.lr, hp.weight_decay)
        return
    m.mul_(hp.b1).add_(g, alpha=1 - hp.b1)
    v.mul_(hp.b2).addcmul_(g, g, value=1 - hp.b2)
    del g
    upd = (m / hp.bc1).div_((v / hp.bc2).sqrt_().add_(hp.eps))
    _apply(p, upd, hp.lr, hp.weight_decay)


def noise_update(g, p: torch.Tensor, m: torch.Tensor, v, hp) -> None:
    """One leaf's phase 4 and optimizer step, in place over m, v (AdamW;
    None for SGD) and p. ``g``: a ``NoisedLeaf`` or a tensor (no noise);
    g and p each f32 or bf16, m and v f32, all contiguous. One launch on a
    CUDA parameter; the plain version on a CPU one."""
    if p.device.type == "cpu":
        plain(g, p, m, v, hp)
        return
    rec = g if isinstance(g, noise.NoisedLeaf) else None
    leaf = rec.g if rec is not None else g
    adamw = isinstance(hp, AdamW)
    g_bf16 = build.check_inputs("noise_update", (leaf,),
                                f32=(m, v) if adamw else (m,))
    p_bf16 = build.check_inputs("noise_update", (p,), f32=(m,))
    if not leaf.numel() == p.numel() == m.numel() or \
            (adamw and v.numel() != p.numel()):
        raise ValueError(f"noise_update: the leaf, p, m and v must match in "
                         f"size, got {leaf.shape}, {p.shape}, {m.shape}"
                         + (f", {v.shape}" if adamw else ""))
    hi, lo = (list(rec.hi_keys), list(rec.lo_keys)) if rec else ([], [])
    if len(hi) + len(lo) > cn.MAX_KEYS:
        raise ValueError(f"noise_update takes at most {cn.MAX_KEYS} keys, "
                         f"got {len(hi) + len(lo)}")
    if p.numel() == 0:
        return
    words = [int(w) & noise.M32 for key in hi + lo for w in key]
    keys = (ctypes.c_uint32 * max(1, len(words)))(*words)
    if rec is not None:
        alpha = cn._scalar(rec.alpha, leaf.dtype)
        denom = cn._scalar(rec.denom, leaf.dtype)
        start, trail = rec.start, rec.trail
    else:
        alpha, denom, start, trail = 0.0, 1.0, 0, 1
    if adamw:
        opt = (hp.lr, hp.b1, 1 - hp.b1, hp.b2, 1 - hp.b2, hp.eps, hp.bc1,
               hp.bc2)
    else:
        opt = (hp.lr, hp.momentum, 1.0, 0.0, 0.0, 0.0, 1.0, 1.0)
    hyper = (ctypes.c_float * 11)(alpha, denom, *opt, hp.weight_decay)
    build.check(build.load().dp_noise_update(
        leaf.data_ptr(), p.data_ptr(), m.data_ptr(),
        v.data_ptr() if adamw else 0, ctypes.addressof(keys), len(hi),
        len(lo), int(rec is not None), start, trail, p.numel(),
        int(g_bf16), int(p_bf16), int(adamw), ctypes.addressof(hyper),
        build.stream_ptr(p)), "noise_update")
    noise_update.launches += 1


noise_update.launches = 0
