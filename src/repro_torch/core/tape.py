"""The tap mechanism: book-keeping + ghost differentiation in PyTorch.

Every generalized-linear op records its activation and marks its output
``s`` as a *tap*. The BK engine runs ONE ``torch.autograd.grad`` with
respect to the taps (and the per-sample vector params): the gradient of a
tap *is* the output gradient dL/ds of that layer, and because the weights do
not require grad, autograd never builds the parameter-gradient matmuls
(module 2b of the paper, "ghost differentiation"). The JAX package adds an
all-zeros tap to each output; here the output tensor itself is the target,
which ``torch.autograd.grad`` accepts for any tensor in the graph and which
costs no extra tensor.

Key naming: ``<path>#<kind>[.s]`` where kind is one of
  mm   — matmul: record = activation a, layouts (B,T,d) / stacked (L,B,T,d)
  emb  — embedding lookup: record = int ids (B,T) / (L,B,T)
  moe  — gathered expert matmul: record = {'a': (B,E,C,d), 'mask': (B,E,C)}
         (each entry stacked to (L, ...) in a stacked scope)
and the ``.s`` suffix marks records stacked over a leading layer axis (the
blocks the JAX package runs under ``lax.scan``; a Python loop here).
The parameter owned by a tapped op lives at ``<path>/w``; all other
parameter leaves are handled by the per-sample-parameter (psp) route.

Tape residency: a record can be held in a smaller form between the BK
phases (``TAPE_POLICIES``). Activations take their stored form at record
time, inside :meth:`Tape.record`, so the stacked (L, ...) copy is built
from the stored per-layer pieces and the native stack never exists.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def parse_key(key: str):
    """-> (param_path, kind, stacked)."""
    path, _, kindpart = key.rpartition("#")
    stacked = kindpart.endswith(".s")
    kind = kindpart[:-2] if stacked else kindpart
    return path, kind, stacked


def tap_w(key: str) -> str:
    """The weight path a tap key owns."""
    return parse_key(key)[0] + "/w"


class Tape:
    """Collects activation records and tap outputs during a forward pass.

    ``active`` is None for an untapped run (records are still collected, for
    structure), or a predicate over tap keys: the outputs of active taps are
    kept as differentiation targets in ``outs`` (a tensor, or a per-layer
    list for stacked keys). A key absent from ``active`` is a frozen-group op.
    ``per_sample`` names the param paths that carry a leading batch axis
    (the psp route), so stacked blocks slice them per layer correctly.
    ``store(key)``, when given, names the residency store of each record
    (``store_record``); ``gen`` draws the int8 store's rounding.
    """

    def __init__(self, active: Optional[Callable[[str], bool]] = None,
                 collect: bool = True, per_sample=frozenset(),
                 store: Optional[Callable[[str], str]] = None,
                 gen: Optional[torch.Generator] = None):
        self.active = active
        self.collect = collect
        self.per_sample = frozenset(per_sample)
        self.store = store
        self.gen = gen
        self.acts: dict = {}
        self.outs: dict = {}
        self._prefix: list = []
        self._stack: Optional[dict] = None   # key -> per-layer acts

    @classmethod
    def null(cls) -> "Tape":
        """Inference tape: records nothing."""
        return cls(None, collect=False)

    # ------------------------------------------------------------------ scope
    class _Scope:
        def __init__(self, tape, name):
            self.tape, self.name = tape, name

        def __enter__(self):
            self.tape._prefix.append(self.name)

        def __exit__(self, *exc):
            self.tape._prefix.pop()

    def scope(self, name: str) -> "_Scope":
        return Tape._Scope(self, name)

    def key(self, name: str, kind: str) -> str:
        key = "/".join(self._prefix + [name]) + "#" + kind
        return key + ".s" if self._stack is not None else key

    # ---------------------------------------------------------------- stacked
    class _Stacked:
        def __init__(self, tape, name):
            self.tape, self.name = tape, name

        def __enter__(self):
            if self.tape._stack is not None:
                raise ValueError("stacked scopes do not nest")
            self.tape._prefix.append(self.name)
            self.tape._stack = {}

        def __exit__(self, *exc):
            tape = self.tape
            tape._prefix.pop()
            per_layer, tape._stack = tape._stack, None
            if exc[0] is not None:
                return
            n = {len(v) for v in per_layer.values()}
            if len(n) > 1:
                raise ValueError(f"stacked records of unequal depth: {n}")
            # one copy of the activations into the (L, ...) layout the
            # kernels read; the per-layer tensors die with this dict
            for key, acts in per_layer.items():
                tape.acts[key] = _stack(acts)

    def stacked(self, name: str) -> "_Stacked":
        """Scope for a loop over the layers of stacked params: records made
        inside get ``.s`` keys and are stacked to (L, ...) on exit."""
        return Tape._Stacked(self, name)

    def layer_params(self, name: str, params: dict, l: int) -> dict:
        """Layer ``l`` of the stacked param subtree ``params`` (at ``name``).
        Weights and vector params are (L, ...); per-sample vector params are
        (B, L, ...) and are sliced on their second axis."""
        def take(path, v):
            if isinstance(v, dict):
                return {k: take(f"{path}/{k}", x) for k, x in v.items()}
            return v[:, l] if path in self.per_sample else v[l]

        return take(name, params)

    # ------------------------------------------------------------------- taps
    def record(self, name: str, kind: str, s: torch.Tensor, act) -> torch.Tensor:
        """Tap site: keeps ``act`` as the record and ``s`` as the
        differentiation target when the key is active; returns s."""
        if not self.collect:
            return s
        key = self.key(name, kind)
        # records are read, never differentiated
        act = ({k: v.detach() for k, v in act.items()}
               if isinstance(act, dict) else act.detach())
        if self.store is not None:
            act = store_record(act, self.store(key), self.gen)
        if self._stack is not None:
            self._stack.setdefault(key, []).append(act)
        elif key in self.acts:
            raise ValueError(f"duplicate tap key {key!r}")
        else:
            self.acts[key] = act
        if self.active is not None and self.active(key):
            if not s.requires_grad:
                # e.g. the embedding gather of a weight that takes no grad:
                # a fresh leaf, made a target
                s.requires_grad_()
            if self._stack is not None:
                self.outs.setdefault(key, []).append(s)
            else:
                self.outs[key] = s
        return s


def _stack(records: list):
    """Per-layer records (tensors, or dicts of them: MoE records, int8
    pairs) -> one record with a leading layer axis."""
    if isinstance(records[0], dict):
        return {k: _stack([r[k] for r in records]) for k in records[0]}
    return torch.stack(records)


# ------------------------------------------------------------ tape residency
# Storage policies for book-kept tap records (activations, held cotangents)
# between BK phases 2 and 3:
#   native     keep the tensor as produced (the engine's bitwise path)
#   bf16       hold a bfloat16 copy; norms and clip factors stay f32
#   int8       hold an int8 stochastic-rounding quantization (per-tensor
#              scale, runtime.compression.quantize): unbiased, loosest
#   recompute  hold NO cotangent; phase 3 re-derives the weighted gradient
#              with a reweighted-loss backward (activations stay native:
#              they are the standard tape)
#   auto       per-tap choice by kernels.dispatch.tape_plan
# Integer / bool leaves (embedding ids, MoE masks) pass through untouched.
TAPE_POLICIES = ("native", "bf16", "int8", "recompute", "auto")


def store_record(x, policy: str, gen: Optional[torch.Generator] = None):
    """One record -> its held form under a storage policy. int8 needs
    ``gen`` for the stochastic rounding draw."""
    if policy in ("native", "recompute"):
        return x
    if isinstance(x, dict):          # moe record {'a': float, 'mask': ...}
        out = dict(x)
        out["a"] = store_record(x["a"], policy, gen)
        return out
    if not x.is_floating_point():
        return x                     # ids / masks: already compact
    if policy == "bf16":
        return x.to(torch.bfloat16)
    if policy == "int8":
        from repro_torch.runtime.compression import quantize
        q, scale = quantize(x, gen)
        return {"q": q, "scale": scale}
    raise ValueError(f"unknown tape storage policy {policy!r}; options: "
                     f"{TAPE_POLICIES[:-1]}")


def load_record(stored, dtype=None):
    """Inverse of :func:`store_record`: -> the record with its float
    tensors in ``dtype`` (the record's native dtype), ready for the norm and
    weighted-grad consumers."""
    if isinstance(stored, dict):
        if "q" in stored:            # int8 (q, scale) pair
            from repro_torch.runtime.compression import dequantize
            return dequantize(stored["q"], stored["scale"],
                              dtype or torch.float32)
        out = dict(stored)
        out["a"] = load_record(stored["a"], dtype)
        return out
    if dtype is not None and stored.dtype != dtype and \
            stored.is_floating_point():
        return stored.to(dtype)
    return stored
