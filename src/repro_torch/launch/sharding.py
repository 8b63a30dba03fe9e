"""Sharding rules: param-path regex -> spec over the trailing dims (leading
stacked/layer dims padded with None), as the JAX package's
``repro/launch/sharding.py``: FSDP on 'data', 'model' on the other matmul
dim, the 'pod' axis pure data parallelism (params replicated across pods).

A spec is a plain tuple, one entry a dim: an axis name, a tuple of axis
names, or None. First match wins; the 2-D fallback shards a matmul's two
dims over ('data', 'model'). A rank holds the block of a leaf its mesh
coordinates pick (``core.blocks.local_block``, which this module
re-exports with ``sanitize``): the whole leaf where the spec is trivial or
a sharded dim does not divide.

The 'model' axis shards storage here, not compute: the ranks of one model
group hold different blocks of a leaf at rest, gather the whole leaf for
the step, and compute the same rows of the batch (``launch.steps``).
"""
from __future__ import annotations

import re

import torch

from repro_torch.core.blocks import (batch_axes, block_slices,
                                     local_block, sanitize, spec_axes,
                                     take_block)
from repro_torch.utils.tree import flatten, unflatten

# (regex on param path, spec for the TRAILING dims): the JAX package's table
RULES = [
    # d over 'model' (not V): the embedding's vocab stays whole, so odd
    # vocab sizes need no padding; the table is replicated over 'data'
    (r"(^|/)embed/w$", (None, "model")),            # (V, d)
    (r"(^|/)head/w$", ("data", "model")),           # (d, V)
    (r"experts/up/w$", ("model", "data", None)),    # (E, d, ff) expert-parallel
    (r"experts/down/w$", ("model", None, "data")),  # (E, ff, d)
    (r"(^|/)router/w$", ("data", None)),            # (d, E)
    (r"(^|/)qkv/w$", ("data", "model")),
    (r"(^|/)o/w$", ("model", "data")),
    (r"(^|/)fuse_o/w$", ("model", "data")),
    (r"(^|/)up/w$", ("data", "model")),
    (r"(^|/)down/w$", ("model", "data")),
    (r"(^|/)value/w$", ("model", "data")),          # rwkv ffn down-proj
    (r"(^|/)(key|receptance|r|k|v|g|xz)/w$", ("data", "model")),
    (r"(^|/)(projector|frontend)/w$", (None, "model")),
    (r"xattn/(q|kv)/w$", ("data", "model")),
    (r"xattn/o/w$", ("model", "data")),
    (r"(^|/)(wa|tm_w1|bcdt)/w$", ("data", None)),
    (r"(^|/)(wb|tm_w2_\d)/w$", (None, "model")),
    (r"(^|/)pos/e$", (None, None)),
    (r"(^|/)meta/m$", (None, None)),
]


def spec_for(path: str, ndim: int) -> tuple:
    for pat, tail in RULES:
        if re.search(pat, path):
            tail = tuple(tail)
            if len(tail) > ndim:  # e.g. a vector matched broadly
                tail = tail[-ndim:]
            return (None,) * (ndim - len(tail)) + tail
    if path.endswith("/w") and ndim >= 2:  # fallback matmul rule
        return (None,) * (ndim - 2) + ("data", "model")
    return ()  # vectors and scalars replicated


def param_pspecs(params, mesh=None) -> dict:
    out = {}
    for p, v in flatten(params).items():
        spec = spec_for(p, v.dim())
        if mesh is not None:
            spec = sanitize(spec, v.shape, mesh)
        out[p] = spec
    return unflatten(out)


def flat_param_pspecs(params, mesh) -> dict:
    """Flat {path: sanitized spec}: the per-leaf layout the shard-local
    noise keys off, from the same table as :func:`param_pspecs`, so params
    and their noise never shard differently."""
    return flatten(param_pspecs(params, mesh))


def opt_state_pspecs(opt_name: str, params, param_specs) -> dict:
    """Optimizer-state specs mirror the param specs (adafactor drops the
    factored dim)."""
    pf = flatten(param_specs)
    if opt_name in ("adamw", "lamb"):
        return {"m": param_specs, "v": param_specs}
    if opt_name == "sgd":
        return {"m": param_specs}
    if opt_name == "ftrl":
        return {"sum": param_specs, "m": param_specs, "theta0": param_specs}
    if opt_name == "adafactor":
        out = {}
        for p, v in flatten(params).items():
            spec = tuple(pf[p]) + (None,) * (v.dim() - len(tuple(pf[p])))
            if v.dim() >= 2:
                out[p + "/vr"] = spec[:-1]
                out[p + "/vc"] = spec[:-2] + spec[-1:]
            else:
                out[p + "/v"] = spec
        return {"s": unflatten(out)}
    raise ValueError(opt_name)


def batch_pspecs(batch_like, mesh) -> dict:
    """Shard the leading (batch) dim of every input over pod+data."""
    ba = batch_axes(mesh)
    return {k: sanitize((ba,) + (None,) * (x.dim() - 1), x.shape, mesh)
            for k, x in batch_like.items()}


def state_pspecs(opt_name: str, params, mesh):
    """Specs for a ``launch.steps.TrainState``: params by the rules table,
    optimizer state mirroring them, step and rng replicated."""
    from repro_torch.launch.steps import TrainState
    pspec = param_pspecs(params, mesh)
    return TrainState(params=pspec,
                      opt_state=opt_state_pspecs(opt_name, params, pspec),
                      step=(), rng=())


# ------------------------------------------------------------- a rank's block
def holds_unique(spec, shape, mesh, coords=None) -> bool:
    """Whether the rank at ``coords`` is the one that writes its block of
    a leaf (the first of the block's replicas: index 0 on every axis the
    sanitized spec does not shard over)."""
    coords = mesh.coords if coords is None else coords
    used = set(spec_axes(sanitize(spec, tuple(shape), mesh)))
    return all(coords[a] == 0 for a in mesh.axis_names if a not in used)


def shard_tree(tree, specs, mesh) -> dict:
    """A tree of whole leaves -> the calling rank's blocks, dense (a leaf
    the rank holds whole is the leaf itself)."""
    fs = flatten(specs)
    return unflatten({path: take_block(leaf, fs[path], mesh, copy=True)[0]
                      for path, leaf in flatten(tree).items()})


def gather_leaf(block: torch.Tensor, spec, shape, mesh) -> torch.Tensor:
    """The whole leaf of ``shape`` from the blocks that ``spec`` gives the
    ranks of this rank's group over the spec's axes: one all-gather. A
    block that is the whole leaf is returned as it is."""
    shape = tuple(int(s) for s in shape)
    spec = sanitize(spec, shape, mesh)
    axes = spec_axes(spec)
    if tuple(block.shape) == shape or mesh.axis_size(axes) <= 1:
        return block
    parts = mesh.all_gather(block, axes)
    whole = torch.empty(shape, dtype=block.dtype, device=block.device)
    for r, part in zip(mesh.members(axes), parts):
        local, offsets = local_block(shape, spec, mesh, mesh.coords_of(r))
        whole[block_slices(local, offsets)] = part
    return whole


def gather_tree(blocks, specs, shapes, mesh) -> dict:
    """The whole leaves of a tree of blocks (``shapes``: {path: whole
    shape}), one :func:`gather_leaf` a leaf, in sorted path order."""
    fb, fs = flatten(blocks), flatten(specs)
    return unflatten({p: gather_leaf(fb[p], fs[p], shapes[p], mesh)
                      for p in sorted(fb)})
