"""A rank's block of a leaf on a mesh: the shape math that the batch split
(``core.bk``), the shard-local noise (``core.noise``) and the sharded
state (``launch.sharding``) share.

A mesh here is anything with ``axis_names``, ``shape`` ({axis: size}) and
``coords`` ({axis: index} of the calling rank): ``launch.mesh.Mesh``, or a
stand-in. A spec is a plain tuple, one entry a dim: an axis name, a tuple
of axis names, or None. Nothing here launches a collective.
"""
from __future__ import annotations

import torch

BATCH_AXES = ("pod", "data")


def batch_axes(mesh) -> tuple:
    """Axes the batch dim shards over (pod included when present)."""
    return tuple(a for a in mesh.axis_names if a in BATCH_AXES)


def axes_of(entry) -> tuple:
    """A spec entry's axis names (None: none)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_axes(spec) -> tuple:
    """Every axis a spec shards over, in the order its dims name them."""
    return tuple(a for e in spec for a in axes_of(e))


def _axis_size(mesh, axes) -> int:
    n = 1
    for a in axes_of(axes):
        n *= mesh.shape[a]
    return n


def sanitize(spec, shape, mesh) -> tuple:
    """Drop sharding on dims the mesh axes do not divide (odd vocab sizes,
    head counts, batch = 1)."""
    tail = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return tuple(a if a is None or shape[i] % _axis_size(mesh, a) == 0
                 else None for i, a in enumerate(tail))


def local_block(shape, spec, mesh, coords=None) -> tuple:
    """-> (local shape, global offsets) of the block of a leaf of ``shape``
    that the rank at ``coords`` (the calling rank's by default) holds under
    ``spec``: the whole leaf where the spec is trivial or a sharded dim
    does not divide. A dim sharded over several axes takes them in the
    order its entry names them (row-major)."""
    coords = mesh.coords if coords is None else coords
    spec = sanitize(spec, tuple(shape), mesh)
    local, offsets = [], []
    for dim, entry in zip(shape, spec):
        n, idx = 1, 0
        for a in axes_of(entry):
            idx = idx * mesh.shape[a] + coords[a]
            n *= mesh.shape[a]
        local.append(int(dim) // n)
        offsets.append(idx * (int(dim) // n))
    return tuple(local), tuple(offsets)


def block_slices(local, offsets) -> tuple:
    return tuple(slice(o, o + n) for o, n in zip(offsets, local))


def take_block(x: torch.Tensor, spec, mesh, copy: bool = False):
    """-> (the calling rank's block of the whole leaf ``x`` under ``spec``,
    dense; its (offsets, full shape)), or (x, None) where the block is the
    whole leaf. ``copy``: the block never shares storage with ``x`` (a leaf
    kept at rest must not hold the whole one alive)."""
    local, offsets = local_block(x.shape, spec, mesh)
    if tuple(local) == tuple(x.shape):
        return x, None
    view = x[block_slices(local, offsets)]
    block = view.clone(memory_format=torch.contiguous_format) if copy \
        else view.contiguous()
    return block, (tuple(offsets), tuple(x.shape))
