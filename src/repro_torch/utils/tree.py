"""Flat-path param utilities.

Params are nested dicts of tensors. Paths are '/'-joined key strings, e.g.
``blocks/attn/qkv/w`` — the same keys as ``repro.utils.tree.flatten``, so
the two packages compare key by key.
"""
from __future__ import annotations


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> flat {path: leaf}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, leaf in flat.items():
        keys = path.split("/")
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return out
