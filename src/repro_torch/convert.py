"""Params across the two packages: the JAX package's flat
``{path: ndarray}`` dict (``repro.utils.tree.flatten`` of its params, as
numpy) to the port's params, and back. Keys and layouts are the same on
both sides, so nothing is transposed or renamed."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.tree import flatten, unflatten


def _tensor(a) -> torch.Tensor:
    a = np.array(a)                      # a writable, contiguous copy
    if a.dtype.name == "bfloat16":       # ml_dtypes' bf16: reinterpret bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(flat: dict, device, dtype=None) -> dict:
    """Flat {path: ndarray} -> the port's nested params on ``device``
    (cast to ``dtype`` when given)."""
    out = {}
    for path, a in flat.items():
        t = _tensor(a).to(device)
        out[path] = t.to(dtype) if dtype is not None else t
    return unflatten(out)


def params_to_numpy(params: dict) -> dict:
    """The port's params (nested or flat) -> flat {path: ndarray}; bfloat16
    tensors come back as float32 (numpy has no bfloat16)."""
    out = {}
    for path, t in flatten(params).items():
        t = t.detach().cpu()
        out[path] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out
