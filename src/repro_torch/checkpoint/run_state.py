"""The run state's parameter digest (counterpart of ``params_digest`` in
``repro/checkpoint/run_state.py``; the rest of the run state, the
checkpoint and the resume checks are ROADMAP B6)."""
from __future__ import annotations

import hashlib

import torch

from repro_torch.utils.tree import flatten


def params_digest(params) -> str:
    """Order-stable sha256 over every parameter's raw bytes, path by sorted
    path: the bitwise restart-parity witness. A bf16 parameter hashes as
    its two raw bytes an element, as numpy's bfloat16 does, so the same
    parameters give the same digest in either package."""
    h = hashlib.sha256()
    flat = flatten(params)
    for path in sorted(flat):
        t = flat[path].detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(path.encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()
