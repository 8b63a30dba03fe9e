"""emb_ghost_norm: per-sample squared norms of an embedding tap, as a CUDA
kernel.

    n_b = sum_l sum_{t,t'} 1[id_lbt == id_lbt'] (g_lbt . g_lbt')
        = sum_l sum_{runs R of (l, b)} || sum_{t in R} g_lbt ||^2

Replaces the TPU kernel ``repro/kernels/emb_norm.py::emb_ghost_norm``.
Source: ``csrc/emb_norm.cu`` (the run-sum form, :func:`run_model`: every
cotangent row read once, whatever the ids), which also says what bounds it
on the H100. Partials are summed in a fixed order.
"""
from __future__ import annotations

import torch

from repro_torch.core import ghost
from repro_torch.kernels import build

# the plain version: what a CPU tensor runs, and what the kernel is held to
plain = ghost.sq_norm_emb


def emb_ghost_norm(ids: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """ids (L,B,T) or (B,T) int32, ds (L,B,T,d) or (B,T,d) -> (B,) f32. One
    launch (and its fixed-order partial sum)."""
    if ids.device.type == "cpu":
        return plain(ids, ds)
    bf16 = build.check_inputs("emb_ghost_norm", (ds,), (ids,))
    if ids.dim() not in (2, 3) or ds.dim() != ids.dim() + 1 or \
            ds.shape[:-1] != ids.shape:
        raise ValueError(f"emb_ghost_norm: ids {tuple(ids.shape)} and ds "
                         f"{tuple(ds.shape)} disagree")
    L = ids.shape[0] if ids.dim() == 3 else 1
    B, T = ids.shape[-2:]
    lib = build.lib_for(ds)
    partial = torch.empty(B, L * lib.dp_emb_norm_nparts(T),
                          dtype=torch.float32, device=ds.device)
    out = torch.empty(B, dtype=torch.float32, device=ds.device)
    build.check(lib.dp_emb_norm(ids.data_ptr(), ds.data_ptr(),
                                partial.data_ptr(), out.data_ptr(), L, B, T,
                                ds.shape[-1], int(bf16),
                                build.stream_ptr(ds)), "emb_ghost_norm")
    emb_ghost_norm.launches += build.counted(lib)
    return out


def run_model(ids: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """The kernel's run-sum form in plain torch, in float64 (nothing but the
    tests runs it): per (l, b), the positions grouped by id value (-1 and
    ids past the vocabulary too), each run's rows summed in t order, the
    squared norms of the sums added. ids (L,B,T) or (B,T), ds (..,T,d)
    -> (B,)."""
    if ids.dim() == 2:
        ids, ds = ids[None], ds[None]
    L, B, _ = ids.shape
    out = torch.zeros(B, dtype=torch.float64, device=ds.device)
    for l in range(L):
        for b in range(B):
            _, run = torch.unique(ids[l, b], return_inverse=True)
            sums = torch.zeros(int(run.max()) + 1, ds.shape[-1],
                               dtype=torch.float64, device=ds.device)
            sums.index_add_(0, run, ds[l, b].double())
            out[b] += (sums * sums).sum()
    return out


emb_ghost_norm.launches = 0
