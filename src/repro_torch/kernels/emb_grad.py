"""emb_clipped_grad: the clip-weighted gradient of an embedding tap, as a
CUDA kernel.

    G_l[v] = sum_b C_b sum_t 1[id_lbt == v] g_lbt

Replaces the TPU kernel ``repro/kernels/emb_grad.py::emb_clipped_grad``
without its one-hot matmul over vocab tiles. Source: ``csrc/emb_grad.cu``
(a pre-pass marks the rows that ids hit, then a store-bound pass writes
the others' zeros as a fill does and sums the marked ones in (b, t)
order), which also says what bounds it on the H100. Every output row is
written once, with no atomics; ids outside [0, vocab) are dropped.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import ghost
from repro_torch.kernels import build

# the pre-pass builds a bitmap of the vocabulary's rows in one block's
# shared memory (227 KB a block: 1.86 M rows)
MAX_SMEM_BYTES = 227 * 1024


def plain(ids: torch.Tensor, C: torch.Tensor, ds: torch.Tensor,
          vocab: int) -> torch.Tensor:
    """The plain version (f32 output, like the kernel): what a CPU tensor
    runs, and what the kernel is held to."""
    return ghost.weighted_grad_emb(ids, C, ds, vocab, torch.float32)


# the pre-pass's scratch, one buffer a (device, stream): the store pass
# reads it after the pre-pass on the same stream, and the next call's
# pre-pass rewrites it only after that, so one buffer serves every call
# there (and no allocation precedes the first launch)
_SCRATCH: dict = {}


def _scratch(ids: torch.Tensor, stream: int, n: int) -> torch.Tensor:
    """The kept buffer of at least ``n`` int32 (on the meta device a new
    one a call: a plan's step allocates it, as the card's first call
    does)."""
    if build.planning(ids):      # a plan's: a new one a call
        return torch.empty(n, dtype=torch.int32, device=ids.device)
    key = (ids.get_device(), stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < n:
        buf = _SCRATCH[key] = torch.empty(n, dtype=torch.int32,
                                          device=ids.device)
    return buf


@functools.cache
def _sizes(lib, vocab: int) -> tuple[int, int]:
    """-> (the pre-pass's shared memory bytes, the scratch's int32 elements
    a layer) for a vocabulary, as the C side states them: asked once a
    vocabulary."""
    return (lib.dp_emb_grad_smem_bytes(vocab),
            lib.dp_emb_grad_scratch_ints(vocab))


@functools.cache
def _geometry(ids_shape, ds_shape, C_shape, vocab: int) -> tuple:
    """-> (L, B, T, d, the output's shape) of operands of these shapes,
    which it checks: asked once a shape."""
    n = len(ids_shape)
    if n not in (2, 3) or len(ds_shape) != n + 1 or \
            ds_shape[:-1] != ids_shape or C_shape != ids_shape[-2:-1]:
        raise ValueError(f"emb_clipped_grad: ids {tuple(ids_shape)}, C "
                         f"{tuple(C_shape)}, ds {tuple(ds_shape)} disagree")
    L, (B, T), d = (ids_shape[0] if n == 3 else 1), ids_shape[-2:], \
        ds_shape[-1]
    return L, B, T, d, ((L, vocab, d) if n == 3 else (vocab, d))


def emb_clipped_grad(ids: torch.Tensor, C: torch.Tensor, ds: torch.Tensor,
                     vocab: int) -> torch.Tensor:
    """ids (L,B,T) or (B,T) int32, C (B,) f32, ds (L,B,T,d) or (B,T,d)
    -> (L,vocab,d) or (vocab,d) f32. One call of the C side (the pre-pass,
    then the store pass). The host work before it is kept to the checks
    (at ~0.3 ms a call on the card, it shows in the call's time): shapes
    are checked once a shape, unstacked operands go to the kernels as L = 1
    without views, and the scratch is kept."""
    if ids.is_cpu:
        return plain(ids, C, ds, vocab)
    if C.dtype is not torch.float32 or not C.is_contiguous():
        C = C.to(torch.float32).contiguous()
    bf16 = build.check_inputs("emb_clipped_grad", (ds,), (ids,), (C,))
    L, B, T, d, shape = _geometry(ids.shape, ds.shape, C.shape, vocab)
    lib = build.lib_for(ds)
    smem, scratch_ints = _sizes(lib, vocab)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"emb_clipped_grad: a bitmap of vocab={vocab} rows "
                         "does not fit one block's shared memory")
    stream = build.stream_ptr(ds)
    scratch = _scratch(ids, stream, L * scratch_ints)
    out = torch.empty(shape, dtype=torch.float32, device=ds.device)
    build.check(lib.dp_emb_grad(ids.data_ptr(), C.data_ptr(), ds.data_ptr(),
                                scratch.data_ptr(), out.data_ptr(), L, B, T,
                                d, vocab, int(bf16), stream),
                "emb_clipped_grad")
    emb_clipped_grad.launches += build.counted(lib)
    return out


emb_clipped_grad.launches = 0
