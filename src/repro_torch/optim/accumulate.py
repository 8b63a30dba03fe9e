"""Gradient accumulation with DP semantics (paper footnote 2): the LOGICAL
batch determines accuracy and privacy accounting; the PHYSICAL (micro) batch
only determines memory. Per-sample clipping happens inside each microbatch,
the clipped sums accumulate across microbatches, and the caller adds noise
ONCE per logical batch (``core.policy.noise_leaf_fn`` fused into
``Optimizer.update_leaves``)."""
from __future__ import annotations

import torch

from repro_torch.core.bk import BK_MODES, batch_size_of, bk_clipped_sum
from repro_torch.core.policy import as_policy


def accumulated_clipped_sum(apply_fn, params, batch, cfg, microbatch: int,
                            seed: int = 0):
    """Phases 1-3 over the logical batch -> (flat_sums, aux, B_logical).
    One microbatch's book-keeping is live at a time. ``seed`` keys the int8
    tape store's rounding (offset by each microbatch's first row)."""
    policy = as_policy(cfg)
    if policy.mode not in BK_MODES:
        raise ValueError(f"mode must be one of {BK_MODES}, got "
                         f"{policy.mode!r}")
    B = batch_size_of(batch)
    if microbatch <= 0 or microbatch >= B:
        sums, aux = bk_clipped_sum(apply_fn, params, batch, policy, seed)
        return sums, aux, B
    if B % microbatch:
        raise ValueError(f"microbatch {microbatch} must divide batch {B}")
    sums, losses, norms = None, [], []
    for lo in range(0, B, microbatch):
        mb = {k: v[lo:lo + microbatch] for k, v in batch.items()}
        s, aux = bk_clipped_sum(apply_fn, params, mb, policy, seed + lo)
        if sums is None:
            sums = s
        else:
            for k in sums:
                sums[k] = sums[k] + s[k]
        losses.append(aux["loss"])
        norms.append(aux["per_sample_norms"])
    aux = {"loss": torch.stack(losses).mean(),
           "per_sample_norms": torch.cat(norms)}
    return sums, aux, B
