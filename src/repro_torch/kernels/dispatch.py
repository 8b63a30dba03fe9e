"""Per-tap method rule: ghost vs direct norm.

The JAX package's dispatch layer also chose kernel vs einsum by a size
threshold and fitted block sizes to the TPU's VMEM; neither applies here. On
the card a kernel wrapper launches its kernel for every record it is given,
and the CUDA kernels fix their own tiles. What stays is the paper's
layerwise rule, one level down per tapped op:

  mode 'bk' forces ghost norms; otherwise ghost iff 2T^2 < pd
  (``core.ghost.prefer_ghost``); a ParamGroup ``method`` override wins.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.ghost import prefer_ghost


@dataclass(frozen=True)
class Plan:
    method: str      # 'ghost' | 'direct'


def norm_plan(kind: str, act_shape, ds_shape, mode: str,
              method: str = "") -> Plan:
    """Per-tap plan for the phase-2 per-sample squared norm."""
    if kind == "mm":
        T, d, p = act_shape[-2], act_shape[-1], ds_shape[-1]
        return Plan(method or ("ghost" if mode == "bk" or prefer_ghost(T, d, p)
                               else "direct"))
    if kind == "emb":
        # ghost is the only sane norm for embeddings: direct would
        # instantiate (B, V, d); a 'direct' group override is ignored
        return Plan("ghost")
    raise ValueError(f"unknown tap kind {kind!r}")

