"""Per-tap plans: ghost vs direct norm, fused vs split streaming, and tape
residency.

The JAX package's dispatch layer also chose kernel vs einsum by a size
threshold and fitted block sizes to the TPU's VMEM; neither applies here. On
the card a kernel wrapper launches its kernel for every record it is given,
and the CUDA kernels fix their own tiles. What stays:

  norm_plan   the paper's layerwise rule, one level down per tapped op:
              mode 'bk' forces ghost norms; otherwise ghost iff 2T^2 < pd
              (``core.ghost.prefer_ghost``); a ParamGroup ``method``
              override wins. For a ``moe`` tap the rule reads the capacity
              C in place of T: the Gram is per (sample, expert) over the C
              slots.
  fused_plan  how a STREAMED single-tap clip unit (scope='layer') runs
              phases 2+3: one ``fused_clip_grad`` launch, or the composed
              norm + weighted-grad route. The JAX package's rule as written:
              an mm unit fuses only when one sample's working set, its
              (L,T,d+p) records plus the (L,d,p) gradient and output
              accumulator, fits ``FUSED_BUDGET`` (the reference's VMEM
              budget), and never under mode 'bk' (forced ghost norms) or a
              'ghost' group override. No full-width unit of the train
              paths fits; a small unit (a LoRA adapter, a smoke model)
              fuses.
  tape_plan   where a tap's book-kept state resides between phases 2 and 3
              (native, bf16, int8, recompute), by the JAX package's byte
              thresholds; ``fit_tape_budget`` upgrades stores until a byte
              budget holds. Pure shape arithmetic: the same inputs give the
              JAX package's plans. (Its REPRO_TAPE* environment overrides
              are not ported.)
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.ghost import prefer_ghost


# f32 bytes of one sample's fused working set. The JAX package's
# VMEM_BUDGET (6 MiB), kept as it is, so that every shape gets the JAX
# package's plan. ``csrc/fused_clip.cu`` holds each CTA's tile of g_b in
# shared memory for up to 8 samples, one CTA a tile where the card holds
# them all at once; the budget bounds a sample's bytes, not the tiles, and a
# unit with more tiles (narrow and stacked deep) takes the kernel's walk.
FUSED_BUDGET = 6 * 2 ** 20


@dataclass(frozen=True)
class Plan:
    method: str      # 'ghost' | 'direct' (norm) | 'fused' | 'split' (stream)


def norm_plan(kind: str, act_shape, ds_shape, mode: str,
              method: str = "") -> Plan:
    """Per-tap plan for the phase-2 per-sample squared norm."""
    if kind in ("mm", "moe"):
        T, d, p = act_shape[-2], act_shape[-1], ds_shape[-1]
        return Plan(method or ("ghost" if mode == "bk" or prefer_ghost(T, d, p)
                               else "direct"))
    if kind == "emb":
        # ghost is the only sane norm for embeddings: direct would
        # instantiate (B, V, d); a 'direct' group override is ignored
        return Plan("ghost")
    raise ValueError(f"unknown tap kind {kind!r}")


def fused_plan(kind: str, act_shape, ds_shape, mode: str,
               method: str = "") -> Plan:
    """Per-tap plan for a streamed single-tap clip unit: 'fused' (one
    ``fused_clip_grad`` launch: the contraction a^T ds runs once, for the
    norm and the weighted grad) or 'split' (norm, then weighted grad)."""
    if kind != "mm" or mode == "bk" or method == "ghost":
        return Plan("split")
    L = act_shape[0] if len(act_shape) == 4 else 1
    T, d, p = act_shape[-2], act_shape[-1], ds_shape[-1]
    fits = 4 * (L * T * (d + p) + 2 * L * d * p) <= FUSED_BUDGET
    return Plan("fused" if fits else "split")


# -------------------------------------------------------- residency planner
# Compression is nearly free and recompute costs a reweighted backward, so
# small records stay native, mid-size records hold bf16, and only records
# big enough to dominate the book-kept footprint pay the re-derivation.
TAPE_STORES = ("native", "bf16", "int8", "recompute")

TAPE_BF16_MIN = 64 * 2 ** 10
TAPE_RECOMPUTE_MIN = 8 * 2 ** 20


@dataclass(frozen=True)
class TapePlan:
    store: str            # one of TAPE_STORES, or the engine's 'stream'
    hold_bytes: int       # bytes this tap holds live between phases 2 and 3
    recompute_flops: int  # modeled phase-3 re-derivation cost (paid only
                          # when store == 'recompute')
    itemsize: int = 4     # the cotangent's native dtype width (model dtype)


def _prod(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _hold_bytes(store: str, ds_elems: int, itemsize: int = 4) -> int:
    """Held cotangent bytes between phases. ``itemsize`` is the cotangent's
    native width: a bf16 model holds 2 bytes an element natively, so the
    'bf16' store is a no-op there, never a halving."""
    return {"native": itemsize * ds_elems,
            "bf16": min(2, itemsize) * ds_elems,
            "int8": ds_elems + 4, "recompute": 0, "stream": 0}[store]


def tape_plan(kind: str, act_shape, ds_shape, policy: str = "auto",
              itemsize: int = 4) -> TapePlan:
    """Residency decision for one tap's book-kept state.

    ``policy`` is the resolved request ('auto' lets the byte thresholds
    pick; an explicit store pins it and still reports its costs; 'stream'
    is assigned by the engine to a streamed tap, which holds nothing).
    ``recompute_flops`` models the re-derivation, ~2 |ds| d_in."""
    if policy == "stream":
        return TapePlan("stream", 0, 0, int(itemsize))
    ds_elems = _prod(ds_shape)
    d_in = act_shape[-1] if kind in ("mm", "moe") else ds_shape[-1]
    flops = 2 * ds_elems * int(d_in)
    store = policy
    if store == "auto":
        nat = _hold_bytes("native", ds_elems, itemsize)
        store = ("recompute" if nat >= TAPE_RECOMPUTE_MIN
                 else "bf16" if nat >= TAPE_BF16_MIN else "native")
    if store not in TAPE_STORES:
        raise ValueError(f"unknown tape store {store!r}; options: "
                         f"{TAPE_STORES} (or 'auto')")
    return TapePlan(store, _hold_bytes(store, ds_elems, itemsize), flops,
                    int(itemsize))


def fit_tape_budget(plans: dict, budget_bytes: int) -> dict:
    """Upgrade per-tap stores ({key: TapePlan}) biggest-first along
    native -> bf16 -> recompute until the total held bytes fit the budget
    (int8 stays opt-in). Returns a new {key: TapePlan} dict."""
    order = {"native": "bf16", "bf16": "recompute"}
    out = dict(plans)

    def total() -> int:
        return sum(p.hold_bytes for p in out.values())

    while total() > budget_bytes:
        cands = [(k, p) for k, p in out.items() if p.store in order]
        if not cands:
            break
        k, p = max(cands, key=lambda kp: kp[1].hold_bytes)
        per = {"native": p.itemsize, "bf16": min(2, p.itemsize)}[p.store]
        ds_elems = p.hold_bytes // per
        nxt = order[p.store]
        out[k] = TapePlan(nxt, _hold_bytes(nxt, ds_elems, p.itemsize),
                          p.recompute_flops, p.itemsize)
    return out
