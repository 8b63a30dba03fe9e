"""The kernels on the meta device: the planner's stand-in for the library.

A wrapper given meta tensors while a plan records (:func:`recording`;
``launch.steps.plan_cell``: shapes only, no data, no card) runs its own
code path, the one a CUDA tensor takes: the
same checks, the same route (``route(dtype, d, p)``, alignment: a meta
tensor's address is 0), and the same allocations, outputs and workspace,
at the same shapes and dtypes. Only ``build.load()`` differs: it returns
:data:`LIB`, whose size entries are the C entries' rules written out in
Python (each names its source below) for the H100's 132 SMs, and whose
launch entries launch nothing: each adds one launch and the kernel's
floating-point operations (2 a multiply-add) to the innermost
:func:`recording`. A wrapper's own ``launches`` count is the card's and is
not touched on meta. Outside a recording a wrapper refuses meta tensors as
not CUDA.

fused_clip_grad's partials (one f32 a sample and CTA) and the SIMT walk's
scratch follow the kernel's plan, whose CTAs the C side asks of the card's
occupancy API. :func:`fused_plan` runs the same search over a model of that
answer (:func:`_resident`: 2 SIMT CTAs or 1 wgmma CTA a SM where shared
memory allows, and as many clusters as the card reported,
:data:`ACTIVE_CLUSTERS`, measured on an H100 SXM through
``dp_fused_clip_plan``); chip_smoke's dryrun phase prints the model beside
the card's plan.

No workspace here depends on the data: the embedding kernels size theirs
by the vocabulary (``emb_grad``'s bitmap, ceil(V / 32) words a layer) and
by T (``emb_norm``'s partials, a warp's run sums of ceil(T / 8) positions),
never by the ids.
"""
from __future__ import annotations

import contextlib
from collections import Counter

SMS = 132                      # H100 SXM
# clusters of ``size`` CTAs resident at once at ``per_sm`` CTAs a SM, as
# cudaOccupancyMaxActiveClusters reported them for fused_clip_grad's kernels
ACTIVE_CLUSTERS = {(2, 8): 30, (2, 4): 62, (1, 4): 30, (1, 2): 66}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _npairs(T: int, tile: int) -> int:
    nt = _cdiv(T, tile)
    return nt * (nt + 1) // 2


def _ntiles(d: int, p: int) -> int:
    """``atb::ntiles`` (csrc/common.cuh): 128 x 128 tiles of (d, p)."""
    return _cdiv(d, 128) * _cdiv(p, 128)


# ------------------------------------------------------------ the recording
class Recorder:
    """What the meta launches of a run add up to: launches by wrapper and
    by C entry (the route), and their floating-point operations."""

    def __init__(self):
        self.launches, self.entries = Counter(), Counter()
        self.flops = 0

    def add(self, name: str, entry: str, flops: int) -> None:
        self.launches[name] += 1
        self.entries[entry] += 1
        self.flops += int(flops)


_STACK: list = []


@contextlib.contextmanager
def recording():
    """-> a :class:`Recorder` that every meta launch inside adds to."""
    rec = Recorder()
    _STACK.append(rec)
    try:
        yield rec
    finally:
        _STACK.pop()


def planning() -> bool:
    """Whether a :func:`recording` is active: the wrappers take meta
    tensors only then (else they refuse them as not CUDA)."""
    return bool(_STACK)


def _record(name, entry, flops):
    for rec in _STACK[-1:]:
        rec.add(name, entry, flops)
    return 0


# ------------------------------------------------------- fused_clip's plan
_WG_TILE = _WG_ROWS = 64
_STAGE_ELEMS, _SIMT_STAGES, _THREADS = 1024, 8, 256
_MAX_NB, _MAX_SPLIT, _WG_MAX_SPLIT, _SPLIT_FEW = 8, 8, 4, 4


def _smem(wgmma: bool, tile: int, nb: int) -> int:
    """``smem_bytes`` (csrc/fused_clip.cu)."""
    if wgmma:
        return 4 * 2 * _WG_ROWS * 128 + nb * 64 * 64 * 4 + 2 * 4 * 8 + 1024
    ntg = _THREADS // (tile * tile // 16)
    fixed = _SIMT_STAGES * 2 * _STAGE_ELEMS + ntg * tile * tile
    return (fixed + nb * tile * tile) * 4


def _resident(wgmma: bool, smem: int, cluster: int) -> int:
    """CTAs resident at once: 1 wgmma or 2 SIMT CTAs a SM (their registers),
    fewer where their shared memory (228 KB a SM, 1 KB of it reserved a
    CTA) holds fewer."""
    if smem > 227 * 1024:
        return 0
    per_sm = min(1 if wgmma else 2, 228 * 1024 // (smem + 1024))
    if cluster > 1:
        return ACTIVE_CLUSTERS.get((per_sm, cluster),
                                   SMS * per_sm // cluster) * cluster
    return SMS * per_sm


def fused_plan(L, B, T, d, p, wgmma: bool) -> dict:
    """The plan ``make_plan`` / ``walk_plan`` (csrc/fused_clip.cu) pick,
    over the residency model above -> {tile, nb, split, grid, walk}."""
    cap = 2 * SMS
    for tile in ((64,) if wgmma else (16, 32, 64)):
        ntiles = L * _cdiv(d, tile) * _cdiv(p, tile)
        sr = _WG_ROWS if wgmma else _STAGE_ELEMS // tile
        for nb in range(min(B, _MAX_NB), 0, -1):
            smem = _smem(wgmma, tile, nb)
            split = _WG_MAX_SPLIT if wgmma else _MAX_SPLIT
            while split >= 1:
                tper = _cdiv(_cdiv(T, split), sr) * sr
                grid = ntiles * split
                skip = split > 1 and ((split - 1) * tper >= T or grid > cap
                                      or (wgmma and _SPLIT_FEW * ntiles
                                          > SMS))
                if not skip and grid <= _resident(wgmma, smem, split):
                    return dict(tile=tile, nb=nb, split=split, grid=grid,
                                walk=0)
                split //= 2
    tile = 64
    if not wgmma:
        least = None
        for t in (16, 32, 64):
            pad = _cdiv(d, t) * t * _cdiv(p, t) * t
            if least is None or pad <= least:
                least, tile = pad, t
    ntiles = L * _cdiv(d, tile) * _cdiv(p, tile)
    for nb in range(min(B, _MAX_NB), 0, -1):
        n = _resident(wgmma, _smem(wgmma, tile, nb), 1)
        if n > 0:
            return dict(tile=tile, nb=nb, split=1, grid=min(n, ntiles),
                        walk=1)
    return dict(tile=tile, nb=0, split=1, grid=0, walk=0)


# ------------------------------------------------------------- the library
class _MetaLib:
    """``build.load()`` on the meta device: the C entries' size rules, and
    launch entries that record (see the module's docstring)."""

    # -------------------------------------------------- sizes (the C rules)
    @staticmethod
    def dp_ghost_norm_nparts(T):                     # ghost_norm.cu
        return _npairs(T, 64)

    @staticmethod
    def dp_ghost_norm_wgmma_split(L, B, T, d, p):    # ghost_norm_wgmma.cu
        kd, kp = _cdiv(min(d, p), 64), _cdiv(max(d, p), 64)
        items, best, best_cost = L * B * _npairs(T, 128), 1, None
        for s in range(1, min(64, kp) + 1):
            cost = _cdiv(items * s, SMS) * (kd + _cdiv(kp, s))
            if best_cost is None or cost < best_cost:
                best, best_cost = s, cost
        return best

    def dp_ghost_norm_wgmma_nparts(self, L, B, T, d, p):
        return L * _npairs(T, 128) * self.dp_ghost_norm_wgmma_split(
            L, B, T, d, p) * 8

    @staticmethod
    def dp_clipped_grad_split(L, B, T, d, p):        # clipped_grad.cu
        ctas, want = _ntiles(d, p) * L, 2 * SMS
        if ctas >= want:
            return 1
        s = min(_cdiv(want, ctas), B * T // 512, 65535 // L)
        return max(s, 1)

    @staticmethod
    def dp_emb_norm_nparts(T):                       # emb_norm.cu
        return _cdiv(T, 8)

    @staticmethod
    def dp_emb_grad_smem_bytes(V):                   # emb_grad.cu
        return _cdiv(V, 32) * 4

    @staticmethod
    def dp_emb_grad_scratch_ints(V):
        return _cdiv(V, 32)

    @staticmethod
    def dp_grad_norm_direct_nparts(d, p):            # grad_norm_direct.cu
        return _ntiles(d, p)

    @staticmethod
    def dp_grad_norm_direct_wgmma_nparts(d):         # wgmma_grad.cuh BM
        return _cdiv(d, 128) * 8

    @staticmethod
    def dp_moe_ghost_norm_wgmma_nparts(C):           # moe_ghost_norm_wgmma
        return _npairs(C, 64) * 4

    dp_moe_direct_norm_nparts = dp_grad_norm_direct_nparts
    dp_moe_direct_norm_wgmma_nparts = dp_grad_norm_direct_wgmma_nparts

    @staticmethod
    def dp_fused_clip_nparts(L, B, T, d, p, bf16, wgmma):
        return fused_plan(L, B, T, d, p, bool(wgmma))["grid"]

    @staticmethod
    def dp_fused_clip_scratch_bytes(L, B, T, d, p, bf16, wgmma):
        pl = fused_plan(L, B, T, d, p, bool(wgmma))
        # SPILL_SIMT: only the SIMT walk keeps its first sweep's tiles
        return pl["nb"] * L * d * p * 4 if pl["walk"] and not wgmma else 0

    @staticmethod
    def dp_wkv6_chunked_nparts(T, h):                # wkv6_chunked.cu
        return _cdiv(T, 32 if h > 64 else 64)

    @staticmethod
    def dp_wkv6_backward_nparts(h):                  # wkv6_backward.cu JB
        return _cdiv(h, 32)

    # ------------------------------------------------ launches (recorded)
    @staticmethod
    def dp_ghost_norm(a, ds, part, out, L, B, T, d, p, bf16, st):
        return _record("ghost_norm", "dp_ghost_norm",
                       L * B * T * (T + 1) * (d + p))

    @staticmethod
    def dp_ghost_norm_wgmma(a, ds, part, out, L, B, T, d, p, st):
        return _record("ghost_norm", "dp_ghost_norm_wgmma",
                       L * B * T * (T + 1) * (d + p))

    @staticmethod
    def dp_clipped_grad(a, C, g, parts, out, L, B, T, d, p, bf16, s, st):
        return _record("clipped_grad", "dp_clipped_grad", 2 * L * B * T * d * p)

    @staticmethod
    def dp_clipped_grad_wgmma(a, C, g, out, L, B, T, d, p, st):
        return _record("clipped_grad", "dp_clipped_grad_wgmma",
                       2 * L * B * T * d * p)

    @staticmethod
    def dp_emb_norm(ids, ds, part, out, L, B, T, d, bf16, st):
        return _record("emb_ghost_norm", "dp_emb_norm", 2 * L * B * T * d)

    @staticmethod
    def dp_emb_grad(ids, C, ds, scratch, out, L, B, T, d, V, bf16, st):
        return _record("emb_clipped_grad", "dp_emb_grad", 2 * L * B * T * d)

    @staticmethod
    def dp_grad_norm_direct(a, ds, part, out, L, B, T, d, p, bf16, st):
        return _record("grad_norm_direct", "dp_grad_norm_direct",
                       2 * L * B * (T + 1) * d * p)

    @staticmethod
    def dp_grad_norm_direct_wgmma(a, ds, part, out, L, B, T, d, p, st):
        return _record("grad_norm_direct", "dp_grad_norm_direct_wgmma",
                       2 * L * B * (T + 1) * d * p)

    @staticmethod
    def dp_moe_ghost_norm(a, m, ds, part, out, L, B, E, C, d, p, bf16, st):
        return _record("moe_ghost_norm", "dp_moe_ghost_norm",
                       L * B * E * C * (C + 1) * (d + p))

    @staticmethod
    def dp_moe_ghost_norm_wgmma(a, m, ds, part, out, L, B, E, C, d, p, st):
        return _record("moe_ghost_norm", "dp_moe_ghost_norm_wgmma",
                       L * B * E * C * (C + 1) * (d + p))

    @staticmethod
    def dp_moe_direct_norm(a, m, ds, part, out, L, B, E, C, d, p, bf16, st):
        return _record("moe_direct_norm", "dp_moe_direct_norm",
                       2 * L * B * E * (C + 1) * d * p)

    @staticmethod
    def dp_moe_direct_norm_wgmma(a, m, ds, flags, part, out, L, B, E, C, d,
                                 p, st):
        return _record("moe_direct_norm", "dp_moe_direct_norm_wgmma",
                       2 * L * B * E * (C + 1) * d * p)

    @staticmethod
    def dp_moe_clipped_grad(a, m, C_, ds, out, L, B, E, C, d, p, bf16, st):
        return _record("moe_clipped_grad", "dp_moe_clipped_grad",
                       2 * L * B * E * C * d * p)

    @staticmethod
    def dp_moe_clipped_grad_wgmma(a, m, C_, ds, flags, out, L, B, E, C, d,
                                  p, st):
        return _record("moe_clipped_grad", "dp_moe_clipped_grad_wgmma",
                       2 * L * B * E * C * d * p)

    @staticmethod
    def dp_fused_clip_grad(a, ds, w, part, scratch, G, sq, L, B, T, d, p,
                           bf16, wgmma, clip, R, gamma, st):
        return _record("fused_clip_grad",
                       "dp_fused_clip_grad" + ("_wgmma" if wgmma else ""),
                       2 * L * B * (T + 2) * d * p)

    @staticmethod
    def _pairs(T, S, causal):
        """(query, key) pairs a causal or full attention scores (the
        plain version's mask: key j <= query i)."""
        return (min(T, S) * (min(T, S) + 1) // 2 + max(0, T - S) * S
                if causal else T * S)

    def dp_flash_attention(self, q, k, v, o, B, T, S, H, K, h, causal, bf16,
                           st):
        return _record("flash_attention", "dp_flash_attention",
                       4 * B * H * h * self._pairs(T, S, causal))

    def dp_flash_attention_wgmma(self, q, k, v, o, B, T, S, H, K, h, causal,
                                 st):
        return _record("flash_attention", "dp_flash_attention_wgmma",
                       4 * B * H * h * self._pairs(T, S, causal))

    @staticmethod
    def dp_wkv6(r, k, v, w, u, ub, o, B, T, H, h, bf16, st):
        return _record("wkv6", "dp_wkv6", 4 * B * T * H * h * h)

    @staticmethod
    def dp_wkv6_chunked(r, k, v, w, u, ub, state, o, B, T, H, h, bf16, st):
        return _record("wkv6", "dp_wkv6_chunked", 4 * B * T * H * h * h)

    @staticmethod
    def dp_wkv6_backward(r, k, v, w, u, ub, do, state, dr, dk, dv, dw, du,
                         part, B, T, H, h, bf16, st):
        # six h x h passes a token and head (csrc/wkv6_backward.cu)
        return _record("wkv6_backward", "dp_wkv6_backward",
                       12 * B * T * H * h * h)

    @staticmethod
    def dp_counter_noise(g, out, keys, sides, n_keys, start, trail, n, alpha,
                         denom, bf16, st):
        return _record("counter_noise", "dp_counter_noise", 3 * n)

    @staticmethod
    def dp_counter_noise_block(g, out, keys, sides, n_keys, where, trail, n,
                               alpha, denom, bf16, st):
        return _record("counter_noise", "dp_counter_noise_block", 3 * n)

    @staticmethod
    def _update_flops(n, opt, noised):
        # the noise add (3), then SGD / FTRL (4) or AdamW (12) an element
        return n * ((12 if opt == 1 else 4) + (3 if noised else 0))

    def dp_noise_update(self, g, p, m, v, keys, sides, n_keys, noised, start,
                        trail, n, g_bf16, p_bf16, opt, hyper, t0, st):
        return _record("noise_update", "dp_noise_update",
                       self._update_flops(n, opt, noised))

    def dp_noise_update_block(self, g, p, m, v, keys, sides, n_keys, where,
                              trail, n, g_bf16, p_bf16, opt, hyper, t0, st):
        return _record("noise_update", "dp_noise_update_block",
                       self._update_flops(n, opt, True))


LIB = _MetaLib()
