"""fused_clip_grad: per-sample norm, clip factor and clip-weighted gradient
of a single-tap clip unit (scope='layer') in one launch, as a CUDA kernel.

    g_b = a_b^T ds_b;  sq_b = ||g_b||^2;  C_b = clip(sqrt(sq_b)) w_b;
    G = sum_b C_b g_b

Replaces the TPU kernel ``repro/kernels/fused_clip.py::fused_clip_grad``.
Source: ``csrc/fused_clip.cu``, which also says what bounds it on the H100.
One CTA owns a tile of (L, d, p) for every sample and keeps each sample's
tile of g_b in shared memory, so the contraction runs once and no g_b
leaves the chip; the CTAs meet at one grid barrier (a cooperative launch)
per group of up to 8 samples, where each sums the samples' partial norms in
one fixed order and folds C_b g_b into its tile of G. Two routes in that
skeleton, by :func:`route`: bf16 records with d and p multiples of 8 take
wgmma (TMA-fed 64 x 64 tiles on the tensor cores); f32 records and
unaligned widths take the SIMT route (tiles of 16, 32 or 64, a CTA's rows
split over its warps). On either route a small unit's tiles each take a
cluster of up to 8 CTAs, which split the rows and sum their partial tiles
in distributed shared memory. C stays f32, as in the Pallas kernel. Device memory holds
the inputs, G, sq and one partial of sq_b a (sample, CTA), in one
allocation: no L*d*p scratch.
:func:`fused_model` is the kernel's decomposition in float64, for the tests.
"""
from __future__ import annotations

import torch

from repro_torch.core import ghost
from repro_torch.core.clipping import get_clip_fn
from repro_torch.kernels import build

F32 = torch.float32
# the clip functions, in the order of the kernel's enum
CLIPS = ("abadi", "automatic", "normalize", "flat")
ROUTES = ("wgmma", "simt")
WGMMA_TILE = 64      # the wgmma route's tile (d x p) and rows a stage
MAX_GROUP = 8        # sample slots a CTA holds between two barriers
THREADS = 256
STAGE_ELEMS = 1024   # a record's elements a SIMT stage: 1024 / tile rows


def _clip(clipping: str, R: float, gamma: float):
    kw = {"gamma": gamma} if clipping == "automatic" else {}
    return get_clip_fn(clipping, R, **kw)


def plain(a: torch.Tensor, ds: torch.Tensor, w: torch.Tensor, clipping: str,
          R: float, gamma: float):
    """The plain version, step for step the Pallas kernel's body: one
    sample at a time (O(L d p) memory), f32 throughout. What a CPU tensor
    runs, and what the kernel is held to."""
    clip = _clip(clipping, R, gamma)
    a4, d4 = ghost._norm4(a, ds)
    L, B, _, d = a4.shape
    G = torch.zeros(L, d, d4.shape[-1], dtype=F32, device=a.device)
    sq = torch.empty(B, dtype=F32, device=a.device)
    for b in range(B):
        g = torch.einsum("ltd,ltp->ldp", a4[:, b].to(F32), d4[:, b].to(F32))
        s = torch.sum(g * g)
        c = clip(torch.sqrt(s)).to(F32) * w[b].to(F32)
        sq[b] = s
        G += c * g
    return (G if a.dim() == 4 else G[0]), sq


def route(dtype: torch.dtype, d: int, p: int) -> str:
    """The kernel a CUDA call takes: 'wgmma' for bf16 records with d and p
    multiples of 8 (TMA's 16-byte strides; wgmma's transposed operands exist
    for 16-bit types only), else 'simt'."""
    return ("wgmma" if dtype == torch.bfloat16 and d % 8 == 0 and p % 8 == 0
            else "simt")


def t_pieces(T: int, kernel: str, tile: int, split: int = 1) -> list:
    """The rows of one sample's contraction as the kernel splits them, in
    the order its partial tiles are added: the ``split`` CTAs of a tile in
    rank order, CTA r taking rows r tper .. (r + 1) tper - 1 (tper: T /
    split rounded up to whole stages, of 64 rows (wgmma) or 1024 / tile);
    in a CTA, wgmma runs one accumulator over its stages in turn, simt its
    T-groups, group q taking the rows t = q mod NTG, NTG = 256 / (tile^2 /
    16)."""
    ntg = 1 if kernel == "wgmma" else THREADS // (tile * tile // 16)
    sr = WGMMA_TILE if kernel == "wgmma" else STAGE_ELEMS // tile
    tper = -(-(-(-T // split)) // sr) * sr
    rows = torch.arange(T)
    return [rows[r * tper:(r + 1) * tper][q::ntg] for r in range(split)
            for q in range(ntg)]


def fused_model(a: torch.Tensor, ds: torch.Tensor, w: torch.Tensor,
                clipping: str, R: float, gamma: float, kernel: str = "simt",
                tile: int = 16, group: int = MAX_GROUP, split: int = 1):
    """The kernel's decomposition in plain torch, in float64 (nothing but
    the tests runs it): one tile of ``tile`` (wgmma: 64) a (l, d tile, p
    tile), zero past d and p, its rows split over ``split`` CTAs (simt);
    per sample, the tile of g_b as its T pieces' partial products added in
    order (:func:`t_pieces`), and one partial of sq_b a CTA (the squares of
    its slice of the tile: slice r of ``split`` equal slices); samples in
    groups of ``group``, after each group sq_b as the sum of its partials
    in CTA order, C_b from it, and each tile of G += C_b g_b in b order.
    -> (G, sq) as :func:`plain` gives them, float64."""
    if kernel == "wgmma":
        tile = WGMMA_TILE
    clip = _clip(clipping, R, gamma)
    a4, d4 = (x.double() for x in ghost._norm4(a, ds))
    L, B, T, d = a4.shape
    p = d4.shape[-1]
    nd, np_ = -(-d // tile), -(-p // tile)
    a4 = torch.nn.functional.pad(a4, (0, nd * tile - d))
    d4 = torch.nn.functional.pad(d4, (0, np_ * tile - p))
    tiles = [(l, i * tile, j * tile) for l in range(L) for i in range(nd)
             for j in range(np_)]
    pieces = t_pieces(T, kernel, tile, split)
    per = -(-tile * tile // split)        # entries of a CTA's slice
    G = torch.zeros(L, nd * tile, np_ * tile, dtype=torch.float64)
    sq = torch.empty(B, dtype=torch.float64)
    for g0 in range(0, B, group):
        slots = {}
        partial = torch.zeros(B, len(tiles) * split, dtype=torch.float64)
        for k, (l, d0, p0) in enumerate(tiles):
            for b in range(g0, min(B, g0 + group)):
                x = a4[l, b, :, d0:d0 + tile]
                y = d4[l, b, :, p0:p0 + tile]
                g = torch.zeros(tile, tile, dtype=torch.float64)
                for rows in pieces:
                    g = g + x[rows].T @ y[rows]
                slots[k, b] = g
                flat = g.reshape(-1)
                for r in range(split):
                    sl = flat[r * per:(r + 1) * per]
                    partial[b, k * split + r] = (sl * sl).sum()
        for b in range(g0, min(B, g0 + group)):
            sq[b] = partial[b].sum()
            c = clip(torch.sqrt(sq[b])) * float(w[b])
            for k, (l, d0, p0) in enumerate(tiles):
                G[l, d0:d0 + tile, p0:p0 + tile] += c * slots[k, b]
    G = G[:, :d, :p]
    return (G if a.dim() == 4 else G[0]), sq


def fused_clip_grad(a: torch.Tensor, ds: torch.Tensor, w: torch.Tensor,
                    clipping: str, R: float, gamma: float,
                    kernel: str | None = None):
    """a (L,B,T,d) or (B,T,d), ds likewise (last dim p), w (B,) per-sample
    weight -> (G (L,d,p) or (d,p) f32, sq (B,) f32). One launch of the
    kernel :func:`route` names (``kernel`` forces one; the wgmma kernel
    raises on records it does not take). Raises, with the unit's shape,
    where the card cannot hold the launch's grid at once."""
    if clipping not in CLIPS:
        raise ValueError(f"fused_clip_grad: clipping must be one of {CLIPS}, "
                         f"got {clipping!r}")
    if a.device.type == "cpu":
        return plain(a, ds, w, clipping, R, gamma)
    a4, d4 = ghost._norm4(a, ds)
    if w.dtype is not F32 or not w.is_contiguous():
        w = w.to(F32).contiguous()
    bf16 = build.check_inputs("fused_clip_grad", (a4, d4), f32=(w,))
    L, B, T, d = a4.shape
    p = d4.shape[-1]
    if tuple(d4.shape[:3]) != (L, B, T) or tuple(w.shape) != (B,):
        raise ValueError(f"fused_clip_grad: a {tuple(a.shape)}, ds "
                         f"{tuple(ds.shape)}, w {tuple(w.shape)} disagree")
    kernel = kernel or route(a4.dtype, d, p)
    if kernel not in ROUTES:
        raise ValueError(f"fused_clip_grad: kernel {kernel!r} not in "
                         f"{ROUTES}")
    wgmma = kernel == "wgmma"
    if wgmma:
        if route(a4.dtype, d, p) != "wgmma":
            raise ValueError(f"fused_clip_grad: the wgmma kernel takes bf16 "
                             f"records with d, p multiples of 8, got "
                             f"{a4.dtype}, d={d}, p={p}")
        if any(t.data_ptr() % 16 for t in (a4, d4)):
            raise ValueError("fused_clip_grad: TMA operands must be 16-byte "
                             "aligned")
    lib = build.load()
    nparts = lib.dp_fused_clip_nparts(L, B, T, d, p, int(bf16),
                                      int(wgmma))
    if nparts < 0:
        raise RuntimeError(f"fused_clip_grad: CUDA error {-nparts} while "
                           "planning the launch")
    if nparts == 0:
        raise ValueError(f"fused_clip_grad: the {kernel} kernel's grid for a "
                         f"{tuple(a.shape)}, ds {tuple(ds.shape)} unit cannot "
                         "be resident on this card at once (one CTA a tile)")
    # one allocation holds G, sq and the (B, nparts) partials, in that
    # order (a small unit's call is mostly host work); the kernel writes
    # every entry
    n = L * d * p
    buf = torch.empty(n + B + B * nparts, dtype=F32, device=a.device)
    G, sq, base = buf[:n].view(L, d, p), buf[n:n + B], buf.data_ptr()
    build.check(lib.dp_fused_clip_grad(
        a4.data_ptr(), d4.data_ptr(), w.data_ptr(), base + 4 * (n + B),
        base, base + 4 * n, L, B, T, d, p, int(bf16), int(wgmma),
        CLIPS.index(clipping), float(R), float(gamma), build.stream_ptr(a)),
        "fused_clip_grad (wgmma)" if wgmma else "fused_clip_grad")
    if wgmma:
        fused_clip_grad.wgmma_launches += 1
    fused_clip_grad.launches += 1
    return (G if a.dim() == 4 else G[0]), sq


fused_clip_grad.launches = 0          # every launch, either route
fused_clip_grad.wgmma_launches = 0    # launches of the wgmma route
