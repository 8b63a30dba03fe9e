"""Time, on the card, the designs that eight kernels' sources name as not
taken, beside the kernels kept, so that those comparisons can be run again:

    PYTHONPATH=src python -m repro_torch.kernels.design_study
    PYTHONPATH=src python -m repro_torch.kernels.design_study --only emb

(``--only ghost``, ``wkv``, ``wkv_bwd``, ``moe``, ``emb_norm``, ``fused``
and ``noise`` likewise.) Each variant is built alone into a temporary
directory (one nvcc a variant, all started together): the kept source with
one line or
block replaced (:data:`EMB_PATCHES`, :data:`GHOST_PATCHES`,
:data:`WKV_PATCHES`, :data:`MOE_PATCHES`, :data:`EMB_NORM_PATCHES`,
:data:`FUSED_PATCHES`, :data:`NOISE_PATCHES`; a replacement that no
longer matches the source raises), or a source of its own under
``designs/``. Inputs are made from
a seed at qwen2-1.5b's ``train`` shapes (B=8, T=512), deepseek-moe-16b's
``train_moe`` shapes, rwkv6-3b's ``prefill_rwkv`` shapes, and qwen2-1.5b's
smoke-width and gate-edge units:

- ``emb_clipped_grad``: ids (8, 512), d 1536, V 151936, bf16 cotangents.
  Variants: the kept kernel (``csrc/emb_grad.cu``), one warp scanning all
  the ids of a marked row, and the sorted design of
  ``designs/emb_grad_sorted.cu`` with a CTA a row or long-lived CTAs; beside
  them a fill of the same output (``zero_``) and ``index_add_``.
- ``ghost_norm`` (wgmma): the head tap, a (1, 8, 512, 1536), ds
  (1, 8, 512, 151936). Variants: the kept kernel (a Gram summed in pieces
  of 8 stages), pieces of 4 and 16 stages, one accumulator for a whole p
  chunk, and one accumulator a stage folded while the next stage runs.
- ``wkv6`` (chunked): r, k, v, w (4, 4096, 40, 64) bf16 (w uniform in
  [0.5, 0.999]), u (40, 64) f32. Variants: the kept kernel
  (``csrc/wkv6_chunked.cu``: chunks of 64, pass-1 CTAs of 32 state
  columns), chunks of 32, pass-1 CTAs of 16 state columns; beside them the
  scan kernel (``csrc/wkv6.cu``) of the kept library. Then ablations
  (:data:`WKV_ABLATIONS`): the kept kernel with one phase skipped, whose
  outputs are wrong by design and whose times say what that phase costs.
- ``wkv6_backward``: rwkv6-3b's ``train_rwkv`` shapes, r, k, v, w
  (8, 512, 40, 64) bf16 (w uniform in [0.5, 0.999]), u (8, 40, 64) f32 per
  sample, do f32 normal, the chunked forward's saved states. Variants: the
  kept kernel (``csrc/wkv6_backward.cu``: the sub-chunk starts in
  registers, each sub-chunk's inputs loaded while the one before it is
  walked, two CTAs an SM) and the first version
  (``designs/wkv6_backward_first.cu``: the starts in shared memory, one CTA
  an SM); the kept kernel's five grads must be bitwise the first's (raises
  after the timings otherwise).
- ``moe_ghost_norm`` (wgmma): the up tap of ``train_moe``, a
  (5, 8, 64, 60, 2048), ds (..., 2816) bf16, random records under a
  router-like 0/1 mask (each (l, b, e) keeps a random count of its first
  slots, ~3/4 of them). Variants: the kept kernel
  (``csrc/moe_ghost_norm_wgmma.cu``: pieces of 8 stages, 208 KB of rings),
  pieces of 4 and 32 stages, rings of 104 and 64 KB (6 and 4 stages a
  consumer where the kept rings have 13); beside them the SIMT kernel of
  the kept library.
- ``emb_ghost_norm``: ids (8, 512), d 1536, bf16 cotangents, three id
  draws: uniform in [0, 151936), 4 values (heavy duplicates), one id at
  every position. Variants: the kept kernel (``csrc/emb_norm.cu``: the
  ids in shared memory, one row of a run in flight, a second launch for
  the partials' sum), its partials summed in the same launch by the last
  CTA of each b, two rows of a run in flight (in passes of fewer
  columns), and the first version (``designs/emb_norm_pairs.cu``).

- ``fused_clip_grad``: parity_layer's five smoke-width units (f32, B=8,
  T=512: qkv, o, gate+up, down at L=2, the head), the four gate-edge
  cases (bf16, B=8, T=512: edge_square L=1 d=p=512, edge_stacked L=4
  d=p=256, edge_adapter_A d=1536 p=16, edge_adapter_B d=16 p=1536) and
  three units whose tiles outnumber the card's resident CTAs (B=8: the
  adapter's A stacked over 28 layers at T=2, bf16 and f32, and 8192
  layers of d=p=8 at T=1).
  Variants: the kept kernel (``csrc/fused_clip.cu``: design (A), one
  grid barrier a group of samples, a cooperative launch; SIMT tiles of
  16 where they fit, each tile's rows split over a cluster of up to 8
  CTAs; wgmma 64 x 64 tiles, rows split over up to 4 where the unit has
  at most a quarter as many tiles as SMs, a ring of 4 stages); design (B)
  (the same source launched as one cluster of at most 16 CTAs meeting at
  barrier.cluster; refused where the unit needs more CTAs); SIMT rows
  split over 1 or at most 4 CTAs; SIMT tiles of 32 at the least; wgmma
  rows never split, or split whatever the unit's tiles; a wgmma ring of 6
  stages; the walk's second sweep on each route the other way: the wgmma
  route reading the first sweep's tiles back from a device scratch of
  nb*L*d*p f32 instead of contracting again (``walk_spill_wgmma``), the
  SIMT route contracting again instead of reading them back
  (``walk_recompute_simt``); the walk for every unit, resident or not
  (``walk_always``); and the first version
  (``designs/fused_clip_two_launch.cu``: 2B launches, an L*d*p scratch, G
  zeroed before each call).
- ``counter_noise`` and ``noise_update``: ``train``'s largest leaf,
  blocks/mlp/up/w (28, 1536, 17920) bf16, under train's step-0 key, and
  2^24 draws alone (an f32 zero leaf, alpha = denom = 1). counter_noise's
  variants: the kept kernel (``csrc/counter_normal.cuh``'s warp draw:
  ndtri's tail compacted per warp, products and sums each rounded), ndtri
  contracted to FMA, the tail not compacted (each lane its own, divergent),
  threefry's adds as IMAD on the FMA pipe (``threefry_imad``; the kept
  draw leaves them to ptxas), the quotient by denom always an IEEE
  division, the other blocks an SM must hold (:data:`NOISE_BLOCKS`: the
  registers a thread may take), and the first version, one thread an
  element (``designs/counter_noise_per_element.cu``); then ablations
  (:data:`NOISE_ABLATIONS`, wrong by design): every lane on ndtri's
  central branch, no ndtri (the uniform is the draw), no threefry (one
  multiply for its rounds); beside them the chain the first phase 4 ran
  (``randn``, multiply, add, divide). Each row says whether the output is
  bitwise the kept kernel's and how many ulp its draws are from the kept
  kernel's, and counts each variant's threefry2x32 block in its SASS
  (:func:`threefry_counts`); then the kept draw and ``threefry_imad``
  timed interleaved, three times. noise_update: first the kept kernel
  (``csrc/noise_update.cu``: a warp's runs drawn, then each lane's
  operands loaded) and the staged design (``designs/noise_update_staged.cu``:
  each warp's next operands staged in shared memory by bulk copies while
  it draws), each against the first version
  (``designs/noise_update_per_lane.cu``: the keys as two lists) on the
  same inputs, p and every state bitwise (:data:`UPDATE_CASES`: AdamW,
  SGD, FTRL ordinary at a tree's t = 3, whose lists share a node, and
  restart; bf16 and f32 g and p; a ragged n; an unaligned head;
  power-of-two and other denoms), raising after the timings where any
  differs; then, on the up leaf, AdamW (bf16 p, f32 moments) and FTRL
  (t = 3, and a restart at t = 1): the kept kernel with its draw and
  without (its bytes and the step alone), and dividing by a denom of 7;
  the first version; the staged design; the draw not compacted; every
  quotient by denom an IEEE division; the designs of
  :data:`NOISE_UPDATE_PATCHES` (the first version loading before its draw
  or drawing by the key plan; the staged design with 3 stages, its results
  stored by bulk copies, a proxy fence before each refill, the largest
  shared-memory carveout asked for); the other blocks an SM; the kept
  kernel and ``threefry_imad`` interleaved, three times each on AdamW and
  FTRL; beside them ``torch._fused_adamw_`` over the noised leaf (on f32
  copies of p and the gradient where it refuses bf16 params with f32
  moments).

Prints one JSON line a variant: CUDA-event ms around the C call (median of
5 runs of 20 calls), device ms by kernel (torch.profiler), whether the
output is bitwise the kept kernel's, ghost_norm's largest relative error
against the plain version and against a float64 evaluation, and the
variant's ptxas lines (registers, spills, C75xx notes); wkv6's largest
difference from the kept kernel and from a float64 recurrence at head 0;
moe_ghost_norm's and emb_ghost_norm's largest relative error against a
float64 evaluation; fused_clip_grad's kernels a call (by the profiler),
its largest difference from the kept kernel and from the plain version
(and whether that is within 1e-3 of the output's scale).
CUDA-event ms time the C call alone (no wrapper).
Then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels import build

DESIGNS = Path(__file__).resolve().parent / "designs"
SEED = 0
B, T, D, V = 8, 512, 1536, 151936

# name -> (source, [(text, replacement)]) against csrc/emb_grad.cu
EMB_PATCHES = {
    "kept": ("emb_grad.cu", []),
    # warp 0 takes every id (the others' ranges start past the last)
    "one_warp_scan": ("emb_grad.cu", [(
        "const int quarter = (BT + 32 * WARPS - 1) / (32 * WARPS) * 32;",
        "const int quarter = (BT + 31) / 32 * 32;")]),
}
EMB_SORTED = ("sorted_rows", "sorted_long_ctas")

_PIECE = "constexpr int PIECE = 8; "
_P_LOOP = """    float sum = 0.f;
    for (int s0 = g0; s0 < g1; s0 += PIECE) {
      for (int s = s0; s < s0 + PIECE && s < g1; ++s)
        stage(gg, s > s0, diag);
      drain();
#pragma unroll
      for (int q = 0; q < 64; ++q) sum = fmaf(ga[q], gg[q], sum);
    }
"""
# the p Gram a stage at a time, alternating between gg and gh: a stage's
# products are folded into the sum while the next stage's run
_FOLD_A_STAGE = """    float sum = 0.f, gh[64];
    for (int s = g0; s < g1; s += 2) {
      stage(gg, false, diag);   // gh's stage (the one before) is done
      hopper::fence_regs(gh);
      if (s > g0) {
#pragma unroll
        for (int q = 0; q < 64; ++q) sum = fmaf(ga[q], gh[q], sum);
      }
      if (s + 1 < g1) {
        stage(gh, false, diag);   // gg's stage is done
        hopper::fence_regs(gg);
      } else {
        drain();
      }
#pragma unroll
      for (int q = 0; q < 64; ++q) sum = fmaf(ga[q], gg[q], sum);
    }
    if ((g1 - g0) % 2 == 0) {   // the last stage went into gh
      drain();
      hopper::fence_regs(gh);
#pragma unroll
      for (int q = 0; q < 64; ++q) sum = fmaf(ga[q], gh[q], sum);
    }
"""
GHOST_PATCHES = {
    "kept": ("ghost_norm_wgmma.cu", []),
    "piece_4": ("ghost_norm_wgmma.cu",
                [(_PIECE, "constexpr int PIECE = 4; ")]),
    "piece_16": ("ghost_norm_wgmma.cu",
                 [(_PIECE, "constexpr int PIECE = 16; ")]),
    "one_accumulator_a_chunk": ("ghost_norm_wgmma.cu",
                                [(_PIECE, "constexpr int PIECE = 1 << 20; ")]),
    "fold_a_stage": ("ghost_norm_wgmma.cu", [(_P_LOOP, _FOLD_A_STAGE)]),
}

_CHUNK = "int chunk_of(int h) { return h > 64 ? 32 : 64; }"
_H64 = ("return launch<T, 64, 64>(r, k, v, w, u, ub, state, o, B, Tn, H, h, "
        "st);")
WKV_PATCHES = {
    "kept": ("wkv6_chunked.cu", []),
    "chunk_32": ("wkv6_chunked.cu", [
        (_CHUNK, "int chunk_of(int h) { return 32; }"),
        (_H64, _H64.replace("<T, 64, 64>", "<T, 64, 32>"))]),
    "state_cols_16": ("wkv6_chunked.cu", [
        ("constexpr int JB = 32; ", "constexpr int JB = 16; ")]),
}
_MOE_PIECE = "constexpr int PIECE = 8; "
_MOE_RING = "constexpr int RING_BYTES = 208 * 1024; "
MOE_PATCHES = {
    "kept": ("moe_ghost_norm_wgmma.cu", []),
    "piece_4": ("moe_ghost_norm_wgmma.cu",
                [(_MOE_PIECE, "constexpr int PIECE = 4; ")]),
    "piece_32": ("moe_ghost_norm_wgmma.cu",
                 [(_MOE_PIECE, "constexpr int PIECE = 32; ")]),
    "ring_104k": ("moe_ghost_norm_wgmma.cu",
                  [(_MOE_RING, "constexpr int RING_BYTES = 104 * 1024; ")]),
    "ring_64k": ("moe_ghost_norm_wgmma.cu",
                 [(_MOE_RING, "constexpr int RING_BYTES = 64 * 1024; ")]),
}

# emb_norm.cu with its partials summed in the same launch: each CTA
# publishes its partial by a device-wide fence and an atomic count a b
# (module memory, 0 at load), and the last CTA of b sums them in index
# order and sets the count back to 0
_EMB_TAIL = """  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < WARPS; ++i) s += warp_tot[i];
    partial[((long long)b * L + l) * nch + chunk] = s;
  }
}
"""
_EMB_ONE_LAUNCH_TAIL = """  __shared__ bool last;
  const int per_b = L * nch;
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < WARPS; ++i) s += warp_tot[i];
    partial[(long long)b * per_b + (long long)l * nch + chunk] = s;
    __threadfence();
    last = atomicAdd(emb_counts + b, 1u) == (unsigned)per_b - 1;
  }
  __syncthreads();
  if (last && w == 0) {
    __threadfence();
    const float* pb = partial + (long long)b * per_b;
    float s = 0.f;
    for (int i = lane; i < per_b; i += 32) s += __ldcg(pb + i);
    s = warp_sum(s);
    if (lane == 0) {
      out[b] = s;
      emb_counts[b] = 0u;
    }
  }
}
"""
_EMB_ONE_LAUNCH = [
    ("template <typename T, bool VEC>\n__global__",
     "__device__ unsigned emb_counts[65536];\n\n"
     "template <typename T, bool VEC>\n__global__"),
    ("                    int nch) {\n",
     "                    int nch, float* __restrict__ out) {\n"),
    (_EMB_TAIL, _EMB_ONE_LAUNCH_TAIL),
    ("int launch(const int* ids, const void* ds, float* partial, int L, "
     "int B,\n",
     "int launch(const int* ids, const void* ds, float* partial, float* out,"
     " int L, int B,\n"),
    ("emb_norm_kernel<T, true><<<grid, THREADS, smem, st>>>(\n"
     "        ids, (const T*)ds, partial, L, B, T_, d, nch);",
     "emb_norm_kernel<T, true><<<grid, THREADS, smem, st>>>(\n"
     "        ids, (const T*)ds, partial, L, B, T_, d, nch, out);"),
    ("emb_norm_kernel<T, false><<<grid, THREADS, smem, st>>>(\n"
     "        ids, (const T*)ds, partial, L, B, T_, d, nch);",
     "emb_norm_kernel<T, false><<<grid, THREADS, smem, st>>>(\n"
     "        ids, (const T*)ds, partial, L, B, T_, d, nch, out);"),
    ("launch<__nv_bfloat16>(ids, ds, partial, L,",
     "launch<__nv_bfloat16>(ids, ds, partial, out, L,"),
    ("launch<float>(ids, ds, partial, L,", "launch<float>(ids, ds, partial, "
     "out, L,"),
    ("  if (err) return err;\n  reduce_rows_kernel<<<B, 256, 0, st>>>("
     "partial, out, L * nch);\n", "  if (err) return err;\n"),
]
EMB_NORM_PATCHES = {
    "kept": ("emb_norm.cu", []),
    "one_launch": ("emb_norm.cu", _EMB_ONE_LAUNCH),
    "two_rows_in_flight": ("emb_norm.cu", [
        ("static constexpr int N = 4, NV = 4;",
         "static constexpr int N = 4, NV = 2;"),
        ("static constexpr int N = 8, NV = 3;",
         "static constexpr int N = 8, NV = 2;"),
        ("constexpr int UNROLL = 1; ", "constexpr int UNROLL = 2; ")]),
}

_SPLIT = "constexpr int MAX_SPLIT = 8; "
FUSED_PATCHES = {
    "kept": ("fused_clip.cu", []),
    "one_cluster": ("fused_clip.cu", [(
        "constexpr bool ONE_CLUSTER = false;",
        "constexpr bool ONE_CLUSTER = true;")]),
    "simt_split_1": ("fused_clip.cu", [
        (_SPLIT, "constexpr int MAX_SPLIT = 1; ")]),
    "simt_split_4": ("fused_clip.cu", [
        (_SPLIT, "constexpr int MAX_SPLIT = 4; ")]),
    "simt_tile_32": ("fused_clip.cu", [(
        "static const int tiles[3] = {16, 32, 64};",
        "static const int tiles[3] = {32, 32, 64};")]),
    "wgmma_split_1": ("fused_clip.cu", [(
        "constexpr int WG_MAX_SPLIT = 4; ",
        "constexpr int WG_MAX_SPLIT = 1; ")]),
    "wgmma_split_always": ("fused_clip.cu", [(
        "constexpr int SPLIT_FEW = 4;", "constexpr int SPLIT_FEW = 0;")]),
    "wgmma_ring_6": ("fused_clip.cu", [(
        "constexpr int STAGES = 4;", "constexpr int STAGES = 6;")]),
    "walk_spill_wgmma": ("fused_clip.cu", [(
        "constexpr bool SPILL_WGMMA = false;",
        "constexpr bool SPILL_WGMMA = true;")]),
    "walk_recompute_simt": ("fused_clip.cu", [(
        "constexpr bool SPILL_SIMT = true;",
        "constexpr bool SPILL_SIMT = false;")]),
    "walk_always": ("fused_clip.cu", [(
        "constexpr bool WALK_ALWAYS = false;",
        "constexpr bool WALK_ALWAYS = true;")]),
}
# (case, L, T, d, p, dtype): L = 0 is the unstacked head; the last three
# have more tiles than the card holds CTAs (the walk)
FUSED_CASES = [("smoke qkv", 2, T, 32, 64, torch.float32),
               ("smoke o", 2, T, 32, 32, torch.float32),
               ("smoke gate+up", 2, T, 32, 96, torch.float32),
               ("smoke down", 2, T, 48, 32, torch.float32),
               ("smoke head", 0, T, 32, 64, torch.float32),
               ("edge_square", 1, T, 512, 512, torch.bfloat16),
               ("edge_stacked", 4, T, 256, 256, torch.bfloat16),
               ("edge_adapter_A", 1, T, 1536, 16, torch.bfloat16),
               ("edge_adapter_B", 1, T, 16, 1536, torch.bfloat16),
               ("edge_adapter_stacked", 28, 2, 1536, 16, torch.bfloat16),
               ("edge_adapter_stacked_f32", 28, 2, 1536, 16, torch.float32),
               ("many_tiles", 8192, 1, 8, 8, torch.bfloat16)]

# the kept wkv6 kernel with one phase skipped (a loop run zero times)
WKV_ABLATIONS = {
    "skip_pass2_diagonal_blocks": ("wkv6_chunked.cu", [(
        "for (int ii = 0; ii < QC; ii += 2) {",
        "for (int ii = 0; ii < 0; ii += 2) {")]),
    "skip_pass2_offdiagonal_blocks": ("wkv6_chunked.cu", [(
        "  if (q > 0) {\n    float acc[NS - 1][4];",
        "  if (q < 0) {\n    float acc[NS - 1][4];")]),
    "skip_pass2_A_V": ("wkv6_chunked.cu", [(
        "for (int kk = 0; kk < qb + SUB; kk += 8) {",
        "for (int kk = 0; kk < 0; kk += 8) {")]),
    "skip_pass2_S0_load_and_product": ("wkv6_chunked.cu", [
        ("  if (c > 0) {\n    for (int e = tid;",
         "  if (c < 0) {\n    for (int e = tid;"),
        ("  if (c > 0) {\n    // S0 split", "  if (c < 0) {\n    // S0 split")]),
    "skip_pass1_walk": ("wkv6_chunked.cu", [(
        "for (int s0 = s_end - 8; s0 >= th * HALF; s0 -= 8) {",
        "for (int s0 = s_end - 8; s0 >= s_end; s0 -= 8) {")]),
    "skip_pass1_product": ("wkv6_chunked.cu", [(
        "for (int kk = th * HALF; kk < th * HALF + HALF; kk += 8) {",
        "for (int kk = th * HALF; kk < th * HALF; kk += 8) {")]),
}

# counter_noise and noise_update: patches of csrc/counter_normal.cuh, which
# each variant's source (csrc/counter_noise.cu or csrc/noise_update.cu)
# takes in place of its #include. ndtri's products and sums contracted to
# FMA, the draw without its tail compacted (each lane evaluates its own
# tail values, divergent), and threefry's adds as IMAD on the FMA pipe
# (a mad.lo by a 1 ptxas cannot fold) instead of ptxas's own mix of IADD3
# and IMAD: the ways not taken; then ablations
# of the kept draw, whose outputs are wrong by design and whose times say
# what each part of a draw costs
_TAIL = "const bool tail = !central(mcp);"
_CENTRAL = "z[j] = ndtri_central(mcp);"
_IADD = """__device__ __forceinline__ uint32_t iadd(uint32_t x, uint32_t y) {
  return x + y;
}"""
NOISE_PATCHES = {
    "kept": [],
    "ndtri_contracted": [("return __fmul_rn(a, b);", "return a * b;"),
                         ("return __fadd_rn(a, b);", "return a + b;")],
    "no_compaction": [(_TAIL, "const bool tail = false;"),
                      (_CENTRAL, "z[j] = central(mcp) ? ndtri_central(mcp) "
                                 ": ndtri_tail(mcp);")],
    # the quotient by denom always by __fdiv_rn (the kept draw multiplies
    # by 1 / denom where denom is a power of two: bitwise the same)
    "ieee_division": [
        ("return q.inv != 0.f ? __fmul_rn(s, q.inv) : __fdiv_rn(s, q.d);",
         "return __fdiv_rn(s, q.d);")],
    "threefry_imad": [(_IADD, """__device__ __forceinline__ uint32_t iadd(uint32_t x, uint32_t y) {
  uint32_t sms, r;
  asm("mov.u32 %0, %%nsmid;" : "=r"(sms));
  asm("mad.lo.u32 %0, %1, %2, %3;"
      : "=r"(r)
      : "r"(y), "r"(sms != 0u ? 1u : 0u), "r"(x));
  return r;
}""")],
}
NOISE_ABLATIONS = {
    # every lane takes ndtri's central branch: the compacted tail's cost is
    # the difference
    "central_branch_only": [(_TAIL, "const bool tail = false;")],
    # the uniform itself is the draw: threefry, the queue's votes and the
    # pass alone
    "skip_ndtri": [(_TAIL, "const bool tail = false;"),
                   (_CENTRAL, "z[j] = mcp;")],
    # one multiply for threefry's 20 rounds: ndtri and the pass alone
    "skip_threefry": [("p = uniform(threefry2x32(k0, k1, lo, hi).x);",
                       "p = uniform((lo ^ k0) * 0x9E3779B9u);")],
}
# noise_update's designs not taken, each (source, patches of it): the first
# version with a run's operands loaded before its draw (they then hold
# registers through it, 101, 2 blocks an SM); the operands staged in shared
# memory by 1-D bulk copies while the warp draws, a ring of 2 stages a warp
# (designs/noise_update_staged.cu), and that design with a ring of 3 stages
# (72-96 KB of shared memory a block: 2 blocks an SM)
_PER_LANE = DESIGNS / "noise_update_per_lane.cu"
_STAGED = DESIGNS / "noise_update_staged.cu"
NOISE_UPDATE_PATCHES = {
    "loads_first": (_PER_LANE, [
        ("    float xi[cn::RUN];\n    if (noise)\n",
         "    float xi[cn::RUN], gv[cn::RUN], mv[cn::RUN], vv[cn::RUN], "
         "pv[cn::RUN];\n    if (r < runs) {\n"
         "      cn::load_run(g + i, gv);\n      cn::load_run(m + i, mv);\n"
         "      if (TWO) cn::load_run(v + i, vv);\n"
         "      if (from_t0)\n        cn::load_run(t0 + i, pv);\n"
         "      else\n        cn::load_run(p + i, pv);\n    }\n"
         "    if (noise)\n"),
        ("      float gv[cn::RUN], mv[cn::RUN], vv[cn::RUN], pv[cn::RUN];\n"
         "      cn::load_run(g + i, gv);\n      cn::load_run(m + i, mv);\n"
         "      if (TWO) cn::load_run(v + i, vv);\n"
         "      if (from_t0)\n        cn::load_run(t0 + i, pv);\n"
         "      else\n        cn::load_run(p + i, pv);\n", "")]),
    "staged": (_STAGED, []),
    "stages_3": (_STAGED, [("constexpr int STAGES = 2;",
                                      "constexpr int STAGES = 3;")]),
    # lane 0 runs fence.proxy.async before it refills a stage
    "proxy_fence": (_STAGED, [
        ("      const uint32_t p_bytes = e * (from_t0 ? 4u : "
         "(uint32_t)sizeof(P));\n",
         "      const uint32_t p_bytes = e * (from_t0 ? 4u : "
         "(uint32_t)sizeof(P));\n      hopper::fence_proxy_async();\n")]),
    # the first version drawing by the key plan (cn::warp_xi) instead of
    # its two lists: what the plan's walk costs
    "per_lane_plan": (_PER_LANE, [
        ("      warp_xi_lists(keys, n_hi, n_lo, start + (unsigned long long)i,\n"
         "                    trail, queue, xi);",
         "      cn::warp_xi(keys, n_hi + n_lo, start + (unsigned long long)i,\n"
         "                  trail, queue, xi);"),
        ("    for (int j = 0; j < 2 * (n_hi + n_lo); ++j) k.k[j] = keys[j];",
         "    for (int j = 0; j < 2 * (n_hi + n_lo); ++j) k.k[j] = keys[j];\n"
         "  for (int j = 0; j < n_hi + n_lo; ++j)\n"
         "    k.side[j] = j < n_hi ? cn::HI : cn::LO;")]),
    # the SM's largest shared-memory carveout asked for (the staged design
    # leaves it to the CUDA driver)
    "carveout_max_shared": (_STAGED, [
        ("  static const int allowed = hopper::allow_smem(kernel, ring);\n",
         "  static const int allowed =\n"
         "      hopper::allow_smem(kernel, ring) |\n"
         "      (int)cudaFuncSetAttribute(\n"
         "          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,\n"
         "          (int)cudaSharedmemCarveoutMaxShared);\n")]),
    # the results written back into the stage and stored by lane 0's 1-D
    # bulk copies (hopper::bulk_store_1d, one bulk group a tile, read out
    # before the stage is refilled) instead of each lane's vector stores
    "bulk_stores": (_STAGED, [
        ("      if (lane != 0) return;\n",
         "      if (lane != 0) return;\n"
         "      hopper::bulk_wait_read<0>();\n"),
        ("        cn::store_run(m + i, mv);\n"
         "        if (TWO) cn::store_run(v + i, vv);\n"
         "        cn::store_run(p + i, pv);\n"
         "      }\n"
         "      __syncwarp();               // stage s is free for tile k + "
         "STAGES\n"
         "    }\n",
         "        uint8_t* sw = mine + s * S::BYTES;\n"
         "        cn::store_run(reinterpret_cast<float*>(sw + S::M_OFF) + at, "
         "mv);\n"
         "        if (TWO)\n"
         "          cn::store_run(reinterpret_cast<float*>(sw + S::V_OFF) + "
         "at, vv);\n"
         "        cn::store_run(reinterpret_cast<P*>(sw + S::P_OFF) + at, "
         "pv);\n"
         "        hopper::fence_proxy_async();\n"
         "      }\n"
         "      __syncwarp();\n"
         "      if (lane == 0) {\n"
         "        const long long left = runs - r0;\n"
         "        const uint32_t e = (uint32_t)((left < 32 ? left : 32) * "
         "cn::RUN);\n"
         "        const long long i0 = head + r0 * cn::RUN;\n"
         "        uint8_t* sw = mine + s * S::BYTES;\n"
         "        hopper::bulk_store_1d(m + i0, sw + S::M_OFF, e * 4u);\n"
         "        if (TWO) hopper::bulk_store_1d(v + i0, sw + S::V_OFF, "
         "e * 4u);\n"
         "        hopper::bulk_store_1d(p + i0, sw + S::P_OFF,\n"
         "                              e * (uint32_t)sizeof(P));\n"
         "        hopper::bulk_commit();\n"
         "      }\n"
         "    }\n"
         "    if (lane == 0) hopper::bulk_wait<0>();\n")]),
}
# the blocks an SM must hold (MIN_BLOCKS in counter_noise.cu and
# noise_update.cu), so the registers a thread may take (2: up to 128; 3:
# 80; 4: 64): each kernel is also built with the counts it does not keep
NOISE_BLOCKS = (2, 3, 4)
_MIN_BLOCKS = re.compile(r"constexpr int MIN_BLOCKS = (\d+);")


def blocks_patches(cu: str, blocks: int) -> list:
    """csrc/``cu``'s MIN_BLOCKS set to ``blocks``: [] where it is kept."""
    text = (build.CSRC / cu).read_text()
    kept = _MIN_BLOCKS.search(text)
    if kept is None:
        raise RuntimeError(f"{cu}: no MIN_BLOCKS")
    return [] if int(kept.group(1)) == blocks else [
        (kept.group(0), f"constexpr int MIN_BLOCKS = {blocks};")]


def patched(src: Path, patches) -> str:
    text = src.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"{src.name}: the text to replace is not "
                               f"there once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variants(variants: dict, tmp: Path) -> dict:
    """name -> text of a .cu -> {name: (CDLL, ptxas output)}; every nvcc
    started together, each into its own library."""
    tmp.mkdir(parents=True, exist_ok=True)
    for h in build.CSRC.glob("*.cuh"):
        shutil.copy(h, tmp)
    procs = {}
    for name, text in variants.items():
        cu, so = tmp / f"{name}.cu", tmp / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), "-gencode", build.ARCH, "-std=c++17", "-O3",
             "-Xptxas=-v", "-Xcompiler", "-fPIC", "-shared", "-I", str(tmp),
             str(cu), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        notes = [ln.strip() for ln in out.splitlines()
                 if "registers" in ln or "spill" in ln or "C75" in ln]
        libs[name] = (ctypes.CDLL(str(tmp / f"lib{name}.so")), notes)
    return libs


def events_ms(fn, n: int = 20, runs: int = 5) -> float:
    """Median over ``runs`` of CUDA-event ms a call, ``n`` calls a run."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / n)
    return statistics.median(times)


def device_ms(fn, reps: int = 5) -> dict:
    """Device ms a call by kernel name (torch.profiler), over ``reps``
    (after two calls of the profiler's warm-up, whose first kernels after
    start-up can be lost)."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=2, active=1,
                                             repeat=1)) as prof:
        for n in (1, 1, reps):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            prof.step()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name[:60]] = (by_name.get(e.name[:60], 0.0)
                                    + e.time_range.elapsed_us() / reps / 1e3)
    return by_name


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def study_emb(tmp: Path, dev: str) -> None:
    variants = {n: patched(build.CSRC / s, p)
                for n, (s, p) in EMB_PATCHES.items()}
    variants["sorted"] = (DESIGNS / "emb_grad_sorted.cu").read_text()
    libs = build_variants(variants, tmp)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    ids = torch.randint(0, V, (B, T), generator=g, device=dev,
                        dtype=torch.int32)
    ds = torch.randn(B, T, D, generator=g, device=dev).to(torch.bfloat16)
    C = torch.rand(B, generator=g, device=dev) + 0.1
    out = torch.empty(V, D, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    calls = {}
    for name in EMB_PATCHES:
        lib = libs[name][0]
        lib.dp_emb_grad.argtypes = [P] * 5 + [I] * 6 + [P]
        lib.dp_emb_grad_scratch_ints.argtypes = [I]
        scr = torch.empty(lib.dp_emb_grad_scratch_ints(V), dtype=torch.int32,
                          device=dev)
        calls[name] = (lambda f=lib.dp_emb_grad, s=scr: _check(f(
            ids.data_ptr(), C.data_ptr(), ds.data_ptr(), s.data_ptr(),
            out.data_ptr(), 1, B, T, D, V, 1, 0), "dp_emb_grad"))
    lib = libs["sorted"][0]
    lib.dp_emb_grad_sorted.argtypes = [P] * 5 + [I] * 7 + [P]
    lib.dp_emb_sorted_scratch_ints.argtypes = [I] * 3
    scr = torch.empty(lib.dp_emb_sorted_scratch_ints(1, B, T),
                      dtype=torch.int32, device=dev)
    sorted_fn = lib.dp_emb_grad_sorted
    for long_lived, name in enumerate(EMB_SORTED):
        calls[name] = (lambda ll=long_lived: _check(sorted_fn(
            ids.data_ptr(), C.data_ptr(), ds.data_ptr(), scr.data_ptr(),
            out.data_ptr(), 1, B, T, D, V, 1, ll, 0), "dp_emb_grad_sorted"))
    flat = ids.reshape(-1).long()
    w = (ds.float() * C[:, None, None]).reshape(-1, D)
    calls["fill"] = lambda: out.zero_()
    calls["index_add"] = lambda: torch.zeros(V, D, device=dev).index_add_(
        0, flat, w)
    calls["kept"]()
    torch.cuda.synchronize()
    kept = out.clone()
    for name, fn in calls.items():
        row = {"study": "emb_clipped_grad", "variant": name,
               "ms": events_ms(fn), "device_ms": device_ms(fn)}
        if name in libs or name in EMB_SORTED:
            out.fill_(float("nan"))
            fn()
            torch.cuda.synchronize()
            row["bitwise_kept"] = bool(torch.equal(out, kept))
            row["ptxas"] = libs["sorted" if name in EMB_SORTED else name][1]
        print(json.dumps(row), flush=True)


def study_ghost(tmp: Path, dev: str) -> None:
    from repro_torch.kernels import ghost_norm as gn
    variants = {n: patched(build.CSRC / s, p)
                for n, (s, p) in GHOST_PATCHES.items()}
    libs = build_variants(variants, tmp)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    a = torch.randn(1, B, T, D, generator=g, device=dev).to(torch.bfloat16)
    ds = torch.randn(1, B, T, V, generator=g, device=dev).to(torch.bfloat16)
    plain = gn.plain(a, ds)
    exact = torch.zeros(B, dtype=torch.float64, device=dev)
    for b in range(B):
        x, y = a[0, b].double(), ds[0, b].double()
        exact[b] = ((x @ x.T) * (y @ y.T)).sum()
    del x, y
    torch.cuda.empty_cache()
    P, I = ctypes.c_void_p, ctypes.c_int
    out = torch.empty(B, device=dev)
    kept = None
    for name, (lib, notes) in libs.items():
        lib.dp_ghost_norm_wgmma.argtypes = [P] * 4 + [I] * 5 + [P]
        lib.dp_ghost_norm_wgmma_nparts.argtypes = [I] * 5
        part = torch.empty(B, lib.dp_ghost_norm_wgmma_nparts(1, B, T, D, V),
                           device=dev)
        fn = (lambda f=lib.dp_ghost_norm_wgmma, pt=part: _check(f(
            a.data_ptr(), ds.data_ptr(), pt.data_ptr(), out.data_ptr(), 1, B,
            T, D, V, 0), "dp_ghost_norm_wgmma"))
        fn()
        torch.cuda.synchronize()
        got = out.clone()
        fn()
        torch.cuda.synchronize()
        kept = got if kept is None else kept
        row = {"study": "ghost_norm", "variant": name, "ms": events_ms(fn),
               "device_ms": device_ms(fn),
               "rel_err_plain": float(((got - plain).abs()
                                       / plain.abs()).max()),
               "rel_err_f64": float(((got.double() - exact).abs()
                                     / exact.abs()).max()),
               "bitwise_run_to_run": bool(torch.equal(got, out)),
               "bitwise_kept": bool(torch.equal(got, kept)),
               "ptxas": notes}
        print(json.dumps(row), flush=True)
    print(json.dumps({"study": "ghost_norm", "variant": "plain_vs_f64",
                      "rel_err_f64": float(((plain.double() - exact).abs()
                                            / exact.abs()).max())}),
          flush=True)


def study_wkv(tmp: Path, dev: str) -> None:
    from repro_torch.kernels import wkv6 as wk
    variants = {n: patched(build.CSRC / s, p)
                for n, (s, p) in {**WKV_PATCHES, **WKV_ABLATIONS}.items()}
    libs = build_variants(variants, tmp)
    Bw, Tw, Hw, hw = 4, 4096, 40, 64
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    r, k, v = (torch.randn(Bw, Tw, Hw, hw, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(3))
    w = (torch.rand(Bw, Tw, Hw, hw, generator=g, device=dev) * 0.499
         + 0.5).to(torch.bfloat16)
    u = torch.randn(Hw, hw, generator=g, device=dev) * 0.5
    # the recurrence in float64 at (b 0, head 0)
    x = [t[0, :, 0].double() for t in (r, k, v, w)]
    S = torch.zeros(hw, hw, dtype=torch.float64, device=dev)
    exact = torch.empty(Tw, hw, dtype=torch.float64, device=dev)
    for t in range(Tw):
        rt, kt, vt, wt = (y[t] for y in x)
        exact[t] = rt @ S + (rt * u[0].double() * kt).sum() * vt
        S = wt[:, None] * S + kt[:, None] * vt[None, :]
    P, I = ctypes.c_void_p, ctypes.c_int
    out = torch.empty(Bw, Tw, Hw, hw, device=dev)
    ptrs = [t.data_ptr() for t in (r, k, v, w, u)]
    calls = {}
    for name, (lib, notes) in libs.items():
        lib.dp_wkv6_chunked.argtypes = [P] * 5 + [I] + [P] * 2 + [I] * 5 + [P]
        lib.dp_wkv6_chunked_nparts.argtypes = [I, I]
        state = torch.empty(Bw, Hw, lib.dp_wkv6_chunked_nparts(Tw, hw), hw,
                            hw, device=dev)
        calls[name] = (lambda f=lib.dp_wkv6_chunked, st=state: _check(f(
            *ptrs, 0, st.data_ptr(), out.data_ptr(), Bw, Tw, Hw, hw, 1, 0),
            "dp_wkv6_chunked"))
    calls["scan"] = lambda: wk.wkv6(r, k, v, w, u, kernel="scan")
    kept = None
    for name, fn in calls.items():
        got = fn() if name == "scan" else (fn(), out.clone())[1]
        torch.cuda.synchronize()
        kept = got if kept is None else kept
        row = {"study": "wkv6", "variant": name, "ms": events_ms(fn),
               "device_ms": device_ms(fn),
               "max_abs_diff_kept": float((got - kept).abs().max()),
               "max_abs_err_f64": float((got[0, :, 0].double() - exact)
                                        .abs().max())}
        if name in libs:
            row["ptxas"] = libs[name][1]
        if name in WKV_ABLATIONS:
            row["ablation"] = "one phase skipped: the output is wrong"
        print(json.dumps(row), flush=True)


def study_wkv_bwd(tmp: Path, dev: str) -> None:
    from repro_torch.kernels import wkv6 as wk
    libs = build_variants({
        "kept": (build.CSRC / "wkv6_backward.cu").read_text(),
        "first": (DESIGNS / "wkv6_backward_first.cu").read_text()}, tmp)
    B, T, H, h = 8, 512, 40, 64
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    r, k, v = (torch.randn(B, T, H, h, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(3))
    w = (torch.rand(B, T, H, h, generator=g, device=dev) * 0.499
         + 0.5).to(torch.bfloat16)
    u = torch.randn(B, H, h, generator=g, device=dev) * 0.5
    do = torch.randn(B, T, H, h, generator=g, device=dev)
    state = wk._forward(r, k, v, w, u, "chunked")[1]
    part = torch.empty(3 * B * T * H * h + B * H * h, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    outs, calls = {}, {}
    for name, (lib, _) in libs.items():
        lib.dp_wkv6_backward.argtypes = [P] * 5 + [I] + [P] * 8 + [I] * 5 + [P]
        outs[name] = [torch.empty(B, T, H, h, device=dev) for _ in range(4)]
        outs[name].append(torch.empty(B, H, h, device=dev))
        ptrs = [t.data_ptr() for t in (r, k, v, w, u)] + [H * h] + [
            t.data_ptr() for t in (do, state, *outs[name], part)]
        calls[name] = (lambda f=lib.dp_wkv6_backward, a=ptrs: _check(
            f(*a, B, T, H, h, 1, 0), "dp_wkv6_backward"))
        calls[name]()
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b)
                  for a, b in zip(outs["kept"], outs["first"]))
    for name, fn in calls.items():
        print(json.dumps({"study": "wkv6_backward", "variant": name,
                          "ms": events_ms(fn), "device_ms": device_ms(fn),
                          "bitwise_first": bitwise,
                          "ptxas": libs[name][1]}), flush=True)
    if not bitwise:
        raise RuntimeError("wkv6_backward: the kept kernel's grads are not "
                           "bitwise the first version's")


def study_moe(tmp: Path, dev: str) -> None:
    from repro_torch.kernels import moe_ghost as mg
    variants = {n: patched(build.CSRC / s, p)
                for n, (s, p) in MOE_PATCHES.items()}
    libs = build_variants(variants, tmp)
    L, E, C, d, p = 5, 64, 60, 2048, 2816
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    # a router-like mask: each (l, b, e) keeps a random count of its first
    # slots, ~3/4 of them; the records zero at the empty slots
    n = torch.randint(0, C + 1, (L, B, E, 1), generator=g,
                      device=dev).float() * 1.5
    mask = (torch.arange(C, device=dev).float() < n).float()
    a = (torch.randn(L, B, E, C, d, generator=g, device=dev)
         * mask[..., None]).to(torch.bfloat16)
    ds = torch.randn(L, B, E, C, p, generator=g, device=dev).to(
        torch.bfloat16)
    exact = torch.zeros(B, dtype=torch.float64, device=dev)
    for l in range(L):
        m = mask[l].double()[..., None]
        x, y = a[l].double() * m, ds[l].double() * m
        exact += torch.einsum("becx,becx->b", x @ x.transpose(-1, -2),
                              y @ y.transpose(-1, -2))
    del x, y
    torch.cuda.empty_cache()
    P, I = ctypes.c_void_p, ctypes.c_int
    out = torch.empty(B, device=dev)
    calls = {}
    for name, (lib, notes) in libs.items():
        lib.dp_moe_ghost_norm_wgmma.argtypes = [P] * 5 + [I] * 6 + [P]
        lib.dp_moe_ghost_norm_wgmma_nparts.argtypes = [I]
        part = torch.empty(B, L * E * lib.dp_moe_ghost_norm_wgmma_nparts(C),
                           device=dev)
        calls[name] = (lambda f=lib.dp_moe_ghost_norm_wgmma, pt=part: _check(
            f(a.data_ptr(), mask.data_ptr(), ds.data_ptr(), pt.data_ptr(),
              out.data_ptr(), L, B, E, C, d, p, 0),
            "dp_moe_ghost_norm_wgmma"))
    calls["simt"] = lambda: out.copy_(mg.moe_ghost_norm(a, mask, ds,
                                                        kernel="simt"))
    kept = None
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        got = out.clone()
        fn()
        torch.cuda.synchronize()
        kept = got if kept is None else kept
        row = {"study": "moe_ghost_norm", "variant": name,
               "ms": events_ms(fn), "device_ms": device_ms(fn),
               "rel_err_f64": float(((got.double() - exact).abs()
                                     / exact.abs()).max()),
               "bitwise_run_to_run": bool(torch.equal(got, out)),
               "bitwise_kept": bool(torch.equal(got, kept))}
        if name in libs:
            row["ptxas"] = libs[name][1]
        print(json.dumps(row), flush=True)


def study_emb_norm(tmp: Path, dev: str) -> None:
    from repro_torch.kernels import emb_norm as en
    variants = {n: patched(build.CSRC / s, p)
                for n, (s, p) in EMB_NORM_PATCHES.items()}
    variants["first_version"] = (DESIGNS / "emb_norm_pairs.cu").read_text()
    libs = build_variants(variants, tmp)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    ds = torch.randn(B, T, D, generator=g, device=dev).to(torch.bfloat16)
    draws = {
        "ids~U[0,V)": torch.randint(0, V, (B, T), generator=g, device=dev,
                                    dtype=torch.int32),
        "4 ids": torch.randint(0, 4, (B, T), generator=g, device=dev,
                               dtype=torch.int32) * 977,
        "one id": torch.full((B, T), 7, device=dev, dtype=torch.int32)}
    P, I = ctypes.c_void_p, ctypes.c_int
    out = torch.empty(B, device=dev)
    for case, ids in draws.items():
        exact = en.run_model(ids, ds)
        kept = None
        for name, (lib, notes) in libs.items():
            if name == "first_version":
                lib.dp_emb_norm_pairs.argtypes = [P] * 4 + [I] * 5 + [P]
                lib.dp_emb_norm_pairs_nparts.argtypes = [I]
                part = torch.empty(B, lib.dp_emb_norm_pairs_nparts(T),
                                   device=dev)
                fn = (lambda f=lib.dp_emb_norm_pairs, pt=part: _check(f(
                    ids.data_ptr(), ds.data_ptr(), pt.data_ptr(),
                    out.data_ptr(), 1, B, T, D, 1, 0), "dp_emb_norm_pairs"))
            else:
                lib.dp_emb_norm.argtypes = [P] * 4 + [I] * 5 + [P]
                lib.dp_emb_norm_nparts.argtypes = [I]
                part = torch.empty(B, lib.dp_emb_norm_nparts(T), device=dev)
                fn = (lambda f=lib.dp_emb_norm, pt=part: _check(f(
                    ids.data_ptr(), ds.data_ptr(), pt.data_ptr(),
                    out.data_ptr(), 1, B, T, D, 1, 0), "dp_emb_norm"))
            fn()
            torch.cuda.synchronize()
            got = out.clone()
            fn()
            torch.cuda.synchronize()
            kept = got if kept is None else kept
            row = {"study": "emb_ghost_norm", "ids": case, "variant": name,
                   "ms": events_ms(fn), "device_ms": device_ms(fn),
                   "rel_err_f64": float(((got.double() - exact).abs()
                                         / exact.abs()).max()),
                   "bitwise_run_to_run": bool(torch.equal(got, out)),
                   "bitwise_kept": bool(torch.equal(got, kept)),
                   "ptxas": notes}
            print(json.dumps(row), flush=True)


def study_fused(tmp: Path, dev: str) -> None:
    from repro_torch.kernels import fused_clip as fc
    variants = {n: patched(build.CSRC / s, p)
                for n, (s, p) in FUSED_PATCHES.items()}
    variants["two_launch"] = (DESIGNS / "fused_clip_two_launch.cu"
                              ).read_text()
    libs = build_variants(variants, tmp)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in FUSED_PATCHES:
        libs[name][0].dp_fused_clip_nparts.argtypes = [I] * 7
        libs[name][0].dp_fused_clip_scratch_bytes.argtypes = [I] * 7
        libs[name][0].dp_fused_clip_grad.argtypes = [P] * 7 + [I] * 8 + [
            F, F, P]
    two = libs["two_launch"][0]
    two.dp_fused_clip_two_launch_nparts.argtypes = [I, I]
    two.dp_fused_clip_two_launch.argtypes = [P] * 7 + [I] * 7 + [F, F, P]
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    for case, L, Tc, d, p, dtype in FUSED_CASES:
        L1 = max(L, 1)
        a = torch.randn(L1, B, Tc, d, generator=g, device=dev).to(dtype)
        ds = torch.randn(L1, B, Tc, p, generator=g, device=dev).to(dtype)
        w = torch.rand(B, generator=g, device=dev) + 0.5
        R = float(torch.sqrt(fc.plain(a, ds, w, "automatic", 1.0, 0.01)[1])
                  .median())
        plain = fc.plain(a, ds, w, "automatic", R, 0.01)[0]
        bf16 = int(dtype == torch.bfloat16)
        wgmma = int(fc.route(dtype, d, p) == "wgmma")
        G = torch.empty(L1, d, p, device=dev)
        sq = torch.empty(B, device=dev)
        calls = {}
        for name in FUSED_PATCHES:
            lib = libs[name][0]
            n = lib.dp_fused_clip_nparts(L1, B, Tc, d, p, bf16, wgmma)
            if n <= 0:
                print(json.dumps({"study": "fused_clip_grad", "case": case,
                                  "variant": name, "refused": n}),
                      flush=True)
                continue
            part = torch.empty(B, n, device=dev)
            nbytes = lib.dp_fused_clip_scratch_bytes(L1, B, Tc, d, p, bf16,
                                                     wgmma)
            scr = torch.empty(max(nbytes, 4) // 4, device=dev)
            calls[name] = (lambda f=lib.dp_fused_clip_grad, pt=part, sc=scr,
                           has=nbytes > 0: _check(
                f(a.data_ptr(), ds.data_ptr(), w.data_ptr(), pt.data_ptr(),
                  sc.data_ptr() if has else None, G.data_ptr(),
                  sq.data_ptr(), L1, B, Tc, d, p, bf16, wgmma, 1, R, 0.01,
                  0), "dp_fused_clip_grad"))
        scratch = torch.empty(L1, d, p, device=dev)
        part2 = torch.empty(L1 * two.dp_fused_clip_two_launch_nparts(d, p),
                            device=dev)

        def two_launch():
            G.zero_()
            _check(two.dp_fused_clip_two_launch(
                a.data_ptr(), ds.data_ptr(), w.data_ptr(), scratch.data_ptr(),
                part2.data_ptr(), G.data_ptr(), sq.data_ptr(), L1, B, Tc, d, p,
                bf16, 1, R, 0.01, 0), "dp_fused_clip_two_launch")
        calls["two_launch"] = two_launch
        kept = None
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            got = G.clone()
            fn()
            torch.cuda.synchronize()
            kept = got if kept is None else kept
            dev_ms = device_ms(fn)
            row = {"study": "fused_clip_grad", "case": case, "variant": name,
                   "L": L, "T": Tc, "d": d, "p": p, "dtype": str(dtype),
                   "ms": events_ms(fn), "device_ms": sum(dev_ms.values()),
                   "device_by_kernel": dev_ms,
                   "max_abs_diff_kept": float((got - kept).abs().max()),
                   "max_abs_err_plain": float((got - plain).abs().max()),
                   "plain_scale": float(plain.abs().max()),
                   # TOL's f32 rtol, times the output's scale
                   "agrees_plain": bool((got - plain).abs().max()
                                        <= 1e-3 * plain.abs().max()),
                   "bitwise_run_to_run": bool(torch.equal(got, G)),
                   "ptxas": libs[name][1]}
            print(json.dumps(row), flush=True)
        del a, ds, G, scratch
        torch.cuda.empty_cache()


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in f32 ulps (the distance of the ordered bit patterns)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def noise_source(patches, cu="counter_noise.cu", cu_patches=()) -> str:
    """``cu`` (counter_noise.cu or noise_update.cu under csrc/, or a path:
    a design under designs/), patched by ``cu_patches``, with
    csrc/counter_normal.cuh, patched by ``patches``, in place of its
    #include."""
    text = patched(build.CSRC / cu, cu_patches)
    inc = '#include "counter_normal.cuh"'
    if text.count(inc) != 1:
        raise RuntimeError(f"{cu}: {inc} is not there once")
    return text.replace(inc, patched(build.CSRC / "counter_normal.cuh",
                                     patches).replace("#pragma once\n", ""))


def fused_adamw_takes_mixed(dev: str = "cuda") -> bool:
    """Whether ``torch._fused_adamw_`` (noise_update's library yardstick,
    here and in chip_smoke.py) takes bf16 params and grads with f32
    moments on the card: one probe launch of 8 elements."""
    z = (lambda dt: torch.zeros(8, dtype=dt, device=dev))
    try:
        torch._fused_adamw_([z(torch.bfloat16)], [z(torch.bfloat16)],
                            [z(torch.float32)], [z(torch.float32)], [],
                            [torch.ones((), device=dev)], lr=1e-3,
                            beta1=0.9, beta2=0.999, weight_decay=0.0,
                            eps=1e-8, amsgrad=False, maximize=False)
        torch.cuda.synchronize()
        return True
    except RuntimeError:
        return False


# the first versions' C entries (designs/noise_update_per_lane.cu,
# designs/counter_noise_per_element.cu): the keys as two lists, n_hi added,
# then n_lo subtracted
PER_LANE_SIGNATURE = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + \
    [ctypes.c_ulonglong] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + \
    [ctypes.c_void_p] * 3
PER_ELEMENT_SIGNATURE = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + \
    [ctypes.c_ulonglong] * 2 + [ctypes.c_longlong, ctypes.c_float,
                                ctypes.c_float, ctypes.c_int,
                                ctypes.c_void_p]
_BF16, _F32 = torch.bfloat16, torch.float32
# noise_update's kept kernel against its first version, bitwise: (optimizer,
# shape, g dtype, p dtype, offset of every operand in its buffer, keys: 0
# the Gaussian's one key, else a depth-10 tree's local t: t = 3 holds node
# (1, 1) in both lists, t = 7 two nodes, t = 1 is FTRL's restart step;
# denom: a power of two, which the kept kernel multiplies by its inverse,
# or not, which it divides by, as the first version always does)
UPDATE_CASES = [
    ("adamw", (28, 1536, 256), _BF16, _BF16, 0, 0, 8.0),
    ("adamw", (28, 1536, 256), _BF16, _BF16, 0, 0, 7.0),
    ("adamw", (28, 3, 1537), _F32, _F32, 0, 0, 8.0),
    ("adamw", (3, 4099), _BF16, _F32, 1, 0, 0.5),
    ("adamw", (28, 3, 1537), _BF16, _BF16, 1, 7, 3.0),
    ("sgd", (28, 1536, 256), _F32, _F32, 0, 0, 8.0),
    ("sgd", (28, 3, 1537), _BF16, _BF16, 1, 0, 6.0),
    ("ftrl", (28, 1536, 256), _BF16, _BF16, 0, 3, 8.0),
    ("ftrl", (28, 3, 1537), _F32, _F32, 1, 3, 0.75),
    ("ftrl_restart", (28, 1536, 256), _BF16, _BF16, 0, 1, 8.0),
    ("ftrl_restart", (28, 3, 1537), _F32, _BF16, 1, 1, 1024.0),
]


def _shifted(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x`` copied into a buffer at element offset ``k`` (k = 1: no
    operand 16-byte aligned at index 0, a head of 7 elements)."""
    if not k:
        return x.clone()
    buf = torch.empty(x.numel() + k, dtype=x.dtype, device=x.device)
    buf[k:].copy_(x.reshape(-1))
    return buf[k:].view(x.shape)


class _Update:
    """One noise_update leaf's inputs and the calls of both C entries:
    ``run(lib, per_lane, state, noisy)`` launches on ``state`` (p, m, v,
    t0: updated in place)."""

    def __init__(self, opt, shape, g_dt, p_dt, offset, t, dev, seed,
                 denom=8.0):
        from repro_torch.core import noise
        from repro_torch.kernels import counter_noise as cn
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        rnd = (lambda: torch.randn(shape, generator=gen, device=dev))
        self.g = _shifted(rnd().to(g_dt), offset)
        self.p0 = rnd().mul_(0.02).to(p_dt)
        self.m0, self.v0 = rnd().mul_(1e-2), rnd().square_().mul_(1e-4)
        self.t00 = rnd().mul_(0.02)
        self.offset, self.n = offset, self.g.numel()
        path = "blocks/mlp/up/w"
        if t:
            tree = noise.TreeAggregationMechanism(seed=3, depth=10)
            hi, lo = tree.node_keys(path, t), tree.node_keys(path, t - 1)
        else:
            hi = [noise._path_rng(noise.fold_in(noise.prng_key(1), 0), path)]
            lo = []
        self.draws = len(cn.key_plan(hi, lo))
        self.lists = len(hi) + len(lo)
        self.plan = cn.plan_args(hi, lo, "design_study")
        words = [w & noise.M32 for key in hi + lo for w in key]
        self.words = (ctypes.c_uint32 * max(1, len(words)))(*words)
        self.n_hi, self.n_lo = len(hi), len(lo)
        self.trail = noise.counter_split(shape)[1]
        alpha, denom = cn._scalar(0.7, g_dt), cn._scalar(denom, g_dt)
        code = {"sgd": 0, "adamw": 1}.get(opt, 2)
        keep = 0.0 if opt == "ftrl_restart" else 1.0
        t_adam = 1 + 97 * (seed - SEED)        # AdamW's step: its bc1, bc2
        scal = {0: (3e-4, 0.9, 1.0, 0.0, 0.0, 0.0, 1.0, 1.0, 0.01),
                1: (3e-4, 0.9, 0.1, 0.999, 0.001, 1e-8, 1.0 - 0.9 ** t_adam,
                    1.0 - 0.999 ** t_adam, 0.1),
                2: (3e-4, 0.9 * keep, keep, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0)}
        self.hyper = (ctypes.c_float * 11)(alpha, denom, *scal[code])
        self.code = code
        self.dtypes = (int(g_dt == _BF16), int(p_dt == _BF16))

    def fresh(self):
        return [_shifted(x, self.offset)
                for x in (self.p0, self.m0, self.v0, self.t00)]

    def run(self, lib, per_lane, state, noisy=1):
        p, m, v, t0 = state
        plan = (ctypes.addressof(self.words), self.n_hi, self.n_lo) \
            if per_lane else (ctypes.addressof(self.plan[0]),
                              ctypes.addressof(self.plan[1]), self.plan[2])
        _check(lib.dp_noise_update(
            self.g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
            *plan, noisy, 0, self.trail, self.n, *self.dtypes, self.code,
            ctypes.addressof(self.hyper), t0.data_ptr(), 0),
            "dp_noise_update")


def threefry_counts(lib: Path) -> dict:
    """One threefry2x32 block's SASS instructions in a variant's library
    (``lib``, built from counter_noise.cu: its threefry_bits_kernel), by
    opcode and pipe, as chip_smoke.py's build phase counts them in the
    kept library (:func:`repro_torch.kernels.sass.threefry_sass`)."""
    from repro_torch.kernels import sass
    return sass.threefry_sass(sass.sass_text(str(lib)))


def study_noise(tmp: Path, dev: str) -> None:
    from repro_torch.core import noise
    from repro_torch.kernels import counter_noise as cn
    variants = {n: noise_source(p)
                for n, p in {**NOISE_PATCHES, **NOISE_ABLATIONS}.items()}
    variants["first_version"] = (DESIGNS / "counter_noise_per_element.cu"
                                 ).read_text()
    for n in ("kept", "no_compaction", "threefry_imad", "ieee_division"):
        variants[f"update_{n}"] = noise_source(NOISE_PATCHES[n],
                                               "noise_update.cu")
    variants["update_per_lane"] = noise_source([], _PER_LANE)
    for n, (cu, cu_patches) in NOISE_UPDATE_PATCHES.items():
        variants[f"update_{n}"] = noise_source([], cu, cu_patches)
    for b in NOISE_BLOCKS:
        for prefix, cu in (("", "counter_noise.cu"),
                           ("update_", "noise_update.cu")):
            patches = blocks_patches(cu, b)
            if patches:
                variants[f"{prefix}min_blocks_{b}"] = noise_source(
                    [], cu, patches)
    libs = build_variants(variants, tmp)
    per_lane = {"update_per_lane",
                *(f"update_{n}" for n, (cu, _) in
                  NOISE_UPDATE_PATCHES.items() if cu == _PER_LANE)}
    for name, (lib, _) in libs.items():
        if name.startswith("update_"):
            lib.dp_noise_update.argtypes = PER_LANE_SIGNATURE \
                if name in per_lane else build.SIGNATURES["dp_noise_update"]
        else:
            lib.dp_counter_noise.argtypes = PER_ELEMENT_SIGNATURE \
                if name == "first_version" else \
                build.SIGNATURES["dp_counter_noise"]
    path, shape = "blocks/mlp/up/w", (28, 1536, 17920)   # train's largest
    key = noise._path_rng(noise.fold_in(noise.prng_key(1), 0), path)
    keys, sides, n_keys = cn.plan_args([key], [], "design_study")
    alpha, denom = 0.7, 8.0
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    leaf = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    out = torch.empty_like(leaf)
    zero = torch.zeros(1 << 24, device=dev)         # the draws themselves
    xi = torch.empty_like(zero)

    def launch(lib, src, dst, bf16, a, d, lists=False):
        plan = (ctypes.addressof(keys), 1, 0) if lists else \
            (ctypes.addressof(keys), ctypes.addressof(sides), n_keys)
        _check(lib.dp_counter_noise(
            src.data_ptr(), dst.data_ptr(), *plan, 0,
            noise.counter_split(src.shape)[1], src.numel(), a, d, bf16, 0),
            "dp_counter_noise")

    kept_out = kept_xi = None
    for name, (lib, notes) in libs.items():
        if name.startswith("update_"):
            continue
        lists = name == "first_version"
        fn = (lambda lib=lib, lists=lists: launch(lib, leaf, out, 1, alpha,
                                                  denom, lists))
        launch(lib, zero, xi, 0, 1.0, 1.0, lists)
        fn()
        torch.cuda.synchronize()
        if kept_out is None:
            kept_out, kept_xi = out.clone(), xi.clone()
        gap = _ulps(xi, kept_xi)
        sass = threefry_counts(tmp / f"lib{name}.so") \
            if name in NOISE_PATCHES else None
        row = {"study": "counter_noise", "variant": name,
               "ablation": name in NOISE_ABLATIONS, "leaf": path,
               "threefry_sass": sass,
               "shape": shape, "dtype": "bfloat16",
               "ms": events_ms(fn, n=10), "device_ms": device_ms(fn, reps=3),
               "bitwise_kept": bool(torch.equal(out, kept_out)),
               "draws_max_ulp_kept": int(gap.max()),
               "draws_unequal_kept": int((gap > 0).sum()),
               "draws": zero.numel(), "ptxas": notes}
        print(json.dumps(row), flush=True)
    del zero, xi

    # threefry's adds: the kept draw against threefry_imad, interleaved
    # (kept, imad, imad, kept, three times): whether the IMAD form's
    # difference stands above the spread of repeated timings
    for rep in range(3):
        for name in ("kept", "threefry_imad", "threefry_imad", "kept"):
            fn = (lambda lib=libs[name][0]: launch(lib, leaf, out, 1, alpha,
                                                   denom))
            print(json.dumps({"study": "counter_noise", "variant": name,
                              "repeat": rep, "leaf": path,
                              "ms": events_ms(fn, n=10)}), flush=True)

    def chain():
        return (leaf + alpha * torch.randn(shape, generator=g, device=dev)
                .to(torch.bfloat16)) / denom
    print(json.dumps({"study": "counter_noise", "variant": "randn_chain",
                      "leaf": path, "shape": shape, "dtype": "bfloat16",
                      "ms": events_ms(chain, n=10),
                      "device_ms": device_ms(chain, reps=3)}), flush=True)
    del leaf, out
    torch.cuda.empty_cache()

    # noise_update: the kept kernel and the staged design each bitwise the
    # first version, p and every state, at each of UPDATE_CASES
    first = libs["update_per_lane"][0]
    unequal = []
    for k, (opt, shp, g_dt, p_dt, offset, t, d) in enumerate(UPDATE_CASES):
        case = _Update(opt, shp, g_dt, p_dt, offset, t, dev, SEED + k, d)
        theirs = case.fresh()
        case.run(first, True, theirs)
        label = (f"{opt} {tuple(shp)} g {str(g_dt)[6:]} p {str(p_dt)[6:]} "
                 f"offset {offset} t {t} denom {d}")
        for name in ("update_kept", "update_staged"):
            mine = case.fresh()
            case.run(libs[name][0], False, mine)
            torch.cuda.synchronize()
            same = {nm: bool(torch.equal(a, b))
                    for nm, a, b in zip(("p", "m", "v", "t0"), mine, theirs)}
            print(json.dumps({"study": "noise_update", "variant": name,
                              "case": label, "keys_in_lists": case.lists,
                              "draws": case.draws,
                              "bitwise_first_version": same}), flush=True)
            if not all(same.values()):
                unequal.append(f"{name}: {label}")
            del mine
        del case, theirs
    torch.cuda.empty_cache()

    # then the times on the up leaf (denom 8, train's batch): AdamW (train's
    # step-0 key; the kept kernel with and without its draw, and dividing
    # by a denom of 7, each variant), FTRL ordinary (t = 3: 3 keys in the
    # lists, 2 distinct) and restart (t = 1); the kept kernel against
    # threefry_imad interleaved on AdamW and FTRL (kept, imad, imad, kept,
    # three times); beside them torch._fused_adamw_ over the noised leaf
    imad = [(n, opt, t, 1, 8.0) for opt, t in (("adamw", 0), ("ftrl", 3))
            for _ in range(3) for n in ("update_kept", "update_threefry_imad",
                                        "update_threefry_imad", "update_kept")]
    rows = [("update_kept", "adamw", 0, 1, 8.0),
            ("update_kept", "adamw", 0, 0, 8.0),
            ("update_per_lane", "adamw", 0, 1, 8.0),
            ("update_per_lane", "adamw", 0, 0, 8.0),
            ("update_staged", "adamw", 0, 1, 8.0),
            ("update_staged", "adamw", 0, 0, 8.0),
            ("update_no_compaction", "adamw", 0, 1, 8.0),
            ("update_loads_first", "adamw", 0, 1, 8.0),
            ("update_stages_3", "adamw", 0, 1, 8.0),
            ("update_proxy_fence", "adamw", 0, 1, 8.0),
            ("update_carveout_max_shared", "adamw", 0, 1, 8.0),
            ("update_per_lane_plan", "adamw", 0, 1, 8.0),
            ("update_bulk_stores", "adamw", 0, 1, 8.0),
            ("update_kept", "adamw", 0, 1, 8.0),
            ("update_staged", "adamw", 0, 1, 8.0),
            ("update_per_lane", "adamw", 0, 1, 8.0),
            *((n, "adamw", 0, 1, 8.0) for n in libs
              if n.startswith("update_min_blocks")),
            ("update_kept", "adamw", 0, 1, 7.0),
            ("update_ieee_division", "adamw", 0, 1, 8.0),
            *imad[:12],
            ("update_staged", "ftrl", 3, 1, 8.0),
            ("update_per_lane", "ftrl", 3, 1, 8.0),
            *imad[12:],
            ("update_kept", "ftrl_restart", 1, 1, 8.0),
            ("update_staged", "ftrl_restart", 1, 1, 8.0),
            ("update_per_lane", "ftrl_restart", 1, 1, 8.0)]
    cases = {}
    for name, opt, t, noisy, d in rows:
        if (opt, t, d) not in cases:
            cases.clear()
            torch.cuda.empty_cache()
            cases[(opt, t, d)] = _Update(opt, shape, _BF16, _BF16, 0, t, dev,
                                         SEED, d)
        case = cases[(opt, t, d)]
        lib, notes = libs[name]
        state = case.fresh()
        fn = (lambda lib=lib, name=name, noisy=noisy: case.run(
            lib, name in per_lane, state, noisy))
        ms = events_ms(fn, n=10)
        adam = opt == "adamw"
        nbytes = case.n * (22 if adam else 24 if opt == "ftrl" else 26)
        print(json.dumps({"study": "noise_update", "variant": name,
                          "noise": bool(noisy), "leaf": path,
                          "shape": shape, "dtype": "bfloat16",
                          "optimizer": opt, "denom": d,
                          "keys_in_lists": case.lists,
                          "draws": case.draws if noisy else 0, "ms": ms,
                          "device_ms": device_ms(fn, reps=3),
                          "bytes": nbytes,
                          "bytes_ms": nbytes / 3.35e12 * 1e3,
                          "ptxas": notes}), flush=True)
        del state
    cases.clear()
    torch.cuda.empty_cache()
    case = _Update("adamw", shape, _BF16, _BF16, 0, 0, dev, SEED)
    p, m, v, _ = case.fresh()
    gn = torch.empty_like(case.g)
    launch(libs["kept"][0], case.g, gn, 1, 0.7, 8.0)
    step_t = torch.ones((), device=dev)

    def fused(pp, gg):
        torch._fused_adamw_([pp], [gg], [m], [v], [], [step_t], lr=3e-4,
                            beta1=0.9, beta2=0.999, weight_decay=0.1,
                            eps=1e-8, amsgrad=False, maximize=False)
    if fused_adamw_takes_mixed(dev):
        on = "bf16 p and gradient, f32 moments"
        pp, gg = p, gn
    else:
        on = "f32 copies of p and the gradient (bf16 p refused)"
        pp, gg = p.float(), gn.float()
    fn = (lambda: fused(pp, gg))
    print(json.dumps({"study": "noise_update",
                      "variant": "torch._fused_adamw_", "on": on,
                      "leaf": path, "shape": shape,
                      "ms": events_ms(fn, n=10),
                      "device_ms": device_ms(fn, reps=3)}), flush=True)
    if unequal:
        raise AssertionError(f"noise_update: the kept kernel is not "
                             f"bitwise its first version at {unequal}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("emb", "ghost", "wkv", "wkv_bwd",
                                       "moe", "emb_norm", "fused", "noise"),
                    default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("design_study: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        if args.only in (None, "emb"):
            study_emb(Path(tmp) / "emb", "cuda")
        if args.only in (None, "ghost"):
            study_ghost(Path(tmp) / "ghost", "cuda")
        if args.only in (None, "wkv"):
            study_wkv(Path(tmp) / "wkv", "cuda")
        if args.only in (None, "wkv_bwd"):
            study_wkv_bwd(Path(tmp) / "wkv_bwd", "cuda")
        if args.only in (None, "moe"):
            study_moe(Path(tmp) / "moe", "cuda")
        if args.only in (None, "emb_norm"):
            study_emb_norm(Path(tmp) / "emb_norm", "cuda")
        if args.only in (None, "fused"):
            study_fused(Path(tmp) / "fused", "cuda")
        if args.only in (None, "noise"):
            study_noise(Path(tmp) / "noise", "cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
