// The mainloop of the tensor-core kernels that contract records over their
// rows, shared by clipped_grad_wgmma.cu (dense mm taps),
// moe_clipped_grad_wgmma.cu (MoE expert taps), and by the direct norms
// moe_direct_norm_wgmma.cu and grad_norm_direct_wgmma.cu (direct_norm):
//
//     G_q = sum_b C_b a_qb^T diag(m_qb) g_qb    a (.., rows, d), g (.., rows, p)
//
// A problem q is a layer (dense) or a (layer, expert) pair (MoE); its
// records for sample b sit at depth z = ((q / E) B + b) E + q % E of 3-D
// tensor maps (width, rows, L*B*E), so dense clipped_grad is the case E = 1
// and has no mask. One CTA per SM walks output tiles (q, 128-row d tile, p
// tile of BN columns) and reduces each over (b, rows). The product is
// D = A B with A = a^T (M = d, K = rows) and B = g (K = rows, N = p); both
// tiles arrive from TMA with the rows as their rows, so both are MN-major
// ("transposed") wgmma operands. A producer warpgroup (one thread issues;
// the warpgroup hands its registers to the consumers) keeps a ring of
// STAGES stages of 64 rows (a: 64 x 128, g: 64 x BN, bf16, 128B swizzle) in
// flight, on across tiles, so the next tile's rows load while the last one
// is written; two consumer warpgroups each own 64 d rows x BN p columns and
// issue m64nBNk16 with f32 accumulators. TMA zero-fills rows past the
// record's row count inside each sample and columns past d or p: any row
// count runs, and ragged edges add zero.
//
// C_b stays f32 and exact: a per-sample accumulator collects b's rows, then
// folds into the running total as total = fmaf(C_b, acc_b, total); no
// weighted copy of a or g exists and C is never rounded to bf16. The tile is
// written once, with no atomics and no split over (b, rows): the sum runs in
// one fixed order, so the result is bitwise equal run to run.
//
// The MoE slot mask m varies per row, so it cannot be folded after the
// product: it has to be on the a operand, (diag(m) a)^T g = a^T diag(m) g.
// The model's records are zero in every empty slot already (models/moe.py
// multiplies them by the mask: +0 or -0), and there a 0/1 mask changes
// nothing but which k16 steps hold a kept slot. So a pre-pass
// (``slot_flags``, slot_flags.cuh) reads the mask, and the rows of a at its
// empty slots, and gives each 64-row block (one stage) 16 bytes of flags:
// its k16 steps with a kept slot, and whether the mask still has to be
// written on a (an empty slot whose row is not zero, or a value other than
// 0 and 1). The flags arrive with the stage
// by TMA; a k16 step without a kept slot is not issued (exact for any
// mask: the router keeps its slots first, so trailing steps are skipped).
// Only a flagged stage waits for the mask warp of the producer warpgroup,
// which zeroes or scales its rows in shared memory and fences them for the
// async proxy (a proxy fence costs about as much as a stage); a general f32
// mask so adds one bf16 rounding of m a_r, inside the bf16 tolerance.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace wgmma_grad {

constexpr int BM = 128;        // d rows of a CTA tile (64 per warpgroup)
constexpr int BK = 64;         // record rows per stage
constexpr int STAGES = 4;      // the ring's stages (dense)
constexpr int MOE_STAGES = 5;  // (masked kernels: a sample is one stage)
constexpr int BOX = 64;        // elements of one 128-byte swizzled row
constexpr int THREADS = 384;   // two consumer warpgroups + a producer's
constexpr int CONSUMER_WARPS = 8;
// registers a thread: the producer warpgroup gives up most of its share so
// that a consumer holds its two 64 x BN accumulators (masked kernels: three,
// and the producer warpgroup runs the mask warp too). Either split adds up
// to the launch's 384 x 168: setmaxnreg.inc waits until the registers it
// asks for are free, so a split above that would never start.
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int MOE_PRODUCER_REGS = 56, MOE_CONSUMER_REGS = 224;
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS == THREADS * 168 &&
                  128 * MOE_PRODUCER_REGS + 256 * MOE_CONSUMER_REGS ==
                      THREADS * 168,
              "a register split must add up to the launch's");
constexpr int BOX_BYTES = BK * hopper::ROW_BYTES;              // 8 KB
constexpr int KSTEP_BYTES = 16 * hopper::ROW_BYTES;   // 16 rows per wgmma
constexpr int OUT_BOX = 32;    // f32 columns of one 128-byte swizzled row

constexpr int FLAG_BYTES = 16;    // a stage's flags: {k16 steps, mask it}
constexpr int FLAG_SLOT = 128;    // their slot in shared memory (aligned)

// BN: p columns of a CTA tile, 128 or 192 (wide taps: fewer, larger tiles
// read each row of a fewer times). MASKED: the stages carry flags, and a
// mask warp hands the flagged ones on (a third barrier, ready). OUT: bytes
// of the staging buffer through which TMA stores the f32 tile.
template <int BN, bool MASKED = false, int OUT = 0>
struct Cfg {
  static constexpr int S = MASKED ? MOE_STAGES : STAGES;
  static constexpr int NACC = BN / 2;   // f32 registers of a 64 x BN tile
  static constexpr int STAGE_BYTES = (BM / BOX + BN / BOX) * BOX_BYTES;
  static constexpr int BARS = MASKED ? 3 : 2;   // full, empty (, ready)
  static constexpr size_t SMEM =
      S * STAGE_BYTES + OUT + (MASKED ? S * FLAG_SLOT : 0) +
      BARS * S * sizeof(uint64_t) +
      hopper::ATOM_BYTES;   // + alignment slack
  static_assert(SMEM <= 232448, "over the 227 KB a block may use");
};

// Where a kernel's shared memory goes: the ring of S stages (1024-aligned),
// a staging buffer of ``out`` bytes, (masked) the stages' flags, then the
// barriers.
template <int S>
struct Smem {
  uint8_t* ring;
  uint8_t* staging;
  uint8_t* flags;
  uint64_t *full, *empty, *ready;
  __device__ __forceinline__ Smem(uint8_t* raw, int ring_bytes, int out,
                                  bool masked) {
    ring = hopper::align_atom(raw);
    staging = ring + ring_bytes;
    flags = staging + out;
    full = reinterpret_cast<uint64_t*>(flags + (masked ? S * FLAG_SLOT : 0));
    empty = full + S;
    ready = empty + S;
  }
  // One thread, then __syncthreads(): a stage is full once the producer's
  // TMA lands, ready once the mask warp has masked it (flagged stages of a
  // masked kernel), empty once every consumer warp (and the mask warp) is
  // done with it.
  __device__ __forceinline__ void init(bool masked) const {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMER_WARPS + (masked ? 1 : 0));
      if (masked) hopper::mbar_init(&ready[s], 1);
    }
    hopper::mbar_fence_init();
  }
  // Word k of stage s's flags: 0, its k16 steps with a kept slot; 1,
  // whether the mask is to be written on it.
  __device__ __forceinline__ uint32_t stage_flag(int s, int k) const {
    return reinterpret_cast<volatile const uint32_t*>(flags +
                                                      s * FLAG_SLOT)[k];
  }
};

// The output tiles in launch order: the tiles of the smaller operand vary
// fastest, so that it stays in L2 while the larger one streams through
// once (d_fast: the d tiles, a is the smaller); then the problem.
struct Tiles {
  int nd, np, L, d_fast, bn;   // L: problems (layers, or (layer, expert))
  __device__ __forceinline__ int count() const { return nd * np * L; }
  __device__ __forceinline__ void at(int t, int& l, int& d0, int& p0) const {
    const int nx = d_fast ? nd : np, ny = d_fast ? np : nd;
    const int x = t % nx, y = (t / nx) % ny;
    l = t / (nx * ny);
    d0 = (d_fast ? x : y) * BM;
    p0 = (d_fast ? y : x) * bn;
  }
};

// The stages of the ring, in the order the producer fills them: a tile
// (q, d0, p0) takes nu x nt stages, stage (u, kt) holding rows kt BK.. of
// a's columns d0.. and of g's columns pu.. at depth z of the maps:
//   weighted grad (norm false): u = b, a sample, z = ((q / E) B + b) E
//     + q % E, pu = p0;
//   direct norm (norm true): u = a p tile, z = q, pu = u BN.
// nu may be padded (to pair the units): a unit u >= nreal is a dummy, whose
// stages load nothing and only complete their phase (their consumers issue
// no product).
struct Walk {
  Tiles tiles;
  int nu, nreal, B, E, nt;
  bool norm;
  __device__ __forceinline__ int z(int q, int u) const {
    return norm ? q : ((q / E) * B + u) * E + q % E;
  }
};

// The producer: one thread keeps the ring full, tile after tile; ``mf``
// (masked kernels) maps the stages' flags as (4, L*B*E*nt) u32, which land
// in sm.flags with each stage.
template <int BN, int S>
__device__ __forceinline__ void produce(const CUtensorMap* ma,
                                        const CUtensorMap* mg,
                                        const CUtensorMap* mf,
                                        const Smem<S>& sm, const Walk& w) {
  constexpr int STAGE_BYTES = Cfg<BN>::STAGE_BYTES;
  int i = 0;
  for (int tile = blockIdx.x; tile < w.tiles.count(); tile += gridDim.x) {
    int q, d0, p0;
    w.tiles.at(tile, q, d0, p0);
    for (int k = 0; k < w.nu * w.nt; ++k, ++i) {
      const int s = i % S, u = k / w.nt;
      hopper::mbar_wait(&sm.empty[s], ((i / S) & 1) ^ 1);
      uint8_t* st = sm.ring + s * STAGE_BYTES;
      const int t0 = (k % w.nt) * BK, z = w.z(q, u);
      const int pu = w.norm ? u * BN : p0;
      uint64_t* full = &sm.full[s];
      if (u >= w.nreal) {
        hopper::mbar_arrive(full);
        continue;
      }
      hopper::mbar_expect_tx(full, STAGE_BYTES + (mf ? FLAG_BYTES : 0));
      if (mf)
        hopper::tma_load_2d(sm.flags + s * FLAG_SLOT, mf, full, 0,
                            z * w.nt + k % w.nt);
#pragma unroll
      for (int c = 0; c < BM / BOX; ++c)
        hopper::tma_load_3d(st + c * BOX_BYTES, ma, full, d0 + c * BOX, t0,
                            z);
#pragma unroll
      for (int c = 0; c < BN / BOX; ++c)
        hopper::tma_load_3d(st + (BM / BOX + c) * BOX_BYTES, mg, full,
                            pu + c * BOX, t0, z);
    }
  }
}

__device__ __forceinline__ uint32_t scale_pair(uint32_t x, float m) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return hopper::pack_bf16(f.x * m, f.y * m);
}

// Row r of a stage's a (both 64-column boxes, 128B-swizzled: the swizzle
// moves 16-byte chunks inside a row, never across rows) times m, in place:
// left alone for m = 1, zeroed for m = 0, scaled otherwise (one bf16
// rounding). The chunks are taken in an order rotated by r, so that the
// lanes of a warp, one row each, hit different banks. -> whether it wrote.
__device__ __forceinline__ bool mask_row(uint8_t* st, int r, float m) {
  if (m == 1.f) return false;
#pragma unroll
  for (int c = 0; c < BM / BOX; ++c) {
    uint4* v = reinterpret_cast<uint4*>(st + c * BOX_BYTES +
                                        r * hopper::ROW_BYTES);
#pragma unroll
    for (int j = 0; j < hopper::ROW_BYTES / 16; ++j) {
      const int jj = (j + r) & 7;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (m != 0.f) {
        x = v[jj];
        x = make_uint4(scale_pair(x.x, m), scale_pair(x.y, m),
                       scale_pair(x.z, m), scale_pair(x.w, m));
      }
      v[jj] = x;
    }
  }
  return true;
}

// The mask warp (a warp of the producer warpgroup), stage after stage in
// the producer's order: it waits for each stage; a flagged one (a real
// unit whose flags say the mask is to be written) it masks, lane owning
// rows lane and lane + 32 with their values from ``mask`` (.., C) f32
// (``mask_row``), fences the writes for the async proxy and marks ready;
// then it tells the producer it is done with the stage.
template <int BN, int S>
__device__ __forceinline__ void mask_stages(const Smem<S>& sm, const Walk& w,
                                            const float* __restrict__ mask,
                                            int C) {
  constexpr int STAGE_BYTES = Cfg<BN>::STAGE_BYTES;
  const int lane = threadIdx.x % 32;
  const int per_tile = w.nu * w.nt;
  int i = 0;
  for (int tile = blockIdx.x; tile < w.tiles.count(); tile += gridDim.x) {
    for (int k = 0; k < per_tile; ++k, ++i) {
      const int s = i % S, u = k / w.nt;
      hopper::mbar_wait(&sm.full[s], (i / S) & 1);
      if (u < w.nreal && sm.stage_flag(s, 1)) {
        int q, d0, p0;
        w.tiles.at(tile, q, d0, p0);
        const float* mrow = mask + (long long)w.z(q, u) * C;
        const int r0 = (k % w.nt) * BK + lane, r1 = r0 + 32;
        uint8_t* st = sm.ring + s * STAGE_BYTES;
        bool wrote = mask_row(st, lane, r0 < C ? mrow[r0] : 0.f);
        wrote |= mask_row(st, lane + 32, r1 < C ? mrow[r1] : 0.f);
        if (wrote) hopper::fence_proxy_async();
        __syncwarp();   // every lane's rows are written and fenced
        if (lane == 0) hopper::mbar_arrive(&sm.ready[s]);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&sm.empty[s]);
    }
  }
}

// A consumer's look at a masked stage (full already): -> its k16 steps with
// a kept slot (none for a dummy unit, whose slot holds stale flags), after
// waiting for the mask warp if the stage is flagged. ``rph`` holds the ready
// phase each slot waits for next (ready completes for flagged stages only).
template <int S>
__device__ __forceinline__ uint32_t wait_masked(const Smem<S>& sm, int s,
                                                bool real, uint32_t& rph) {
  if (!real) return 0u;
  if (sm.stage_flag(s, 1)) {
    hopper::mbar_wait(&sm.ready[s], (rph >> s) & 1u);
    rph ^= 1u << s;
  }
  return sm.stage_flag(s, 0);
}

// Issues one stage's products into acc: the k16 steps of ``kmask`` (all four
// when MASKED is false), the first one issued overwriting acc unless
// ``live``; -> live after the stage.
template <int BN, bool MASKED>
__device__ __forceinline__ int issue_stage(float (&acc)[BN / 2],
                                           const uint8_t* sa,
                                           const uint8_t* sg, uint32_t kmask,
                                           int live) {
  if constexpr (MASKED) {
    uint64_t da[4], db[4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      da[kk] = hopper::desc(sa + kk * KSTEP_BYTES, BOX_BYTES,
                            hopper::ATOM_BYTES);
      db[kk] = hopper::desc(sg + kk * KSTEP_BYTES, BOX_BYTES,
                            hopper::ATOM_BYTES);
    }
    hopper::mma_ss4_if(acc, da, db, kmask, live);
    return live || kmask != 0u;
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    hopper::mma_ss<1, 1>(acc,
                         hopper::desc(sa + kk * KSTEP_BYTES, BOX_BYTES,
                                      hopper::ATOM_BYTES),
                         hopper::desc(sg + kk * KSTEP_BYTES, BOX_BYTES,
                                      hopper::ATOM_BYTES),
                         (live || kk > 0) ? 1 : 0);
  return 1;
}

// The weighted grad of every output tile: the shared kernel body. Dense
// (MOE false): E = 1, no mask, the tile stored from registers to ``out``
// (L, d, p). MoE: the slot mask ``mask`` (L,B,E,T) f32 and the stages'
// flags (``mf``, from ``slot_flags``), k16 steps without a kept slot
// skipped, a flagged stage masked by the mask warp, a sample with none not
// folded, two per-sample accumulators (sample b's products run while
// sample b - 1's fold), and the tile stored through shared memory by TMA
// (``mo``: (p, d, L*E) f32, box 32 x 64), so that the consumers go on to
// the next tile while it drains: the output bytes are on a par with the
// products.
template <int BN, bool MOE>
__device__ __forceinline__ void weighted_grad(
    const CUtensorMap* ma, const CUtensorMap* mg, const CUtensorMap* mf,
    const CUtensorMap* mo, const float* __restrict__ C,
    const float* __restrict__ mask, float* __restrict__ out, int B, int E,
    int T, int d, int p, Tiles tiles) {
  constexpr int OUT = MOE ? BM * BN * 4 : 0;
  constexpr int S = Cfg<BN, MOE>::S;
  constexpr int NACC = BN / 2, STAGE_BYTES = Cfg<BN>::STAGE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const Smem<S> sm(smem_raw, S * STAGE_BYTES, OUT, MOE);

  const int wg = hopper::warpgroup(), lane = threadIdx.x % 32;
  const int nt = (T + BK - 1) / BK;   // row tiles of one sample
  // (MoE) samples run in pairs, one accumulator each: B rounded up
  const Walk walk{tiles, MOE ? B + (B & 1) : B, B, B, E, nt, false};

  if (threadIdx.x == 0) sm.init(MOE);
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full, tile after tile; (MoE) the
    // next warp masks each stage
    hopper::regs_dealloc<MOE ? MOE_PRODUCER_REGS : PRODUCER_REGS>();
    if (threadIdx.x == 256) produce<BN, S>(ma, mg, mf, sm, walk);
    if constexpr (MOE) {
      if (threadIdx.x / 32 == 9) mask_stages<BN, S>(sm, walk, mask, T);
    }
    return;
  }

  // consumers: warpgroup wg owns d rows d0 + 64 wg .. +63 of each tile
  hopper::regs_alloc<MOE ? MOE_CONSUMER_REGS : CONSUMER_REGS>();
  const int warp = threadIdx.x / 32, wtid = threadIdx.x % 128;
  float acc[NACC], tot[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.f;
  float acc1[MOE ? NACC : 1];   // (MoE) the odd samples' accumulator
#pragma unroll
  for (int j = 0; j < (MOE ? NACC : 1); ++j) acc1[j] = 0.f;

  int i = 0;
  uint32_t rph = 0u;   // (MoE) the ready phase each slot waits for next
  for (int tile = blockIdx.x; tile < tiles.count(); tile += gridDim.x) {
    int l, d0, p0;
    tiles.at(tile, l, d0, p0);
#pragma unroll
    for (int j = 0; j < NACC; ++j) tot[j] = 0.f;
    if constexpr (!MOE) {
      // per sample: its row tiles with one stage's products kept in
      // flight, then all of them waited for and folded in with C_b (no
      // wait sits in a branch, so the wgmmas of consecutive stages overlap)
      for (int b = 0; b < B; ++b) {
        int held = -1;  // the stage whose wgmmas may still read it
        for (int tt = 0; tt < nt; ++tt, ++i) {
          const int s = i % S;
          hopper::mbar_wait(&sm.full[s], (i / S) & 1);
          const uint8_t* st = sm.ring + s * STAGE_BYTES;
          hopper::fence_regs(acc);
          hopper::wgmma_fence();
          // the first product of a sample overwrites acc (scale_d = 0)
          issue_stage<BN, false>(acc, st + wg * BOX_BYTES,
                                 st + (BM / BOX) * BOX_BYTES, 0xFu, tt > 0);
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();   // the previous stage's products are done
          hopper::fence_regs(acc);
          __syncwarp();
          if (lane == 0 && held >= 0) hopper::mbar_arrive(&sm.empty[held]);
          held = s;
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&sm.empty[held]);
        const float c = C[b];
#pragma unroll
        for (int j = 0; j < NACC; ++j) tot[j] = fmaf(c, acc[j], tot[j]);
      }
    } else {
      // per sample: its stages' products into one accumulator while the
      // last sample's, in the other, are waited for and folded in with its
      // C (in sample order: the same sums as one accumulator)
      int held = -1, live0 = 0, live1 = 0;
      float c0 = 0.f, c1 = 0.f;
      auto sample = [&](float(&cur)[NACC], float(&prev)[NACC], int& lcur,
                        int& lprev, float& ccur, float cprev, int b) {
        lcur = 0;
        ccur = b < B ? C[b] : 0.f;
        for (int tt = 0; tt < nt; ++tt, ++i) {
          const int s = i % S;
          hopper::mbar_wait(&sm.full[s], (i / S) & 1);
          const uint32_t kmask = wait_masked(sm, s, b < B, rph);
          const uint8_t* st = sm.ring + s * STAGE_BYTES;
          hopper::fence_regs(cur);
          hopper::wgmma_fence();
          lcur = issue_stage<BN, true>(cur, st + wg * BOX_BYTES,
                                       st + (BM / BOX) * BOX_BYTES, kmask,
                                       lcur);
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();   // every earlier group (prev's) is done
          hopper::fence_regs(cur);
          hopper::fence_regs(prev);
          __syncwarp();
          if (lane == 0 && held >= 0) hopper::mbar_arrive(&sm.empty[held]);
          held = s;
          if (tt == 0 && lprev) {
#pragma unroll
            for (int j = 0; j < NACC; ++j)
              tot[j] = fmaf(cprev, prev[j], tot[j]);
            lprev = 0;
          }
        }
      };
      for (int b = 0; b < walk.nu; b += 2) {
        sample(acc, acc1, live0, live1, c0, c1, b);
        sample(acc1, acc, live1, live0, c1, c0, b + 1);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc1);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&sm.empty[held]);
      if (live1) {
#pragma unroll
        for (int j = 0; j < NACC; ++j) tot[j] = fmaf(c1, acc1[j], tot[j]);
      }
    }

    const int r0 = 16 * (warp % 4) + lane / 4;   // row in the warpgroup's 64
    if constexpr (MOE) {
      // epilogue: the f32 tile into this warpgroup's staging half, in the
      // 128B-swizzled boxes of 32 columns x 64 rows that the TMA store
      // reads (16-byte chunk c of row r at chunk c ^ (r % 8)), then one
      // store per box; rows past d and columns past p are dropped by TMA.
      // The last tile's stores must have read the buffer first.
      uint8_t* half = sm.staging + wg * (OUT / 2);
      if (wtid == 0) hopper::bulk_wait_read<0>();
      hopper::bar_sync(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < NACC / 4; ++j) {
        // a 64-row box of 128-byte rows: BOX_BYTES, as a bf16 box
        uint8_t* box = half + (j / 4) * BOX_BYTES;
        const int chunk = (2 * (j % 4) + (lane % 4) / 2) ^ (r0 & 7);
        const int off = chunk * 16 + 8 * (lane & 1);
        *reinterpret_cast<float2*>(box + r0 * hopper::ROW_BYTES + off) =
            make_float2(tot[4 * j], tot[4 * j + 1]);
        *reinterpret_cast<float2*>(box + (r0 + 8) * hopper::ROW_BYTES + off) =
            make_float2(tot[4 * j + 2], tot[4 * j + 3]);
      }
      hopper::fence_proxy_async();
      hopper::bar_sync(1 + wg, 128);
      if (wtid == 0) {
        // (a box wholly past d or p is not issued)
#pragma unroll
        for (int c = 0; c < BN / OUT_BOX; ++c)
          if (d0 + 64 * wg < d && p0 + c * OUT_BOX < p)
            hopper::tma_store_3d(mo, half + c * BOX_BYTES, p0 + c * OUT_BOX,
                                 d0 + 64 * wg, l);
        hopper::bulk_commit();
      }
    } else {
      // epilogue: the f32 tile, once; rows past d and columns past p dropped
      float* o = out + (long long)l * d * p;
      const int r = d0 + 64 * wg + r0;
      const int c0 = p0 + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < NACC / 4; ++j) {
        const int c = c0 + 8 * j;
        if (c >= p) continue;
        if (r < d)
          *reinterpret_cast<float2*>(o + (long long)r * p + c) =
              make_float2(tot[4 * j], tot[4 * j + 1]);
        if (r + 8 < d)
          *reinterpret_cast<float2*>(o + (long long)(r + 8) * p + c) =
              make_float2(tot[4 * j + 2], tot[4 * j + 3]);
      }
    }
  }
  if constexpr (MOE) {
    if (wtid == 0) hopper::bulk_wait<0>();   // the stores leave smem first
  }
}

// The direct norm of every work item: the shared kernel body of
// moe_direct_norm_wgmma.cu (MASKED: MoE expert taps, the slot mask ``mask``
// (L,B,E,C) f32 and the stages' flags ``mf``) and grad_norm_direct_wgmma.cu
// (dense mm taps: E = 1, no mask, no flags, no mask warp, a ring of
// STAGES). Problem q = (l B + b) E + e at depth q of the maps (width, C,
// L*B*E); a work item is (q, a 128-wide d strip), walked with the strip
// fastest; the item's p tiles of 128 columns stream through the ring, a
// stage holding the strip's a rows beside the tile's g rows. A consumer
// warpgroup issues a tile's 64 x 128 products into one accumulator and
// squares and sums the last tile's, from the other, while they run. A
// tile past p (p tiles go in pairs) loads nothing and adds nothing. Each
// warp writes one partial an item: partial (b, ((l E + e) nd + d strip) 8
// + warp), row_len a b's partials; np: p tiles of an item.
template <bool MASKED>
__device__ __forceinline__ void direct_norm(const CUtensorMap* ma,
                                            const CUtensorMap* mg,
                                            const CUtensorMap* mf,
                                            const float* __restrict__ mask,
                                            float* __restrict__ partial,
                                            int B, int E, int C, int np,
                                            int row_len, Tiles tiles) {
  constexpr int BN = 128, NACC = BN / 2;
  constexpr int S = Cfg<BN, MASKED>::S, STAGE_BYTES = Cfg<BN>::STAGE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const Smem<S> sm(smem_raw, S * STAGE_BYTES, 0, MASKED);
  const int wg = hopper::warpgroup(), lane = threadIdx.x % 32;
  const int nt = (C + BK - 1) / BK;   // row tiles of one (l, b, e)
  // an item's p tiles run in pairs, one accumulator each: np rounded up
  const Walk walk{tiles, np + (np & 1), np, B, E, nt, true};

  if (threadIdx.x == 0) sm.init(MASKED);
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full; (masked) the next warp
    // masks it
    hopper::regs_dealloc<MASKED ? MOE_PRODUCER_REGS : PRODUCER_REGS>();
    if (threadIdx.x == 256) produce<BN, S>(ma, mg, mf, sm, walk);
    if constexpr (MASKED) {
      if (threadIdx.x / 32 == 9) mask_stages<BN, S>(sm, walk, mask, C);
    }
    return;
  }

  // consumers: warpgroup wg owns d columns d0 + 64 wg .. +63 of each strip
  hopper::regs_alloc<MASKED ? MOE_CONSUMER_REGS : CONSUMER_REGS>();
  const int warp = threadIdx.x / 32;
  float acc0[NACC], acc1[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc0[j] = acc1[j] = 0.f;
  int i = 0, held = -1;     // stage counter; the stage still being read
  int live0 = 0, live1 = 0;  // an accumulator holds products not yet summed
  uint32_t rph = 0u;         // (masked) the ready phase each slot waits for
  float s = 0.f;

  // One p tile: its stages' products into cur and, once they are issued
  // and the last tile's are done, prev squared and summed into s.
  auto ptile = [&](float(&cur)[NACC], float(&prev)[NACC], int& live_cur,
                   int& live_prev, bool real) {
    live_cur = 0;
    for (int kt = 0; kt < nt; ++kt, ++i) {
      const int st = i % S;
      hopper::mbar_wait(&sm.full[st], (i / S) & 1);
      const uint8_t* stage = sm.ring + st * STAGE_BYTES;
      hopper::fence_regs(cur);
      hopper::wgmma_fence();
      // the first product issued for a tile overwrites cur; a dummy tile's
      // stages hold nothing (masked: no k16 step flagged)
      if constexpr (MASKED) {
        const uint32_t kmask = wait_masked(sm, st, real, rph);
        live_cur = issue_stage<BN, true>(cur, stage + wg * BOX_BYTES,
                                         stage + (BM / BOX) * BOX_BYTES,
                                         kmask, live_cur);
      } else if (real) {
        live_cur = issue_stage<BN, false>(cur, stage + wg * BOX_BYTES,
                                          stage + (BM / BOX) * BOX_BYTES,
                                          0xFu, live_cur);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();   // every earlier group (prev's) is done
      hopper::fence_regs(cur);
      hopper::fence_regs(prev);
      __syncwarp();
      if (lane == 0 && held >= 0) hopper::mbar_arrive(&sm.empty[held]);
      held = st;
      if (kt == 0 && live_prev) {
#pragma unroll
        for (int j = 0; j < NACC; ++j) s = fmaf(prev[j], prev[j], s);
        live_prev = 0;
      }
    }
  };

  for (int tile = blockIdx.x; tile < tiles.count(); tile += gridDim.x) {
    int q, d0, p0;
    tiles.at(tile, q, d0, p0);
    s = 0.f;
    for (int pt = 0; pt < walk.nu; pt += 2) {
      ptile(acc0, acc1, live0, live1, pt < np);
      ptile(acc1, acc0, live1, live0, pt + 1 < np);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc1);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&sm.empty[held]);
    held = -1;
    if (live1) {
#pragma unroll
      for (int j = 0; j < NACC; ++j) s = fmaf(acc1[j], acc1[j], s);
      live1 = 0;
    }
    s = warp_sum(s);
    if (lane == 0) {
      // partial (b, ((l E + e) nd + d strip) 8 + warp)
      const int b = (q / E) % B, le = q / (B * E) * E + q % E;
      partial[(long long)b * row_len +
              ((long long)le * tiles.nd + d0 / BM) * CONSUMER_WARPS + warp] =
          s;
    }
  }
}


// The CTAs of a persistent launch: one an SM, at most one a tile.
inline int persistent_grid(int tiles, int* grid) {
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  *grid = tiles < sms ? tiles : sms;
  return err;
}

}  // namespace wgmma_grad
