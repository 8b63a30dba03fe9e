// fused_clip_grad: norm, clip and weighted gradient of a single-tap clip
// unit (scope='layer') in one launch and one pass over the records,
//
//     g_b  = a_b^T ds_b                       per-sample gradient (L,d,p)
//     sq_b = ||g_b||_F^2
//     C_b  = clip(sqrt(sq_b)) * w_b           f32, never rounded
//     G    = sum_b C_b g_b                    a (L,B,T,d), ds (L,B,T,p)
//
// Replaces the TPU kernel repro/kernels/fused_clip.py::fused_clip_grad, whose
// grid (B,) keeps one sample's whole (L,d,p) gradient in VMEM. The gate that
// sends a unit here (kernels/dispatch.py fused_plan, the reference's 6 MiB
// rule) admits L d p < 786,432, so the unit is small: at its edge ~2 GFLOP
// and ~9-18 MB (bf16), at the smoke-width units of parity_layer 25-100
// MFLOP. Its time is set by latency, by how many SMs it keeps busy and (at
// the edge) by the tiles' reads of a and ds through L2, not by the card's
// peak rates. The design:
//
// * A tile of (L, d, p) (l, a d tile, a p tile) belongs to a group of
//   ``split`` CTAs (a cluster), which split the unit's rows T; each computes
//   its rows' partial tile of g_b for every sample in turn, so the
//   contraction runs once and no g_b leaves the chip: a sample's partial
//   tile stays in shared memory. After a group of samples the cluster's
//   CTAs sum their partial tiles in distributed shared memory, each CTA one
//   slice of the tile in rank order, and each writes one partial of sq_b a
//   sample (its slice's squares) to device memory, the only state there.
// * The norm needs all of g_b before any tile is scaled: all CTAs meet at
//   one grid-wide barrier (cooperative_groups' grid sync; the launch is
//   cooperative, so a grid that cannot be co-resident is refused at launch,
//   and the host plan says so first). Then every CTA sums each b's
//   partials in the same fixed order (a warp a sample: lane j the partials
//   j, j + 32, .., then a xor tree), so all agree on sq_b, forms C_b in
//   f32, and folds its slice into its slice of G as tot = fmaf(C_b, g_b,
//   tot) in b order. G is written once, each entry by the CTA that owns it.
// * Samples go in groups of nb (<= 8) slots, one barrier a group, the
//   running slice of G held in registers across groups. The host picks the
//   route's tile, then the largest nb, then the largest split whose grid is
//   resident (make_plan). No float atomics anywhere: G and sq are bitwise
//   equal run to run.
//
// Two routes inside that skeleton (kernels/fused_clip.py route()):
// * wgmma, bf16 records with d and p multiples of 8: 64 x 64 tiles; a
//   producer thread keeps a TMA ring of STAGES stages of 64 rows (a: 64 d
//   columns, ds: 64 p columns, 128B swizzle; 3-D maps (width, T, L*B), so
//   rows past T and columns past d or p load as zero) on across samples, and
//   one consumer warpgroup issues m64n64k16 on the two MN-major operands
//   (hopper.cuh), one accumulator a sample, restarted at its first stage.
//   Rows are split only for a unit of few tiles (SPLIT_FEW). wgmma_grad.cuh's
//   mainloop (128-row d tiles, a persistent walk over tiles) does not fit:
//   its tiles would give 16 CTAs at edge_square (d = p = 512), and a CTA
//   that walks tiles cannot hold each tile's samples until the barrier.
// * simt, f32 records and unaligned widths: tiles of 16, 32 or 64 (the
//   smallest whose grid is resident), the rows split over up to MAX_SPLIT
//   CTAs; in a CTA 256 threads in NTG T-groups of 4 x 4 entries a thread,
//   T-group q taking the rows t = q (mod NTG) of each stage, a ring of
//   SIMT_STAGES stages fed by cp.async (the bf16 route: plain loads), the
//   T-groups' partial tiles summed in q order at the end of a sample.
//
// At the gate's edge: edge_stacked (L = 4, d = p = 256, B = 8, T = 512,
// exactly 6 MiB) is 64 wgmma CTAs of 193 KB of shared memory (8 slots,
// one a SM, one barrier); the edge's L d p in f32 ((1, 8, T, 512, 512))
// is 256 SIMT CTAs of 32 x 32 tiles, 112 KB each (two a SM). A unit whose
// grid cannot be resident at one slot is refused (the wrapper raises with
// its shape): one of more than 264 wgmma tiles, e.g. 80 layers of d = p =
// 72 at T = 64 (320 tiles), which the gate admits.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float EPS = 1e-12f;  // core/clipping.py _EPS
enum Clip { ABADI = 0, AUTOMATIC = 1, NORMALIZE = 2, FLAT = 3 };

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_NB = 8;        // sample slots of a group
// The unit's CTAs meet at a grid barrier (cooperative launch). Design (B)
// of design_study --only fused sets this: the whole unit in one cluster of
// at most MAX_CLUSTER CTAs, meeting at barrier.cluster instead.
constexpr bool ONE_CLUSTER = false;
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_SPLIT = 8;     // CTAs a tile's rows are split over
constexpr int WG_MAX_SPLIT = 4;  // (wgmma)
constexpr int MAX_PEERS = 8;     // a cluster's CTAs the sum reads
static_assert(MAX_SPLIT <= MAX_PEERS && WG_MAX_SPLIT <= MAX_PEERS,
              "a split beyond the peers the DSMEM sum reads");
// (wgmma) rows are split only where the unit has at most 1 / SPLIT_FEW
// tiles an SM: where it has more, the tiles' reads of a and ds already
// load L2, and a split (its DSMEM sum) measured slower (design_study)
constexpr int SPLIT_FEW = 4;

// wgmma route: 64 x 64 tiles, stages of 64 rows
constexpr int WG_TILE = 64;
constexpr int WG_ROWS = 64;
constexpr int STAGES = 4;
constexpr int NACC = WG_TILE * WG_TILE / 128;   // f32 a consumer thread
constexpr int BOX_BYTES = WG_ROWS * hopper::ROW_BYTES;    // 8 KB
constexpr int STAGE_BYTES = 2 * BOX_BYTES;                // a box, ds box
constexpr int KSTEP_BYTES = 16 * hopper::ROW_BYTES;       // 16 rows a k16

// The unit, its outputs and the launch's plan, as every kernel sees them.
struct Unit {
  const float* w;     // (B,) per-sample weight
  float* partial;     // (B, CTAs) partials of sq_b
  float* G;           // (L, d, p)
  float* sq;          // (B,)
  int B, T, d, p;
  int nd, np;         // tiles along d and p
  int nb;             // sample slots of a group
  int split, tper;    // CTAs a tile's rows are split over, rows each
  int clip;
  float R, gamma;
};

__device__ __forceinline__ float clip_factor(float n, int clip, float R,
                                             float gamma) {
  switch (clip) {
    case ABADI: return fminf(R / (n + EPS), 1.f);
    case AUTOMATIC: return R / (n + gamma);
    case NORMALIZE: return R / (n + EPS);
    default: return n <= R ? 1.f : 0.f;  // FLAT
  }
}

// The unit's CTAs, all of them: every partial of the group is written and
// visible once this returns.
__device__ __forceinline__ void unit_barrier() {
  if constexpr (ONE_CLUSTER)
    cg::this_cluster().sync();
  else
    cg::this_grid().sync();
}

// After a group's barrier: C_b of samples g0 .. g0 + nb - 1 into cvec, sq_b
// written by CTA 0. Warp w takes samples w, w + 8, ..: lane j sums the
// partials j, j + 32, .. of the unit's CTAs in order (from L2: other SMs
// wrote them), then a xor tree; every CTA runs the same sums on the same
// values, so all agree on C_b.
__device__ __forceinline__ void group_factors(const Unit& u, int g0, int nb,
                                              float* cvec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ncta = gridDim.x;
  for (int j = warp; j < nb; j += WARPS) {
    const float* row = u.partial + (long long)(g0 + j) * ncta;
    float s = 0.f;
#pragma unroll 8
    for (int k = lane; k < ncta; k += 32) s += __ldcg(row + k);
    s = warp_sum(s);
    if (lane == 0) {
      cvec[j] = clip_factor(sqrtf(s), u.clip, u.R, u.gamma) * u.w[g0 + j];
      if (blockIdx.x == 0) u.sq[g0 + j] = s;
    }
  }
  __syncthreads();
}

// Where a CTA works: its tile (layer l, first row d0 and column p0; the
// tiles in (l, d tile, p tile) order), its rank among the u.split CTAs
// that share the tile (a cluster), the rows [t0, t1) of each sample it
// contracts, and the slice [e0, e1) of the tile's entries it owns.
struct Work {
  int l, d0, p0, rank, t0, t1, e0, e1;
  __device__ __forceinline__ Work(const Unit& u, int tile) {
    rank = blockIdx.x % u.split;
    const int index = blockIdx.x / u.split, per_l = u.nd * u.np;
    l = index / per_l;
    d0 = (index % per_l / u.np) * tile;
    p0 = (index % per_l % u.np) * tile;
    t0 = rank * u.tper;
    t1 = min(u.T, t0 + u.tper);
    const int per = (tile * tile + u.split - 1) / u.split;
    e0 = rank * per;
    e1 = min(tile * tile, e0 + per);
  }
};

// Row and column (in the tile) of entry e of a partial tile: row-major
// (simt), or (FRAG, wgmma) in the accumulators' order, entry k 128 + t
// being register k of consumer thread t (warp w = t / 32 of the warpgroup:
// row 16 w + (t % 32) / 4 + 8 ((k % 4) / 2), column 8 (k / 4) + 2 (t % 4)
// + k % 2), so that the consumers store a tile without bank conflicts.
template <bool FRAG, int TILE>
__device__ __forceinline__ void entry_at(int e, int& r, int& c) {
  if constexpr (FRAG) {
    const int k = e / 128, t = e % 128;
    r = 16 * (t / 32) + (t % 32) / 4 + 8 * ((k % 4) / 2);
    c = 8 * (k / 4) + 2 * (t % 4) + k % 2;
  } else {
    r = e / TILE;
    c = e % TILE;
  }
}

// The end of a group of nb samples, every thread of the CTA: ``part``
// (nb, TILE^2) holds this CTA's partial tile of each sample, over its rows.
// Each CTA sums its slice of the tile over the CTAs that share the tile,
// in rank order, in place (the others read only their own slices of it):
// one (sample, entry) pair a thread, the other CTAs' values loaded
// together. Then warp j writes sample j's partial of sq_b (its slice's
// squares, lane-strided, a xor tree); the unit's barrier; C_b; and tot
// (entries e0 + threadIdx.x + k THREADS of the slice) += C_b g_b in b
// order.
template <int TILE>
__device__ __forceinline__ void group_tail(const Unit& u, const Work& wk,
                                           float* part, int g0, int nb,
                                           float* cvec,
                                           float (&tot)[TILE * TILE /
                                                        THREADS]) {
  constexpr int E = TILE * TILE;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int len = wk.e1 - wk.e0;
  if (u.split > 1) {
    const cg::cluster_group cl = cg::this_cluster();
    cl.sync();   // every CTA of the tile holds its partial tiles
    const float* peer[MAX_PEERS];
    const unsigned first = cl.block_rank() - wk.rank;
#pragma unroll
    for (int q = 0; q < MAX_PEERS; ++q)
      peer[q] = cl.map_shared_rank(part, first + (q < u.split ? q : 0));
    for (int x = tid; x < nb * len; x += THREADS) {
      const int at = (x / len) * E + wk.e0 + x % len;
      float v[MAX_PEERS];
#pragma unroll
      for (int q = 0; q < MAX_PEERS; ++q)
        if (q < u.split) v[q] = peer[q][at];
      float sum = v[0];
#pragma unroll
      for (int q = 1; q < MAX_PEERS; ++q)
        if (q < u.split) sum += v[q];
      part[at] = sum;
    }
  }
  __syncthreads();
  for (int j = warp; j < nb; j += WARPS) {
    float s = 0.f;
    for (int e = wk.e0 + lane; e < wk.e1; e += 32) {
      const float v = part[j * E + e];
      s = fmaf(v, v, s);
    }
    s = warp_sum(s);
    if (lane == 0)
      u.partial[(long long)(g0 + j) * gridDim.x + blockIdx.x] = s;
  }
  unit_barrier();
  group_factors(u, g0, nb, cvec);
  for (int j = 0; j < nb; ++j) {
    const float cf = cvec[j];
#pragma unroll
    for (int k = 0; k < E / THREADS; ++k) {
      const int e = wk.e0 + tid + k * THREADS;
      if (e < wk.e1) tot[k] = fmaf(cf, part[j * E + e], tot[k]);
    }
  }
}

// The CTA's slice of G, once (entries past d or p dropped).
template <bool FRAG, int TILE>
__device__ __forceinline__ void store_slice(
    const Unit& u, const Work& wk, const float (&tot)[TILE * TILE / THREADS]) {
  float* o = u.G + (long long)wk.l * u.d * u.p;
#pragma unroll
  for (int k = 0; k < TILE * TILE / THREADS; ++k) {
    const int e = wk.e0 + threadIdx.x + k * THREADS;
    int r, c;
    entry_at<FRAG, TILE>(e, r, c);
    r += wk.d0;
    c += wk.p0;
    if (e < wk.e1 && r < u.d && c < u.p) o[(long long)r * u.p + c] = tot[k];
  }
}

// ------------------------------------------------------------ wgmma route
__global__ void __launch_bounds__(THREADS)
    fused_clip_wgmma_kernel(const __grid_constant__ CUtensorMap ma,
                            const __grid_constant__ CUtensorMap mg, Unit u) {
  constexpr int E = WG_TILE * WG_TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hopper::align_atom(smem_raw);
  float* part = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(part + u.nb * E);
  uint64_t* empty = full + STAGES;
  __shared__ float cvec[MAX_NB];

  const Work wk(u, WG_TILE);
  // stages of 64 rows of a sample here (tper is a whole number of them)
  const int nst = wk.t1 > wk.t0 ? (wk.t1 - wk.t0 + WG_ROWS - 1) / WG_ROWS
                                : 0;
  const int wg = hopper::warpgroup(), lane = threadIdx.x % 32;
  const int wtid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);   // the consumer warps
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  float tot[E / THREADS], acc[NACC];
#pragma unroll
  for (int k = 0; k < E / THREADS; ++k) tot[k] = 0.f;
  int i = 0;   // stages filled (producer) or used (consumers) so far
  for (int g0 = 0; g0 < u.B; g0 += u.nb) {
    const int nb = min(u.nb, u.B - g0);
    if (wg == 1) {
      // producer: one thread fills the group's stages, on across samples
      if (threadIdx.x == 128) {
        for (int k = 0; k < nb * nst; ++k, ++i) {
          const int s = i % STAGES, z = wk.l * u.B + g0 + k / nst;
          const int t0 = wk.t0 + (k % nst) * WG_ROWS;
          hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
          uint8_t* st = ring + s * STAGE_BYTES;
          hopper::mbar_expect_tx(&full[s], STAGE_BYTES);
          hopper::tma_load_3d(st, &ma, &full[s], wk.d0, t0, z);
          hopper::tma_load_3d(st + BOX_BYTES, &mg, &full[s], wk.p0, t0, z);
        }
      }
    } else {
      for (int j = 0; j < nb; ++j) {
        // sample g0 + j: its stages' products into acc, one stage's kept
        // in flight; the first overwrites acc (scale_d = 0)
#pragma unroll
        for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
        int held = -1;
        for (int tt = 0; tt < nst; ++tt, ++i) {
          const int s = i % STAGES;
          hopper::mbar_wait(&full[s], (i / STAGES) & 1);
          const uint8_t* st = ring + s * STAGE_BYTES;
          hopper::fence_regs(acc);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < WG_ROWS / 16; ++kk)
            hopper::mma_ss<1, 1>(
                acc,
                hopper::desc(st + kk * KSTEP_BYTES, BOX_BYTES,
                             hopper::ATOM_BYTES),
                hopper::desc(st + BOX_BYTES + kk * KSTEP_BYTES, BOX_BYTES,
                             hopper::ATOM_BYTES),
                (tt > 0 || kk > 0) ? 1 : 0);
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();   // the previous stage's products are done
          hopper::fence_regs(acc);
          __syncwarp();
          if (lane == 0 && held >= 0) hopper::mbar_arrive(&empty[held]);
          held = s;
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        __syncwarp();
        if (lane == 0 && held >= 0) hopper::mbar_arrive(&empty[held]);
        // this CTA's partial tile of g_b, in the accumulators' order
#pragma unroll
        for (int k = 0; k < NACC; ++k) part[j * E + k * 128 + wtid] = acc[k];
      }
    }
    group_tail<WG_TILE>(u, wk, part, g0, nb, cvec, tot);
  }
  store_slice<true, WG_TILE>(u, wk, tot);
}

// ------------------------------------------------------------- simt route
constexpr int STAGE_ELEMS = 1024;   // a record's elements a stage: SR x TILE
constexpr int SIMT_STAGES = 8;      // the ring's stages

template <int TILE>
struct Simt {
  static constexpr int TPG = TILE * TILE / 16;   // threads of a T-group
  static constexpr int NTG = THREADS / TPG;      // T-groups: 16, 4, 1
  static constexpr int SR = STAGE_ELEMS / TILE;  // rows a stage: 64, 32, 16
  static constexpr int PER = STAGE_ELEMS / THREADS;   // copies a record
  static constexpr int E = TILE * TILE;
  // floats of dynamic shared memory before the nb partial tiles: the ring
  // (a, then ds, a stage) and the T-groups' partial tiles
  static constexpr int FIXED = SIMT_STAGES * 2 * STAGE_ELEMS + NTG * E;
};

// One element of a stage: f32, an asynchronous 4-byte copy (zero-filled
// where ``valid`` is false); bf16, loaded, widened and stored here.
__device__ __forceinline__ void stage_copy(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   hopper::smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void stage_copy(float* dst,
                                           const __nv_bfloat16* src,
                                           bool valid) {
  *dst = valid ? to_f32(*src) : 0.f;
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N commit groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows t0 .. t0 + SR - 1 of sample b (those below t1) into ring stage
// ``st``, a then ds, as the stage's elements threadIdx.x + k THREADS (row
// e / TILE, column e % TILE: a thread keeps its column); rows past t1 and
// columns past d or p are zero.
template <typename T, int TILE>
__device__ __forceinline__ void issue_stage(float* st, const T* a, const T* g,
                                            const Unit& u, const Work& wk,
                                            int b, int t0) {
  const int c = threadIdx.x % TILE, r0 = threadIdx.x / TILE;
  const long long row0 = ((long long)wk.l * u.B + b) * u.T;
  const bool in_a = wk.d0 + c < u.d, in_g = wk.p0 + c < u.p;
#pragma unroll
  for (int k = 0; k < Simt<TILE>::PER; ++k) {
    const int r = r0 + k * (THREADS / TILE), t = t0 + r;
    const bool va = in_a && t < wk.t1, vg = in_g && t < wk.t1;
    stage_copy(st + r * TILE + c,
               va ? a + (row0 + t) * u.d + wk.d0 + c : a, va);
    stage_copy(st + STAGE_ELEMS + r * TILE + c,
               vg ? g + (row0 + t) * u.p + wk.p0 + c : g, vg);
  }
}

template <typename T, int TILE>
__global__ void __launch_bounds__(THREADS)
    fused_clip_simt_kernel(const void* a_, const void* g_, Unit u) {
  using S = Simt<TILE>;
  const T* a = static_cast<const T*>(a_);
  const T* g = static_cast<const T*>(g_);
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);   // (STAGES, 2, SR*TILE)
  float* red = ring + SIMT_STAGES * 2 * STAGE_ELEMS;   // (NTG, TILE^2)
  float* part = red + S::NTG * S::E;   // (nb, TILE^2): this CTA's tiles
  __shared__ float cvec[MAX_NB];

  const Work wk(u, TILE);
  const int nst =   // stages of a sample here
      wk.t1 > wk.t0 ? (wk.t1 - wk.t0 + S::SR - 1) / S::SR : 0;
  const int tid = threadIdx.x;
  const int tg = tid / S::TPG, ti = tid % S::TPG;
  const int ty = ti / (TILE / 4), tx = ti % (TILE / 4);

  float tot[S::E / THREADS];
#pragma unroll
  for (int k = 0; k < S::E / THREADS; ++k) tot[k] = 0.f;
  for (int g0 = 0; g0 < u.B; g0 += u.nb) {
    const int nb = min(u.nb, u.B - g0), n = nb * nst;   // the group's stages
    auto issue = [&](int i) {
      issue_stage<T, TILE>(ring + (i % SIMT_STAGES) * 2 * STAGE_ELEMS, a, g,
                           u, wk, g0 + i / nst,
                           wk.t0 + (i % nst) * S::SR);
    };
    for (int i = 0; i < SIMT_STAGES - 1; ++i) {
      if (i < n) issue(i);
      copies_commit();
    }
    float acc[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][q] = 0.f;
    for (int i = 0; i < n; ++i) {
      copies_wait<SIMT_STAGES - 2>();   // stage i has landed (this thread's)
      __syncthreads();                  // (everyone's), and i - 1 is read
      if (i + SIMT_STAGES - 1 < n) issue(i + SIMT_STAGES - 1);
      copies_commit();
      const int j = i / nst, c = i % nst;
      const int rows = min(S::SR, wk.t1 - (wk.t0 + c * S::SR));
      const float* xa = ring + (i % SIMT_STAGES) * 2 * STAGE_ELEMS + ty * 4;
      const float* xg = xa - ty * 4 + STAGE_ELEMS + tx * 4;
#pragma unroll 4
      for (int r = tg; r < rows; r += S::NTG) {
        const float4 x = *reinterpret_cast<const float4*>(xa + r * TILE);
        const float4 y = *reinterpret_cast<const float4*>(xg + r * TILE);
        const float xv[4] = {x.x, x.y, x.z, x.w};
        const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[m][q] = fmaf(xv[m], yv[q], acc[m][q]);
      }
      if (c != nst - 1) continue;
      // sample g0 + j done here: the T-groups' partial tiles, summed in
      // T-group order, into part[j]
      float* mine = red + tg * S::E;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        *reinterpret_cast<float4*>(mine + (ty * 4 + m) * TILE + tx * 4) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][q] = 0.f;
      }
      __syncthreads();
      for (int e = tid; e < S::E; e += THREADS) {
        float v = red[e];
        for (int q = 1; q < S::NTG; ++q) v += red[q * S::E + e];
        part[j * S::E + e] = v;
      }
    }
    copies_wait<0>();
    if (nst == 0)   // no rows of this split here
      for (int e = tid; e < nb * S::E; e += THREADS) part[e] = 0.f;
    group_tail<TILE>(u, wk, part, g0, nb, cvec, tot);
  }
  store_slice<false, TILE>(u, wk, tot);
}

// ------------------------------------------------------------------ host
using SimtFn = void (*)(const void*, const void*, Unit);

SimtFn simt_kernel(int bf16, int tile) {
  if (bf16)
    return tile == 16 ? fused_clip_simt_kernel<__nv_bfloat16, 16>
           : tile == 32 ? fused_clip_simt_kernel<__nv_bfloat16, 32>
                        : fused_clip_simt_kernel<__nv_bfloat16, 64>;
  return tile == 16 ? fused_clip_simt_kernel<float, 16>
         : tile == 32 ? fused_clip_simt_kernel<float, 32>
                      : fused_clip_simt_kernel<float, 64>;
}

size_t smem_bytes(int wgmma, int tile, int nb) {
  if (wgmma)
    return STAGES * STAGE_BYTES +
           (size_t)nb * WG_TILE * WG_TILE * sizeof(float) +
           2 * STAGES * sizeof(uint64_t) + hopper::ATOM_BYTES;
  const int fixed = tile == 16   ? Simt<16>::FIXED
                    : tile == 32 ? Simt<32>::FIXED
                                 : Simt<64>::FIXED;
  return ((size_t)fixed + (size_t)nb * tile * tile) * sizeof(float);
}

// A launch's configuration: ``grid`` CTAs of THREADS, clusters of
// ``cluster`` CTAs; cooperative, or (ONE_CLUSTER) the grid one cluster.
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  Launch(int grid, int cluster, size_t smem, cudaStream_t st)
      : cfg{}, attr{} {
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    int n = 0;
    if (!ONE_CLUSTER) {
      attr[n].id = cudaLaunchAttributeCooperative;
      attr[n++].val.cooperative = 1;
    }
    if (ONE_CLUSTER || cluster > 1) {
      attr[n].id = cudaLaunchAttributeClusterDimension;
      attr[n].val.clusterDim.x = ONE_CLUSTER ? grid : cluster;
      attr[n].val.clusterDim.y = 1;
      attr[n++].val.clusterDim.z = 1;
    }
    cfg.attrs = attr;
    cfg.numAttrs = n;
  }
};

// -> in *n, how many CTAs of ``kernel`` (``smem`` bytes each, clusters of
// ``cluster``) the card holds at once: clusters an SM... times the
// cluster, or blocks an SM times SMs; (ONE_CLUSTER) ``grid`` if the grid
// fits as one cluster, else 0. -> 0 or a cudaError_t.
template <typename K>
int resident(K kernel, size_t smem, int grid, int cluster, int* n) {
  *n = 0;
  int err = hopper::allow_smem(kernel, smem);
  if (err) return err;
  if (ONE_CLUSTER || cluster > 1) {
    if (ONE_CLUSTER && grid > MAX_CLUSTER) return 0;
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    Launch lc(grid, cluster, smem, nullptr);
    int clusters = 0;
    if (!err)
      err = (int)cudaOccupancyMaxActiveClusters(&clusters, kernel, &lc.cfg);
    *n = ONE_CLUSTER ? (clusters > 0 ? grid : 0) : clusters * cluster;
    return err;
  }
  int per_sm = 0, dev = 0, sms = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                           THREADS, smem);
  if (!err) err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  *n = per_sm * sms;
  return err;
}

struct Plan {
  int tile, nb, split, tper, grid, resident;
  size_t smem;
};

int sm_count(int* sms) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  return err;
}

// The plan of a unit: the route's tile (wgmma: 64; simt: the smallest of
// 16, 32, 64 with which a plan is resident), the largest group of sample
// slots (<= 8), then (simt) the largest split of each tile's rows (1, 2, 4
// or 8 CTAs, each at least a stage of rows) that keeps the grid within
// twice the SMs (ONE_CLUSTER: within MAX_CLUSTER) and resident. grid = 0:
// no plan is resident (``resident`` then holds the last count tried).
int make_plan(int L, int B, int T, int d, int p, int bf16, int wgmma,
              Plan* pl) {
  static const int tiles[3] = {16, 32, 64};
  *pl = Plan{0, 0, 0, 0, 0, 0, 0};
  int sms = 0;
  int err = sm_count(&sms);
  if (err) return err;
  const int cap = ONE_CLUSTER ? MAX_CLUSTER : 2 * sms;
  for (int ti = wgmma ? 2 : 0; ti < 3; ++ti) {
    const int tile = tiles[ti];
    const int ntiles =
        L * ((d + tile - 1) / tile) * ((p + tile - 1) / tile);
    const int sr = wgmma ? WG_ROWS : STAGE_ELEMS / tile;   // rows a stage
    for (int nb = B < MAX_NB ? B : MAX_NB; nb >= 1; --nb) {
      const size_t smem = smem_bytes(wgmma, tile, nb);
      for (int split = wgmma ? WG_MAX_SPLIT : MAX_SPLIT; split >= 1;
           split /= 2) {
        const int tper = ((T + split - 1) / split + sr - 1) / sr * sr;
        const int grid = ntiles * split;
        if (split > 1 && ((split - 1) * tper >= T || grid > cap ||
                          (wgmma && SPLIT_FEW * ntiles > sms)))
          continue;
        int n = 0;
        err = wgmma
                  ? resident(fused_clip_wgmma_kernel, smem, grid, split, &n)
                  : resident(simt_kernel(bf16, tile), smem, grid, split, &n);
        if (err) return err;
        pl->resident = n;
        if (grid <= n) {
          *pl = Plan{tile, nb, split, tper, grid, n, smem};
          return 0;
        }
      }
    }
  }
  return 0;
}

// The last plans made, by unit shape (a unit's plan is asked for twice a
// call, for its partials and at the launch).
int plan_of(int L, int B, int T, int d, int p, int bf16, int wgmma,
            Plan* pl) {
  constexpr int KEY = 8, SLOTS = 16;
  struct Entry {
    int key[KEY];
    Plan plan;
  };
  static Entry cache[SLOTS];
  static int used = 0, next = 0;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  const int key[KEY] = {L, B, T, d, p, bf16, wgmma, dev};
  for (int e = 0; e < used; ++e) {
    bool same = true;
    for (int k = 0; k < KEY; ++k) same = same && cache[e].key[k] == key[k];
    if (same) {
      *pl = cache[e].plan;
      return 0;
    }
  }
  err = make_plan(L, B, T, d, p, bf16, wgmma, pl);
  if (err) return err;
  Entry& slot = cache[used < SLOTS ? used++ : next++ % SLOTS];
  for (int k = 0; k < KEY; ++k) slot.key[k] = key[k];
  slot.plan = *pl;
  return 0;
}

}  // namespace

// The plan of a unit (route: wgmma 1, simt 0) -> out[7] = {tile, sample
// slots a group, CTAs a tile's rows are split over, rows each, CTAs, CTAs
// the card holds at once, shared memory bytes a CTA}; CTAs = 0 when no
// plan's grid can be resident.
extern "C" int dp_fused_clip_plan(int L, int B, int T, int d, int p,
                                  int bf16, int wgmma, int* out) {
  Plan pl;
  const int err = plan_of(L, B, T, d, p, bf16, wgmma, &pl);
  out[0] = pl.tile;
  out[1] = pl.nb;
  out[2] = pl.split;
  out[3] = pl.tper;
  out[4] = pl.grid;
  out[5] = pl.resident;
  out[6] = (int)pl.smem;
  return err;
}

// -> the CTAs of the unit's launch (the partials a sample), 0 when no
// plan's grid can be resident, or -(a cudaError_t).
extern "C" int dp_fused_clip_nparts(int L, int B, int T, int d, int p,
                                    int bf16, int wgmma) {
  Plan pl;
  const int err = plan_of(L, B, T, d, p, bf16, wgmma, &pl);
  return err ? -err : pl.grid;
}

// a (L,B,T,d), ds (L,B,T,p) contiguous, both f32 (bf16 == 0) or bf16 (wgmma:
// bf16, d and p multiples of 8, 16-byte aligned); w (B,) f32; partial
// (B, nparts) f32; G (L,d,p) f32 (every entry written); sq (B,) f32. clip:
// 0 abadi, 1 automatic, 2 normalize, 3 flat. One launch on ``stream``.
extern "C" int dp_fused_clip_grad(const void* a, const void* ds,
                                  const float* w, float* partial, float* G,
                                  float* sq, int L, int B, int T, int d,
                                  int p, int bf16, int wgmma, int clip,
                                  float R, float gamma, void* stream) {
  if (wgmma && (!bf16 || d % 8 || p % 8)) return (int)cudaErrorInvalidValue;
  Plan pl;
  int err = plan_of(L, B, T, d, p, bf16, wgmma, &pl);
  if (err) return err;
  if (!pl.grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  const Unit u{w, partial, G, sq, B, T, d, p,
               (d + pl.tile - 1) / pl.tile, (p + pl.tile - 1) / pl.tile,
               pl.nb, pl.split, pl.tper, clip, R, gamma};
  Launch lc(pl.grid, pl.split, pl.smem, (cudaStream_t)stream);
  if (!wgmma)
    return (int)cudaLaunchKernelEx(&lc.cfg, simt_kernel(bf16, pl.tile), a,
                                   ds, u);
  CUtensorMap ma, mg;
  const cuuint64_t LB = (cuuint64_t)L * B;
  const cuuint32_t box[3] = {WG_TILE, WG_ROWS, 1};
  const cuuint64_t adims[3] = {(cuuint64_t)d, (cuuint64_t)T, LB};
  const cuuint64_t astr[2] = {(cuuint64_t)d * 2, (cuuint64_t)T * d * 2};
  const cuuint64_t gdims[3] = {(cuuint64_t)p, (cuuint64_t)T, LB};
  const cuuint64_t gstr[2] = {(cuuint64_t)p * 2, (cuuint64_t)T * p * 2};
  err = hopper::make_map(&ma, a, 3, adims, astr, box);
  if (!err) err = hopper::make_map(&mg, ds, 3, gdims, gstr, box);
  if (err) return err;
  return (int)cudaLaunchKernelEx(&lc.cfg, fused_clip_wgmma_kernel, ma, mg,
                                 u);
}
