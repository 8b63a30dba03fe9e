// moe_ghost_norm on the tensor cores: per-sample squared gradient norms of
// an MoE expert tap by the ghost trick over the per-(sample, expert) capacity
// layout, for bf16 records whose widths d and p are multiples of 8, with no
// per-sample gradient and no Gram in device memory,
//
//     n_b = sum_{l,e} < am am^T , gm gm^T >_F      am = diag(m) a_lbe, etc.
//         = sum_{l,e} sum_{i,j} (m_i m_j)^2 (a a^T)_ij (g g^T)_ij
//
//     a (L,B,E,C,d), mask m (L,B,E,C) f32, g (L,B,E,C,p) -> (B,) f32
//
// Replaces the TPU kernel repro/kernels/moe_ghost.py::moe_ghost_norm on the
// MoE train paths (f32 records and unaligned widths keep moe_ghost_norm.cu,
// the SIMT kernel). Bound on the H100: ~C/2 operations per input byte, far
// under the card's ridge, so reading the records bounds it: 2.56 GB a step
// at deepseek-moe-16b's two expert taps (L=5, B=8, E=64, C=60; 0.76 ms at
// 3.35 TB/s), against 0.17 TFLOP of Grams (0.18 ms at the bf16 peak). The
// SIMT kernel formed the Grams on the f32 cores from synchronous loads and
// ran at 0.23 TB/s. Here the records stream through TMA at HBM rate while
// the tensor cores form the Grams out of sight.
//
// Work items are (l, b, e, tile pair i >= j of the packed lower triangle of
// 64-slot tiles): one diagonal item a (l, b, e) where C <= 64 (both
// operands are then one box), the triangle's pairs in order for a longer
// capacity, an off-diagonal pair counted twice. A 128-row tile, as
// ghost_norm_wgmma.cu takes, would zero-fill more than half of each tile at
// C = 60. One CTA per SM walks the items; each of its two consumer
// warpgroups takes every other one and forms the item's two 64 x 64 Grams
// with m64n64k16, both operands K-major from shared memory (the reduction
// axis d or p is contiguous in the records): A_i A_j^T over d, then
// G_i G_j^T over p, each summed in pieces (below). The fragments of the two
// Grams have the same layout, so the item's sum is a register-local fmaf.
// A producer warpgroup (one thread issues; the warpgroup hands its
// registers to the consumers) feeds each consumer its own ring of k64
// stages (a stage: box i, and box j off the diagonal), the two rings in
// turn, so that both consumers stream at once; the ring runs on across
// items. The tensor maps are 3-D (width, C, L*B*E) over the records as they
// lie, so TMA zero-fills rows past C inside each item and columns past d or
// p: a zero row adds nothing to either Gram.
//
// The slot mask goes on the accumulators, not on the operands: each thread
// loads the mask of its fragment's two rows and sixteen columns and weights
// its entries of the finished d Gram by (m_i m_j)^2. No masked copy, no
// write to shared memory, no pre-pass; exact for a mask of any value (a
// mask on the operands would round m a to bf16 first). The reference's f32
// am = a m differs from this only by f32 rounding.
//
// Precision: as in ghost_norm_wgmma.cu, a wgmma accumulator sums at most
// PIECE k64 stages (k = 512), and the pieces are added in f32 on the CUDA
// cores: the d Gram's pieces into ga, each p piece's products with the
// weighted ga summed by fmaf into the item's sum. chip_smoke.py holds the
// norms to a float64 evaluation; repro_torch.kernels.design_study times
// pieces of 4 and 32 stages and shallower rings beside this kernel.
//
// Each warp writes one partial an item, and a second pass sums each b's
// partials in a fixed order (no float atomics): bitwise equal run to run.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int TILE = 64;        // slots of a Gram tile: M and N of a wgmma
constexpr int BOX = 64;         // columns of a stage: one 128-byte row
constexpr int THREADS = 384;    // two consumer warpgroups + a producer's
constexpr int WARPS = 4;        // warps of a consumer
constexpr int PIECE = 8;        // k64 stages a wgmma accumulator sums
constexpr int RING_BYTES = 208 * 1024;   // the two consumers' rings
// registers a thread: the producer warpgroup gives up most of its share;
// the split adds up to the launch's 384 x 168 (setmaxnreg.inc waits for
// registers that are free, so a split above that would never start)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS == THREADS * 168,
              "the register split must add up to the launch's");
constexpr int BOX_BYTES = TILE * hopper::ROW_BYTES;   // 8 KB

// A consumer's ring: NBOX boxes a stage (1 where every item is diagonal,
// C <= 64; 2 else), S stages.
template <int NBOX>
struct Ring {
  static constexpr int STAGE_BYTES = NBOX * BOX_BYTES;
  static constexpr int S = RING_BYTES / (2 * STAGE_BYTES);
  static constexpr size_t SMEM = 2 * S * STAGE_BYTES +
                                 4 * S * sizeof(uint64_t) +
                                 hopper::ATOM_BYTES;   // + alignment slack
  static_assert(S >= 2, "a ring needs two stages");
  static_assert(SMEM <= 232448, "over the 227 KB a block may use");
};

// The work items in launch order: the pair fastest, then z = (l B + b) E
// + e. kd, kp: k64 stages of d and of p.
struct Items {
  int npairs, z, kd, kp;
  __device__ __forceinline__ int count() const { return npairs * z; }
  __device__ __forceinline__ void at(int w, int& zz, int& i, int& j) const {
    const int k = w % npairs;
    zz = w / npairs;
    // packed lower triangle: k = i (i + 1) / 2 + j, j <= i
    i = (int)((sqrtf(8.f * (float)k + 1.f) - 1.f) * 0.5f);
    while ((i + 1) * (i + 2) / 2 <= k) ++i;
    while (i * (i + 1) / 2 > k) --i;
    j = k - i * (i + 1) / 2;
  }
};

template <int NBOX>
__global__ void __launch_bounds__(THREADS, 1)
    moe_ghost_wgmma_kernel(const __grid_constant__ CUtensorMap ma,
                           const __grid_constant__ CUtensorMap mg,
                           const float* __restrict__ mask,
                           float* __restrict__ partial, int B, int E, int C,
                           int row_len, Items items) {
  using R = Ring<NBOX>;
  constexpr int S = R::S;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hopper::align_atom(smem_raw);   // consumer c's at c S
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 2 * S * R::STAGE_BYTES);
  uint64_t* empty = full + 2 * S;
  const int wg = hopper::warpgroup(), lane = threadIdx.x % 32;
  const int consumers = 2 * gridDim.x;   // consumer 2 x + c takes every
                                         // consumers-th item from there

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], WARPS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread loads stage s of both consumers' items, in turn
    // (both items have kd + kp stages; the last round may have one item)
    hopper::regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      const int n = items.kd + items.kp, count = items.count();
      int it = 0;
      for (int w0 = 2 * blockIdx.x; w0 < count; w0 += consumers) {
        const int nc = count - w0 < 2 ? 1 : 2;
        for (int s = 0; s < n; ++s, ++it) {
          const bool on_a = s < items.kd;
          const CUtensorMap* m = on_a ? &ma : &mg;
          const int col = (on_a ? s : s - items.kd) * BOX;
          for (int c = 0; c < nc; ++c) {
            int z, i, j;
            items.at(w0 + c, z, i, j);
            const bool two = NBOX == 2 && i != j;
            const int q = c * S + it % S;
            uint8_t* st = ring + q * R::STAGE_BYTES;
            hopper::mbar_wait(&empty[q], ((it / S) & 1) ^ 1);
            hopper::mbar_expect_tx(&full[q], two ? 2 * BOX_BYTES : BOX_BYTES);
            hopper::tma_load_3d(st, m, &full[q], col, i * TILE, z);
            if (two)
              hopper::tma_load_3d(st + BOX_BYTES, m, &full[q], col, j * TILE,
                                  z);
          }
        }
      }
    }
    return;
  }

  // consumer wg: items 2 blockIdx.x + wg, then every consumers-th
  hopper::regs_alloc<CONSUMER_REGS>();
  const int warp = (threadIdx.x / 32) % WARPS;
  uint8_t* cring = ring + wg * S * R::STAGE_BYTES;
  uint64_t* cfull = full + wg * S;
  uint64_t* cempty = empty + wg * S;
  float ga[32], gg[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) ga[q] = gg[q] = 0.f;
  int it = 0, held = -1;   // stage counter; the stage still being read

  // One stage's four k16 steps into acc (the first step of a piece, live
  // false, overwrites it), with the previous stage's products waited for
  // and its slot handed back.
  auto stage = [&](float(&acc)[32], bool live, bool diag) {
    const int slot = it % S;
    hopper::mbar_wait(&cfull[slot], (it / S) & 1);
    const uint8_t* sa = cring + slot * R::STAGE_BYTES;
    const uint8_t* sb = sa + (diag ? 0 : BOX_BYTES);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BOX / 16; ++kk)
      hopper::mma_ss<0, 0>(
          acc, hopper::desc(sa + 32 * kk, 16, hopper::ATOM_BYTES),
          hopper::desc(sb + 32 * kk, 16, hopper::ATOM_BYTES),
          (live || kk > 0) ? 1 : 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();   // the previous stage's products are done
    hopper::fence_regs(acc);
    __syncwarp();
    if (lane == 0 && held >= 0) hopper::mbar_arrive(&cempty[held]);
    held = slot;
    ++it;
  };

  // every product issued so far is done (the slot last read stays held)
  auto drain = [&]() {
    hopper::wgmma_wait<0>();
    hopper::fence_regs(ga);
    hopper::fence_regs(gg);
  };

  // the thread's fragment: ga[4 jj + e] is entry (r0 + 8 (e / 2),
  // 8 jj + c0 + e % 2) of the item's 64 x 64 Gram
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const int count = items.count();
  for (int w = 2 * blockIdx.x + wg; w < count; w += consumers) {
    int z, i, j;
    items.at(w, z, i, j);
    const bool diag = i == j;
    // the slot mask of the fragment's rows and columns, 0 past C
    const float* mz = mask + (long long)z * C;
    float mr[2], mc[16];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = i * TILE + r0 + 8 * e;
      mr[e] = r < C ? mz[r] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int col = j * TILE + 8 * (q / 2) + c0 + q % 2;
      mc[q] = col < C ? mz[col] : 0.f;
    }
    // the d Gram: its first piece into ga, each later one into gg and then
    // added to ga
    const int kd = items.kd, kp = items.kp, n0 = kd < PIECE ? kd : PIECE;
    for (int s = 0; s < n0; ++s) stage(ga, s > 0, diag);
    for (int s0 = n0; s0 < kd; s0 += PIECE) {
      for (int s = s0; s < s0 + PIECE && s < kd; ++s)
        stage(gg, s > s0, diag);
      drain();
#pragma unroll
      for (int q = 0; q < 32; ++q) ga[q] += gg[q];
    }
    drain();
    // the mask on the d Gram: (m_i m_j)^2
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const float x = mr[(q % 4) / 2] * mc[2 * (q / 4) + q % 2];
      ga[q] *= x * x;
    }
    // the p Gram, piece by piece into gg, each piece's products with the
    // weighted d Gram summed
    float sum = 0.f;
    for (int s0 = 0; s0 < kp; s0 += PIECE) {
      for (int s = s0; s < s0 + PIECE && s < kp; ++s)
        stage(gg, s > s0, diag);
      drain();
#pragma unroll
      for (int q = 0; q < 32; ++q) sum = fmaf(ga[q], gg[q], sum);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&cempty[held]);
    held = -1;
    sum = warp_sum(sum);
    if (lane == 0) {
      // partial (b, ((l E + e) npairs + pair) 4 + warp)
      const int e = z % E, b = (z / E) % B, l = z / (E * B);
      const int k = i * (i + 1) / 2 + j;
      partial[(long long)b * row_len +
              (((long long)l * E + e) * items.npairs + k) * WARPS + warp] =
          (diag ? 1.f : 2.f) * sum;
    }
  }
}

int sm_count(int* sms) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  return err;
}

int npairs_of(int C) {
  const int nt = (C + TILE - 1) / TILE;
  return nt * (nt + 1) / 2;
}

template <int NBOX>
int launch(const CUtensorMap& ma, const CUtensorMap& mg, const float* mask,
           float* partial, float* out, int B, int E, int C, int row_len,
           const Items& items, cudaStream_t st) {
  int sms = 0;
  int err = sm_count(&sms);
  if (!err)
    err = hopper::allow_smem(moe_ghost_wgmma_kernel<NBOX>, Ring<NBOX>::SMEM);
  if (err) return err;
  const int pairs = (items.npairs * items.z + 1) / 2;   // two items a CTA
  moe_ghost_wgmma_kernel<NBOX>
      <<<pairs < sms ? pairs : sms, THREADS, Ring<NBOX>::SMEM, st>>>(
          ma, mg, mask, partial, B, E, C, row_len, items);
  err = (int)cudaGetLastError();
  if (err) return err;
  reduce_rows_kernel<<<B, 256, 0, st>>>(partial, out, row_len);
  return (int)cudaGetLastError();
}

}  // namespace

// Partials of one sample per (layer, expert): a warp's per tile pair.
extern "C" int dp_moe_ghost_norm_wgmma_nparts(int C) {
  return npairs_of(C) * WARPS;
}

// a (L,B,E,C,d), ds (L,B,E,C,p) contiguous bf16, 16-byte aligned, d and p
// multiples of 8 (the wrapper checks); mask (L,B,E,C) f32; partial
// (B, L * E * nparts(C)) f32 scratch; out (B,) f32.
extern "C" int dp_moe_ghost_norm_wgmma(const void* a, const float* mask,
                                       const void* ds, float* partial,
                                       float* out, int L, int B, int E,
                                       int C, int d, int p, void* stream) {
  if (d % 8 || p % 8 || L * B * E <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mg;
  const cuuint64_t Z = (cuuint64_t)L * B * E;
  const cuuint32_t box[3] = {BOX, TILE, 1};
  const cuuint64_t adims[3] = {(cuuint64_t)d, (cuuint64_t)C, Z};
  const cuuint64_t astr[2] = {(cuuint64_t)d * 2, (cuuint64_t)C * d * 2};
  const cuuint64_t gdims[3] = {(cuuint64_t)p, (cuuint64_t)C, Z};
  const cuuint64_t gstr[2] = {(cuuint64_t)p * 2, (cuuint64_t)C * p * 2};
  int err = hopper::make_map(&ma, a, 3, adims, astr, box);
  if (!err) err = hopper::make_map(&mg, ds, 3, gdims, gstr, box);
  if (err) return err;
  const Items items{npairs_of(C), L * B * E, (d + BOX - 1) / BOX,
                    (p + BOX - 1) / BOX};
  const int row_len = L * E * items.npairs * WARPS;
  cudaStream_t st = (cudaStream_t)stream;
  return C <= TILE ? launch<1>(ma, mg, mask, partial, out, B, E, C, row_len,
                               items, st)
                   : launch<2>(ma, mg, mask, partial, out, B, E, C, row_len,
                               items, st);
}
