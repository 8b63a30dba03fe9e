// ghost_norm on the tensor cores: per-sample squared gradient norms of a
// matmul tap for bf16 records whose widths d and p are multiples of 8,
// without any per-sample gradient or any (T,T) Gram in device memory,
//
//     n_b = sum_l sum_{t,t'} (a_lbt . a_lbt') (g_lbt . g_lbt')
//
//     a (L,B,T,d), g (L,B,T,p) -> (B,) f32
//
// Replaces the TPU kernel repro/kernels/ghost_norm.py::ghost_norm (and its
// tri_table) on the train paths (f32 records and unaligned widths keep
// ghost_norm.cu, the SIMT kernel). Bound on the H100: 2 (d+p) L B T(T+1)/2
// operations against L B T (d+p) bf16 inputs, 2.48 TFLOP against 9.65 GB
// at qwen2-1.5b's five taps (B=8, T=512): 2.51 ms at the bf16 peak, 2.88 ms
// at 3.35 TB/s, so it sits on the ridge between the two, and only wgmma
// reaches the bf16 rate; the SIMT kernel ran at ~18 TFLOP/s.
//
// Work items are (l, b, tile pair i >= j of the packed lower triangle of
// 128-row tiles, p chunk), each the same length; one CTA per SM walks them,
// the pairs of one (l, b, chunk) adjacent so that concurrent CTAs share its
// row tiles in L2; (i, j) comes from the item index (no tri_table copy).
// Per item a consumer warpgroup owns 64 rows of tile i against the 128 rows
// of tile j and runs two Grams with m64n128k16, both operands K-major from
// shared memory (the reduction axis d or p is contiguous in the records, as
// in S = Q K^T of flash_attention_wgmma.cu): A_i A_j^T over d, then
// G_i G_j^T over the item's p chunk, each in pieces (the precision note
// below). The fragments of the two have the same layout, so
// sum (A_i A_j^T) . (G_i G_j^T) is a register-local fmaf; an off-diagonal
// item counts twice. A producer
// warpgroup (one thread issues; the warpgroup hands its registers to the
// consumers) keeps a ring of k64 stages in flight, on across items; a stage
// holds the A_i and A_j boxes (or G's), one box for a diagonal item, which
// is then both operands. The tensor maps are 3-D (width, T, L*B) over the
// records as they lie, so TMA zero-fills rows past T inside each sample and
// columns past d or p: a zero row adds nothing to either Gram.
//
// The split over p: the norm is linear in G G^T, so cutting p into s chunks
// (each item recomputing its d Gram: the head's d is 1% of its p) is exact.
// It exists for taps with too few items to fill the card (the head: L B
// pairs = 80 items against 132 SMs, each a 2,374-step k loop). The rule,
// host side: s (<= 64) minimises the launch's rounds times an item's
// steps, ceil(items s / SMs) (kd + ceil(kp / s)), the smallest s on a tie;
// every tap of L B >= SMs takes s = 1. The function is symmetric in a and g,
// so the wider of the two is the one split.
//
// Precision: bf16 x bf16 products are exact in f32, but the tensor cores'
// f32 accumulation loses bits as it adds, so an accumulator run over a
// long k loop drifts: with the head's 297-stage p chunks summed in one
// accumulator the norms came out 1.5e-4 from the plain version's. So a
// Gram is summed in pieces of PIECE stages (k = 512) on the tensor cores
// and the pieces in f32 on the CUDA cores (exact by linearity): the d
// Gram's pieces added into ga, each p piece's products with ga summed by
// fmaf into the item's sum; a piece waits for the warpgroup's products in
// flight (the other warpgroup's keep the tensor cores busy meanwhile).
// Against a float64 evaluation the head's norms are then within 2e-6,
// where the SIMT kernel's and the plain version's f32 sums over p = 151936
// are 7.3e-5 off: the NORM_TOL of 1e-4 against the plain version holds
// with that margin (chip_smoke.py prints all three errors). One
// accumulator a stage, folded while the next stage's products run, is as
// exact, but ptxas serialises its wgmmas (C7514): 1.5x slower at the head.
// repro_torch.kernels.design_study times those variants, and pieces of 4
// and 16 stages, beside this kernel.
//
// Each warp writes one partial an item, and a second pass sums each b's
// partials in a fixed order (no float atomics): bitwise equal run to run.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int TILE = 128;       // rows of a Gram tile (64 per consumer)
constexpr int BOX = 64;         // columns of a stage: one 128-byte row
constexpr int STAGES = 6;
constexpr int THREADS = 384;    // two consumer warpgroups + a producer's
constexpr int CONSUMER_WARPS = 8;
constexpr int MAX_SPLIT = 64;
constexpr int PIECE = 8;        // k64 stages a wgmma accumulator sums
// registers a thread: the producer warpgroup gives up most of its share so
// that a consumer holds its two 64 x 128 tiles (the d Gram and a piece's
// accumulator); the split adds up to
// the launch's 384 x 168 (setmaxnreg.inc waits for registers that are free,
// so a split above that would never start)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS == THREADS * 168,
              "the register split must add up to the launch's");
constexpr int BOX_BYTES = TILE * hopper::ROW_BYTES;   // 16 KB
constexpr int STAGE_BYTES = 2 * BOX_BYTES;
constexpr size_t SMEM = STAGES * STAGE_BYTES +
                        2 * STAGES * sizeof(uint64_t) +
                        hopper::ATOM_BYTES;           // + alignment slack
static_assert(SMEM <= 232448, "over the 227 KB a block may use");

// The work items in launch order: the pair fastest, then the p chunk, then
// z = l B + b. Chunk c covers k64 steps [c kp / s, (c+1) kp / s) of g.
struct Items {
  int npairs, split, z, kd, kp;
  __device__ __forceinline__ int count() const { return npairs * split * z; }
  __device__ __forceinline__ void at(int w, int& zz, int& c, int& i, int& j,
                                     int& g0, int& g1) const {
    const int k = w % npairs;
    c = (w / npairs) % split;
    zz = w / (npairs * split);
    // packed lower triangle: k = i (i + 1) / 2 + j, j <= i
    i = (int)((sqrtf(8.f * (float)k + 1.f) - 1.f) * 0.5f);
    while ((i + 1) * (i + 2) / 2 <= k) ++i;
    while (i * (i + 1) / 2 > k) --i;
    j = k - i * (i + 1) / 2;
    g0 = (int)((long long)c * kp / split);
    g1 = (int)((long long)(c + 1) * kp / split);
  }
};

__global__ void __launch_bounds__(THREADS, 1)
    ghost_norm_wgmma_kernel(const __grid_constant__ CUtensorMap ma,
                            const __grid_constant__ CUtensorMap mg,
                            float* __restrict__ partial, int B, int row_len,
                            Items items) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hopper::align_atom(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int wg = hopper::warpgroup(), lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread loads each item's d stages, then its p chunk's
    // (it counts stages over the CTA's items)
    hopper::regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      int it = 0;
      for (int w = blockIdx.x; w < items.count(); w += gridDim.x) {
        int z, c, i, j, g0, g1;
        items.at(w, z, c, i, j, g0, g1);
        const bool diag = i == j;
        const int n = items.kd + g1 - g0;
        for (int s = 0; s < n; ++s, ++it) {
          const int slot = it % STAGES;
          hopper::mbar_wait(&empty[slot], ((it / STAGES) & 1) ^ 1);
          const bool on_a = s < items.kd;
          const CUtensorMap* m = on_a ? &ma : &mg;
          const int col = (on_a ? s : g0 + s - items.kd) * BOX;
          uint8_t* st = ring + slot * STAGE_BYTES;
          hopper::mbar_expect_tx(&full[slot], diag ? BOX_BYTES : STAGE_BYTES);
          hopper::tma_load_3d(st, m, &full[slot], col, i * TILE, z);
          if (!diag)
            hopper::tma_load_3d(st + BOX_BYTES, m, &full[slot], col,
                                j * TILE, z);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. +63 of tile i of each item
  hopper::regs_alloc<CONSUMER_REGS>();
  const int warp = threadIdx.x / 32;
  float ga[64], gg[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) ga[q] = gg[q] = 0.f;
  int it = 0, held = -1;   // stage counter; the stage still being read

  // One stage's four k16 steps into acc (the first step of a piece, live
  // false, overwrites it), with the previous stage's products waited for
  // and its slot handed back.
  auto stage = [&](float(&acc)[64], bool live, bool diag) {
    const int slot = it % STAGES;
    hopper::mbar_wait(&full[slot], (it / STAGES) & 1);
    const uint8_t* st = ring + slot * STAGE_BYTES;
    const uint8_t* sa = st + 64 * wg * hopper::ROW_BYTES;
    const uint8_t* sb = st + (diag ? 0 : BOX_BYTES);
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
    if (lane == 0 && held >= 0) hopper::mbar_arrive(&empty[held]);
    held = slot;
    ++it;
  };

  // every product issued so far is done (the slot last read stays held)
  auto drain = [&]() {
    hopper::wgmma_wait<0>();
    hopper::fence_regs(ga);
    hopper::fence_regs(gg);
  };

  for (int w = blockIdx.x; w < items.count(); w += gridDim.x) {
    int z, c, i, j, g0, g1;
    items.at(w, z, c, i, j, g0, g1);
    const bool diag = i == j;
    const int kd = items.kd, n0 = kd < PIECE ? kd : PIECE;
    // the d Gram: its first piece into ga, each later one into gg and then
    // added to ga
    for (int s = 0; s < n0; ++s) stage(ga, s > 0, diag);
    for (int s0 = n0; s0 < kd; s0 += PIECE) {
      for (int s = s0; s < s0 + PIECE && s < kd; ++s)
        stage(gg, s > s0, diag);
      drain();
#pragma unroll
      for (int q = 0; q < 64; ++q) ga[q] += gg[q];
    }
    // the p Gram of the chunk, piece by piece into gg, each piece's
    // products with the d Gram summed
    float sum = 0.f;
    for (int s0 = g0; s0 < g1; s0 += PIECE) {
      for (int s = s0; s < s0 + PIECE && s < g1; ++s)
        stage(gg, s > s0, diag);
      drain();
#pragma unroll
      for (int q = 0; q < 64; ++q) sum = fmaf(ga[q], gg[q], sum);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[held]);
    held = -1;
    sum = warp_sum(sum);
    if (lane == 0) {
      // partial (b, ((l npairs + pair) split + chunk) 8 + warp)
      const int l = z / B, b = z % B, k = i * (i + 1) / 2 + j;
      partial[(long long)b * row_len +
              (((long long)l * items.npairs + k) * items.split + c) *
                  CONSUMER_WARPS +
              warp] = (diag ? 1.f : 2.f) * sum;
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

// The chunks p is cut into: the s <= MAX_SPLIT (and <= kp) that minimises
// ceil(items s / sms) (kd + ceil(kp / s)), the smallest on a tie. kd, kp:
// k64 steps of the narrower and the wider record.
int choose_split(long long items, int kd, int kp, int sms) {
  int best = 1;
  long long best_cost = -1;
  for (int s = 1; s <= MAX_SPLIT && s <= kp; ++s) {
    const long long rounds = (items * s + sms - 1) / sms;
    const long long cost = rounds * (kd + (kp + s - 1) / s);
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

int npairs_of(int T) {
  const int nt = (T + TILE - 1) / TILE;
  return nt * (nt + 1) / 2;
}

// -> the split of a launch (0 on an error): d, p in either order.
int split_of(int L, int B, int T, int d, int p) {
  int sms = 0;
  if (sm_count(&sms) || sms <= 0) return 0;
  const int narrow = d < p ? d : p, wide = d < p ? p : d;
  const int kd = (narrow + BOX - 1) / BOX, kp = (wide + BOX - 1) / BOX;
  return choose_split((long long)L * B * npairs_of(T), kd, kp, sms);
}

}  // namespace

// The p chunks a launch at these shapes cuts the wider record into.
extern "C" int dp_ghost_norm_wgmma_split(int L, int B, int T, int d, int p) {
  return split_of(L, B, T, d, p);
}

// Partials of one sample: a warp's per (layer, tile pair, p chunk).
extern "C" int dp_ghost_norm_wgmma_nparts(int L, int B, int T, int d,
                                          int p) {
  return L * npairs_of(T) * split_of(L, B, T, d, p) * CONSUMER_WARPS;
}

// a (L,B,T,d), ds (L,B,T,p) contiguous bf16, 16-byte aligned, d and p
// multiples of 8 (the wrapper checks); partial (B, nparts(L, B, T, d, p))
// f32 scratch; out (B,) f32.
extern "C" int dp_ghost_norm_wgmma(const void* a, const void* ds,
                                   float* partial, float* out, int L, int B,
                                   int T, int d, int p, void* stream) {
  if (d % 8 || p % 8) return (int)cudaErrorInvalidValue;
  const int split = split_of(L, B, T, d, p);
  int sms = 0;
  int err = sm_count(&sms);
  if (err) return err;
  if (!split) return (int)cudaErrorInvalidValue;
  if (d > p) {   // the function is symmetric: split the wider record
    const void* t = a;
    a = ds;
    ds = t;
    const int w = d;
    d = p;
    p = w;
  }
  CUtensorMap ma, mg;
  const cuuint64_t LB = (cuuint64_t)L * B;
  const cuuint32_t box[3] = {BOX, TILE, 1};
  const cuuint64_t adims[3] = {(cuuint64_t)d, (cuuint64_t)T, LB};
  const cuuint64_t astr[2] = {(cuuint64_t)d * 2, (cuuint64_t)T * d * 2};
  const cuuint64_t gdims[3] = {(cuuint64_t)p, (cuuint64_t)T, LB};
  const cuuint64_t gstr[2] = {(cuuint64_t)p * 2, (cuuint64_t)T * p * 2};
  err = hopper::make_map(&ma, a, 3, adims, astr, box);
  if (!err) err = hopper::make_map(&mg, ds, 3, gdims, gstr, box);
  if (!err) err = hopper::allow_smem(ghost_norm_wgmma_kernel, SMEM);
  if (err) return err;
  const Items items{npairs_of(T), split, L * B, (d + BOX - 1) / BOX,
                    (p + BOX - 1) / BOX};
  const int n = items.npairs * split * L * B;
  const int row_len = L * items.npairs * split * CONSUMER_WARPS;
  cudaStream_t st = (cudaStream_t)stream;
  ghost_norm_wgmma_kernel<<<n < sms ? n : sms, THREADS, SMEM, st>>>(
      ma, mg, partial, B, row_len, items);
  err = (int)cudaGetLastError();
  if (err) return err;
  reduce_rows_kernel<<<B, 256, 0, st>>>(partial, out, row_len);
  return (int)cudaGetLastError();
}
