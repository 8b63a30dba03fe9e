// clipped_grad on the tensor cores: the clip-weighted gradient of a matmul
// tap for bf16 records whose widths d and p are multiples of 8,
//
//     G_l = sum_b C_b a_lb^T g_lb          a (L,B,T,d), g (L,B,T,p) -> (L,d,p)
//
// Replaces the TPU kernel repro/kernels/clipped_grad.py::clipped_grad on the
// train paths (f32 records and unaligned widths keep clipped_grad.cu, the
// SIMT kernel). Bound on the H100: 2 L B T d p operations against L B T
// (d+p) bf16 inputs and L d p f32 outputs, about 12.6 TFLOP per qwen2-1.5b
// step at B=8, T=512, so it is compute-bound, and only wgmma reaches the
// bf16 rate; the SIMT kernel ran at 17 TFLOP/s.
//
// One CTA per SM walks output tiles (l, 128-row d tile, p tile of 128
// columns, or 192 on the wide taps) and reduces each over (b, t), t inner,
// as the Pallas grid's innermost B axis does. The product is D = A B with
// A = a^T (M = d, K = t) and B = g (K = t, N = p); both tiles arrive from
// TMA with t as their rows, so both are MN-major ("transposed") wgmma
// operands. A producer warpgroup (one thread issues; the warpgroup hands
// its registers to the consumers) keeps a ring of STAGES stages of 64
// t-rows (a: 64 x 128, g: 64 x BN, bf16, 128B swizzle) in flight, on
// across tiles, so the next tile's rows load while the last one is
// written; two consumer warpgroups each own 64 d rows x BN p columns and
// issue m64nBNk16 with f32 accumulators. The tensor maps are 3-D (width,
// T, L*B), so TMA zero-fills rows past T inside each b and columns past d
// or p: any T runs, and ragged edges add zero. Tiles are walked with the
// smaller operand's fastest, so that it stays in L2 while the larger one
// streams through once.
//
// C_b stays f32 and exact: a per-b accumulator collects b's T rows, then
// folds into the running total as total = fmaf(C_b, acc_b, total); no
// weighted copy of a or g exists and C is never rounded to bf16. The tile is
// written once, with no atomics and no split over (b, t): the sum runs in
// one fixed order, so the result is bitwise equal run to run.
#include "hopper.cuh"

namespace {

constexpr int BM = 128;        // d rows of a CTA tile (64 per warpgroup)
constexpr int BK = 64;         // t rows per stage
constexpr int STAGES = 4;
constexpr int WIDE = 8192;     // p from which a CTA tile is 192 columns wide
constexpr int BOX = 64;        // elements of one 128-byte swizzled row
constexpr int THREADS = 384;   // two consumer warpgroups + a producer's
constexpr int CONSUMER_WARPS = 8;
// registers a thread: the producer warpgroup gives up most of its share so
// that a consumer holds its two 64 x BN accumulators
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int BOX_BYTES = BK * hopper::ROW_BYTES;              // 8 KB
constexpr int KSTEP_BYTES = 16 * hopper::ROW_BYTES;   // 16 t rows per wgmma

// BN: p columns of a CTA tile, 128 or 192 (wide taps: fewer, larger tiles
// read each t row of a fewer times)
template <int BN>
struct Cfg {
  static constexpr int NACC = BN / 2;   // f32 registers of a 64 x BN tile
  static constexpr int STAGE_BYTES = (BM / BOX + BN / BOX) * BOX_BYTES;
  static constexpr size_t SMEM = STAGES * STAGE_BYTES +
                                 2 * STAGES * sizeof(uint64_t) +
                                 hopper::ATOM_BYTES;   // + alignment slack
};

// The output tiles in launch order: the tiles of the smaller operand vary
// fastest, so that it stays in L2 while the larger one streams through
// once (d_fast: the d tiles, a is the smaller); then the layer.
struct Tiles {
  int nd, np, L, d_fast, bn;
  __device__ __forceinline__ int count() const { return nd * np * L; }
  __device__ __forceinline__ void at(int t, int& l, int& d0, int& p0) const {
    const int nx = d_fast ? nd : np, ny = d_fast ? np : nd;
    const int x = t % nx, y = (t / nx) % ny;
    l = t / (nx * ny);
    d0 = (d_fast ? x : y) * BM;
    p0 = (d_fast ? y : x) * bn;
  }
};

// A persistent CTA walks output tiles blockIdx.x, + gridDim.x, ...; its
// ring of stages runs on across tiles, so the producer loads the next
// tile's rows while the consumers write the last one.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    clipped_grad_wgmma_kernel(const __grid_constant__ CUtensorMap ma,
                              const __grid_constant__ CUtensorMap mg,
                              const float* __restrict__ C,
                              float* __restrict__ out, int B, int T, int d,
                              int p, Tiles tiles) {
  constexpr int NACC = Cfg<BN>::NACC, STAGE_BYTES = Cfg<BN>::STAGE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_atom(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int wg = hopper::warpgroup(), lane = threadIdx.x % 32;
  const int nt = (T + BK - 1) / BK;   // t tiles of one sample

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full, tile after tile
    hopper::regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      int i = 0;
      for (int tile = blockIdx.x; tile < tiles.count(); tile += gridDim.x) {
        int l, d0, p0;
        tiles.at(tile, l, d0, p0);
        for (int k = 0; k < B * nt; ++k, ++i) {
          const int s = i % STAGES;
          hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
          uint8_t* st = smem + s * STAGE_BYTES;
          const int t0 = (k % nt) * BK, lb = l * B + k / nt;
          hopper::mbar_expect_tx(&full[s], STAGE_BYTES);
#pragma unroll
          for (int c = 0; c < BM / BOX; ++c)
            hopper::tma_load_3d(st + c * BOX_BYTES, &ma, &full[s],
                                d0 + c * BOX, t0, lb);
#pragma unroll
          for (int c = 0; c < BN / BOX; ++c)
            hopper::tma_load_3d(st + (BM / BOX + c) * BOX_BYTES, &mg,
                                &full[s], p0 + c * BOX, t0, lb);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns d rows d0 + 64 wg .. +63 of each tile
  hopper::regs_alloc<CONSUMER_REGS>();
  const int warp = threadIdx.x / 32;
  float acc[NACC], tot[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.f;

  int i = 0;
  for (int tile = blockIdx.x; tile < tiles.count(); tile += gridDim.x) {
    int l, d0, p0;
    tiles.at(tile, l, d0, p0);
#pragma unroll
    for (int j = 0; j < NACC; ++j) tot[j] = 0.f;
    // per sample: its t tiles with one stage's products kept in flight,
    // then all of them waited for and folded in with C_b (no wait sits in
    // a branch, so the wgmmas of consecutive stages overlap)
    for (int b = 0; b < B; ++b) {
      int held = -1;  // the stage whose wgmmas may still read it
      for (int tt = 0; tt < nt; ++tt, ++i) {
        const int s = i % STAGES;
        hopper::mbar_wait(&full[s], (i / STAGES) & 1);
        const uint8_t* st = smem + s * STAGE_BYTES;
        const uint8_t* sa = st + wg * BOX_BYTES;   // this warpgroup's 64 d
        const uint8_t* sg = st + (BM / BOX) * BOX_BYTES;   // the p boxes
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // the first product of a sample overwrites acc (scale_d = 0)
          hopper::mma_ss<1, 1>(
              acc,
              hopper::desc(sa + kk * KSTEP_BYTES, BOX_BYTES,
                           hopper::ATOM_BYTES),
              hopper::desc(sg + kk * KSTEP_BYTES, BOX_BYTES,
                           hopper::ATOM_BYTES),
              (tt > 0 || kk > 0) ? 1 : 0);
        }
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
      if (lane == 0) hopper::mbar_arrive(&empty[held]);
      const float c = C[b];
#pragma unroll
      for (int j = 0; j < NACC; ++j) tot[j] = fmaf(c, acc[j], tot[j]);
    }

    // epilogue: the f32 tile, once; rows past d and columns past p dropped
    float* o = out + (long long)l * d * p;
    const int r0 = d0 + 64 * wg + 16 * (warp % 4) + lane / 4;
    const int c0 = p0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < NACC / 4; ++j) {
      const int c = c0 + 8 * j;
      if (c >= p) continue;
      if (r0 < d)
        *reinterpret_cast<float2*>(o + (long long)r0 * p + c) =
            make_float2(tot[4 * j], tot[4 * j + 1]);
      if (r0 + 8 < d)
        *reinterpret_cast<float2*>(o + (long long)(r0 + 8) * p + c) =
            make_float2(tot[4 * j + 2], tot[4 * j + 3]);
    }
  }
}

template <int BN>
int launch(const CUtensorMap& ma, const CUtensorMap& mg, const float* C,
           float* out, int L, int B, int T, int d, int p, cudaStream_t st) {
  int dev = 0, sms = 0;
  int err = hopper::allow_smem(clipped_grad_wgmma_kernel<BN>, Cfg<BN>::SMEM);
  if (!err) err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err) return err;
  const Tiles tiles{(d + BM - 1) / BM, (p + BN - 1) / BN, L, d <= p, BN};
  const int n = tiles.nd * tiles.np * L;
  clipped_grad_wgmma_kernel<BN><<<n < sms ? n : sms, THREADS, Cfg<BN>::SMEM,
                                  st>>>(ma, mg, C, out, B, T, d, p, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// a (L,B,T,d), g (L,B,T,p) contiguous bf16, 16-byte aligned, d and p
// multiples of 8 (the wrapper checks); C (B,) f32; out (L,d,p) f32.
extern "C" int dp_clipped_grad_wgmma(const void* a, const float* C,
                                     const void* g, float* out, int L, int B,
                                     int T, int d, int p, void* stream) {
  if (d % 8 || p % 8) return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mg;
  const cuuint64_t LB = (cuuint64_t)L * B;
  const cuuint32_t box[3] = {BOX, BK, 1};
  const cuuint64_t adims[3] = {(cuuint64_t)d, (cuuint64_t)T, LB};
  const cuuint64_t astr[2] = {(cuuint64_t)d * 2, (cuuint64_t)T * d * 2};
  const cuuint64_t gdims[3] = {(cuuint64_t)p, (cuuint64_t)T, LB};
  const cuuint64_t gstr[2] = {(cuuint64_t)p * 2, (cuuint64_t)T * p * 2};
  int err = hopper::make_map(&ma, a, 3, adims, astr, box);
  if (!err) err = hopper::make_map(&mg, g, 3, gdims, gstr, box);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  return p >= WIDE ? launch<192>(ma, mg, C, out, L, B, T, d, p, st)
                   : launch<128>(ma, mg, C, out, L, B, T, d, p, st);
}
