// grad_norm_direct on the tensor cores: per-sample squared gradient norms
// of a matmul tap by instantiation, for bf16 records whose widths d and p
// are multiples of 8, with no (B,d,p) per-sample gradient in device memory,
//
//     n_b = sum_l || a_lb^T g_lb ||_F^2      a (L,B,T,d), g (L,B,T,p) -> (B,)
//
// Replaces the TPU kernel repro/kernels/grad_norm_direct.py::
// grad_norm_direct on the bf16 train paths (f32 records and unaligned
// widths keep grad_norm_direct.cu, the SIMT kernel). Bound on the H100:
// 2 L B T d p operations against L B T (d+p) bf16 inputs, 1.26 TFLOP
// against 1.53 GB at qwen2-1.5b's qkv and o taps of the long-sequence path
// (B=2, T=2048): 1.28 ms at the bf16 peak against 0.46 ms at 3.35 TB/s, so
// it is compute-bound and only wgmma reaches the bf16 rate; the SIMT kernel
// ran at ~25 TFLOP/s.
//
// It is moe_direct_norm_wgmma.cu's loop (wgmma_grad.cuh's direct_norm) as
// the case E = 1 with no mask: (l, b) is problem q = l B + b, at depth q of
// 3-D maps (width, T, L*B) whose TMA zero-fill past T inside each sample
// lets any T run; no slot-flag pre-pass, no mask warp, a ring of STAGES.
// One CTA per SM walks the items (q, a 128-wide d strip) and streams each
// item's p tiles of 128 columns through the ring; per p tile a consumer
// warpgroup runs its 64 x 128 product over all T rows in one f32
// accumulator (T / 16 k16 steps: 128 at T = 2048) and squares and sums it
// while the next tile's products run. Each warp writes one partial an
// item, and a second pass sums each b's partials in a fixed order (no
// float atomics): bitwise equal run to run.
#include "common.cuh"
#include "wgmma_grad.cuh"

namespace {

using namespace wgmma_grad;

constexpr int BN = 128;   // p columns of a tile (direct_norm's)
constexpr size_t SMEM = Cfg<BN>::SMEM;

__global__ void __launch_bounds__(THREADS, 1)
    dense_norm_wgmma_kernel(const __grid_constant__ CUtensorMap ma,
                            const __grid_constant__ CUtensorMap mg,
                            float* __restrict__ partial, int B, int T,
                            int np, int row_len, Tiles tiles) {
  direct_norm<false>(&ma, &mg, nullptr, nullptr, partial, B, 1, T, np,
                     row_len, tiles);
}

}  // namespace

// Partials of one sample per layer: a warp's per d strip.
extern "C" int dp_grad_norm_direct_wgmma_nparts(int d) {
  return (d + BM - 1) / BM * CONSUMER_WARPS;
}

// a (L,B,T,d), ds (L,B,T,p) contiguous bf16, 16-byte aligned, d and p
// multiples of 8 (the wrapper checks); partial (B, L * nparts(d)) f32
// scratch; out (B,) f32.
extern "C" int dp_grad_norm_direct_wgmma(const void* a, const void* ds,
                                         float* partial, float* out, int L,
                                         int B, int T, int d, int p,
                                         void* stream) {
  if (d % 8 || p % 8) return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mg;
  const cuuint64_t Z = (cuuint64_t)L * B;
  const cuuint32_t box[3] = {BOX, BK, 1};
  const cuuint64_t adims[3] = {(cuuint64_t)d, (cuuint64_t)T, Z};
  const cuuint64_t astr[2] = {(cuuint64_t)d * 2, (cuuint64_t)T * d * 2};
  const cuuint64_t gdims[3] = {(cuuint64_t)p, (cuuint64_t)T, Z};
  const cuuint64_t gstr[2] = {(cuuint64_t)p * 2, (cuuint64_t)T * p * 2};
  int err = hopper::make_map(&ma, a, 3, adims, astr, box);
  if (!err) err = hopper::make_map(&mg, ds, 3, gdims, gstr, box);
  if (err) return err;
  const int nd = (d + BM - 1) / BM, np = (p + BN - 1) / BN;
  const Tiles tiles{nd, 1, L * B, 1, BN};
  const int row_len = L * nd * CONSUMER_WARPS;
  int grid = 0;
  err = hopper::allow_smem(dense_norm_wgmma_kernel, SMEM);
  if (!err) err = persistent_grid(nd * L * B, &grid);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  dense_norm_wgmma_kernel<<<grid, THREADS, SMEM, st>>>(ma, mg, partial, B, T,
                                                       np, row_len, tiles);
  err = (int)cudaGetLastError();
  if (err) return err;
  reduce_rows_kernel<<<B, 256, 0, st>>>(partial, out, row_len);
  return (int)cudaGetLastError();
}
