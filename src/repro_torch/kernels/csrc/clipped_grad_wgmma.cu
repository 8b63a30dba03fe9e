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
// The kernel body is wgmma_grad.cuh's mainloop at E = 1 with no mask (the
// MoE expert taps' kernel, moe_clipped_grad_wgmma.cu, is the same loop over
// (layer, expert) problems): one CTA per SM walks output tiles (l, 128-row
// d tile, p tile of 128 columns, or 192 on the wide taps) and reduces each
// over (b, t), t inner, as the Pallas grid's innermost B axis does; a
// producer warpgroup keeps a TMA ring of 64 t-rows in flight and two
// consumer warpgroups issue m64nBNk16 on MN-major operands. The tensor maps
// are 3-D (width, T, L*B), so TMA zero-fills rows past T inside each b and
// columns past d or p: any T runs, and ragged edges add zero. Tiles are
// walked with the smaller operand's fastest, so that it stays in L2 while
// the larger one streams through once.
//
// C_b stays f32 and exact: a per-b accumulator collects b's T rows, then
// folds into the running total as total = fmaf(C_b, acc_b, total); no
// weighted copy of a or g exists and C is never rounded to bf16. The tile is
// written once, with no atomics and no split over (b, t): the sum runs in
// one fixed order, so the result is bitwise equal run to run.
#include "wgmma_grad.cuh"

namespace {

using namespace wgmma_grad;

constexpr int WIDE = 8192;     // p from which a CTA tile is 192 columns wide

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    clipped_grad_wgmma_kernel(const __grid_constant__ CUtensorMap ma,
                              const __grid_constant__ CUtensorMap mg,
                              const float* __restrict__ C,
                              float* __restrict__ out, int B, int T, int d,
                              int p, Tiles tiles) {
  weighted_grad<BN, false>(&ma, &mg, nullptr, nullptr, C, nullptr, out, B,
                           1, T, d, p, tiles);
}

template <int BN>
int launch(const CUtensorMap& ma, const CUtensorMap& mg, const float* C,
           float* out, int L, int B, int T, int d, int p, cudaStream_t st) {
  int grid = 0;
  const Tiles tiles{(d + BM - 1) / BM, (p + BN - 1) / BN, L, d <= p, BN};
  int err = hopper::allow_smem(clipped_grad_wgmma_kernel<BN>,
                               Cfg<BN>::SMEM);
  if (!err) err = persistent_grid(tiles.nd * tiles.np * L, &grid);
  if (err) return err;
  clipped_grad_wgmma_kernel<BN><<<grid, THREADS, Cfg<BN>::SMEM, st>>>(
      ma, mg, C, out, B, T, d, p, tiles);
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
