// clipped_grad: the clip-weighted gradient of a matmul tap (BK Algorithm 1
// line 9),
//
//     G_l = sum_b C_b a_lb^T g_lb          a (L,B,T,d), g (L,B,T,p) -> (L,d,p)
//
// Replaces the TPU kernel repro/kernels/clipped_grad.py::clipped_grad. One
// CTA owns one (l, 128-row d tile, 128-column p tile) of the output and loops
// over b and t inside the block (the TPU's innermost B grid axis): each
// 16-row chunk of a is scaled by C_b in registers on its way into shared
// memory, so the (B,T,p) weighted copy never exists, and the tile is written
// once. No atomics: the sum over (b, t) runs in one fixed order.
//
// Bound on the H100: 2 L B T d p operations against (L B T (d+p)) inputs and
// L d p outputs — about 12.6 TFLOP per step summed over the five taps at
// B=8, T=512 — so it is compute-bound. This kernel runs on the f32 SIMT
// cores with an 8 x 8 register tile per thread; it serves f32 records and
// bf16 records with unaligned widths. bf16 records with d, p multiples of 8
// (every train path's taps) take clipped_grad_wgmma.cu (tensor cores).
#include "common.cuh"

namespace {

using atb::BK;
using atb::BM;
using atb::BN;
using atb::THREADS;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    clipped_grad_kernel(const T* __restrict__ a, const float* __restrict__ C,
                        const T* __restrict__ g, float* __restrict__ out,
                        int B, int Tn, int d, int p) {
  __shared__ float sa[BK][BM];
  __shared__ float sg[BK][BN];
  const int p0 = blockIdx.x * BN, d0 = blockIdx.y * BM, l = blockIdx.z;

  float acc[8][8];
  atb::zero(acc);
  for (int b = 0; b < B; ++b) {
    const long long row0 = ((long long)l * B + b) * Tn;
    atb::accumulate<T>(acc, a + row0 * d, g + row0 * p, Tn, d, p, d0, p0,
                       RowScale{nullptr, C[b]}, sa, sg);
  }
  atb::store(out + (long long)l * d * p, acc, d, p, d0, p0);
}

}  // namespace

// a (L,B,T,d), g (L,B,T,p) contiguous, both f32 (bf16 == 0) or bf16;
// C (B,) f32; out (L,d,p) f32.
extern "C" int dp_clipped_grad(const void* a, const float* C, const void* g,
                               float* out, int L, int B, int T, int d, int p,
                               int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((p + BN - 1) / BN, (d + BM - 1) / BM, L);
  if (bf16)
    clipped_grad_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (const __nv_bfloat16*)a, C, (const __nv_bfloat16*)g, out, B, T, d, p);
  else
    clipped_grad_kernel<float><<<grid, THREADS, 0, st>>>(
        (const float*)a, C, (const float*)g, out, B, T, d, p);
  return (int)cudaGetLastError();
}
