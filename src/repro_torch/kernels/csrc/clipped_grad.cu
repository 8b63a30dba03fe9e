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
// B=8, T=512 — so it is compute-bound. This first version runs on the f32
// SIMT cores with an 8 x 8 register tile per thread; tensor cores (wgmma with
// TMA-fed operands) are later work.
#include "common.cuh"

namespace {

constexpr int BM = 128;       // d tile
constexpr int BN = 128;       // p tile
constexpr int BK = 16;        // rows of (b, t) per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each

template <typename T>
__global__ void __launch_bounds__(THREADS)
    clipped_grad_kernel(const T* __restrict__ a, const float* __restrict__ C,
                        const T* __restrict__ g, float* __restrict__ out,
                        int B, int Tn, int d, int p) {
  __shared__ float sa[BK][BM];
  __shared__ float sg[BK][BN];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int p0 = blockIdx.x * BN, d0 = blockIdx.y * BM, l = blockIdx.z;

  float acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = 0.f;

  for (int b = 0; b < B; ++b) {
    const float cb = C[b];
    const long long row0 = ((long long)l * B + b) * Tn;
    const T* ab = a + row0 * d;
    const T* gb = g + row0 * p;
    for (int t0 = 0; t0 < Tn; t0 += BK) {
      // consecutive threads take consecutive columns: coalesced reads,
      // conflict-free shared stores
#pragma unroll
      for (int e = tid; e < BK * BM; e += THREADS) {
        const int r = e / BM, c = e % BM, t = t0 + r;
        sa[r][c] = (t < Tn && d0 + c < d)
                       ? cb * to_f32(ab[(long long)t * d + d0 + c]) : 0.f;
        sg[r][c] = (t < Tn && p0 + c < p)
                       ? to_f32(gb[(long long)t * p + p0 + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float u[8], v[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) u[m] = sa[kk][ty + 16 * m];
#pragma unroll
        for (int n = 0; n < 8; ++n) v[n] = sg[kk][tx + 16 * n];
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
          for (int n = 0; n < 8; ++n) acc[m][n] = fmaf(u[m], v[n], acc[m][n]);
      }
      __syncthreads();
    }
  }

  float* o = out + (long long)l * d * p;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int r = d0 + ty + 16 * m;
    if (r >= d) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = p0 + tx + 16 * n;
      if (c < p) o[(long long)r * p + c] = acc[m][n];
    }
  }
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
