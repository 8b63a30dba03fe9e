// ghost_norm: per-sample squared gradient norms of a matmul tap without
// forming any per-sample gradient or any (T,T) Gram in device memory,
//
//     n_b = sum_l sum_{t,t'} (a_lbt . a_lbt') (g_lbt . g_lbt')
//
// Replaces the TPU kernel repro/kernels/ghost_norm.py::ghost_norm. The Pallas
// grid carries out[b] across sequential grid steps; Hopper's blocks run in no
// order, so here one CTA owns one (b, l, tile pair i >= j) of the packed lower
// triangle of (T,T) tiles, forms both 64x64 Gram tiles in registers (one over
// d, one over p), writes one partial (x2 off the diagonal), and a second pass
// sums the partials of each b in a fixed order. (i, j) is derived from the
// linear block index (there is no scalar prefetch), and the ragged T edge is
// masked at load time instead of padding copies.
//
// Bound on the H100: at the main path's shapes (T=512, d+p up to 153k) the
// Grams need ~T^2 (d+p) multiply-adds per (l, b) against T (d+p) input
// elements, so it is compute-bound on the bf16 tensor-core peak. This first
// version runs on the f32 SIMT cores (bf16 is widened to f32 on the way into
// shared memory); tensor cores (wgmma) are later work.
#include "common.cuh"

namespace {

constexpr int BT = 64;        // T tile (rows of a Gram tile)
constexpr int BK = 32;        // reduction chunk over d or p
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 Gram entries each

// acc[m][n] += sum_k X[ri0 + ty + 16m, k] * X[rj0 + tx + 16n, k] over k < K,
// with X row-major (Tn, K). Rows >= Tn read as zero.
template <typename T>
__device__ __forceinline__ void gram_tile(float acc[4][4],
                                          const T* __restrict__ x, int ri0,
                                          int rj0, int Tn, int K,
                                          float (*si)[BT + 1],
                                          float (*sj)[BT + 1]) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  for (int k0 = 0; k0 < K; k0 += BK) {
    // a warp reads 32 consecutive k of one row: coalesced; stored k-major
    // with a stride of 65 so the transposed stores hit 32 distinct banks
#pragma unroll
    for (int e = tid; e < BT * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK, k = k0 + kk;
      const int ri = ri0 + r, rj = rj0 + r;
      si[kk][r] = (ri < Tn && k < K) ? to_f32(x[(long long)ri * K + k]) : 0.f;
      sj[kk][r] = (rj < Tn && k < K) ? to_f32(x[(long long)rj * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float u[4], v[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) u[m] = si[kk][ty + 16 * m];
#pragma unroll
      for (int n = 0; n < 4; ++n) v[n] = sj[kk][tx + 16 * n];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(u[m], v[n], acc[m][n]);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ghost_norm_kernel(const T* __restrict__ a, const T* __restrict__ ds,
                      float* __restrict__ partial, int L, int B, int Tn, int d,
                      int p, int ntri) {
  __shared__ float si[BK][BT + 1];
  __shared__ float sj[BK][BT + 1];
  const int k = blockIdx.x, l = blockIdx.y, b = blockIdx.z;
  // packed lower triangle: k = i (i + 1) / 2 + j, j <= i
  int i = (int)((sqrtf(8.f * (float)k + 1.f) - 1.f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= k) ++i;
  while (i * (i + 1) / 2 > k) --i;
  const int j = k - i * (i + 1) / 2;

  const long long row0 = ((long long)l * B + b) * Tn;
  float ga[4][4], gg[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) ga[m][n] = gg[m][n] = 0.f;
  gram_tile<T>(ga, a + row0 * d, i * BT, j * BT, Tn, d, si, sj);
  gram_tile<T>(gg, ds + row0 * p, i * BT, j * BT, Tn, p, si, sj);

  float s = 0.f;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) s = fmaf(ga[m][n], gg[m][n], s);
  s = block_sum(s);
  if (threadIdx.x == 0)
    partial[((long long)b * L + l) * ntri + k] = (i == j ? 1.f : 2.f) * s;
}

}  // namespace

extern "C" int dp_ghost_norm_nparts(int T) {
  const int nt = (T + BT - 1) / BT;
  return nt * (nt + 1) / 2;
}

// a (L,B,T,d), ds (L,B,T,p) contiguous, both f32 (bf16 == 0) or bf16;
// partial (B, L * ntri) f32 scratch; out (B,) f32.
extern "C" int dp_ghost_norm(const void* a, const void* ds, float* partial,
                             float* out, int L, int B, int T, int d, int p,
                             int bf16, void* stream) {
  const int ntri = dp_ghost_norm_nparts(T);
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(ntri, L, B);
  if (bf16)
    ghost_norm_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)ds, partial, L, B, T,
        d, p, ntri);
  else
    ghost_norm_kernel<float><<<grid, THREADS, 0, st>>>(
        (const float*)a, (const float*)ds, partial, L, B, T, d, p, ntri);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<B, 256, 0, st>>>(partial, out, L * ntri);
  return (int)cudaGetLastError();
}
