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
// elements, on the ridge of the bf16 tensor-core peak (ghost_norm_wgmma.cu
// says more). This kernel runs on the f32 SIMT cores (bf16 is widened to f32
// on the way into shared memory), at ~18 TFLOP/s of the 67 f32 ones; it is
// the route of f32 records (every parity step) and of widths that are not
// multiples of 8. bf16 records with aligned widths take the tensor-core
// kernel, ghost_norm_wgmma.cu.
#include "common.cuh"

namespace {

using gram::BK;
using gram::BT;
using gram::THREADS;

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
  const RowScale one{nullptr, 1.f};
  float ga[4][4] = {}, gg[4][4] = {};
  gram::tile<T>(ga, a + row0 * d, i * BT, j * BT, Tn, d, one, si, sj);
  gram::tile<T>(gg, ds + row0 * p, i * BT, j * BT, Tn, p, one, si, sj);

  const float s = block_sum(gram::dot(ga, gg));
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
