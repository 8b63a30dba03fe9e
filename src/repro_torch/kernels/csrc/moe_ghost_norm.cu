// moe_ghost_norm: per-sample squared gradient norms of an MoE expert tap by
// the ghost trick over the per-(sample, expert) capacity layout, with no
// per-sample gradient and no Gram in device memory,
//
//     n_b = sum_{l,e} < am am^T , gm gm^T >_F      am = diag(m) a_lbe, etc.
//
//     a (L,B,E,C,d), mask m (L,B,E,C) f32, g (L,B,E,C,p) -> (B,) f32
//
// Replaces the TPU kernel repro/kernels/moe_ghost.py::moe_ghost_norm. The
// Pallas grid carries out[b] over sequential (l, e) steps; here one CTA owns
// one (l, b, e), forms both C x C Grams (over d and over p) tile pair by tile
// pair of 64 slots in registers, with the slot mask applied to each row as it
// is loaded, and writes one partial; a second pass sums each b's partials in
// a fixed order (no float atomics). At C = 60 there is one tile pair; a
// longer capacity walks the packed lower triangle of tile pairs in order.
// Ragged C, d and p edges are masked at load.
//
// Bound on the H100: about C^2 (d+p) operations per (l, b, e) against
// C (d+p) inputs, i.e. ~C/2 operations per input byte in bf16 — below the
// card's ~295 — so reading the records bounds it (1.49 GB at experts/up,
// L=5, B=8, E=64, C=60). f32 SIMT cores, the Gram tile code shared with
// ghost_norm.
#include "common.cuh"

namespace {

using gram::BK;
using gram::BT;
using gram::THREADS;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    moe_ghost_norm_kernel(const T* __restrict__ a,
                          const float* __restrict__ mask,
                          const T* __restrict__ g,
                          float* __restrict__ partial, int L, int B, int E,
                          int C, int d, int p) {
  __shared__ float si[BK][BT + 1];
  __shared__ float sj[BK][BT + 1];
  const int e = blockIdx.x, l = blockIdx.y, b = blockIdx.z;
  const long long slot0 = (((long long)l * B + b) * E + e) * C;
  const RowScale m{mask + slot0, 1.f};
  const int nt = (C + BT - 1) / BT;

  float s = 0.f;
  for (int i = 0; i < nt; ++i) {
    for (int j = 0; j <= i; ++j) {
      float ga[4][4] = {}, gg[4][4] = {};
      gram::tile<T>(ga, a + slot0 * d, i * BT, j * BT, C, d, m, si, sj);
      gram::tile<T>(gg, g + slot0 * p, i * BT, j * BT, C, p, m, si, sj);
      s += (i == j ? 1.f : 2.f) * gram::dot(ga, gg);
    }
  }
  s = block_sum(s);
  if (threadIdx.x == 0) partial[((long long)b * L + l) * E + e] = s;
}

}  // namespace

// a (L,B,E,C,d), ds (L,B,E,C,p) contiguous, both f32 (bf16 == 0) or bf16;
// mask (L,B,E,C) f32; partial (B, L * E) f32 scratch; out (B,) f32.
extern "C" int dp_moe_ghost_norm(const void* a, const float* mask,
                                 const void* ds, float* partial, float* out,
                                 int L, int B, int E, int C, int d, int p,
                                 int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(E, L, B);
  if (bf16)
    moe_ghost_norm_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (const __nv_bfloat16*)a, mask, (const __nv_bfloat16*)ds, partial, L,
        B, E, C, d, p);
  else
    moe_ghost_norm_kernel<float><<<grid, THREADS, 0, st>>>(
        (const float*)a, mask, (const float*)ds, partial, L, B, E, C, d, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<B, 256, 0, st>>>(partial, out, L * E);
  return (int)cudaGetLastError();
}
