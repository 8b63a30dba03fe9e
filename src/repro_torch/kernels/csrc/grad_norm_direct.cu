// grad_norm_direct: per-sample squared gradient norms of a matmul tap by
// instantiation, one (d,p) tile at a time, with no (B,d,p) per-sample
// gradient in device memory,
//
//     n_b = sum_l || a_lb^T g_lb ||_F^2      a (L,B,T,d), g (L,B,T,p) -> (B,)
//
// Replaces the TPU kernel repro/kernels/grad_norm_direct.py::grad_norm_direct.
// The Pallas grid carries out[b] across sequential grid steps; Hopper's blocks
// run in no order, so here one CTA owns one (b, l, 128x128 tile of d x p),
// loops over t inside the block, squares and sums its tile in registers and
// writes one partial; a second pass sums each b's partials in a fixed order
// (no float atomics: the norms are bitwise run to run). The ragged T, d and p
// edges are masked at load instead of padding copies.
//
// Bound on the H100: 2 L B T d p operations against L B T (d+p) inputs — at
// the long-sequence path (qwen2-1.5b qkv and o, B=2, T=2048) 1.26 TFLOP per
// step against 1.5 GB, so it is compute-bound. This first version runs on the
// f32 SIMT cores with an 8 x 8 register tile per thread (the tile code is
// shared with clipped_grad); tensor cores (wgmma) are later work.
#include "common.cuh"

namespace {

using atb::BK;
using atb::BM;
using atb::BN;
using atb::THREADS;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    grad_norm_direct_kernel(const T* __restrict__ a, const T* __restrict__ g,
                            float* __restrict__ partial, int L, int B, int Tn,
                            int d, int p, int ntile) {
  __shared__ float sa[BK][BM];
  __shared__ float sg[BK][BN];
  const int tile = blockIdx.x, l = blockIdx.y, b = blockIdx.z;
  const int np = (p + BN - 1) / BN;
  const int d0 = (tile / np) * BM, p0 = (tile % np) * BN;

  const long long row0 = ((long long)l * B + b) * Tn;
  float acc[8][8];
  atb::zero(acc);
  atb::accumulate<T>(acc, a + row0 * d, g + row0 * p, Tn, d, p, d0, p0,
                     RowScale{nullptr, 1.f}, sa, sg);
  const float s = block_sum(atb::sq_sum(acc));
  if (threadIdx.x == 0) partial[((long long)b * L + l) * ntile + tile] = s;
}

}  // namespace

extern "C" int dp_grad_norm_direct_nparts(int d, int p) {
  return atb::ntiles(d, p);
}

// a (L,B,T,d), ds (L,B,T,p) contiguous, both f32 (bf16 == 0) or bf16;
// partial (B, L * ntile) f32 scratch; out (B,) f32.
extern "C" int dp_grad_norm_direct(const void* a, const void* ds,
                                   float* partial, float* out, int L, int B,
                                   int T, int d, int p, int bf16,
                                   void* stream) {
  const int ntile = atb::ntiles(d, p);
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(ntile, L, B);
  if (bf16)
    grad_norm_direct_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)ds, partial, L, B, T,
        d, p, ntile);
  else
    grad_norm_direct_kernel<float><<<grid, THREADS, 0, st>>>(
        (const float*)a, (const float*)ds, partial, L, B, T, d, p, ntile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<B, 256, 0, st>>>(partial, out, L * ntile);
  return (int)cudaGetLastError();
}
