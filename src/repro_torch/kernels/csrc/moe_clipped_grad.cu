// moe_clipped_grad: the clip-weighted gradient of an MoE expert tap over the
// per-(sample, expert) capacity layout,
//
//     G_le = sum_b C_b a_lbe^T diag(m_lbe) g_lbe
//
//     a (L,B,E,C,d), mask m (L,B,E,C) f32, C (B,) f32, g (L,B,E,C,p)
//     -> (L,E,d,p) f32
//
// Replaces the TPU kernel repro/kernels/moe_ghost.py::moe_clipped_grad. One
// CTA owns one (l, e, 128x128 tile of d x p) of the output and loops over b
// and the C slots inside the block (the TPU's innermost B grid axis); each
// row of a is scaled by C_b * m in registers on its way into shared memory,
// so no masked or weighted copy exists, and every output tile is written
// once — zeros included, for an expert that no sample reached. No atomics:
// the sum over (b, slot) runs in one fixed order. Ragged C, d and p edges are
// masked at load.
//
// Bound on the H100: 2 L B E C d p operations against the inputs and an
// L E d p f32 output — at deepseek-moe-16b experts/up (L=5, B=8, E=64, C=60,
// d=2048, p=2816) 1.77 TFLOP against 8.9 GB, 7.4 GB of it the output write,
// so the bytes bound it. f32 SIMT cores, the tile code shared with
// clipped_grad; tensor cores are later work.
#include "common.cuh"

namespace {

using atb::BK;
using atb::BM;
using atb::BN;
using atb::THREADS;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    moe_clipped_grad_kernel(const T* __restrict__ a,
                            const float* __restrict__ mask,
                            const float* __restrict__ Cw,
                            const T* __restrict__ g, float* __restrict__ out,
                            int B, int E, int C, int d, int p) {
  __shared__ float sa[BK][BM];
  __shared__ float sg[BK][BN];
  const int tile = blockIdx.x, e = blockIdx.y, l = blockIdx.z;
  const int np = (p + BN - 1) / BN;
  const int d0 = (tile / np) * BM, p0 = (tile % np) * BN;

  float acc[8][8];
  atb::zero(acc);
  for (int b = 0; b < B; ++b) {
    const long long slot0 = (((long long)l * B + b) * E + e) * C;
    atb::accumulate<T>(acc, a + slot0 * d, g + slot0 * p, C, d, p, d0, p0,
                       RowScale{mask + slot0, Cw[b]}, sa, sg);
  }
  atb::store(out + ((long long)l * E + e) * d * p, acc, d, p, d0, p0);
}

}  // namespace

// a (L,B,E,C,d), ds (L,B,E,C,p) contiguous, both f32 (bf16 == 0) or bf16;
// mask (L,B,E,C) f32; Cw (B,) f32; out (L,E,d,p) f32.
extern "C" int dp_moe_clipped_grad(const void* a, const float* mask,
                                   const float* Cw, const void* ds,
                                   float* out, int L, int B, int E, int C,
                                   int d, int p, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(atb::ntiles(d, p), E, L);
  if (bf16)
    moe_clipped_grad_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (const __nv_bfloat16*)a, mask, Cw, (const __nv_bfloat16*)ds, out, B,
        E, C, d, p);
  else
    moe_clipped_grad_kernel<float><<<grid, THREADS, 0, st>>>(
        (const float*)a, mask, Cw, (const float*)ds, out, B, E, C, d, p);
  return (int)cudaGetLastError();
}
