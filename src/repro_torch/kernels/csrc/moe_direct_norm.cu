// moe_direct_norm: per-sample squared gradient norms of an MoE expert tap by
// instantiation over the per-(sample, expert) capacity layout,
//
//     n_b = sum_{l,e} || a_lbe^T diag(m_lbe) g_lbe ||_F^2
//
//     a (L,B,E,C,d), mask m (L,B,E,C) f32, g (L,B,E,C,p) -> (B,) f32
//
// Replaces the TPU kernel repro/kernels/moe_ghost.py::moe_direct_norm. The
// Pallas grid carries out[b] over sequential (l, e, d-tile, p-tile) steps;
// here one CTA owns one (b, l, 128x128 tile of d x p) and loops over the E
// experts inside the block: C is short (60 slots at deepseek-moe-16b, B=8,
// T=512), so a CTA per (e, tile) would launch ~0.9 M blocks of 60 rows each.
// For each expert it forms the tile over the C slots with the slot mask
// applied to each row in registers, squares and sums it, and adds it to a
// running sum; it writes one partial, and a second pass sums each b's
// partials in a fixed order (no float atomics). Ragged C, d and p edges are
// masked at load.
//
// Bound on the H100: 2 L B E C d p operations against L B E C (d+p) inputs —
// 1.77 TFLOP against 1.5 GB for experts/up at that shape — so it is
// compute-bound. f32 SIMT cores, the tile code shared with clipped_grad;
// tensor cores are later work.
#include "common.cuh"

namespace {

using atb::BK;
using atb::BM;
using atb::BN;
using atb::THREADS;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    moe_direct_norm_kernel(const T* __restrict__ a,
                           const float* __restrict__ mask,
                           const T* __restrict__ g,
                           float* __restrict__ partial, int L, int B, int E,
                           int C, int d, int p, int ntile) {
  __shared__ float sa[BK][BM];
  __shared__ float sg[BK][BN];
  const int tile = blockIdx.x, l = blockIdx.y, b = blockIdx.z;
  const int np = (p + BN - 1) / BN;
  const int d0 = (tile / np) * BM, p0 = (tile % np) * BN;

  float s = 0.f, acc[8][8];
  for (int e = 0; e < E; ++e) {
    const long long slot0 = (((long long)l * B + b) * E + e) * C;
    atb::zero(acc);
    atb::accumulate<T>(acc, a + slot0 * d, g + slot0 * p, C, d, p, d0, p0,
                       RowScale{mask + slot0, 1.f}, sa, sg);
    s += atb::sq_sum(acc);
  }
  s = block_sum(s);
  if (threadIdx.x == 0) partial[((long long)b * L + l) * ntile + tile] = s;
}

}  // namespace

extern "C" int dp_moe_direct_norm_nparts(int d, int p) {
  return atb::ntiles(d, p);
}

// a (L,B,E,C,d), ds (L,B,E,C,p) contiguous, both f32 (bf16 == 0) or bf16;
// mask (L,B,E,C) f32; partial (B, L * ntile) f32 scratch; out (B,) f32.
extern "C" int dp_moe_direct_norm(const void* a, const float* mask,
                                  const void* ds, float* partial, float* out,
                                  int L, int B, int E, int C, int d, int p,
                                  int bf16, void* stream) {
  const int ntile = atb::ntiles(d, p);
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(ntile, L, B);
  if (bf16)
    moe_direct_norm_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (const __nv_bfloat16*)a, mask, (const __nv_bfloat16*)ds, partial, L,
        B, E, C, d, p, ntile);
  else
    moe_direct_norm_kernel<float><<<grid, THREADS, 0, st>>>(
        (const float*)a, mask, (const float*)ds, partial, L, B, E, C, d, p,
        ntile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<B, 256, 0, st>>>(partial, out, L * ntile);
  return (int)cudaGetLastError();
}
