// emb_clipped_grad: the clip-weighted gradient of an embedding lookup,
//
//     G_l[v] = sum_b C_b sum_t 1[id_lbt == v] g_lbt        -> (L, V, d) f32
//
// Replaces the TPU kernel repro/kernels/emb_grad.py::emb_clipped_grad. The
// Pallas kernel contracts a (T, bv) one-hot against the cotangents for every
// vocab tile; at V=151936 and B*T=4096 that would be ~1.9 PFLOP, so it is not
// carried over. Instead each CTA owns 128 vocab rows of one layer and stages
// that layer's B*T ids in shared memory. A warp takes one row, finds the
// (b, t) with that id by ballots in (b, t) order, and sums C_b g_bt for them
// across d in registers. Every output row is written exactly once (rows no
// id hits are written as zeros), the sum runs in (b, t) order, and there are
// no atomics. Ids outside [0, V) match no row and are dropped.
//
// Bound on the H100: the (L, V, d) f32 output write, ~0.93 GB per step at
// qwen2-1.5b's vocab.
#include "common.cuh"

namespace {

constexpr int ROWS = 128;     // vocab rows per CTA
constexpr int THREADS = 256;  // 8 warps, 16 rows each
constexpr int CAP = 64;       // matches a warp lists before it rescans
constexpr int PER_LANE = 8;   // d columns a lane carries per pass (x32)

template <typename T>
__device__ __forceinline__ void accumulate_row(
    float acc[PER_LANE], const T* __restrict__ g, const float* __restrict__ C,
    int k, int Tn, int d, int c0, int lane) {
  const float cb = C[k / Tn];
  const T* gk = g + (long long)k * d;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int c = c0 + lane + 32 * i;
    if (c < d) acc[i] = fmaf(cb, to_f32(gk[c]), acc[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    emb_grad_kernel(const int* __restrict__ ids, const float* __restrict__ C,
                    const T* __restrict__ ds, float* __restrict__ out, int B,
                    int Tn, int d, int V) {
  extern __shared__ int smem[];
  const int BT = B * Tn;
  int* sid = smem;                                  // (BT,) ids of layer l
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int* list = smem + BT + w * CAP;                  // this warp's matches
  const int l = blockIdx.y, v0 = blockIdx.x * ROWS;
  const int* idl = ids + (long long)l * BT;
  const T* g = ds + (long long)l * BT * d;

  for (int k = threadIdx.x; k < BT; k += THREADS) sid[k] = idl[k];
  __syncthreads();

  for (int r = w; r < ROWS; r += THREADS / 32) {
    const int v = v0 + r;
    if (v >= V) break;
    // ordered compaction of the matching k into this warp's list
    int n = 0;
    for (int k0 = 0; k0 < BT; k0 += 32) {
      const int k = k0 + lane;
      const bool m = k < BT && sid[k] == v;
      const unsigned hit = __ballot_sync(0xffffffffu, m);
      if (m) {
        const int pos = n + __popc(hit & ((1u << lane) - 1u));
        if (pos < CAP) list[pos] = k;
      }
      n += __popc(hit);
    }
    __syncwarp();
    float* orow = out + ((long long)l * V + v) * d;
    for (int c0 = 0; c0 < d; c0 += 32 * PER_LANE) {
      float acc[PER_LANE];
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) acc[i] = 0.f;
      if (n <= CAP) {
        for (int q = 0; q < n; ++q)
          accumulate_row<T>(acc, g, C, list[q], Tn, d, c0, lane);
      } else {
        // more matches than the list holds: rescan the ids in the same
        // (b, t) order, so the sum is bitwise the one the list would give
        for (int k0 = 0; k0 < BT; k0 += 32) {
          const int k = k0 + lane;
          unsigned hit = __ballot_sync(0xffffffffu, k < BT && sid[k] == v);
          while (hit) {
            const int kk = k0 + __ffs(hit) - 1;
            hit &= hit - 1;
            accumulate_row<T>(acc, g, C, kk, Tn, d, c0, lane);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const int c = c0 + lane + 32 * i;
        if (c < d) orow[c] = acc[i];
      }
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int dp_emb_grad_smem_bytes(int B, int T) {
  return (B * T + (THREADS / 32) * CAP) * (int)sizeof(int);
}

// ids (L,B,T) int32, C (B,) f32, ds (L,B,T,d) f32 (bf16 == 0) or bf16,
// contiguous; out (L,V,d) f32, every element written.
extern "C" int dp_emb_grad(const int* ids, const float* C, const void* ds,
                           float* out, int L, int B, int T, int d, int V,
                           int bf16, void* stream) {
  const int smem = dp_emb_grad_smem_bytes(B, T);
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((V + ROWS - 1) / ROWS, L);
  cudaError_t err;
  if (bf16) {
    err = cudaFuncSetAttribute(emb_grad_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    emb_grad_kernel<__nv_bfloat16><<<grid, THREADS, smem, st>>>(
        ids, C, (const __nv_bfloat16*)ds, out, B, T, d, V);
  } else {
    err = cudaFuncSetAttribute(emb_grad_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    emb_grad_kernel<float><<<grid, THREADS, smem, st>>>(
        ids, C, (const float*)ds, out, B, T, d, V);
  }
  return (int)cudaGetLastError();
}
