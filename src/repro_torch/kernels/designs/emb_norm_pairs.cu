// emb_ghost_norm as pairs of id-matching rows: the first version of the
// kernel (until csrc/emb_norm.cu took the run-sum form), kept so that the
// comparison can be run again
// (``python -m repro_torch.kernels.design_study --only emb_norm``). Not part
// of the kernel library.
//
//     n_b = sum_l sum_{t,t'} 1[id_lbt == id_lbt'] (g_lbt . g_lbt')
//
// A warp takes one t, finds the t' <= t with the same id by a ballot over 32
// ids at a time, and dots only the matching rows (x2 off the diagonal), with
// scalar loads and a shuffle reduction a pair: O(T^2 / 32) id loads a
// sample, and a row read once for every pair it is in. One CTA covers 32 t
// of one (l, b) and writes one partial; a second pass sums the partials of
// each b in a fixed order. No atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TCHUNK = 32;    // t values per CTA
constexpr int THREADS = 256;  // 8 warps, 4 t each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block, in thread 0; once a kernel.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_tot[32];
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) warp_tot[w] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += warp_tot[i];
  return s;
}

__global__ void reduce_rows_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, int n) {
  const float* row = part + (long long)blockIdx.x * n;
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s += row[i];
  s = block_sum(s);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    emb_norm_pairs_kernel(const int* __restrict__ ids,
                          const T* __restrict__ ds,
                          float* __restrict__ partial, int L, int B, int Tn,
                          int d, int nchunks) {
  const int chunk = blockIdx.x, l = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long row0 = ((long long)l * B + b) * Tn;
  const int* id = ids + row0;
  const T* g = ds + row0 * d;

  float acc = 0.f;  // identical in every lane of the warp
  for (int q = w; q < TCHUNK; q += THREADS / 32) {
    const int t = chunk * TCHUNK + q;
    if (t >= Tn) break;
    const int idt = id[t];
    const T* gt = g + (long long)t * d;
    for (int s0 = 0; s0 <= t; s0 += 32) {
      const int s = s0 + lane;
      unsigned hit = __ballot_sync(0xffffffffu, s <= t && id[s] == idt);
      while (hit) {
        const int sp = s0 + __ffs(hit) - 1;
        hit &= hit - 1;
        const T* gs = g + (long long)sp * d;
        float dot = 0.f;
        for (int c = lane; c < d; c += 32)
          dot = fmaf(to_f32(gt[c]), to_f32(gs[c]), dot);
        acc += (sp == t ? 1.f : 2.f) * warp_sum(dot);
      }
    }
  }
  // every lane holds the warp's total: count it once per warp
  const float s = block_sum(lane == 0 ? acc : 0.f);
  if (threadIdx.x == 0)
    partial[((long long)b * L + l) * nchunks + chunk] = s;
}

}  // namespace

extern "C" int dp_emb_norm_pairs_nparts(int T) {
  return (T + TCHUNK - 1) / TCHUNK;
}

// ids (L,B,T) int32, ds (L,B,T,d) f32 (bf16 == 0) or bf16, contiguous;
// partial (B, L * nchunks) f32 scratch; out (B,) f32.
extern "C" int dp_emb_norm_pairs(const int* ids, const void* ds,
                                 float* partial, float* out, int L, int B,
                                 int T, int d, int bf16, void* stream) {
  const int nch = dp_emb_norm_pairs_nparts(T);
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(nch, L, B);
  if (bf16)
    emb_norm_pairs_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        ids, (const __nv_bfloat16*)ds, partial, L, B, T, d, nch);
  else
    emb_norm_pairs_kernel<float><<<grid, THREADS, 0, st>>>(
        ids, (const float*)ds, partial, L, B, T, d, nch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<B, 256, 0, st>>>(partial, out, L * nch);
  return (int)cudaGetLastError();
}
