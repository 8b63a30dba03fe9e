// The first version of fused_clip_grad (kept as the design that
// csrc/fused_clip.cu replaced, timed beside it by design_study --only fused):
// norm, clip and weighted gradient of a single-tap clip unit
// (scope='layer'),
//
//     g_b  = a_b^T ds_b                       per-sample gradient (L,d,p)
//     sq_b = ||g_b||_F^2
//     C_b  = clip(sqrt(sq_b)) * w_b           f32, never rounded
//     G    = sum_b C_b g_b                    a (L,B,T,d), ds (L,B,T,p)
//
// For each sample b, two launches on one stream:
//   1. tile kernel: one CTA per (128x128 tile of d x p, l) contracts t
//      (atb::accumulate, the tile code of clipped_grad), writes the g_b tile
//      to an f32 scratch of L*d*p (reused across samples) and one partial
//      of sq_b;
//   2. apply kernel: every CTA sums the partials in one fixed order (so all
//      agree on sq_b), forms C_b, and adds C_b * g_b into G, each element
//      owned by one thread.
// So 2B launches a call; each tile CTA walks all T rows of its sample
// serially on the f32 SIMT cores, and g_b streams through device memory (16
// bytes an element a sample: the scratch written and read, G read and
// written). G is zeroed by the caller.
#include "common.cuh"

namespace {

using atb::BK;
using atb::BM;
using atb::BN;
using atb::THREADS;

constexpr float EPS = 1e-12f;  // core/clipping.py _EPS
enum Clip { ABADI = 0, AUTOMATIC = 1, NORMALIZE = 2, FLAT = 3 };

template <typename T>
__global__ void __launch_bounds__(THREADS)
    two_launch_tile_kernel(const T* __restrict__ a, const T* __restrict__ g,
                           float* __restrict__ scratch,
                           float* __restrict__ partial, int b, int B, int Tn,
                           int d, int p, int ntile) {
  __shared__ float sa[BK][BM];
  __shared__ float sg[BK][BN];
  const int tile = blockIdx.x, l = blockIdx.y;
  const int np = (p + BN - 1) / BN;
  const int d0 = (tile / np) * BM, p0 = (tile % np) * BN;

  const long long row0 = ((long long)l * B + b) * Tn;
  float acc[8][8];
  atb::zero(acc);
  atb::accumulate<T>(acc, a + row0 * d, g + row0 * p, Tn, d, p, d0, p0,
                     RowScale{nullptr, 1.f}, sa, sg);
  atb::store(scratch + (long long)l * d * p, acc, d, p, d0, p0);
  const float s = block_sum(atb::sq_sum(acc));
  if (threadIdx.x == 0) partial[(long long)l * ntile + tile] = s;
}

__device__ __forceinline__ float clip_factor(float n, int clip, float R,
                                             float gamma) {
  switch (clip) {
    case ABADI: return fminf(R / (n + EPS), 1.f);
    case AUTOMATIC: return R / (n + gamma);
    case NORMALIZE: return R / (n + EPS);
    default: return n <= R ? 1.f : 0.f;  // FLAT
  }
}

__global__ void __launch_bounds__(256)
    two_launch_apply_kernel(const float* __restrict__ scratch,
                            const float* __restrict__ partial, int nparts,
                            const float* __restrict__ w,
                            float* __restrict__ G, float* __restrict__ sq,
                            int b, long long n, int clip, float R,
                            float gamma) {
  __shared__ float c_sh;
  float s = 0.f;
  for (int i = threadIdx.x; i < nparts; i += blockDim.x) s += partial[i];
  s = block_sum(s);
  if (threadIdx.x == 0) {
    c_sh = clip_factor(sqrtf(s), clip, R, gamma) * w[b];
    if (blockIdx.x == 0) sq[b] = s;
  }
  __syncthreads();
  const float c = c_sh;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n4 = n / 4;
  const float4* s4 = reinterpret_cast<const float4*>(scratch);
  float4* G4 = reinterpret_cast<float4*>(G);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const float4 x = s4[i];
    float4 y = G4[i];
    y.x += c * x.x;
    y.y += c * x.y;
    y.z += c * x.z;
    y.w += c * x.w;
    G4[i] = y;
  }
  for (long long i = 4 * n4 + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    G[i] += c * scratch[i];
}

}  // namespace

extern "C" int dp_fused_clip_two_launch_nparts(int d, int p) {
  return atb::ntiles(d, p);
}

// a (L,B,T,d), ds (L,B,T,p) contiguous, both f32 (bf16 == 0) or bf16;
// w (B,) f32; scratch (L,d,p) f32; partial (L * nparts) f32; G (L,d,p) f32,
// zeroed by the caller; sq (B,) f32. clip: 0 abadi, 1 automatic,
// 2 normalize, 3 flat. 2B launches on ``stream``.
extern "C" int dp_fused_clip_two_launch(const void* a, const void* ds,
                                        const float* w, float* scratch,
                                        float* partial, float* G, float* sq,
                                        int L, int B, int T, int d, int p,
                                        int bf16, int clip, float R,
                                        float gamma, void* stream) {
  const int ntile = atb::ntiles(d, p);
  const long long n = (long long)L * d * p;
  const long long blocks = (n / 4 + 255) / 256;
  const int apply_grid = (int)(blocks < 1 ? 1 : blocks > 2112 ? 2112 : blocks);
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(ntile, L);
  for (int b = 0; b < B; ++b) {
    if (bf16)
      two_launch_tile_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
          (const __nv_bfloat16*)a, (const __nv_bfloat16*)ds, scratch, partial,
          b, B, T, d, p, ntile);
    else
      two_launch_tile_kernel<float><<<grid, THREADS, 0, st>>>(
          (const float*)a, (const float*)ds, scratch, partial, b, B, T, d, p,
          ntile);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    two_launch_apply_kernel<<<apply_grid, 256, 0, st>>>(
        scratch, partial, L * ntile, w, G, sq, b, n, clip, R, gamma);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
