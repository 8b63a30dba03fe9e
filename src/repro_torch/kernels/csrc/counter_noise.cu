// counter_noise: phase 4 of DP training, drawn and added in one pass,
//
//     out[i] = (g[i] + alpha * (sum_{j < n_hi} z(key_j, start + i)
//                               - sum_{j >= n_hi} z(key_j, start + i))) / denom
//
//     g, out: one contiguous leaf, f32 (bf16 == 0) or bf16; out may be g
//
// with z the counter-based normal of counter_normal.cuh. One key (n_hi = 1,
// n_lo = 0) is the Gaussian mechanism; the tree mechanism's increment
// N(t_hi) - N(t - 1) is two key lists, each the nodes whose index bit is set,
// summed in ascending level order (repro/core/noise.py::prefix_noise adds 0 z
// for the others, and every z here is finite, so skipping them is exact).
// The rounding points are the reference's: in f32 for f32 leaves; for bf16
// leaves xi is rounded to bf16, then the product, the sum and the quotient
// each (alpha and denom arrive rounded to bf16 by the wrapper), as
// g + (sigma * scale) * xi.astype(g.dtype) then / denom does.
//
// Replaces no TPU kernel: the JAX package draws this noise with jnp
// (repro/core/noise.py::counter_normal, then add_noise's arithmetic), and the
// port's first phase 4 chained a Philox randn, a multiply, an add and a
// divide over every parameter. Word 0 of the counter is (start + i) mod
// trail and word 1 its quotient (64-bit start: a window of a tensor past 2^32
// elements is drawn without the rest of it).
//
// Bound on the H100: per element 4 bytes at bf16, 8 at f32 (g read, out
// written), and one threefry2x32 block per key: 68 instructions in the
// SASS, 51 on the integer ALU pipe (20 funnel shifts, 21 LOP3, 10 IADD3;
// 17 adds go to the FMA pipe as IMAD.IADD), which issues 64 results an SM
// a clock. Over qwen2-1.5b's 1.78 G noised bf16 elements that is ~5.4 ms at
// 1.98 GHz, above the bytes (~2.1 ms at 3.35 TB/s). The kernel takes ~4x
// that: on the largest leaf (design_study --only noise, H100 80GB HBM3 at
// 700 W) ndtri's tail branch, which 27% of lanes take and nearly every warp
// runs, is 43% of its time. The design: one thread an element, 256 threads
// a block, grid-stride; the keys are kernel parameters (__grid_constant__,
// read from the constant bank by every thread, no local copy); no shared
// memory and no sums across threads, so the result is bitwise the same run
// to run.
#include <cuda_bf16.h>

#include "counter_normal.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 32;
constexpr int MAX_KEYS = 64;

struct Keys {
  uint32_t k[2 * MAX_KEYS];
};

__device__ __forceinline__ float load(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* p, long long i, float g,
                                      float xi, float alpha, float denom) {
  p[i] = __fdiv_rn(__fadd_rn(g, __fmul_rn(alpha, xi)), denom);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float g,
                                      float xi, float alpha, float denom) {
  const float t = bf16_round(__fmul_rn(alpha, bf16_round(xi)));
  const float s = bf16_round(__fadd_rn(g, t));
  p[i] = __float2bfloat16_rn(__fdiv_rn(s, denom));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    counter_noise_kernel(const T* g, T* out, const __grid_constant__ Keys keys,
                         int n_hi, int n_lo, unsigned long long start,
                         unsigned long long trail, long long n, float alpha,
                         float denom) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const unsigned long long c = start + (unsigned long long)i;
    uint32_t lo, hi;
    if (c < trail) {
      lo = (uint32_t)c;
      hi = 0u;
    } else {
      const unsigned long long q = c / trail;
      hi = (uint32_t)q;
      lo = (uint32_t)(c - q * trail);
    }
    float a = 0.f, b = 0.f;
    for (int j = 0; j < n_hi; ++j)
      a = __fadd_rn(a, cn::normal(keys.k[2 * j], keys.k[2 * j + 1], lo, hi));
    for (int j = n_hi; j < n_hi + n_lo; ++j)
      b = __fadd_rn(b, cn::normal(keys.k[2 * j], keys.k[2 * j + 1], lo, hi));
    store(out, i, load(g, i), __fsub_rn(a, b), alpha, denom);
  }
}

// The check entries' kernels: the same device functions on given inputs.
__global__ void __launch_bounds__(THREADS)
    threefry_bits_kernel(const uint32_t* __restrict__ in,
                         uint32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const cn::Bits y = cn::threefry2x32(in[4 * i], in[4 * i + 1], in[4 * i + 2],
                                      in[4 * i + 3]);
  out[2 * i] = y.x;
  out[2 * i + 1] = y.y;
}

__global__ void __launch_bounds__(THREADS)
    ndtri_kernel(const float* __restrict__ u, float* __restrict__ out,
                 long long n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < n) out[i] = cn::ndtri_f32(u[i]);
}

int blocks_for(long long n, long long cap) {
  const long long b = (n + THREADS - 1) / THREADS;
  return (int)(b < cap ? b : cap);
}

}  // namespace

// g, out: n contiguous elements (f32, or bf16 when bf16 != 0; out may be g);
// keys: 2 * (n_hi + n_lo) uint32 on the host, key j at keys[2j], keys[2j+1],
// the n_hi added first, then the n_lo subtracted; start: the leaf's first
// linear index in the whole tensor; trail: the span of counter word 0.
extern "C" int dp_counter_noise(const void* g, void* out,
                                const uint32_t* keys, int n_hi, int n_lo,
                                unsigned long long start,
                                unsigned long long trail, long long n,
                                float alpha, float denom, int bf16,
                                void* stream) {
  if (n <= 0 || n_hi < 0 || n_lo < 0 || n_hi + n_lo > MAX_KEYS || trail == 0)
    return (int)cudaErrorInvalidValue;
  Keys k = {};
  for (int j = 0; j < 2 * (n_hi + n_lo); ++j) k.k[j] = keys[j];
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = blocks_for(n, MAX_BLOCKS);
  if (bf16)
    counter_noise_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        (const __nv_bfloat16*)g, (__nv_bfloat16*)out, k, n_hi, n_lo, start,
        trail, n, alpha, denom);
  else
    counter_noise_kernel<float><<<blocks, THREADS, 0, st>>>(
        (const float*)g, (float*)out, k, n_hi, n_lo, start, trail, n, alpha,
        denom);
  return (int)cudaGetLastError();
}

// in (n, 4) uint32 rows (k0, k1, x0, x1) -> out (n, 2): threefry2x32 blocks.
extern "C" int dp_threefry_bits(const uint32_t* in, uint32_t* out,
                                long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  threefry_bits_kernel<<<blocks_for(n, 1LL << 30), THREADS, 0,
                         (cudaStream_t)stream>>>(in, out, n);
  return (int)cudaGetLastError();
}

// u (n,) f32 -> out (n,): ndtri_f32.
extern "C" int dp_ndtri_f32(const float* u, float* out, long long n,
                            void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  ndtri_kernel<<<blocks_for(n, 1LL << 30), THREADS, 0,
                 (cudaStream_t)stream>>>(u, out, n);
  return (int)cudaGetLastError();
}
