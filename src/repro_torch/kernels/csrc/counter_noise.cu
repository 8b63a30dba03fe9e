// counter_noise: phase 4 of DP training, drawn and added in one pass,
//
//     out[i] = (g[i] + alpha * (sum_{key in hi} z(key, start + i)
//                               - sum_{key in lo} z(key, start + i))) / denom
//
//     g, out: one contiguous leaf, f32 (bf16 == 0) or bf16; out may be g
//
// with z the counter-based normal of counter_normal.cuh. One key (a plan of
// one HI key) is the Gaussian mechanism; the tree mechanism's increment
// N(t_hi) - N(t - 1) is two key lists, each the nodes whose index bit is set,
// summed in ascending level order, which travel as their key plan (each
// distinct key once, with its sides). The rounding points are the reference's
// (cn::noised). It is the kernel of the paths that materialize a noised tree
// (the baseline modes, core.policy.finalize_noise, and the mechanisms' direct
// calls); the BK train step draws the same noise inside its optimizer pass
// (noise_update.cu).
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
// SASS, 51 on the integer ALU pipe, which issues 64 results an SM a clock.
// Over qwen2-1.5b's 1.78 G noised bf16 elements that is ~5.4 ms at 1.98 GHz,
// above the bytes (~2.1 ms at 3.35 TB/s). The first version, one thread an
// element (designs/counter_noise_per_element.cu), took ~4x that: ndtri's
// tail branch, which 27% of lanes take, ran in nearly every warp. The
// design: the warp draw of counter_normal.cuh (cn::warp_xi: runs of 8
// elements a lane, counters stepped, the tail compacted per warp and
// evaluated 32 values a round); a run's g loaded as one 16-byte vector
// (bf16) or two float4 (f32) and its result stored likewise; the elements
// before the first 16-byte-aligned index and after the last whole run, one
// a thread (cn::xi_at, the same values); 256 threads a block, 3 blocks an SM
// (at most 80 registers), as many blocks as are resident, striding over
// the leaf; no sums across threads, so the result is bitwise the same run
// to run, and bitwise the first version's. On train's largest leaf it
// takes ~6.7 ms against the first version's ~9.3 (design_study --only
// noise, H100 80GB HBM3 at 700 W; PERF.md): threefry and the pass ~3.4, the
// central branch ~1.1, the compacted tail ~2.2, where uncompacted it costs
// ~5.6. The pass is bound by instruction issue: the division by a
// power-of-two denom as a product (cn::quotient) saves ~0.4 of it.
#include <cuda_bf16.h>

#include "counter_normal.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// blocks an SM holds at once, by the registers a thread may take
// (design_study --only noise times 2, 3 and 4: 3 was 8% faster than 2)
constexpr int MIN_BLOCKS = 3;

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    counter_noise_kernel(const T* g, T* out,
                         const __grid_constant__ cn::Keys keys, int n_keys,
                         unsigned long long start, uint32_t trail,
                         long long n, long long head, float alpha,
                         const cn::Denom denom) {
  constexpr bool BF16 = sizeof(T) == 2;
  __shared__ float queues[WARPS][cn::WARP_RUN];
  float* queue = queues[threadIdx.x / 32];
  const long long runs = (n - head) / cn::RUN;
  const long long warp = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const long long warps = (long long)gridDim.x * WARPS;
  // warp-uniform trip count: every lane draws (warp_xi's ballots); lanes
  // past the last run load and store nothing
  for (long long r0 = warp * 32; r0 < runs; r0 += warps * 32) {
    const long long r = r0 + (threadIdx.x & 31);
    const long long i = head + r * cn::RUN;
    const bool live = r < runs;
    float v[cn::RUN], xi[cn::RUN];
    if (live) cn::load_run(g + i, v);
    cn::warp_xi(keys, n_keys, start + (unsigned long long)i, trail, queue,
                xi);
    if (live) {
#pragma unroll
      for (int j = 0; j < cn::RUN; ++j)
        v[j] = cn::noised<BF16>(v[j], xi[j], alpha, denom);
      cn::store_run(out + i, v);
    }
  }
  // the elements outside the runs: [0, head) and the last (n - head) % RUN
  const long long rest = head + (n - head - runs * cn::RUN);
  for (long long k = (long long)blockIdx.x * THREADS + threadIdx.x; k < rest;
       k += (long long)gridDim.x * THREADS) {
    const long long i = k < head ? k : head + runs * cn::RUN + (k - head);
    const float xi =
        cn::xi_at(keys, n_keys, start + (unsigned long long)i, trail);
    cn::store_one(out, i, cn::noised<BF16>(cn::load_one(g, i), xi, alpha,
                                           denom));
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

template <typename T>
int launch(const void* g, void* out, const cn::Keys& k, int n_keys,
           unsigned long long start, uint32_t trail, long long n, float alpha,
           float denom, cudaStream_t st) {
  const void* ptrs[2] = {g, out};
  const int sizes[2] = {(int)sizeof(T), (int)sizeof(T)};
  const long long head = cn::aligned_head(ptrs, sizes, 2, n);
  const int blocks =
      cn::pass_blocks(counter_noise_kernel<T>, THREADS, n, head);
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  counter_noise_kernel<T><<<blocks, THREADS, 0, st>>>(
      (const T*)g, (T*)out, k, n_keys, start, trail, n, head, alpha,
      cn::denom_of(denom));
  return (int)cudaGetLastError();
}

}  // namespace

// g, out: n contiguous elements (f32, or bf16 when bf16 != 0; out may be g);
// the key plan on the host: keys, 2 * n_keys uint32, key j at keys[2j],
// keys[2j+1]; sides, n_keys bytes, key j's at sides[j] (1: its normal is
// added to the hi sum, 2: to the lo sum, 3: to both; xi = hi - lo); start:
// the leaf's first linear index in the whole tensor; trail: the span of
// counter word 0.
extern "C" int dp_counter_noise(const void* g, void* out,
                                const uint32_t* keys, const uint8_t* sides,
                                int n_keys, unsigned long long start,
                                unsigned long long trail, long long n,
                                float alpha, float denom, int bf16,
                                void* stream) {
  cn::Keys k = {};
  if (n <= 0 || trail == 0 || trail >= (1ULL << 32) ||
      !cn::read_plan(keys, sides, n_keys, k))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(g, out, k, n_keys, start,
                                      (uint32_t)trail, n, alpha, denom, st)
              : launch<float>(g, out, k, n_keys, start, (uint32_t)trail, n,
                              alpha, denom, st);
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
