// noise_update: phase 4 and the optimizer step of one leaf in one pass,
//
//     gn = (g + alpha * xi) / denom        (noise != 0; else gn = g)
//     AdamW:  m = b1 m + (1 - b1) gn,  v = b2 v + (1 - b2) gn^2,
//             p = p - lr ((m / bc1) / (sqrt(v / bc2) + eps) + wd p)
//     SGD:    m = momentum m + gn,     p = p - lr (m + wd p)
//
//     g: the leaf's clipped sum (f32 or bf16), m, v: f32 state, p: the
//     parameter (f32 or bf16); m, v and p written in place
//
// with xi the phase-4 draw of counter_noise.cu (the same keys, counters and
// sums: cn::warp_xi) and gn the noised gradient at the reference's rounding
// points in g's dtype (cn::noised), then widened to f32; the step in f32, p
// rounded to its dtype, as repro/optim/optimizers.py's adamw (:76-101) and
// sgd (:57-72) do. Without noise (frozen leaves, sigma = 0 after the
// mechanism's own g / denom, the baseline modes' materialized trees) the
// leaf is taken as given.
//
// Replaces no TPU kernel: the JAX package writes the noise and the update in
// jnp (repro/core/noise.py::counter_normal, repro/optim/optimizers.py), which
// XLA fuses into a few passes; the port's first phase 4 ran counter_noise
// over the leaf, then ~14 torch passes of the update (its plain version,
// kernels/noise_update.py).
//
// Bound on the H100: bytes. AdamW over a bf16 leaf reads g 2, m 4, v 4 and
// p 2 bytes an element and writes m, v and p (10): 22 bytes, 11.67 ms over
// qwen2-1.5b's 1.78 G elements at 3.35 TB/s; SGD 14 bytes; f32 g and p 28
// (AdamW). The draw's integer work (~5.4 ms for those elements, 51 ALU-pipe
// instructions a threefry2x32 block) issues beside the bytes. The design:
// counter_noise.cu's pass (runs of 8 elements a lane, g and p as one 16-byte
// vector each in bf16, m and v as two float4 each, the draw compacted per
// warp); a run's operands loaded after its draw, so that the kernel takes 78
// registers, 3 blocks an SM are resident, and the other warps' draws cover
// the loads' latency (loaded before the draw, design_study's loads_first,
// they hold ~30 registers through it: 101, 2 blocks an SM); the elements
// outside the runs one a thread; as many blocks as are resident; no shared
// memory beyond the draw's warp queues and no sums across threads, so the
// result is bitwise the same run to run, and its draws bitwise
// counter_noise's.
#include <cuda_bf16.h>

#include "counter_normal.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// blocks an SM holds at once, by the registers a thread may take: 3, as
// counter_noise.cu (design_study --only noise builds 2, 3 and 4; the
// kernel takes 78 registers under both 2 and 3, so both hold 3 blocks an
// SM, and their times differ by no more than run to run)
constexpr int MIN_BLOCKS = 3;

// the step's scalars, in f32 (host-rounded once)
struct Hyper {
  float alpha, denom;        // the noise (unused without it)
  float lr, b1, omb1, b2, omb2, eps, bc1, bc2, wd;   // SGD: b1 = momentum
};

// One element's update from its noised gradient (f32) -> m, v, p in place.
template <bool ADAMW>
__device__ __forceinline__ void step(float gn, float& m, float& v, float& p,
                                     const Hyper& h) {
  float upd;
  if (ADAMW) {
    m = __fmaf_rn(h.omb1, gn, __fmul_rn(h.b1, m));
    v = __fmaf_rn(h.omb2, __fmul_rn(gn, gn), __fmul_rn(h.b2, v));
    upd = __fdiv_rn(__fdiv_rn(m, h.bc1),
                    __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps));
  } else {
    m = __fadd_rn(__fmul_rn(h.b1, m), gn);
    upd = m;
  }
  if (h.wd != 0.f) upd = __fmaf_rn(h.wd, p, upd);
  p = __fmaf_rn(-h.lr, upd, p);
}

template <typename G, typename P, bool ADAMW>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    noise_update_kernel(const G* g, P* p, float* m, float* v,
                        const __grid_constant__ cn::Keys keys, int n_hi,
                        int n_lo, int noise, unsigned long long start,
                        uint32_t trail, long long n, long long head,
                        const Hyper h) {
  constexpr bool G_BF16 = sizeof(G) == 2;
  __shared__ float queues[WARPS][cn::WARP_RUN];
  float* queue = queues[threadIdx.x / 32];
  const long long runs = (n - head) / cn::RUN;
  const long long warp = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const long long warps = (long long)gridDim.x * WARPS;
  // warp-uniform trip count and noise flag: every lane draws together. A
  // run's operands are loaded after its draw, so that they do not hold
  // registers through it (the resident warps' draws hide their latency)
  for (long long r0 = warp * 32; r0 < runs; r0 += warps * 32) {
    const long long r = r0 + (threadIdx.x & 31);
    const long long i = head + r * cn::RUN;
    float xi[cn::RUN];
    if (noise)
      cn::warp_xi(keys, n_hi, n_lo, start + (unsigned long long)i, trail,
                  queue, xi);
    if (r < runs) {
      float gv[cn::RUN], mv[cn::RUN], vv[cn::RUN], pv[cn::RUN];
      cn::load_run(g + i, gv);
      cn::load_run(m + i, mv);
      if (ADAMW) cn::load_run(v + i, vv);
      cn::load_run(p + i, pv);
#pragma unroll
      for (int j = 0; j < cn::RUN; ++j) {
        const float gn =
            noise ? cn::noised<G_BF16>(gv[j], xi[j], h.alpha, h.denom)
                  : gv[j];
        step<ADAMW>(gn, mv[j], vv[j], pv[j], h);
      }
      cn::store_run(m + i, mv);
      if (ADAMW) cn::store_run(v + i, vv);
      cn::store_run(p + i, pv);
    }
  }
  // the elements outside the runs: [0, head) and the last (n - head) % RUN
  const long long rest = head + (n - head - runs * cn::RUN);
  for (long long k = (long long)blockIdx.x * THREADS + threadIdx.x; k < rest;
       k += (long long)gridDim.x * THREADS) {
    const long long i = k < head ? k : head + runs * cn::RUN + (k - head);
    float gn = cn::load_one(g, i);
    if (noise)
      gn = cn::noised<G_BF16>(
          gn, cn::xi_at(keys, n_hi, n_lo, start + (unsigned long long)i,
                        trail),
          h.alpha, h.denom);
    float mi = m[i], vi = ADAMW ? v[i] : 0.f, pi = cn::load_one(p, i);
    step<ADAMW>(gn, mi, vi, pi, h);
    m[i] = mi;
    if (ADAMW) v[i] = vi;
    cn::store_one(p, i, pi);
  }
}

template <typename G, typename P, bool ADAMW>
int launch(const void* g, void* p, float* m, float* v, const cn::Keys& k,
           int n_hi, int n_lo, int noise, unsigned long long start,
           uint32_t trail, long long n, const Hyper& h, cudaStream_t st) {
  const void* ptrs[4] = {g, p, m, ADAMW ? v : m};
  const int sizes[4] = {(int)sizeof(G), (int)sizeof(P), 4, 4};
  const long long head = cn::aligned_head(ptrs, sizes, 4, n);
  const int blocks =
      cn::pass_blocks(noise_update_kernel<G, P, ADAMW>, THREADS, n, head);
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  noise_update_kernel<G, P, ADAMW><<<blocks, THREADS, 0, st>>>(
      (const G*)g, (P*)p, m, v, k, n_hi, n_lo, noise, start, trail, n, head,
      h);
  return (int)cudaGetLastError();
}

template <typename G, typename P>
int launch_opt(int adamw, const void* g, void* p, float* m, float* v,
               const cn::Keys& k, int n_hi, int n_lo, int noise,
               unsigned long long start, uint32_t trail, long long n,
               const Hyper& h, cudaStream_t st) {
  return adamw ? launch<G, P, true>(g, p, m, v, k, n_hi, n_lo, noise, start,
                                    trail, n, h, st)
               : launch<G, P, false>(g, p, m, v, k, n_hi, n_lo, noise, start,
                                     trail, n, h, st);
}

}  // namespace

// g: n contiguous elements of the leaf's clipped sum (bf16 when g_bf16,
// else f32); p: the parameter, n elements (bf16 when p_bf16, else f32); m,
// v: f32 state (v unused by SGD); keys, n_hi, n_lo, start, trail: as
// dp_counter_noise takes them, read when noise != 0; adamw: 1 AdamW, 0 SGD;
// hyper: 11 floats on the host, alpha, denom, lr, b1 (SGD: momentum),
// 1 - b1, b2, 1 - b2, eps, bc1, bc2, weight decay.
extern "C" int dp_noise_update(const void* g, void* p, float* m, float* v,
                               const uint32_t* keys, int n_hi, int n_lo,
                               int noise, unsigned long long start,
                               unsigned long long trail, long long n,
                               int g_bf16, int p_bf16, int adamw,
                               const float* hyper, void* stream) {
  if (n <= 0 || n_hi < 0 || n_lo < 0 || n_hi + n_lo > cn::MAX_KEYS ||
      (noise && (trail == 0 || trail >= (1ULL << 32))) ||
      (adamw && v == nullptr))
    return (int)cudaErrorInvalidValue;
  cn::Keys k = {};
  if (noise)
    for (int j = 0; j < 2 * (n_hi + n_lo); ++j) k.k[j] = keys[j];
  const Hyper h = {hyper[0], hyper[1], hyper[2], hyper[3],
                   hyper[4], hyper[5], hyper[6], hyper[7],
                   hyper[8], hyper[9], hyper[10]};
  const uint32_t tr = (uint32_t)trail;
  cudaStream_t st = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
  if (g_bf16)
    return p_bf16 ? launch_opt<bf, bf>(adamw, g, p, m, v, k, n_hi, n_lo,
                                       noise, start, tr, n, h, st)
                  : launch_opt<bf, float>(adamw, g, p, m, v, k, n_hi, n_lo,
                                          noise, start, tr, n, h, st);
  return p_bf16 ? launch_opt<float, bf>(adamw, g, p, m, v, k, n_hi, n_lo,
                                        noise, start, tr, n, h, st)
                : launch_opt<float, float>(adamw, g, p, m, v, k, n_hi, n_lo,
                                           noise, start, tr, n, h, st);
}
