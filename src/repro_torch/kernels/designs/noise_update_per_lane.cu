// noise_update, the first version (with its FTRL branch), kept as a
// design: csrc/noise_update.cu replaced it. design_study --only noise builds
// it beside the kept kernel, holds the kept kernel's p and state bitwise to
// it (AdamW, SGD, FTRL ordinary and restart; bf16 and f32; a ragged n, an
// unaligned head) and times both.
//
// The same function as the kept kernel: phase 4's draw (the hi keys' normals
// summed, minus the lo keys'), then adamw / sgd / DP-FTRL, at the same
// rounding points. The design: runs of 8 elements a lane, 32 runs a warp;
// each run drawn first (counter_normal.cuh's warp_normals, ndtri's tail
// compacted per warp), then its operands loaded from device memory, so that
// they hold no registers through the draw (78 registers, 3 blocks an SM);
// the other resident warps' draws were to cover the loads' latency. On the
// H100 it took 10.21 ms on train's up leaf against 5.98 without the draw
// and 7.106 for the draw alone (PERF.md), read then as the draw and the
// loads taking turns; staging the loads showed the pass bound by
// instruction issue instead. Its keys are the two lists (n_hi added, then
// n_lo subtracted), each key drawn once for each list it is in
// (warp_xi_lists, xi_at_lists below: the header's warp_xi and xi_at as
// they were).
#include <cuda_bf16.h>

#include "counter_normal.cuh"

namespace {

// xi at one linear index from the two lists: the hi keys' normals summed in
// order from 0 in f32, minus the lo keys' likewise
__device__ __forceinline__ float xi_at_lists(const cn::Keys& keys, int n_hi,
                                             int n_lo, unsigned long long c,
                                             uint32_t trail) {
  uint32_t lo, hi;
  cn::split(c, trail, lo, hi);
  float a = 0.f, b = 0.f;
  for (int j = 0; j < n_hi; ++j)
    a = __fadd_rn(a, cn::normal(keys.k[2 * j], keys.k[2 * j + 1], lo, hi));
  for (int j = n_hi; j < n_hi + n_lo; ++j)
    b = __fadd_rn(b, cn::normal(keys.k[2 * j], keys.k[2 * j + 1], lo, hi));
  return __fsub_rn(a, b);
}

// xi at a lane's RUN consecutive linear indices from c (the warp's 32
// lanes together): xi_at_lists's sums, each key drawn by warp_normals
__device__ __forceinline__ void warp_xi_lists(const cn::Keys& keys, int n_hi,
                                              int n_lo, unsigned long long c,
                                              uint32_t trail, float* queue,
                                              float (&xi)[cn::RUN]) {
  uint32_t lo, hi;
  cn::split(c, trail, lo, hi);
  float a[cn::RUN], b[cn::RUN], z[cn::RUN];
#pragma unroll
  for (int j = 0; j < cn::RUN; ++j) a[j] = b[j] = 0.f;
  for (int k = 0; k < n_hi; ++k) {
    cn::warp_normals(keys.k[2 * k], keys.k[2 * k + 1], lo, hi, trail, queue,
                     z);
#pragma unroll
    for (int j = 0; j < cn::RUN; ++j) a[j] = __fadd_rn(a[j], z[j]);
  }
  for (int k = n_hi; k < n_hi + n_lo; ++k) {
    cn::warp_normals(keys.k[2 * k], keys.k[2 * k + 1], lo, hi, trail, queue,
                     z);
#pragma unroll
    for (int j = 0; j < cn::RUN; ++j) b[j] = __fadd_rn(b[j], z[j]);
  }
#pragma unroll
  for (int j = 0; j < cn::RUN; ++j) xi[j] = __fsub_rn(a[j], b[j]);
}

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// blocks an SM holds at once, by the registers a thread may take: 3, as
// counter_noise.cu (design_study --only noise builds 2, 3 and 4; the
// kernel takes 78 registers under both 2 and 3, so both hold 3 blocks an
// SM, and their times differ by no more than run to run)
constexpr int MIN_BLOCKS = 3;

// the optimizers (the C entry's ``opt``)
constexpr int SGD = 0, ADAMW = 1, FTRL = 2;

// the step's scalars, in f32 (host-rounded once). SGD: b1 = momentum.
// FTRL: b1 = momentum x keep, omb1 = keep (0 on a restart step, else 1).
struct Hyper {
  float alpha, denom;        // the noise (unused without it)
  float lr, b1, omb1, b2, omb2, eps, bc1, bc2, wd;
};

// One element's update from its noised gradient (f32) -> m, v, p in place.
// FTRL: m holds s, v holds m, and p comes in as the anchor t0.
template <int OPT>
__device__ __forceinline__ void step(float gn, float& m, float& v, float& p,
                                     const Hyper& h) {
  if (OPT == FTRL) {
    m = __fadd_rn(__fmul_rn(h.omb1, m), gn);
    v = __fadd_rn(__fmul_rn(h.b1, v), m);
    p = __fmaf_rn(-h.lr, v, p);
    return;
  }
  float upd;
  if (OPT == ADAMW) {
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

template <typename G, typename P, int OPT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    noise_update_kernel(const G* g, P* p, float* m, float* v, float* t0,
                        const __grid_constant__ cn::Keys keys, int n_hi,
                        int n_lo, int noise, unsigned long long start,
                        uint32_t trail, long long n, long long head,
                        const Hyper h) {
  constexpr bool G_BF16 = sizeof(G) == 2;
  constexpr bool TWO = OPT != SGD;      // a second state: AdamW v, FTRL m
  // FTRL reads p only on a restart step (it becomes the anchor, written to
  // t0), and the anchor t0 only on the others
  const bool restart = OPT == FTRL && h.omb1 == 0.f;
  const bool from_t0 = OPT == FTRL && !restart;
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
      warp_xi_lists(keys, n_hi, n_lo, start + (unsigned long long)i,
                    trail, queue, xi);
    if (r < runs) {
      float gv[cn::RUN], mv[cn::RUN], vv[cn::RUN], pv[cn::RUN];
      cn::load_run(g + i, gv);
      cn::load_run(m + i, mv);
      if (TWO) cn::load_run(v + i, vv);
      if (from_t0)
        cn::load_run(t0 + i, pv);
      else
        cn::load_run(p + i, pv);
      if (restart) cn::store_run(t0 + i, pv);
#pragma unroll
      for (int j = 0; j < cn::RUN; ++j) {
        const float gn =
            noise ? cn::noised<G_BF16>(gv[j], xi[j], h.alpha, h.denom)
                  : gv[j];
        step<OPT>(gn, mv[j], vv[j], pv[j], h);
      }
      cn::store_run(m + i, mv);
      if (TWO) cn::store_run(v + i, vv);
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
          gn, xi_at_lists(keys, n_hi, n_lo,
                              start + (unsigned long long)i, trail),
          h.alpha, h.denom);
    float mi = m[i], vi = TWO ? v[i] : 0.f;
    float pi = from_t0 ? t0[i] : cn::load_one(p, i);
    if (restart) t0[i] = pi;
    step<OPT>(gn, mi, vi, pi, h);
    m[i] = mi;
    if (TWO) v[i] = vi;
    cn::store_one(p, i, pi);
  }
}

template <typename G, typename P, int OPT>
int launch(const void* g, void* p, float* m, float* v, float* t0,
           const cn::Keys& k, int n_hi, int n_lo, int noise,
           unsigned long long start, uint32_t trail, long long n,
           const Hyper& h, cudaStream_t st) {
  const void* ptrs[5] = {g, p, m, OPT != SGD ? v : m, OPT == FTRL ? t0 : m};
  const int sizes[5] = {(int)sizeof(G), (int)sizeof(P), 4, 4, 4};
  const long long head = cn::aligned_head(ptrs, sizes, 5, n);
  const int blocks =
      cn::pass_blocks(noise_update_kernel<G, P, OPT>, THREADS, n, head);
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  noise_update_kernel<G, P, OPT><<<blocks, THREADS, 0, st>>>(
      (const G*)g, (P*)p, m, v, t0, k, n_hi, n_lo, noise, start, trail, n,
      head, h);
  return (int)cudaGetLastError();
}

template <typename G, typename P>
int launch_opt(int opt, const void* g, void* p, float* m, float* v,
               float* t0, const cn::Keys& k, int n_hi, int n_lo, int noise,
               unsigned long long start, uint32_t trail, long long n,
               const Hyper& h, cudaStream_t st) {
  switch (opt) {
    case SGD:
      return launch<G, P, SGD>(g, p, m, v, t0, k, n_hi, n_lo, noise, start,
                               trail, n, h, st);
    case ADAMW:
      return launch<G, P, ADAMW>(g, p, m, v, t0, k, n_hi, n_lo, noise,
                                 start, trail, n, h, st);
    default:
      return launch<G, P, FTRL>(g, p, m, v, t0, k, n_hi, n_lo, noise,
                                start, trail, n, h, st);
  }
}

}  // namespace

// g: n contiguous elements of the leaf's clipped sum (bf16 when g_bf16,
// else f32); p: the parameter, n elements (bf16 when p_bf16, else f32); m,
// v: f32 state (AdamW m, v; SGD m, v unused; FTRL the prefix sum s, the
// momentum m); keys, n_hi, n_lo, start, trail: as dp_counter_noise takes
// them, read when noise != 0; opt: 0 SGD, 1 AdamW, 2 FTRL; hyper: 11 floats
// on the host, alpha, denom, lr, b1 (SGD: momentum; FTRL: momentum x
// keep), 1 - b1 (FTRL: keep, 0 on a restart step, else 1), b2, 1 - b2,
// eps, bc1, bc2, weight decay; t0: FTRL's f32 anchor (else unused).
extern "C" int dp_noise_update(const void* g, void* p, float* m, float* v,
                               const uint32_t* keys, int n_hi, int n_lo,
                               int noise, unsigned long long start,
                               unsigned long long trail, long long n,
                               int g_bf16, int p_bf16, int opt,
                               const float* hyper, float* t0, void* stream) {
  if (n <= 0 || n_hi < 0 || n_lo < 0 || n_hi + n_lo > cn::MAX_KEYS ||
      (noise && (trail == 0 || trail >= (1ULL << 32))) || opt < SGD ||
      opt > FTRL || (opt != SGD && v == nullptr) ||
      (opt == FTRL && t0 == nullptr))
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
    return p_bf16 ? launch_opt<bf, bf>(opt, g, p, m, v, t0, k, n_hi, n_lo,
                                       noise, start, tr, n, h, st)
                  : launch_opt<bf, float>(opt, g, p, m, v, t0, k, n_hi,
                                          n_lo, noise, start, tr, n, h, st);
  return p_bf16 ? launch_opt<float, bf>(opt, g, p, m, v, t0, k, n_hi, n_lo,
                                        noise, start, tr, n, h, st)
                : launch_opt<float, float>(opt, g, p, m, v, t0, k, n_hi,
                                           n_lo, noise, start, tr, n, h, st);
}
