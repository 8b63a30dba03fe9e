// noise_update with its operands staged in shared memory by bulk copies
// under the draw: a design built, measured slower than the kept kernel and
// not kept. design_study --only noise builds it beside csrc/noise_update.cu,
// holds it bitwise to the first version (designs/noise_update_per_lane.cu)
// and times it with its own variants (3 stages, bulk stores, a proxy fence
// before each refill, the largest shared-memory carveout).
//
// The same function as the kept kernel, at the same rounding points, with
// the same draw (cn::warp_xi: the key plan, each distinct key once). The
// design: each warp owns a ring of STAGES tiles in shared memory, a tile its
// 32 runs' operands (g, p or t0, m, v: whatever the step reads). Before it
// draws tile k its lane 0 issues tile k+1's operands as 1-D bulk copies
// (cp.async.bulk, hopper::bulk_load_1d, no registers held) completing on
// the stage's mbarrier; the warp then draws tile k, waits on tile k's
// barrier, steps from shared memory and stores with vector stores. Tiles of
// whole runs start on 16-byte boundaries (cn::aligned_head) and end on them
// (a run is 16 bytes of bf16), as the bulk copies need; the elements outside
// the runs go one a thread. 256 threads a block, 3 blocks an SM (at most 80
// registers; the ring and the queues 56-72 KB of shared memory a block).
// Without noise the pass streams as the kept kernel does. The mbarrier's
// byte count must equal the copies' or the warp waits for ever: both come
// from one count of whole runs.
//
// Why it was not kept (PERF.md): the premise was that the draw and the
// loads take turns in each warp. On the H100 the staged pass took about
// the time of the same code with its operands loaded from device memory
// after the draw (~3.5% more on train's up leaf): the pass is bound by
// instruction issue, not by the loads' latency, and the ring adds
// instructions (the barriers, the copies' byte counts, the shared-memory
// reads).
#include <cuda_bf16.h>

#include "counter_normal.cuh"
#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// blocks an SM holds at once, by the registers a thread may take (80) and
// the ring's shared memory
constexpr int MIN_BLOCKS = 3;
// a warp's ring: the copies of its next STAGES - 1 tiles land while it
// draws one (design_study --only noise builds 3: stages_3)
constexpr int STAGES = 2;

// the optimizers (the C entry's ``opt``)
constexpr int SGD = 0, ADAMW = 1, FTRL = 2;

// the step's scalars, in f32 (host-rounded once). SGD: b1 = momentum.
// FTRL: b1 = momentum x keep, omb1 = keep (0 on a restart step, else 1).
struct Hyper {
  float alpha, denom;        // the noise (unused without it)
  float lr, b1, omb1, b2, omb2, eps, bc1, bc2, wd;
  cn::Denom dn;              // cn::denom_of(denom)
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

// One stage of a warp's ring: a tile's operands, WARP_RUN elements each, in
// this order, each 16-byte aligned: g, the p slot (t0 on an ordinary FTRL
// step, else p), m, v (AdamW v, FTRL m; none for SGD).
template <typename G, typename P, int OPT>
struct Stage {
  static constexpr int P_SLOT = OPT == FTRL ? 4 : (int)sizeof(P);
  static constexpr int P_OFF = cn::WARP_RUN * (int)sizeof(G);
  static constexpr int M_OFF = P_OFF + cn::WARP_RUN * P_SLOT;
  static constexpr int V_OFF = M_OFF + cn::WARP_RUN * 4;
  static constexpr int BYTES = V_OFF + (OPT != SGD ? cn::WARP_RUN * 4 : 0);
};

template <typename G, typename P, int OPT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    noise_update_kernel(const G* g, P* p, float* m, float* v, float* t0,
                        const __grid_constant__ cn::Keys keys, int n_keys,
                        int noise, unsigned long long start, uint32_t trail,
                        long long n, long long head, const Hyper h) {
  using S = Stage<G, P, OPT>;
  constexpr bool G_BF16 = sizeof(G) == 2;
  constexpr bool TWO = OPT != SGD;      // a second state: AdamW v, FTRL m
  // FTRL reads p only on a restart step (it becomes the anchor, written to
  // t0), and the anchor t0 only on the others
  const bool restart = OPT == FTRL && h.omb1 == 0.f;
  const bool from_t0 = OPT == FTRL && !restart;
  __shared__ float queues[WARPS][cn::WARP_RUN];
  __shared__ uint64_t bars[WARPS][STAGES];
  extern __shared__ __align__(128) uint8_t ring[];
  const int w = threadIdx.x / 32, lane = threadIdx.x & 31;
  float* queue = queues[w];
  const long long runs = (n - head) / cn::RUN;
  const long long warp = (long long)blockIdx.x * WARPS + w;
  const long long warps = (long long)gridDim.x * WARPS;
  if (noise) {
    uint64_t* bar = bars[w];
    uint8_t* mine = ring + (size_t)w * STAGES * S::BYTES;
    if (lane == 0) {
      for (int s = 0; s < STAGES; ++s) hopper::mbar_init(&bar[s], 1);
      hopper::mbar_fence_init();
    }
    __syncwarp();
    // lane 0 copies the tile of runs [r0, r0 + 32) (the last one may be
    // shorter) into stage s. The warp's reads of the stage's last tile are
    // behind the __syncwarp that ended its turn, and each had returned its
    // value (the step used it) before that: no proxy fence is needed ahead
    // of the copy's writes
    const auto issue = [&](long long r0, int s) {
      if (lane != 0) return;
      const long long i = head + r0 * cn::RUN;
      const long long left = runs - r0;
      const uint32_t e = (uint32_t)((left < 32 ? left : 32) * cn::RUN);
      uint8_t* st = mine + s * S::BYTES;
      const uint32_t p_bytes = e * (from_t0 ? 4u : (uint32_t)sizeof(P));
      hopper::mbar_expect_tx(&bar[s], e * (uint32_t)sizeof(G) + p_bytes +
                                          e * (TWO ? 8u : 4u));
      hopper::bulk_load_1d(st, g + i, e * (uint32_t)sizeof(G), &bar[s]);
      if (from_t0)
        hopper::bulk_load_1d(st + S::P_OFF, t0 + i, p_bytes, &bar[s]);
      else
        hopper::bulk_load_1d(st + S::P_OFF, p + i, p_bytes, &bar[s]);
      hopper::bulk_load_1d(st + S::M_OFF, m + i, e * 4u, &bar[s]);
      if (TWO) hopper::bulk_load_1d(st + S::V_OFF, v + i, e * 4u, &bar[s]);
    };
    const long long stride = warps * 32;   // runs between a warp's tiles
    long long r0 = warp * 32;
    for (int s = 0; s + 1 < STAGES; ++s)
      if (r0 + s * stride < runs) issue(r0 + s * stride, s);
    // warp-uniform trip count: every lane draws (warp_xi's ballots)
    for (int k = 0; r0 < runs; r0 += stride, ++k) {
      const int s = k % STAGES;
      // tile k + STAGES - 1 into the stage tile k - 1 left
      const long long ahead = r0 + (STAGES - 1) * stride;
      if (ahead < runs) issue(ahead, (k + STAGES - 1) % STAGES);
      const long long r = r0 + lane;
      const long long i = head + r * cn::RUN;
      float xi[cn::RUN];
      cn::warp_xi(keys, n_keys, start + (unsigned long long)i, trail, queue,
                  xi);
      hopper::mbar_wait(&bar[s], (uint32_t)(k / STAGES) & 1u);
      if (r < runs) {
        const uint8_t* st = mine + s * S::BYTES;
        const int at = lane * cn::RUN;
        float gv[cn::RUN], mv[cn::RUN], vv[cn::RUN], pv[cn::RUN];
        cn::load_run(reinterpret_cast<const G*>(st) + at, gv);
        cn::load_run(reinterpret_cast<const float*>(st + S::M_OFF) + at, mv);
        if (TWO)
          cn::load_run(reinterpret_cast<const float*>(st + S::V_OFF) + at,
                       vv);
        if (from_t0)
          cn::load_run(reinterpret_cast<const float*>(st + S::P_OFF) + at,
                       pv);
        else
          cn::load_run(reinterpret_cast<const P*>(st + S::P_OFF) + at, pv);
        if (restart) cn::store_run(t0 + i, pv);
#pragma unroll
        for (int j = 0; j < cn::RUN; ++j)
          step<OPT>(cn::noised<G_BF16>(gv[j], xi[j], h.alpha, h.dn), mv[j],
                    vv[j], pv[j], h);
        cn::store_run(m + i, mv);
        if (TWO) cn::store_run(v + i, vv);
        cn::store_run(p + i, pv);
      }
      __syncwarp();               // stage s is free for tile k + STAGES
    }
  } else {
    for (long long r0 = warp * 32; r0 < runs; r0 += warps * 32) {
      const long long r = r0 + lane;
      const long long i = head + r * cn::RUN;
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
        for (int j = 0; j < cn::RUN; ++j)
          step<OPT>(gv[j], mv[j], vv[j], pv[j], h);
        cn::store_run(m + i, mv);
        if (TWO) cn::store_run(v + i, vv);
        cn::store_run(p + i, pv);
      }
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
          gn, cn::xi_at(keys, n_keys, start + (unsigned long long)i, trail),
          h.alpha, h.dn);
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
           const cn::Keys& k, int n_keys, int noise, unsigned long long start,
           uint32_t trail, long long n, const Hyper& h, cudaStream_t st) {
  const auto kernel = noise_update_kernel<G, P, OPT>;
  const size_t ring = (size_t)WARPS * STAGES * Stage<G, P, OPT>::BYTES;
  // the ring's dynamic shared memory (the CUDA driver sizes the SM's
  // carveout at launch: asking for its largest made the no-noise pass 2%
  // slower)
  static const int allowed = hopper::allow_smem(kernel, ring);
  if (allowed) return allowed;
  const void* ptrs[5] = {g, p, m, OPT != SGD ? v : m, OPT == FTRL ? t0 : m};
  const int sizes[5] = {(int)sizeof(G), (int)sizeof(P), 4, 4, 4};
  const long long head = cn::aligned_head(ptrs, sizes, 5, n);
  const size_t smem = noise ? ring : 0;
  const int blocks = cn::pass_blocks(kernel, THREADS, n, head, smem);
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  noise_update_kernel<G, P, OPT><<<blocks, THREADS, smem, st>>>(
      (const G*)g, (P*)p, m, v, t0, k, n_keys, noise, start, trail, n, head,
      h);
  return (int)cudaGetLastError();
}

template <typename G, typename P>
int launch_opt(int opt, const void* g, void* p, float* m, float* v,
               float* t0, const cn::Keys& k, int n_keys, int noise,
               unsigned long long start, uint32_t trail, long long n,
               const Hyper& h, cudaStream_t st) {
  switch (opt) {
    case SGD:
      return launch<G, P, SGD>(g, p, m, v, t0, k, n_keys, noise, start,
                               trail, n, h, st);
    case ADAMW:
      return launch<G, P, ADAMW>(g, p, m, v, t0, k, n_keys, noise, start,
                                 trail, n, h, st);
    default:
      return launch<G, P, FTRL>(g, p, m, v, t0, k, n_keys, noise, start,
                                trail, n, h, st);
  }
}

}  // namespace

// g: n contiguous elements of the leaf's clipped sum (bf16 when g_bf16,
// else f32); p: the parameter, n elements (bf16 when p_bf16, else f32); m,
// v: f32 state (AdamW m, v; SGD m, v unused; FTRL the prefix sum s, the
// momentum m); keys, sides, n_keys, start, trail: the key plan and window
// as dp_counter_noise takes them, read when noise != 0; opt: 0 SGD, 1
// AdamW, 2 FTRL; hyper: 11 floats on the host, alpha, denom, lr, b1 (SGD:
// momentum; FTRL: momentum x keep), 1 - b1 (FTRL: keep, 0 on a restart
// step, else 1), b2, 1 - b2, eps, bc1, bc2, weight decay; t0: FTRL's f32
// anchor (else unused).
extern "C" int dp_noise_update(const void* g, void* p, float* m, float* v,
                               const uint32_t* keys, const uint8_t* sides,
                               int n_keys, int noise,
                               unsigned long long start,
                               unsigned long long trail, long long n,
                               int g_bf16, int p_bf16, int opt,
                               const float* hyper, float* t0, void* stream) {
  cn::Keys k = {};
  if (n <= 0 || n_keys < 0 || n_keys > cn::MAX_KEYS ||
      (noise && (trail == 0 || trail >= (1ULL << 32) ||
                 !cn::read_plan(keys, sides, n_keys, k))) ||
      opt < SGD || opt > FTRL || (opt != SGD && v == nullptr) ||
      (opt == FTRL && t0 == nullptr))
    return (int)cudaErrorInvalidValue;
  const Hyper h = {hyper[0], hyper[1], hyper[2],  hyper[3],
                   hyper[4], hyper[5], hyper[6],  hyper[7],
                   hyper[8], hyper[9], hyper[10], cn::denom_of(hyper[1])};
  const uint32_t tr = (uint32_t)trail;
  cudaStream_t st = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
  if (g_bf16)
    return p_bf16 ? launch_opt<bf, bf>(opt, g, p, m, v, t0, k, n_keys, noise,
                                       start, tr, n, h, st)
                  : launch_opt<bf, float>(opt, g, p, m, v, t0, k, n_keys,
                                          noise, start, tr, n, h, st);
  return p_bf16 ? launch_opt<float, bf>(opt, g, p, m, v, t0, k, n_keys,
                                        noise, start, tr, n, h, st)
                : launch_opt<float, float>(opt, g, p, m, v, t0, k, n_keys,
                                           noise, start, tr, n, h, st);
}
