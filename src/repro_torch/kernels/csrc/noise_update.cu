// noise_update: phase 4 and the optimizer step of one leaf in one pass,
//
//     gn = (g + alpha * xi) / denom        (noise != 0; else gn = g)
//     AdamW:  m = b1 m + (1 - b1) gn,  v = b2 v + (1 - b2) gn^2,
//             p = p - lr ((m / bc1) / (sqrt(v / bc2) + eps) + wd p)
//     SGD:    m = momentum m + gn,     p = p - lr (m + wd p)
//     FTRL:   keep = 0 on a restart step, else 1;
//             s = keep s + gn,  m = (momentum keep) m + s,
//             t0 = p (restart) or t0,  p = t0 - lr m
//
//     g: the leaf's clipped sum (f32 or bf16), the state (AdamW m, v; SGD
//     m; FTRL s, m, t0): f32, p: the parameter (f32 or bf16); the state and
//     p written in place
//
// with xi the phase-4 draw of counter_noise.cu (the same key plan, counters
// and sums: cn::warp_xi) and gn the noised gradient at the reference's
// rounding points in g's dtype (cn::noised), then widened to f32; the step
// in f32, p rounded to its dtype, as repro/optim/optimizers.py's adamw
// (:76-101) and sgd (:57-72) and repro/optim/ftrl.py (:81-97) do. FTRL's s,
// m and t0 round where its plain version's torch chain rounds (a product,
// then a sum: no contraction), so they come out bitwise the chain's. Without
// noise (frozen leaves, sigma = 0 after the mechanism's own g / denom, the
// baseline modes' materialized trees) the leaf is taken as given.
//
// Replaces no TPU kernel: the JAX package writes the noise and the update in
// jnp (repro/core/noise.py::counter_normal, repro/optim/optimizers.py,
// repro/optim/ftrl.py), which XLA fuses into a few passes; the port's first
// phase 4 ran counter_noise over the leaf, then ~14 torch passes of the
// update (its plain version, kernels/noise_update.py).
//
// Bound on the H100: bytes. AdamW over a bf16 leaf reads g 2, m 4, v 4 and
// p 2 bytes an element and writes m, v and p (10): 22 bytes, 11.67 ms over
// qwen2-1.5b's 1.78 G elements at 3.35 TB/s; SGD 14 bytes; f32 g and p 28
// (AdamW). FTRL's new p does not depend on the old one except on a restart
// step, where it becomes the anchor, and the anchor is then not read: an
// ordinary step reads g 2, s 4, m 4, t0 4 and writes s, m (8) and p 2, 24
// bytes (12.73 ms over those elements); a restart step reads p 2 in place
// of t0 and writes t0 4 more, 26 bytes (13.79 ms). The draw's integer work
// (one threefry2x32 block a distinct key an element; kernels/sass.py counts
// its instructions) issues beside the bytes.
//
// The design: runs of 8 elements a lane, 32 runs a warp. Each warp draws
// its 32 runs together (cn::warp_xi: the key plan, each distinct key once,
// ndtri's tail compacted per warp), then each lane loads its run's operands
// (g, p or t0, m, v: whatever the step reads) from device memory, steps and
// stores them as 16-byte vectors, so that the operands hold no registers
// through the draw (at most 80 registers: 3 blocks an SM). Runs start on
// 16-byte boundaries (cn::aligned_head); the elements outside them go one a
// thread. As many blocks as are resident. Without noise the same loop
// streams the leaf as given. No sums across threads, so the result is
// bitwise the same run to run, bitwise the first version's
// (designs/noise_update_per_lane.cu), and its draws bitwise counter_noise's.
//
// What the H100 showed (design_study --only noise, train's up leaf; the
// numbers in PERF.md): the pass is bound by instruction issue, not by the
// loads' latency. Staging the operands in shared memory by bulk copies
// while the warp draws (designs/noise_update_staged.cu) took ~3.5% longer;
// fewer instructions are what shorten it: the division by a power-of-two
// denom as a product (cn::quotient) and a single HI key drawn without the
// plan's sums (cn::warp_xi). What the key plan buys is one draw a distinct
// key: FTRL's ordinary step at a tree's t = 3 draws 2 keys where the first
// version drew 3.
//
// A rank's block of a leaf under a mesh (dp_noise_update_block): g, p and
// the state are its dense elements, and only the draw's counters follow
// the block's geometry, as counter_noise.cu walks them (cn::ROWS,
// cn::IN_ROWS); the update is elementwise, so a block's p and state are
// bitwise that block of the whole leaf's. chip_smoke's shard block timing
// holds it against the window's over a (2,2) rank's blocks of qwen2-1.5b's
// leaves (PERF.md section 6).
#include <cuda_bf16.h>

#include "counter_normal.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// blocks an SM holds at once, so the registers a thread may take (80);
// design_study --only noise builds 2, 3 and 4
constexpr int MIN_BLOCKS = 3;

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

// MODE (cn::WINDOW, cn::ROWS, cn::IN_ROWS): the leaf is the contiguous
// window from ``start`` (the instantiation the one-device paths launch,
// unchanged), or a block of the tensor (cn::Block, a rank's shard under a
// mesh; g, p and the state are its dense elements) whose counters are
// found by its rows, where a lane's run may cross a row's end (ROWS) or
// never does (IN_ROWS).
template <typename G, typename P, int OPT, int MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    noise_update_kernel(const G* g, P* p, float* m, float* v, float* t0,
                        const __grid_constant__ cn::Keys keys, int n_keys,
                        int noise, unsigned long long start, uint32_t trail,
                        long long n, long long head, const Hyper h,
                        const __grid_constant__ cn::Block blk) {
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
  // the block route: the place of the lane's first run, and the step to
  // its next (found once a thread; a thread step moves them on)
  constexpr bool BLOCK = MODE != cn::WINDOW;
  cn::Place at = {}, by = {};
  if constexpr (BLOCK) {
    at = cn::place_of(blk, head + (warp * 32 + (threadIdx.x & 31)) * cn::RUN);
    by = cn::place_of(blk, warps * 32 * cn::RUN);
  }
  // warp-uniform trip count and noise flag: every lane draws together
  for (long long r0 = warp * 32; r0 < runs; r0 += warps * 32) {
    const long long r = r0 + (threadIdx.x & 31);
    const long long i = head + r * cn::RUN;
    float xi[cn::RUN];
    if constexpr (BLOCK) {
      cn::warp_xi_block<MODE == cn::ROWS>(keys, n_keys, blk, at, trail, queue,
                                          xi);
      cn::advance(blk, at, by);
    } else {
      if (noise)
        cn::warp_xi(keys, n_keys, start + (unsigned long long)i, trail,
                    queue, xi);
    }
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
            noise ? cn::noised<G_BF16>(gv[j], xi[j], h.alpha, h.dn) : gv[j];
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
    if (noise) {
      const unsigned long long c =
          BLOCK ? cn::linear_at(blk, cn::place_of(blk, i))
                : start + (unsigned long long)i;
      gn = cn::noised<G_BF16>(gn, cn::xi_at(keys, n_keys, c, trail), h.alpha,
                              h.dn);
    }
    float mi = m[i], vi = TWO ? v[i] : 0.f;
    float pi = from_t0 ? t0[i] : cn::load_one(p, i);
    if (restart) t0[i] = pi;
    step<OPT>(gn, mi, vi, pi, h);
    m[i] = mi;
    if (TWO) v[i] = vi;
    cn::store_one(p, i, pi);
  }
}

template <typename G, typename P, int OPT, int MODE>
int launch_mode(const void* g, void* p, float* m, float* v, float* t0,
                const cn::Keys& k, int n_keys, int noise,
                unsigned long long start, uint32_t trail, long long n,
                long long head, const Hyper& h, const cn::Block& blk,
                cudaStream_t st) {
  const int blocks = cn::pass_blocks(noise_update_kernel<G, P, OPT, MODE>,
                                     THREADS, n, head);
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  noise_update_kernel<G, P, OPT, MODE><<<blocks, THREADS, 0, st>>>(
      (const G*)g, (P*)p, m, v, t0, k, n_keys, noise, start, trail, n, head,
      h, blk);
  return (int)cudaGetLastError();
}

template <typename G, typename P, int OPT, bool BLOCK>
int launch(const void* g, void* p, float* m, float* v, float* t0,
           const cn::Keys& k, int n_keys, int noise, unsigned long long start,
           uint32_t trail, long long n, const Hyper& h, const cn::Block& blk,
           cudaStream_t st) {
  const void* ptrs[5] = {g, p, m, OPT != SGD ? v : m, OPT == FTRL ? t0 : m};
  const int sizes[5] = {(int)sizeof(G), (int)sizeof(P), 4, 4, 4};
  const long long head = cn::aligned_head(ptrs, sizes, 5, n);
  if (!BLOCK)
    return launch_mode<G, P, OPT, cn::WINDOW>(g, p, m, v, t0, k, n_keys,
                                              noise, start, trail, n, head,
                                              h, blk, st);
  if (cn::runs_in_rows(blk, head))
    return launch_mode<G, P, OPT, cn::IN_ROWS>(g, p, m, v, t0, k, n_keys,
                                               noise, start, trail, n, head,
                                               h, blk, st);
  return launch_mode<G, P, OPT, cn::ROWS>(g, p, m, v, t0, k, n_keys, noise,
                                          start, trail, n, head, h, blk, st);
}

template <typename G, typename P, bool BLOCK>
int launch_opt(int opt, const void* g, void* p, float* m, float* v,
               float* t0, const cn::Keys& k, int n_keys, int noise,
               unsigned long long start, uint32_t trail, long long n,
               const Hyper& h, const cn::Block& blk, cudaStream_t st) {
  switch (opt) {
    case SGD:
      return launch<G, P, SGD, BLOCK>(g, p, m, v, t0, k, n_keys, noise,
                                      start, trail, n, h, blk, st);
    case ADAMW:
      return launch<G, P, ADAMW, BLOCK>(g, p, m, v, t0, k, n_keys, noise,
                                        start, trail, n, h, blk, st);
    default:
      return launch<G, P, FTRL, BLOCK>(g, p, m, v, t0, k, n_keys, noise,
                                       start, trail, n, h, blk, st);
  }
}

template <bool BLOCK>
int launch_all(const void* g, void* p, float* m, float* v,
               const uint32_t* keys, const uint8_t* sides, int n_keys,
               int noise, unsigned long long start, unsigned long long trail,
               long long n, int g_bf16, int p_bf16, int opt,
               const float* hyper, float* t0, const cn::Block& blk,
               void* stream) {
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
    return p_bf16 ? launch_opt<bf, bf, BLOCK>(opt, g, p, m, v, t0, k, n_keys,
                                              noise, start, tr, n, h, blk, st)
                  : launch_opt<bf, float, BLOCK>(opt, g, p, m, v, t0, k,
                                                 n_keys, noise, start, tr, n,
                                                 h, blk, st);
  return p_bf16 ? launch_opt<float, bf, BLOCK>(opt, g, p, m, v, t0, k,
                                               n_keys, noise, start, tr, n,
                                               h, blk, st)
                : launch_opt<float, float, BLOCK>(opt, g, p, m, v, t0, k,
                                                  n_keys, noise, start, tr,
                                                  n, h, blk, st);
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
  return launch_all<false>(g, p, m, v, keys, sides, n_keys, noise, start,
                           trail, n, g_bf16, p_bf16, opt, hyper, t0,
                           cn::Block{}, stream);
}

// The same over a block of the tensor (a rank's shard under a mesh): g, p
// and the state hold the block's n elements dense; the noise is drawn at
// the block's counters (geometry as dp_counter_noise_block takes it).
// Always noised: a leaf without noise takes dp_noise_update.
extern "C" int dp_noise_update_block(const void* g, void* p, float* m,
                                     float* v, const uint32_t* keys,
                                     const uint8_t* sides, int n_keys,
                                     const unsigned long long* geometry,
                                     unsigned long long trail, long long n,
                                     int g_bf16, int p_bf16, int opt,
                                     const float* hyper, float* t0,
                                     void* stream) {
  cn::Block b = {};
  if (!cn::read_block(geometry, n, b)) return (int)cudaErrorInvalidValue;
  return launch_all<true>(g, p, m, v, keys, sides, n_keys, 1, b.base, trail,
                          n, g_bf16, p_bf16, opt, hyper, t0, b, stream);
}
