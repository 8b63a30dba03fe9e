// The counter-based normal of the phase-4 noise, as device functions:
//
//     z(key, i) = ndtri(uniform(threefry2x32(key, (lo, hi)).x))
//
// with (lo, hi) the counter words of linear index i (lo = i mod trail,
// hi = i div trail; repro_torch.core.noise.counter_split). The plain
// version is repro_torch/core/noise.py (threefry2x32, uniform, ndtri), which
// is the JAX package's repro/core/noise.py::counter_normal op for op:
//
//   threefry2x32  20 rounds in JAX's rotation order, key parity 0x1BD11BDA,
//                 rotations by __funnelshift_l: bitwise equal to JAX.
//   uniform       the top 24 bits m to m * 2^-24 + 2^-25 in f32, bitwise
//                 the reference's, except m = 2^24 - 1: the reference's sum
//                 rounds to 1.0 and its normal is +inf; here it is 1 - 2^-24
//                 (0x3F7FFFFF), so every draw is finite.
//   ndtri_f32     jax._src.scipy.special._ndtri's f32 polynomial: the same
//                 constants (float64 literals rounded to f32, as its
//                 np.array(..., float32) does), branches, thresholds and
//                 Horner order (jnp.polyval: y = y * x + c from y = 0), IEEE
//                 division and square root, and logf (1 ulp). Only the branch
//                 an element needs is evaluated; the reference computes all
//                 and selects, which gives the same value.
//
// ndtri's products and sums are each rounded (__fmul_rn / __fadd_rn), as the
// reference's are: contracted to FMA (one rounding where the reference rounds
// twice) the card's ndtri was up to 5 ulp from the plain version over all
// 2^24 uniforms, and 0 this way (PERF.md; design_study --only noise builds
// and times the contracted way).
//
// A leaf's keys travel as a plan (repro_torch.kernels.counter_noise.key_plan):
// the distinct keys of the hi and lo lists, each once, in an order that keeps
// each list's own, each with its sides (HI: added to the hi sum, LO: to the
// lo sum, both where the lists share it). Walking the plan adds each list's
// draws in its own order, so xi = hi - lo is bitwise the two lists summed
// apart, and a key the lists share (a tree's node at an FTRL step) is drawn
// once.
//
// Two ways to draw. ``normal`` gives one value a thread (the check entries,
// and the few elements of a leaf outside its runs). ``warp_xi`` draws a run
// of RUN consecutive elements a lane, 32 runs a warp together, for the
// passes over a leaf (counter_noise.cu, noise_update.cu): each lane steps its
// counter words from the run's first (one 64-bit division a run, and only
// where the index is past trail), runs threefry2x32 and the uniform on its
// RUN counters, and evaluates ndtri's central branch inline. ndtri's tail
// branch (two logf, a square root, four divisions, two 9-term Horner sums),
// which 27% of uniforms take, is compacted: each lane puts its tail values
// in the warp's queue in shared memory (offsets by __ballot_sync and
// __popc), the warp evaluates the queue 32 values a round with every lane
// busy (~69 values, 3 rounds, for a warp's 256), and each lane reads its
// results back from the offsets it wrote them to. One thread an element ran
// the tail in nearly every warp (a warp has no tail lane with probability
// 0.73^32), so every lane paid for both branches. Every value is computed
// by the same device functions as ``normal``'s, so the draws are bitwise
// ``normal``'s: only the lane that computes a tail value changes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cn {

struct Bits {
  uint32_t x, y;
};

// x + y mod 2^32: every add of a threefry2x32 block (a round's and a key
// injection's), which ptxas issues as IADD3 or IMAD as it chooses: 68
// instructions a block, 51 of them on the ALU pipe (kernels/sass.py's
// threefry_sass). design_study --only noise builds threefry_imad, every add
// an IMAD on the FMA pipe (41 on the ALU pipe, 81 in all): on the H100 it
// was 3.8% faster for noise_update's AdamW pass and 1.9% for
// counter_noise's, and 2.0% slower for the FTRL pass, which this header
// serves as well (PERF.md).
__device__ __forceinline__ uint32_t iadd(uint32_t x, uint32_t y) {
  return x + y;
}

template <int R>
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1) {
  x0 = iadd(x0, x1);
  x1 = __funnelshift_l(x1, x1, R);
  x1 ^= x0;
}

// x0 += a, x1 += b: a key injection between groups of four rounds
__device__ __forceinline__ void inject(uint32_t& x0, uint32_t& x1,
                                       uint32_t a, uint32_t b) {
  x0 = iadd(x0, a);
  x1 = iadd(x1, b);
}

// One threefry2x32 block of key (k0, k1) on counter (x0, x1).
__device__ __forceinline__ Bits threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  inject(x0, x1, k0, k1);
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  inject(x0, x1, k1, k2 + 1u);
  mix<17>(x0, x1); mix<29>(x0, x1); mix<16>(x0, x1); mix<24>(x0, x1);
  inject(x0, x1, k2, k0 + 2u);
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  inject(x0, x1, k0, k1 + 3u);
  mix<17>(x0, x1); mix<29>(x0, x1); mix<16>(x0, x1); mix<24>(x0, x1);
  inject(x0, x1, k1, k2 + 4u);
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  inject(x0, x1, k2, k0 + 5u);
  Bits out;
  out.x = x0;
  out.y = x1;
  return out;
}

__device__ __forceinline__ float uniform(uint32_t bits) {
  const uint32_t m = bits >> 8;
  if (m == 0xFFFFFFu) return __uint_as_float(0x3F7FFFFFu);
  return __fadd_rn(__fmul_rn((float)m, 0x1p-24f), 0x1p-25f);
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// jnp.polyval(c, x): y = 0, then y = y * x + c_i for each coefficient
__device__ __forceinline__ float horner(float, float y) { return y; }
template <typename... Rest>
__device__ __forceinline__ float horner(float x, float y, float c,
                                        Rest... rest) {
  return horner(x, add(mul(y, x), c), rest...);
}

#define CN_F(v) static_cast<float>(v)

__device__ __forceinline__ float p0(float x) {
  return horner(x, 0.f, CN_F(-5.99633501014107895267E1),
                CN_F(9.80010754185999661536E1),
                CN_F(-5.66762857469070293439E1),
                CN_F(1.39312609387279679503E1),
                CN_F(-1.23916583867381258016E0));
}
__device__ __forceinline__ float q0(float x) {
  return horner(x, 0.f, 1.f, CN_F(1.95448858338141759834E0),
                CN_F(4.67627912898881538453E0),
                CN_F(8.63602421390890590575E1),
                CN_F(-2.25462687854119370527E2),
                CN_F(2.00260212380060660359E2),
                CN_F(-8.20372256168333339912E1),
                CN_F(1.59056225126211695515E1),
                CN_F(-1.18331621121330003142E0));
}
__device__ __forceinline__ float p1(float x) {
  return horner(x, 0.f, CN_F(4.05544892305962419923E0),
                CN_F(3.15251094599893866154E1),
                CN_F(5.71628192246421288162E1),
                CN_F(4.40805073893200834700E1),
                CN_F(1.46849561928858024014E1),
                CN_F(2.18663306850790267539E0),
                CN_F(-1.40256079171354495875E-1),
                CN_F(-3.50424626827848203418E-2),
                CN_F(-8.57456785154685413611E-4));
}
__device__ __forceinline__ float q1(float x) {
  return horner(x, 0.f, 1.f, CN_F(1.57799883256466749731E1),
                CN_F(4.53907635128879210584E1),
                CN_F(4.13172038254672030440E1),
                CN_F(1.50425385692907503408E1),
                CN_F(2.50464946208309415979E0),
                CN_F(-1.42182922854787788574E-1),
                CN_F(-3.80806407691578277194E-2),
                CN_F(-9.33259480895457427372E-4));
}
__device__ __forceinline__ float p2(float x) {
  return horner(x, 0.f, CN_F(3.23774891776946035970E0),
                CN_F(6.91522889068984211695E0),
                CN_F(3.93881025292474443415E0),
                CN_F(1.33303460815807542389E0),
                CN_F(2.01485389549179081538E-1),
                CN_F(1.23716634817820021358E-2),
                CN_F(3.01581553508235416007E-4),
                CN_F(2.65806974686737550832E-6),
                CN_F(6.23974539184983293730E-9));
}
__device__ __forceinline__ float q2(float x) {
  return horner(x, 0.f, 1.f, CN_F(6.02427039364742014255E0),
                CN_F(3.67983563856160859403E0),
                CN_F(1.37702099489081330271E0),
                CN_F(2.16236993594496635890E-1),
                CN_F(1.34204006088543189037E-2),
                CN_F(3.28014464682127739104E-4),
                CN_F(2.89247864745380683936E-6),
                CN_F(6.79019408009981274425E-9));
}

// -np.expm1(-2.) and 1 - np.exp(-2.) (the same double), np.exp(-2.),
// np.sqrt(2 pi), each rounded to f32 as the reference's dtype(...) does
constexpr double EXPM1_M2 = 0.8646647167633873;
constexpr double EXP_M2 = 0.1353352832366127;
constexpr double SQRT_2PI = 2.5066282746310002;

// ndtri's two branches on mcp = min(p, 1 - p) as the reference forms it,
// before the sign: the central one (mcp > exp(-2)) and the tail
__device__ __forceinline__ float ndtri_central(float mcp) {
  const float w = __fsub_rn(mcp, 0.5f);
  const float ww = mul(w, w);
  const float r = __fdiv_rn(p0(ww), q0(ww));
  const float x = add(w, mul(mul(w, ww), r));
  return mul(x, -CN_F(SQRT_2PI));
}

__device__ __forceinline__ float ndtri_tail(float mcp) {
  const float z = __fsqrt_rn(mul(-2.f, logf(mcp)));
  const float first = __fsub_rn(z, __fdiv_rn(logf(z), z));
  const float rz = __fdiv_rn(1.f, z);
  const float second = z >= 8.f ? __fdiv_rn(__fdiv_rn(p2(rz), q2(rz)), z)
                                : __fdiv_rn(__fdiv_rn(p1(rz), q1(rz)), z);
  return __fsub_rn(first, second);
}

__device__ __forceinline__ bool upper(float p) { return p > CN_F(EXPM1_M2); }
__device__ __forceinline__ bool central(float mcp) {
  return mcp > CN_F(EXP_M2);
}

__device__ __forceinline__ float ndtri_f32(float p) {
  if (p == 0.f) return -INFINITY;
  if (p == 1.f) return INFINITY;
  float mcp = upper(p) ? __fsub_rn(1.f, p) : p;
  if (mcp == 0.f) mcp = 0.5f;
  const float x = central(mcp) ? ndtri_central(mcp) : ndtri_tail(mcp);
  return upper(p) ? x : -x;
}

#undef CN_F

// The standard normal at counter (lo, hi) under key (k0, k1).
__device__ __forceinline__ float normal(uint32_t k0, uint32_t k1,
                                        uint32_t lo, uint32_t hi) {
  return ndtri_f32(uniform(threefry2x32(k0, k1, lo, hi).x));
}

// ---------------------------------------------------------- a leaf's draws
constexpr int MAX_KEYS = 64;        // distinct keys a launch takes
constexpr int RUN = 8;              // consecutive elements a lane draws
constexpr int WARP_RUN = 32 * RUN;  // elements a warp draws at once
constexpr uint8_t HI = 1, LO = 2;   // a plan key's sides (HI | LO: both)

// The plan, as kernel parameters (__grid_constant__: read from the
// constant bank by every thread, no local copy): key j at k[2j], k[2j+1],
// its sides at side[j].
struct Keys {
  uint32_t k[2 * MAX_KEYS];
  uint8_t side[MAX_KEYS];
};

// The C entries' plan: n_keys keys from the host arrays (2 words a key,
// one side a key) into ``out``; false where n_keys is out of range or a
// side is not HI, LO or both.
__host__ inline bool read_plan(const uint32_t* keys, const uint8_t* sides,
                               int n_keys, Keys& out) {
  out = {};
  if (n_keys < 0 || n_keys > MAX_KEYS) return false;
  for (int j = 0; j < n_keys; ++j) {
    if (sides[j] == 0 || (sides[j] & ~(HI | LO))) return false;
    out.k[2 * j] = keys[2 * j];
    out.k[2 * j + 1] = keys[2 * j + 1];
    out.side[j] = sides[j];
  }
  return true;
}

// The counter words of linear index c: c mod trail, c div trail (trail <
// 2^32, repro_torch.core.noise.counter_split); no division below trail.
__device__ __forceinline__ void split(unsigned long long c, uint32_t trail,
                                      uint32_t& lo, uint32_t& hi) {
  if (c < trail) {
    lo = (uint32_t)c;
    hi = 0u;
  } else {
    const unsigned long long q = c / trail;
    hi = (uint32_t)q;
    lo = (uint32_t)(c - q * trail);
  }
}

// xi at one linear index: the hi keys' normals summed in order from 0 in
// f32, minus the lo keys' likewise (repro/core/noise.py::prefix_noise adds
// 0 z for the tree's unset levels, and every z here is finite, so skipping
// them is exact), by the plan: each key drawn once, added to its sides.
__device__ __forceinline__ float xi_at(const Keys& keys, int n_keys,
                                       unsigned long long c, uint32_t trail) {
  uint32_t lo, hi;
  split(c, trail, lo, hi);
  if (n_keys == 1 && keys.side[0] == HI)      // (0 + z) - 0 is z: see below
    return normal(keys.k[0], keys.k[1], lo, hi);
  float a = 0.f, b = 0.f;
  for (int j = 0; j < n_keys; ++j) {
    const float z = normal(keys.k[2 * j], keys.k[2 * j + 1], lo, hi);
    if (keys.side[j] & HI) a = __fadd_rn(a, z);
    if (keys.side[j] & LO) b = __fadd_rn(b, z);
  }
  return __fsub_rn(a, b);
}

// One key's normals at a lane's RUN counters from (lo, hi), into z. All 32
// lanes of the warp call it together; queue: the warp's WARP_RUN floats of
// shared memory. The uniform lies in [2^-25, 1 - 2^-24], so ndtri's p = 0,
// p = 1 and mcp = 0 cases never arise. (Drawing the RUN threefry blocks
// first, then the RUN central branches, as independent chains was 12%
// slower on the card: PERF.md.)
__device__ __forceinline__ void warp_normals(uint32_t k0, uint32_t k1,
                                             uint32_t lo, uint32_t hi,
                                             uint32_t trail, float* queue,
                                             float (&z)[RUN]) {
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  bool up[RUN];
  int slot[RUN];
  int count = 0;
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const float p = uniform(threefry2x32(k0, k1, lo, hi).x);
    if (++lo == trail) {
      lo = 0u;
      ++hi;
    }
    up[j] = upper(p);
    const float mcp = up[j] ? __fsub_rn(1.f, p) : p;
    const bool tail = !central(mcp);
    z[j] = ndtri_central(mcp);            // a tail value's is replaced below
    const unsigned vote = __ballot_sync(0xFFFFFFFFu, tail);
    slot[j] = tail ? count + __popc(vote & below) : -1;
    if (tail) queue[slot[j]] = mcp;
    count += __popc(vote);
  }
  __syncwarp();
  for (int q = threadIdx.x & 31; q < count; q += 32)
    queue[q] = ndtri_tail(queue[q]);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    const float x = slot[j] >= 0 ? queue[slot[j]] : z[j];
    z[j] = up[j] ? x : -x;
  }
  __syncwarp();                           // the queue is free again
}

// xi at a lane's RUN consecutive linear indices from c (the warp's 32
// lanes together): xi_at's sums by the plan, each key drawn once by
// warp_normals (the sides are warp-uniform: no divergence). A plan of one
// HI key (the Gaussian mechanism) skips the sums: every z is finite and
// none is -0 (the one zero, at the uniform 1/2, is +0; a negative z comes
// from the lower half, where p < 1/2), so (0 + z) - 0 is z bit for bit
// (all 2^24 uniforms: tests/test_torch_noise.py).
__device__ __forceinline__ void warp_xi(const Keys& keys, int n_keys,
                                        unsigned long long c, uint32_t trail,
                                        float* queue, float (&xi)[RUN]) {
  uint32_t lo, hi;
  split(c, trail, lo, hi);
  if (n_keys == 1 && keys.side[0] == HI) {
    warp_normals(keys.k[0], keys.k[1], lo, hi, trail, queue, xi);
    return;
  }
  float a[RUN], b[RUN], z[RUN];
#pragma unroll
  for (int j = 0; j < RUN; ++j) a[j] = b[j] = 0.f;
  for (int k = 0; k < n_keys; ++k) {
    warp_normals(keys.k[2 * k], keys.k[2 * k + 1], lo, hi, trail, queue, z);
    if (keys.side[k] & HI) {
#pragma unroll
      for (int j = 0; j < RUN; ++j) a[j] = __fadd_rn(a[j], z[j]);
    }
    if (keys.side[k] & LO) {
#pragma unroll
      for (int j = 0; j < RUN; ++j) b[j] = __fadd_rn(b[j], z[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < RUN; ++j) xi[j] = __fsub_rn(a[j], b[j]);
}

// ------------------------------------------------- the noised gradient
// (g + alpha * xi) / denom at the reference's rounding points: in f32 for
// an f32 leaf; for a bf16 leaf xi is rounded to bf16, then the product, the
// sum and the quotient each (alpha and denom arrive rounded to bf16), as
// g + (sigma * scale) * xi.astype(g.dtype) then / denom does. The result is
// the leaf dtype's value, held in a float.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The quotient by denom, the batch size a leaf's clipped sum is divided by,
// which a whole launch shares. Where denom is a power of two, s * (1 /
// denom) and s / denom round the same real number, so the product is the
// IEEE quotient bit for bit, for every s; one __fdiv_rn an element costs
// the noise passes ~7% of their time on the H100, which they spend issuing
// instructions (design_study --only noise: ieee_division).
//
// pow2_inverse: 1 / d where d is a power of two whose reciprocal is a
// normal float, else 0 (host).
__host__ inline float pow2_inverse(float d) {
  int e = 0;
  const float m = frexpf(d, &e);           // d = m 2^e, m in [0.5, 1)
  return m == 0.5f && e - 1 >= -126 && e - 1 <= 126 ? ldexpf(1.f, 1 - e)
                                                     : 0.f;
}

// A launch's divisor with its inverse (host: denom_of)
struct Denom {
  float d, inv;              // d, pow2_inverse(d)
};

__host__ inline Denom denom_of(float d) { return {d, pow2_inverse(d)}; }

// s / d: the product where d is a power of two, else divided
__device__ __forceinline__ float quotient(float s, const Denom& q) {
  return q.inv != 0.f ? __fmul_rn(s, q.inv) : __fdiv_rn(s, q.d);
}

template <bool BF16>
__device__ __forceinline__ float noised(float g, float xi, float alpha,
                                        const Denom& denom) {
  if (!BF16) return quotient(__fadd_rn(g, __fmul_rn(alpha, xi)), denom);
  const float t = bf16_round(__fmul_rn(alpha, bf16_round(xi)));
  const float s = bf16_round(__fadd_rn(g, t));
  return bf16_round(quotient(s, denom));
}

// the same, always divided (the first versions under designs/)
template <bool BF16>
__device__ __forceinline__ float noised(float g, float xi, float alpha,
                                        float denom) {
  return noised<BF16>(g, xi, alpha, Denom{denom, 0.f});
}

// --------------------------------------------- a run's loads and stores
// RUN consecutive elements of an f32 or bf16 array, as floats: two float4
// or one 16-byte vector (the caller's address is 16-byte aligned).
__device__ __forceinline__ void load_run(const float* p, float (&v)[RUN]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load_run(const __nv_bfloat16* p,
                                         float (&v)[RUN]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {           // a bf16 is an f32's top half
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void store_run(float* p, const float (&v)[RUN]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ __forceinline__ void store_run(__nv_bfloat16* p,
                                          const float (&v)[RUN]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                 bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
}

__device__ __forceinline__ float load_one(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_one(const __nv_bfloat16* p,
                                          long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_one(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_one(__nv_bfloat16* p, long long i,
                                          float v) {
  p[i] = __float2bfloat16_rn(v);
}

// The first index from which every operand (addresses a[], element sizes
// size[]) is 16-byte aligned, so that runs of RUN elements from there load
// and store as vectors; n where no index below RUN is (the whole leaf then
// goes one element a thread).
__host__ inline long long aligned_head(const void* const* a, const int* size,
                                       int count, long long n) {
  for (int h = 0; h < RUN && h < n; ++h) {
    bool ok = true;
    for (int k = 0; k < count; ++k)
      ok = ok && ((uintptr_t)a[k] + (uintptr_t)h * size[k]) % 16 == 0;
    if (ok) return h;
  }
  return n;
}

// Blocks of a pass over n elements from head (threads a block, smem bytes
// of dynamic shared memory a block): enough for its runs (a warp 32 of
// them) and for the elements outside them, at most the blocks the card
// holds resident; 0 where a query fails.
template <typename K>
__host__ int pass_blocks(K kernel, int threads, long long n, long long head,
                         size_t smem = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess)
    return 0;
  const long long runs = (n - head) / RUN;
  const long long rest = n - runs * RUN;
  const long long lanes_a_block = threads;       // a run a lane
  long long want = (runs + lanes_a_block - 1) / lanes_a_block;
  const long long for_rest = (rest + threads - 1) / threads;
  if (for_rest > want) want = for_rest;
  const long long cap = (long long)sms * per_sm;
  return (int)(want < cap ? want : cap);
}

}  // namespace cn
