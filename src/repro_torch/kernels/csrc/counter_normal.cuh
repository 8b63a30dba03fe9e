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
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cn {

struct Bits {
  uint32_t x, y;
};

template <int R>
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, R);
  x1 ^= x0;
}

// One threefry2x32 block of key (k0, k1) on counter (x0, x1).
__device__ __forceinline__ Bits threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  mix<17>(x0, x1); mix<29>(x0, x1); mix<16>(x0, x1); mix<24>(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  mix<17>(x0, x1); mix<29>(x0, x1); mix<16>(x0, x1); mix<24>(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  mix<13>(x0, x1); mix<15>(x0, x1); mix<26>(x0, x1); mix<6>(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
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

__device__ __forceinline__ float ndtri_f32(float p) {
  if (p == 0.f) return -INFINITY;
  if (p == 1.f) return INFINITY;
  float mcp = p > CN_F(EXPM1_M2) ? __fsub_rn(1.f, p) : p;
  if (mcp == 0.f) mcp = 0.5f;
  float x;
  if (mcp > CN_F(EXP_M2)) {
    const float w = __fsub_rn(mcp, 0.5f);
    const float ww = mul(w, w);
    const float r = __fdiv_rn(p0(ww), q0(ww));
    x = add(w, mul(mul(w, ww), r));
    x = mul(x, -CN_F(SQRT_2PI));
  } else {
    const float z = __fsqrt_rn(mul(-2.f, logf(mcp)));
    const float first = __fsub_rn(z, __fdiv_rn(logf(z), z));
    const float rz = __fdiv_rn(1.f, z);
    const float second =
        z >= 8.f ? __fdiv_rn(__fdiv_rn(p2(rz), q2(rz)), z)
                 : __fdiv_rn(__fdiv_rn(p1(rz), q1(rz)), z);
    x = __fsub_rn(first, second);
  }
  return p > CN_F(EXPM1_M2) ? x : -x;
}

#undef CN_F

// The standard normal at counter (lo, hi) under key (k0, k1).
__device__ __forceinline__ float normal(uint32_t k0, uint32_t k1,
                                        uint32_t lo, uint32_t hi) {
  return ndtri_f32(uniform(threefry2x32(k0, k1, lo, hi).x));
}

}  // namespace cn
