// wkv6: the RWKV6 time-mix recurrence, one token at a time, exactly,
//
//     o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t          S_0 = 0, S (h,h) per head
//
// r, k, v, w (B,T,H,h) f32 or bf16, u (H,h) or per sample (B,H,h) f32 -> o
// (B,T,H,h) f32. Replaces
// the TPU kernel repro/kernels/wkv6.py::wkv6, and computes the recurrence
// that kernel stands for (repro/kernels/ref.py::wkv6_ref): the Pallas kernel
// rewrites a chunk as matmuls through k / P with P the in-chunk cumulative
// product of the decays, which underflows f32 under strong decay (w = 0.01:
// P reaches 1e-32 within 16 tokens). Nothing here divides: the state is
// decayed and updated token by token, so any w in [0, 1] is exact to f32
// rounding.
//
// One CTA per (head, b), one thread per state column j, which holds column j
// of S in registers (HM registers, HM = h rounded up to 32, 64 or 128).
// Tokens are staged CT at a time in shared memory; each warp reduces the
// bonus sum_i r_i u_i k_i of its tokens with a fixed xor-shuffle tree; then
// every thread steps through the staged tokens reading r, k, w as broadcasts.
// Columns past h are zero and stay zero. The order of every sum is fixed:
// bitwise run to run.
//
// Bound on the H100: B T H h (4 inputs + 1 f32 output) bytes against about
// 5 B T H h^2 operations — at rwkv6-3b's prefill (B=4, T=4096, H=40, h=64,
// bf16) 0.50 GB (0.15 ms) and 1.3e10 operations per layer, so it is
// bytes-bound. The sequential dependence along T leaves B*H = 160 CTAs of
// 2 warps on 132 SMs, so this version is latency-bound well above that. A
// chunked tensor-core form is later work, and then only with the in-chunk
// decays as differences of log-cumsums, never a division by P.
#include "common.cuh"

namespace {

template <typename T, int HM>
__global__ void __launch_bounds__(HM)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const float* __restrict__ u, int ub, float* __restrict__ o,
                int Tn, int H, int h) {
  constexpr int CT = HM <= 64 ? 32 : 16;  // tokens staged at once (32 KB)
  __shared__ __align__(16) float sr[CT][HM];
  __shared__ __align__(16) float sk[CT][HM];
  __shared__ __align__(16) float sw[CT][HM];
  __shared__ float sv[CT][HM];
  __shared__ float su[HM];
  __shared__ float sb[CT];

  const int j = threadIdx.x, lane = j & 31, warp = j >> 5;
  const int head = blockIdx.x, b = blockIdx.y;
  const long long stride = (long long)H * h;
  const long long base = (long long)b * Tn * stride + (long long)head * h + j;
  su[j] = j < h ? u[(long long)b * ub + head * h + j] : 0.f;

  float S[HM];
#pragma unroll
  for (int i = 0; i < HM; ++i) S[i] = 0.f;

  for (int t0 = 0; t0 < Tn; t0 += CT) {
    const int nt = min(CT, Tn - t0);
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll 4
    for (int tt = 0; tt < nt; ++tt) {
      const long long off = base + (t0 + tt) * stride;
      const bool in = j < h;
      sr[tt][j] = in ? to_f32(r[off]) : 0.f;
      sk[tt][j] = in ? to_f32(k[off]) : 0.f;
      sv[tt][j] = in ? to_f32(v[off]) : 0.f;
      sw[tt][j] = in ? to_f32(w[off]) : 0.f;
    }
    __syncthreads();
    // bonus of token tt: warp tt % nwarps, lanes over i, one shuffle tree
    for (int tt = warp; tt < nt; tt += HM / 32) {
      float x = 0.f;
#pragma unroll
      for (int i = lane; i < HM; i += 32) x += sr[tt][i] * su[i] * sk[tt][i];
      x = warp_sum(x);
      if (lane == 0) sb[tt] = x;
    }
    __syncthreads();
    if (j >= h) continue;
    for (int tt = 0; tt < nt; ++tt) {
      const float vj = sv[tt][j];
      float y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < HM; i += 4) {
        const float4 rr = *reinterpret_cast<const float4*>(&sr[tt][i]);
        const float4 kk = *reinterpret_cast<const float4*>(&sk[tt][i]);
        const float4 ww = *reinterpret_cast<const float4*>(&sw[tt][i]);
        y[0] = fmaf(rr.x, S[i], y[0]);
        y[1] = fmaf(rr.y, S[i + 1], y[1]);
        y[2] = fmaf(rr.z, S[i + 2], y[2]);
        y[3] = fmaf(rr.w, S[i + 3], y[3]);
        S[i] = fmaf(ww.x, S[i], kk.x * vj);
        S[i + 1] = fmaf(ww.y, S[i + 1], kk.y * vj);
        S[i + 2] = fmaf(ww.z, S[i + 2], kk.z * vj);
        S[i + 3] = fmaf(ww.w, S[i + 3], kk.w * vj);
      }
      o[base + (t0 + tt) * stride] = ((y[0] + y[1]) + (y[2] + y[3])) +
                                     sb[tt] * vj;
    }
  }
}

template <typename T, int HM>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, int ub, float* o, int B, int Tn, int H, int h,
           cudaStream_t st) {
  dim3 grid(H, B);
  wkv6_kernel<T, HM><<<grid, HM, 0, st>>>((const T*)r, (const T*)k,
                                          (const T*)v, (const T*)w, u, ub, o,
                                          Tn, H, h);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const float* u, int ub, float* o, int B, int Tn, int H, int h,
             cudaStream_t st) {
  if (h <= 32) return launch<T, 32>(r, k, v, w, u, ub, o, B, Tn, H, h, st);
  if (h <= 64) return launch<T, 64>(r, k, v, w, u, ub, o, B, Tn, H, h, st);
  return launch<T, 128>(r, k, v, w, u, ub, o, B, Tn, H, h, st);
}

}  // namespace

// r, k, v, w (B,T,H,h) contiguous, all f32 (bf16 == 0) or all bf16; u f32,
// (H,h) shared (ub == 0) or (B,H,h) per sample (ub == H h, its batch
// stride); o (B,T,H,h) f32; 1 <= h <= 128 (the wrapper checks).
extern "C" int dp_wkv6(const void* r, const void* k, const void* v,
                       const void* w, const float* u, int ub, float* o, int B,
                       int T, int H, int h, int bf16, void* stream) {
  if (h < 1 || h > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(r, k, v, w, u, ub, o, B, T, H, h, st)
              : dispatch<float>(r, k, v, w, u, ub, o, B, T, H, h, st);
}
