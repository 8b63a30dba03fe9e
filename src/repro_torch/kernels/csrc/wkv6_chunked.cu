// wkv6, chunked: the RWKV6 time-mix recurrence of wkv6.cu, exactly, as two
// passes of tensor-core products over chunks of C tokens,
//
//     o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t          S_0 = 0, S (h,h) per head
//
// r, k, v, w (B,T,H,h) f32 or bf16, u (H,h) or per sample (B,H,h) f32 -> o
// (B,T,H,h) f32, h a multiple of 16 up to 128. Replaces the TPU kernel
// repro/kernels/wkv6.py::wkv6 on the prefill (bf16) and the f32 parity
// prefill; other head sizes keep wkv6.cu, the token-by-token scan.
//
// Write D(a..b) for the per-channel product w_a ... w_b (1 when a > b). With
// t0 the start of t's chunk and S0 the state before it,
//
//     o_t   = (r_t D(t0..t-1)) S0 + sum_{t0<=s<t} A[t,s] v_s + A[t,t] v_t
//     A[t,s] = sum_i r_t[i] D(s+1..t-1)[i] k_s[i],  A[t,t] = sum_i r_t u k_t
//     S_end = diag(D(t0..t0+C-1)) S0 + sum_s (k_s D(s+1..t0+C-1))^T v_s
//
// Pass 1 (wkv6_state_kernel) walks the chunks of one (b, head, block of 32
// state columns) in order, the block in registers: column j of S depends
// only on v[:, j], so 2 (h = 64) column blocks give 320 CTAs at the prefill
// (B=4, H=40) where one a head gave 160 for 132 SMs. Each chunk's k, w, v
// come in by cp.async a chunk ahead; each half of the chunk is walked per
// channel (K~ = k D(s+1..end of the half), a running product from the
// half's end, loaded 8 tokens ahead of its stores: shared-memory stores
// keep later loads from being hoisted) and multiplied into its own product
// P_half = K~^T V by its own warps; then S = D(chunk) S + (G1 P_0 + P_1),
// G1 the second half's D, and S at the next chunk's start goes to an f32
// scratch (B, H, T/C, h, h).
// Pass 2 (wkv6_out_kernel) is one CTA per (b, head, chunk), all in
// parallel; two warps own sub-chunk q (16 tokens, one m16 row tile):
//   - r'_t = r_t D(h0..t-1) and k'_s = k_s D(s+1..h1) over each half [h0,
//     h1] of 8 tokens, and the halves' D (G8a, G8b), by running products
//     per channel;
//   - each half's diagonal block A[t,s], h0 <= s <= t, on the CUDA cores:
//     lane (pair p, channel group) walks rows p and 7 - p together (7
//     steps for every lane), D(s+1..t-1) a running product from s = t-1;
//   - the second half's rows against the first half's columns through the
//     half's start: r' k'^T, one product;
//   - its off-diagonal blocks through the start b of its sub-chunk,
//     A[t,s] = r^_t . (k^_s F), r^ = r' (first half) or r' G8a, k^ = k' G8b
//     (first half) or k', F the product of the G of the sub-chunks
//     between (a table of such products per channel): one product each;
//   - O = A V + (r^ D(t0..b-1)) S0, S0 split once in shared memory for
//     every warp, and one f32 store of its rows.
// (Diagonal blocks of 16 all on the CUDA cores, and one warp a sub-chunk,
// measured slower during development; chunks of 32 and pass-1 CTAs of 16
// columns are timed beside this kernel by
// repro_torch.kernels.design_study.)
//
// Exactness: nothing divides by a decay product, and no factor is the
// difference of two prefix sums of log w (which loses absolute precision
// once a prefix sum is large and gives -inf - -inf = NaN at w = 0). Every
// factor is a product of w's over its own interval, formed in f32 from 1
// (a running product, or a product of such products over adjacent
// intervals), so it is <= 1 and carries a few ulps of relative error; an
// underflow to 0 multiplies a factor that is <= 1, so its error stays below
// f32's tiny times |r||k|. w = 0 and w = 1 are exact, and log w is never
// clamped (the Pallas kernel clamps it at -20: repro/kernels/wkv6.py:29,46).
// Running products stand in for the exp of a sum of log w: equal up to
// rounding, with no exp or log on the critical path.
//
// Products on the tensor cores: the scaled operands (r^, k-, the state) are
// f32, and a bf16 or TF32 rounding of them (~4e-3, ~5e-4) would miss the
// 1e-3 the prefill is held to, so each product runs as split TF32
// (mma.sync m16n8k8: x = hi + lo, both TF32; hi.hi + hi.lo + lo.hi, small
// terms first, about f32 accuracy for 3x the TF32 operations). A bf16 v is
// exact in TF32, so its products take two. Each chunk's product sums into
// fresh accumulators; the state is then updated in f32 on the CUDA cores
// (fmaf(g, S, P)), so it is never carried through the tensor cores' adds.
// Every sum runs in a fixed order and no float atomics: bitwise run to run.
//
// Bound on the H100 (prefill, B=4, T=4096, H=40, h=64, bf16): the inputs
// once and the f32 output, 0.50 GB, 0.150 ms, against ~2e10 operations (3x
// TF32 ~5e10, 0.1 ms at 495 TFLOP/s): bytes-bound. These two passes move
// ~1.1 GB (pass 2 reads the inputs again and the scratch S, 168 MB written
// and read at C = 64): ~0.33 ms at 3.35 TB/s. C = 64 (h <= 64) or 32
// (h = 128, for shared memory). PERF.md has the measured times, and where
// the rest goes: pass 2's loads and its products do not overlap well at
// two CTAs an SM.
#include "common.cuh"

namespace {

constexpr int SUB = 16;   // tokens of a sub-chunk: one m16 row tile
constexpr int HS = SUB / 2;   // tokens of its halves
constexpr int JB = 32;    // state columns of a pass-1 CTA

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- split TF32
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo to ~2^-22 relative, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d (16 x 8) += a (16 x 8, row) b (8 x 8, col): thread (g = lane/4, q =
// lane%4) holds a (g, q), (g+8, q), (g, q+4), (g+8, q+4); b (q, g),
// (q+4, g); d (g, 2q), (g, 2q+1), (g+8, 2q), (g+8, 2q+1).
__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A split 16 x 8 A operand, and one product of it with a B operand: split
// (three products) or, EXACT, already TF32 (two).
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(int e, float x) { split(x, hi[e], lo[e]); }
};
template <bool EXACT>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, float b0,
                                     float b1) {
  if constexpr (EXACT) {
    const uint32_t h0 = __float_as_uint(b0), h1 = __float_as_uint(b1);
    mma8(d, a.lo, h0, h1);
    mma8(d, a.hi, h0, h1);
  } else {
    uint32_t h0, l0, h1, l1;
    split(b0, h0, l0);
    split(b1, h1, l1);
    mma8(d, a.lo, h0, h1);
    mma8(d, a.hi, l0, l1);
    mma8(d, a.hi, h0, h1);
  }
}

// Pre-split B operands (hi, lo as stored).
__device__ __forceinline__ void mma3s(float (&d)[4], const FragA& a, float h0,
                                      float l0, float h1, float l1) {
  const uint32_t bh0 = __float_as_uint(h0), bh1 = __float_as_uint(h1);
  mma8(d, a.lo, bh0, bh1);
  mma8(d, a.hi, __float_as_uint(l0), __float_as_uint(l1));
  mma8(d, a.hi, bh0, bh1);
}

// Two neighbouring channels of a tile row, as f32.
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Shared-memory row strides (elements) of a chunk's tiles: raw r, k, w (A
// operand rows or walked per channel), v (a B operand: 8 words mod 32),
// f32 A operands (4 words mod 32), f32 B operands (8 words mod 32); every
// row a multiple of 16 bytes, for cp.async.
template <typename T, int HM, int C>
struct Layout {
  static constexpr int E = 16 / sizeof(T);   // elements of a 16-byte copy
  static constexpr int RS = HM + E, VS = HM + 2 * E;
  static constexpr int FS = HM + 4, AS = C + 4, SS = HM + 8;
  static constexpr int NS = C / SUB, THREADS = NS * 64;
  // pass 2: [r k w | S0 hi, S0 lo] v r' k' A G [G8a G8b] F
  static constexpr int RAW = 3 * C * RS * (int)sizeof(T);
  static constexpr int S0 = 2 * HM * SS * 4;
  static constexpr int U = RAW > S0 ? RAW : S0;
  static constexpr int V_OFF = U, RH_OFF = V_OFF + C * VS * (int)sizeof(T);
  static constexpr int KB_OFF = RH_OFF + C * FS * 4;
  static constexpr int A_OFF = KB_OFF + C * FS * 4;
  static constexpr int G_OFF = A_OFF + C * AS * 4;
  static constexpr int G8_OFF = G_OFF + NS * HM * 4;
  static constexpr int F_OFF = G8_OFF + 2 * NS * HM * 4;
  static constexpr int OUT_SMEM = F_OFF + NS * 2 * NS * HM * 4;
  // pass 1: two buffers of [k w v(JB)] (k, w read a row a warp: no
  // padding), then K~ (f32, a transposed A operand: 8 words mod 32), the
  // upper half's products handed over (32 a lane, a warp per channel
  // block), the halves' D
  static constexpr int PRS = HM, PVS = JB + E, KS = HM + 8;
  static constexpr int BUF = 2 * C * PRS * (int)sizeof(T) +
                             C * PVS * (int)sizeof(T);
  static constexpr int STATE_SMEM =
      2 * BUF + C * KS * 4 + HM * 32 * 4 + 2 * HM * 4;
  static_assert(OUT_SMEM <= 232448 && STATE_SMEM <= 232448,
                "over the 227 KB a block may use");
};

// ------------------------------------------------------------------ pass 1
// 2 HM threads: warp w owns channels 32 (w % (HM/32)) .. +31 and half
// th = w / (HM/32) of each chunk's tokens. Each thread walks one channel's
// half (a running product from the half's end, loaded 8 tokens ahead of
// the stores), and the warp multiplies its K~ rows into its half's product
// P_th; the lower half's K~ lacks the upper half's decay G1 = D(upper
// half), which the update applies: S = D(chunk) S + (G1 P_0 + P_1), the
// state held by the lower-half warps.
template <typename T, int HM, int C>
__global__ void __launch_bounds__(2 * HM)
    wkv6_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ w, float* __restrict__ state,
                      int Tn, int H, int h, int nc) {
  using Ly = Layout<T, HM, C>;
  constexpr int E = Ly::E, RS = Ly::PRS, PVS = Ly::PVS, KS = Ly::KS;
  constexpr int THREADS = 2 * HM, HALF = C / 2, NCB = HM / 32;
  constexpr bool EXACT = sizeof(T) == 2;   // bf16 v is exact in TF32
  extern __shared__ __align__(16) uint8_t smem[];
  float* kt = reinterpret_cast<float*>(smem + 2 * Ly::BUF);
  float* handoff = kt + C * KS;   // [NCB][32][32]
  float* sgh = handoff + HM * 32;   // [2][HM]: each half's D

  const int jb = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3, j0 = jb * JB;
  const int cb = wp % NCB, th = wp / NCB;   // channel block, token half
  const long long rows = (long long)H * h;   // elements between tokens
  const long long col0 = (long long)b * Tn * rows + (long long)head * h;

  // chunk c's k, w (all HM channels) and v (this CTA's JB columns) into
  // buffer c & 1, as one cp.async group
  auto load = [&](int c) {
    uint8_t* buf = smem + (c & 1) * Ly::BUF;
    T* bk = reinterpret_cast<T*>(buf);
    T* bw = bk + C * RS;
    T* bv = bw + C * RS;
    constexpr int CPR = HM / E, VPR = JB / E;
    for (int e = tid; e < 2 * C * CPR; e += THREADS) {
      const int row = (e / CPR) % C, ch = (e % CPR) * E, t = c * C + row;
      const T* src = e < C * CPR ? k : w;
      const bool ok = t < Tn && ch < h;
      cp16((e < C * CPR ? bk : bw) + row * RS + ch,
           ok ? src + col0 + t * rows + ch : src, ok);
    }
    for (int e = tid; e < C * VPR; e += THREADS) {
      const int row = e / VPR, ch = (e % VPR) * E, t = c * C + row;
      const bool ok = t < Tn && j0 + ch < h;
      cp16(bv + row * PVS + ch, ok ? v + col0 + t * rows + j0 + ch : v, ok);
    }
    cp_commit();
  };

  // S rows 32 cb + 16 mt + g (+8), columns j0 + 8 nt + 2 tq (+1): held by
  // the lower half's warps
  float S[2][JB / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < JB / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[mt][nt][e] = 0.f;

  load(0);
  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc)
      load(c + 1);
    else
      cp_commit();   // an empty group: chunk c's is then the one before
    cp_wait<1>();
    __syncthreads();
    const uint8_t* buf = smem + (c & 1) * Ly::BUF;
    const T* bk = reinterpret_cast<const T*>(buf);
    const T* bw = bk + C * RS;
    const T* bv = bw + C * RS;

    // K~[s][i] = k_s[i] D(s+1..end of the half)[i]: this lane's channel i,
    // the warp's half, 8 tokens loaded before they are walked
    {
      const int i = 32 * cb + lane, s_end = th * HALF + HALF;
      float P = 1.f;
      for (int s0 = s_end - 8; s0 >= th * HALF; s0 -= 8) {
        float kk[8], ww[8];
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          kk[x] = to_f32(bk[(s0 + x) * RS + i]);
          ww[x] = to_f32(bw[(s0 + x) * RS + i]);
        }
#pragma unroll
        for (int x = 7; x >= 0; --x) {
          kt[(s0 + x) * KS + i] = kk[x] * P;
          P *= ww[x];
        }
      }
      sgh[th * HM + i] = P;
    }
    __syncwarp();

    // P_th = K~^T V over the half: A[m = i][k = s] = K~[s][i], B = V[s][j]
    float acc[2][JB / 8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < JB / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
    for (int kk = th * HALF; kk < th * HALF + HALF; kk += 8) {
      FragA a[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* col = kt + 32 * cb + 16 * mt + g;
        a[mt].set(0, col[(kk + tq) * KS]);
        a[mt].set(1, col[(kk + tq) * KS + 8]);
        a[mt].set(2, col[(kk + tq + 4) * KS]);
        a[mt].set(3, col[(kk + tq + 4) * KS + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < JB / 8; ++nt) {
        const float b0 = to_f32(bv[(kk + tq) * PVS + 8 * nt + g]);
        const float b1 = to_f32(bv[(kk + tq + 4) * PVS + 8 * nt + g]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma3<EXACT>(acc[mt][nt], a[mt], b0, b1);
      }
    }
    // the upper half hands P_1 over: element e of each lane at e 32 + lane
    float* hand = handoff + cb * 32 * 32 + lane;
    if (th == 1) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < JB / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            hand[((mt * (JB / 8) + nt) * 4 + e) * 32] = acc[mt][nt][e];
    }
    __syncthreads();   // P_1 and both halves' D are written; buffer c & 1
                       // and K~ are read
    if (th == 0) {
      // S = D(chunk) S + (G1 P_0 + P_1), in f32 on the CUDA cores; then
      // the state before chunk c + 1
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int r8 = 0; r8 < 2; ++r8) {
          const int i = 32 * cb + 16 * mt + g + 8 * r8;
          const float g1 = sgh[HM + i], gc = sgh[i] * g1;
#pragma unroll
          for (int nt = 0; nt < JB / 8; ++nt)
#pragma unroll
            for (int e = 2 * r8; e < 2 * r8 + 2; ++e)
              S[mt][nt][e] = fmaf(
                  gc, S[mt][nt][e],
                  fmaf(g1, acc[mt][nt][e],
                       hand[((mt * (JB / 8) + nt) * 4 + e) * 32]));
        }
      if (c + 1 < nc) {
        float* dst =
            state + (((long long)b * H + head) * nc + c + 1) * h * h;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < JB / 8; ++nt) {
            const int i = 32 * cb + 16 * mt + g, j = j0 + 8 * nt + 2 * tq;
            if (j >= h) continue;
            if (i < h)
              *reinterpret_cast<float2*>(dst + (long long)i * h + j) =
                  make_float2(S[mt][nt][0], S[mt][nt][1]);
            if (i + 8 < h)
              *reinterpret_cast<float2*>(dst + (long long)(i + 8) * h + j) =
                  make_float2(S[mt][nt][2], S[mt][nt][3]);
          }
      }
    }
  }
}

// ------------------------------------------------------------------ pass 2
// 64 threads a sub-chunk: warp (q, part) owns sub-chunk q's half `part` in
// the walks (channels) and the diagonal blocks (tokens), every other 8
// columns of its off-diagonal blocks, and half of its output columns.
template <typename T, int HM, int C>
__global__ void __launch_bounds__(C / SUB * 64)
    wkv6_out_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ w,
                    const float* __restrict__ u, int ub,
                    const float* __restrict__ state, float* __restrict__ o,
                    int Tn, int H, int h, int nc) {
  using Ly = Layout<T, HM, C>;
  constexpr int E = Ly::E, RS = Ly::RS, VS = Ly::VS, FS = Ly::FS,
                AS = Ly::AS, SS = Ly::SS, NS = Ly::NS, THREADS = Ly::THREADS;
  constexpr int NTW = HM / 16;   // a warp's 8-column output tiles
  constexpr bool EXACT = sizeof(T) == 2;
  extern __shared__ __align__(16) uint8_t smem[];
  T* sr = reinterpret_cast<T*>(smem);
  T* sk = sr + C * RS;
  T* sw = sk + C * RS;
  float* s0 = reinterpret_cast<float*>(smem);   // over r, k, w once read
  float* s0lo = s0 + HM * SS;
  T* sv = reinterpret_cast<T*>(smem + Ly::V_OFF);
  float* rh = reinterpret_cast<float*>(smem + Ly::RH_OFF);
  float* kb = reinterpret_cast<float*>(smem + Ly::KB_OFF);
  float* sa = reinterpret_cast<float*>(smem + Ly::A_OFF);
  float* sg = reinterpret_cast<float*>(smem + Ly::G_OFF);
  float* sg8 = reinterpret_cast<float*>(smem + Ly::G8_OFF);
  float* ft = reinterpret_cast<float*>(smem + Ly::F_OFF);

  const int c = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int q = wp % NS, part = wp / NS;
  const int g = lane >> 2, tq = lane & 3, t0 = c * C, qb = q * SUB;
  const long long rows = (long long)H * h;
  const long long col0 = (long long)b * Tn * rows + (long long)head * h;

  // ---- the chunk's r, k, w, v; rows past T and channels past h are zero
  {
    constexpr int CPR = HM / E;
    for (int e = tid; e < 4 * C * CPR; e += THREADS) {
      const int which = e / (C * CPR), row = (e / CPR) % C;
      const int ch = (e % CPR) * E, t = t0 + row;
      const T* src = which == 0 ? r : which == 1 ? k : which == 2 ? w : v;
      T* dst = which == 3 ? sv + row * VS : sr + (which * C + row) * RS;
      const bool ok = t < Tn && ch < h;
      cp16(dst + ch, ok ? src + col0 + t * rows + ch : src, ok);
    }
    cp_commit();
    cp_wait<0>();
    __syncthreads();
  }

  // ---- sub-chunk q's running products over each half [h0, h1], lane over
  // channels (its 16 tokens loaded before they are walked): r'_t = r_t
  // D(h0..t-1), k'_t = k_t D(t+1..h1); G8a, G8b the halves' D, G_q their
  // product
#pragma unroll 1
  for (int i = lane + 32 * part; i < HM; i += 64) {
    float rr[SUB], kk[SUB], ww[SUB];
#pragma unroll
    for (int tt = 0; tt < SUB; ++tt) {
      rr[tt] = to_f32(sr[(qb + tt) * RS + i]);
      kk[tt] = to_f32(sk[(qb + tt) * RS + i]);
      ww[tt] = to_f32(sw[(qb + tt) * RS + i]);
    }
    float P = 1.f, Q = 1.f, pa = 1.f;
#pragma unroll
    for (int tt = 0; tt < SUB; ++tt) {
      if (tt == HS) {
        pa = P;   // D(first half)
        P = Q = 1.f;
      }
      rh[(qb + tt) * FS + i] = rr[tt] * P;
      P *= ww[tt];
      const int tb = SUB - 1 - tt;
      kb[(qb + tb) * FS + i] = kk[tb] * Q;
      Q *= ww[tb];
    }
    sg8[q * HM + i] = pa;
    sg8[(NS + q) * HM + i] = P;   // D(second half)
    sg[q * HM + i] = pa * P;
  }

  // ---- the diagonal block of half `part` of sub-chunk q, and the bonus on
  // its diagonal, on the CUDA cores. Lane (p, group): rows p and 7 - p of
  // the half (p and 7 - p strictly earlier tokens: 7 steps in all), the
  // channels of one of 8 groups; step j < p is (p, p-1-j), step j >= p is
  // (7-p, 6-j), so acc[j] has a static index.
  {
    constexpr int QC = HM / 8;
    const int p = lane & 3, grp = lane >> 2;
    const int hb = qb + part * HS, ta = hb + p, tb = hb + HS - 1 - p;
    float acc[HS - 1], bon_a = 0.f, bon_b = 0.f;
#pragma unroll
    for (int j = 0; j < HS - 1; ++j) acc[j] = 0.f;
    // two channels at a time, each with its own running product
    for (int ii = 0; ii < QC; ii += 2) {
      const int i = grp * QC + ii;
      const float2 ra = ld2(sr + ta * RS + i), rb = ld2(sr + tb * RS + i);
      const float2 ui = i < h ? *reinterpret_cast<const float2*>(
                                    u + (long long)b * ub + head * h + i)
                              : make_float2(0.f, 0.f);
      const float2 ka = ld2(sk + ta * RS + i), kb2 = ld2(sk + tb * RS + i);
      bon_a = fmaf(ra.y * ui.y, ka.y, fmaf(ra.x * ui.x, ka.x, bon_a));
      bon_b = fmaf(rb.y * ui.y, kb2.y, fmaf(rb.x * ui.x, kb2.x, bon_b));
      float px = 1.f, py = 1.f;   // D(s+1..t-1), from s = t-1 down
#pragma unroll
      for (int j = 0; j < HS - 1; ++j) {
        const bool first = j < p;
        if (j == p) px = py = 1.f;
        const int s = hb + (first ? p - 1 - j : HS - 2 - j);
        const float2 rr = first ? ra : rb;
        const float2 ks = ld2(sk + s * RS + i), ws = ld2(sw + s * RS + i);
        acc[j] = fmaf(rr.y * py, ks.y, fmaf(rr.x * px, ks.x, acc[j]));
        px *= ws.x;
        py *= ws.y;
      }
    }
    // the eight groups' sums, the same bits in each of their lanes
#pragma unroll
    for (int j = 0; j < HS - 1; ++j)
#pragma unroll
      for (int x = 4; x < 32; x <<= 1)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], x);
#pragma unroll
    for (int x = 4; x < 32; x <<= 1) {
      bon_a += __shfl_xor_sync(0xffffffffu, bon_a, x);
      bon_b += __shfl_xor_sync(0xffffffffu, bon_b, x);
    }
    if (grp == 0) {
      float* ya = sa + ta * AS + hb;
      float* yb = sa + tb * AS + hb;
#pragma unroll
      for (int j = 0; j < HS - 1; ++j) {
        if (j < p)
          ya[p - 1 - j] = acc[j];
        else
          yb[HS - 2 - j] = acc[j];
      }
      ya[p] = bon_a;
      yb[HS - 1 - p] = bon_b;
      // above the diagonal: the rest of the half's block, and (first half)
      // the second half's columns
      for (int x = p + 1; x < (2 - part) * HS; ++x) ya[x] = 0.f;
      for (int x = HS - p; x < (2 - part) * HS; ++x) yb[x] = 0.f;
    }
  }
  __syncthreads();   // every sub-chunk's r', k', G; r, k, w are read

  // ---- S0 into the space of r, k, w (read at the end)
  const float* src0 = state + (((long long)b * H + head) * nc + c) * h * h;
  if (c > 0) {
    for (int e = tid; e < HM * (HM / 4); e += THREADS) {
      const int i = e / (HM / 4), j = (e % (HM / 4)) * 4;
      const bool ok = i < h && j < h;
      cp16(s0 + i * SS + j, ok ? src0 + (long long)i * h + j : src0, ok);
    }
    cp_commit();
  }

  // ---- per channel, the factor of each 8-column block nt < 2q of rows q
  // against r^ = r' (first half) or r' G8a (second half), F[q][nt]: the
  // decay over the sub-chunks between p = nt / 2 and q, times (nt even)
  // the second half of p; and of S0 against r', F[q][2q + half]: the
  // sub-chunks before q, times (second half) G8a. Running products from
  // q - 1 down.
  for (int i = tid; i < HM; i += THREADS) {
#pragma unroll
    for (int qq = 0; qq < NS; ++qq) {
      float* fq = ft + qq * 2 * NS * HM + i;
      float f = 1.f;
      for (int pp = qq - 1; pp >= 0; --pp) {
        fq[(2 * pp + 1) * HM] = f;
        fq[2 * pp * HM] = f * sg8[(NS + pp) * HM + i];
        f *= sg[pp * HM + i];
      }
      fq[2 * qq * HM] = f;
      fq[(2 * qq + 1) * HM] = f * sg8[qq * HM + i];
    }
  }
  __syncthreads();

  if (part == 0) {
    // ---- the block of the second half's rows and the first half's
    // columns through the half's start: r' (second half) k'^T (first
    // half), rows g of the m16 tile zero
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    FragA a;
    a.hi[0] = a.hi[2] = a.lo[0] = a.lo[2] = 0u;
    for (int kk = 0; kk < HM; kk += 8) {
      const int i0 = kk + tq, i1 = i0 + 4;
      a.set(1, rh[(qb + HS + g) * FS + i0]);
      a.set(3, rh[(qb + HS + g) * FS + i1]);
      mma3<false>(acc, a, kb[(qb + g) * FS + i0], kb[(qb + g) * FS + i1]);
    }
    *reinterpret_cast<float2*>(sa + (qb + HS + g) * AS + qb + 2 * tq) =
        make_float2(acc[2], acc[3]);
  }

  // ---- the off-diagonal blocks of rows qb.., 8-column blocks nt = part,
  // part + 2, ..: r^ (k' F[q][nt])^T
  if (q > 0) {
    float acc[NS - 1][4];
#pragma unroll
    for (int x = 0; x < NS - 1; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[x][e] = 0.f;
    const float* fq = ft + q * 2 * NS * HM;   // F[q][nt] at nt HM + i
    const float* g8 = sg8 + q * HM;
    for (int kk = 0; kk < HM; kk += 8) {
      const int i0 = kk + tq, i1 = i0 + 4;
      FragA a;   // r^: r' (first half), r' G8a (second half)
      a.set(0, rh[(qb + g) * FS + i0]);
      a.set(1, rh[(qb + g + HS) * FS + i0] * g8[i0]);
      a.set(2, rh[(qb + g) * FS + i1]);
      a.set(3, rh[(qb + g + HS) * FS + i1] * g8[i1]);
#pragma unroll
      for (int x = 0; x < NS - 1; ++x) {
        const int nt = 2 * x + part;
        if (nt >= 2 * q) break;
        const int s = 8 * nt + g;
        mma3<false>(acc[x], a, kb[s * FS + i0] * fq[nt * HM + i0],
                    kb[s * FS + i1] * fq[nt * HM + i1]);
      }
    }
#pragma unroll
    for (int x = 0; x < NS - 1; ++x) {
      const int nt = 2 * x + part;
      if (nt >= 2 * q) break;
      float* y = sa + (qb + g) * AS + 8 * nt + 2 * tq;
      *reinterpret_cast<float2*>(y) = make_float2(acc[x][0], acc[x][1]);
      *reinterpret_cast<float2*>(y + 8 * AS) =
          make_float2(acc[x][2], acc[x][3]);
    }
  }
  __syncthreads();   // rows q of A, from both warps of q

  // ---- O = A V over s < b + 16, then + (r^ D(t0..b-1)) S0: output
  // columns 8 (NTW part + x) ..
  float out[NTW][4];
#pragma unroll
  for (int x = 0; x < NTW; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[x][e] = 0.f;
  const int j0 = 8 * NTW * part;
  for (int kk = 0; kk < qb + SUB; kk += 8) {
    FragA a;
    a.set(0, sa[(qb + g) * AS + kk + tq]);
    a.set(1, sa[(qb + g + 8) * AS + kk + tq]);
    a.set(2, sa[(qb + g) * AS + kk + tq + 4]);
    a.set(3, sa[(qb + g + 8) * AS + kk + tq + 4]);
#pragma unroll
    for (int x = 0; x < NTW; ++x)
      mma3<EXACT>(out[x], a, to_f32(sv[(kk + tq) * VS + j0 + 8 * x + g]),
                  to_f32(sv[(kk + tq + 4) * VS + j0 + 8 * x + g]));
  }
  if (c > 0) {
    // S0 split once for every warp: each thread its own copies' elements
    cp_wait<0>();
    for (int e = tid; e < HM * (HM / 4); e += THREADS) {
      const int ij = e / (HM / 4) * SS + (e % (HM / 4)) * 4;
#pragma unroll
      for (int x = ij; x < ij + 4; ++x) {
        uint32_t hi, lo;
        split(s0[x], hi, lo);
        s0[x] = __uint_as_float(hi);
        s0lo[x] = __uint_as_float(lo);
      }
    }
    __syncthreads();
    // r' times D(t0..h0-1): F[q][2q] (first half), F[q][2q+1] (second)
    const float* fb = ft + (q * 2 * NS + 2 * q) * HM;
    for (int kk = 0; kk < HM; kk += 8) {
      const int i0 = kk + tq, i1 = i0 + 4;
      FragA a;
      a.set(0, rh[(qb + g) * FS + i0] * fb[i0]);
      a.set(1, rh[(qb + g + HS) * FS + i0] * fb[HM + i0]);
      a.set(2, rh[(qb + g) * FS + i1] * fb[i1]);
      a.set(3, rh[(qb + g + HS) * FS + i1] * fb[HM + i1]);
#pragma unroll
      for (int x = 0; x < NTW; ++x) {
        const int j = j0 + 8 * x + g;
        mma3s(out[x], a, s0[i0 * SS + j], s0lo[i0 * SS + j],
              s0[i1 * SS + j], s0lo[i1 * SS + j]);
      }
    }
  }

  // ---- rows past T and columns past h are dropped
#pragma unroll
  for (int x = 0; x < NTW; ++x) {
    const int j = j0 + 8 * x + 2 * tq, t = t0 + qb + g;
    if (j >= h) continue;
    if (t < Tn)
      *reinterpret_cast<float2*>(o + col0 + t * rows + j) =
          make_float2(out[x][0], out[x][1]);
    if (t + 8 < Tn)
      *reinterpret_cast<float2*>(o + col0 + (t + 8) * rows + j) =
          make_float2(out[x][2], out[x][3]);
  }
}

template <typename T, int HM, int C>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, int ub, float* state, float* o, int B, int Tn,
           int H, int h, cudaStream_t st) {
  using Ly = Layout<T, HM, C>;
  const int nc = (Tn + C - 1) / C;
  auto pass1 = wkv6_state_kernel<T, HM, C>;
  auto pass2 = wkv6_out_kernel<T, HM, C>;
  int err = (int)cudaFuncSetAttribute(
      pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, Ly::STATE_SMEM);
  if (!err)
    err = (int)cudaFuncSetAttribute(
        pass2, cudaFuncAttributeMaxDynamicSharedMemorySize, Ly::OUT_SMEM);
  if (err) return err;
  pass1<<<dim3(HM / JB, H, B), 2 * HM, Ly::STATE_SMEM, st>>>(
      (const T*)k, (const T*)v, (const T*)w, state, Tn, H, h, nc);
  err = (int)cudaGetLastError();
  if (err) return err;
  pass2<<<dim3(nc, H, B), Ly::THREADS, Ly::OUT_SMEM, st>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, u, ub, state, o, Tn,
      H, h, nc);
  return (int)cudaGetLastError();
}

// the chunk length of a head size: 64, or 32 at h > 64 (shared memory)
int chunk_of(int h) { return h > 64 ? 32 : 64; }

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const float* u, int ub, float* state, float* o, int B, int Tn,
             int H, int h, cudaStream_t st) {
  if (h <= 32)
    return launch<T, 32, 64>(r, k, v, w, u, ub, state, o, B, Tn, H, h, st);
  if (h <= 64)
    return launch<T, 64, 64>(r, k, v, w, u, ub, state, o, B, Tn, H, h, st);
  return launch<T, 128, 32>(r, k, v, w, u, ub, state, o, B, Tn, H, h, st);
}

}  // namespace

// Chunks of T at head size h: the scratch is (B, H, nparts, h, h) f32.
extern "C" int dp_wkv6_chunked_nparts(int T, int h) {
  return (T + chunk_of(h) - 1) / chunk_of(h);
}

// r, k, v, w (B,T,H,h) contiguous, 16-byte aligned, all f32 (bf16 == 0) or
// all bf16; u f32, (H,h) shared (ub == 0) or (B,H,h) per sample (ub == H h,
// its batch stride); state: scratch of (B, H, nparts(T, h), h, h) f32, whose
// chunk c >= 1 holds the state before chunk c when the call returns (the
// backward's saved tensor, csrc/wkv6_backward.cu; chunk 0 is not written);
// o (B,T,H,h) f32; h a multiple of 16 up to 128 (the wrapper checks).
extern "C" int dp_wkv6_chunked(const void* r, const void* k, const void* v,
                               const void* w, const float* u, int ub,
                               float* state, float* o, int B, int T, int H,
                               int h, int bf16, void* stream) {
  if (h < 16 || h > 128 || h % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(r, k, v, w, u, ub, state, o, B, T, H,
                                        h, st)
              : dispatch<float>(r, k, v, w, u, ub, state, o, B, T, H, h, st);
}
