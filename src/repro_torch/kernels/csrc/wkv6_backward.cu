// wkv6_backward: the gradients of the RWKV6 time-mix recurrence, exactly,
//
//     o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t          S_{-1} = 0, S (h,h) a head
//
// with S indexed [i = key channel, j = value channel]. Given do (B,T,H,h) f32,
// the inputs and the states the forward's pass 1 saved at each chunk start
// (wkv6_chunked.cu), it returns dr, dk, dv, dw (B,T,H,h) f32 and du (B,H,h)
// f32, per sample. Write dS_t for dL/dS_t (dS_{T-1} = 0):
//
//     dS_{t-1} = diag(w_t) dS_t + r_t^T do_t             (the reverse walk)
//     dr_t[i] = sum_j do_t[j] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
//     dk_t[i] = sum_j v_t[j] E_t[i,j],  dv_t[j] = sum_i k_t[i] E_t[i,j],
//               E_t[i,j] = dS_t[i,j] + u[i] r_t[i] do_t[j]
//     dw_t[i] = sum_j dS_t[i,j] S_{t-1}[i,j]
//     du[i]   = sum_t r_t[i] k_t[i] (v_t . do_t)
//
// It replaces no TPU kernel: the Pallas wkv6 (repro/kernels/wkv6.py) has no
// backward, and the JAX package trains rwkv6 through jnp autodiff of its
// recurrence (src/repro/models/rwkv6.py:200-206).
//
// Exactness. Nothing divides by a decay or a product of decays, and no
// factor is a difference of prefix sums of log w: dS is walked back token by
// token (one multiply by w_t, one add), and S_{t-1}, which dw_t needs beside
// dS_t, is recomputed forward from the saved chunk-start state. So any w in
// [0, 1] is exact to f32 rounding, w = 0 and 1 included, as the forward is.
//
// Design. One CTA per (block of 32 state columns, head, b), as the forward's
// pass 1 is cut: column j of S depends only on v[:, j] and column j of dS
// only on do[:, j], so the blocks are independent. 256 threads; thread (i,
// cg) owns row i and the 8 columns 8 cg .. 8 cg + 7 of the block, of S and
// of dS, in registers. Per chunk of 64 tokens (the forward's chunk): a walk
// forward from the saved state keeps the state at each sub-chunk start
// (every 8 tokens) in registers (the sub-chunk loops unrolled, so that they
// index it statically); then, sub-chunk by sub-chunk from the last, the 8
// states S_{t-1} are recomputed into shared memory (each thread its own
// elements) and the sub-chunk is walked in reverse. dr, dk, dw sum over a
// thread's 8 columns, then over the 4 threads of a row (xor shuffles); dv
// sums over the warp's 8 rows by a shuffle reduce-scatter and over the 8
// warps in shared memory, in warp order. The inputs come in 8 tokens at a
// time, f32 in shared memory, each sub-chunk's loaded into registers while
// the one before it is walked; rows past h and tokens past T are zero (w
// one), which leaves S and dS as they are. 86 KB of shared memory and at
// most 128 registers a thread: two CTAs an SM. A second pass adds the other
// column blocks' dr, dk, dw, du into the first's, in block order (h = 64:
// two blocks). Every sum runs in a fixed order and there are no float
// atomics: bitwise run to run. (The first version, with the starts in
// shared memory, one CTA an SM and no loads ahead, is
// kernels/designs/wkv6_backward_first.cu; design_study --only wkv_bwd times
// the two.)
//
// Bound on the H100 (train_rwkv: B=8, T=512, H=40, h=64, bf16 r, k, v, w):
// the inputs once (8 B an element), do (4 B) and the four f32 grads (16 B),
// and the saved chunk states (f32) read once, ~0.34 GB a layer, 0.100 ms at
// 3.35 TB/s; the arithmetic 6 h^2 f32 FMAs a token and head (the S and dS
// updates, dr, dk, dv, dw), 8.1 GFLOP a layer, 0.120 ms at 67 TFLOP/s:
// bound by operations. This kernel is far from it: the S update runs twice
// (the chunk walk and the sub-chunk recompute; 22 h^2 operations a token
// and head as written), the reductions cost about as many shuffles as the
// FMAs they reduce, the sequential walk leaves each warp little to overlap,
// and the second pass moves 9 f32 words an element again. PERF.md has its
// measured time. The products could go on the tensor cores in a chunked
// form (later work).
#include "common.cuh"

namespace {

constexpr int HM = 64;              // rows (key channels), h padded to 64
constexpr int JB = 32;              // state columns of a CTA
constexpr int C = 64;               // the forward's chunk for h <= 64
constexpr int TS = 8;               // tokens of a sub-chunk
constexpr int NQ = C / TS;          // sub-chunks of a chunk
constexpr int EPT = 8;              // columns a thread owns (of one row)
constexpr int NCG = JB / EPT;       // column groups: threads of a row
constexpr int THREADS = HM * NCG;   // 256
constexpr int NW = THREADS / 32;    // warps
// shared memory, in floats: the sub-chunk's states (thread-private:
// [slot][x][thread]), the staged inputs, dv's partials by warp, and the
// sub-chunk's dr, dk, dw
constexpr int SUBS = TS * EPT * THREADS;
constexpr int STAGE = TS * (3 * HM + 2 * JB);
constexpr int DVP = TS * NW * JB;
constexpr int OUTS = TS * 3 * HM;
constexpr int SMEM = (SUBS + STAGE + DVP + OUTS) * 4;
static_assert(2 * (SMEM + 1024) <= 233472, "two CTAs an SM");
static_assert(NCG == 4 && EPT == 8, "the reductions below are written for "
                                    "4 threads a row, 8 columns each");
static_assert(TS * HM == 2 * THREADS && TS * JB == THREADS,
              "a sub-chunk's rows of r, k, w are two a thread, of v, do one");

// 8 floats from 32-byte aligned shared memory
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w;
  o[4] = b.x, o[5] = b.y, o[6] = b.z, o[7] = b.w;
}

// One step of dv's reduce-scatter over lane bit M: the lanes with the bit
// set keep the upper HALF of x, the others the lower, each summed with its
// partner's copy.
template <int M, int HALF>
__device__ __forceinline__ void scatter_step(float (&x)[EPT], int lane) {
  const bool up = lane & M;
#pragma unroll
  for (int e = 0; e < HALF; ++e) {
    const float send = up ? x[e] : x[e + HALF];
    const float keep = up ? x[e + HALF] : x[e];
    x[e] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ w,
                    const float* __restrict__ u, int ub,
                    const float* __restrict__ dout,
                    const float* __restrict__ state, float* __restrict__ dr,
                    float* __restrict__ dk, float* __restrict__ dv,
                    float* __restrict__ dw, float* __restrict__ du,
                    float* __restrict__ part, int B, int Tn, int H, int h,
                    int nc) {
  extern __shared__ __align__(16) float smem[];
  float* subs = smem;
  float* sr = subs + SUBS;          // [TS][HM]
  float* sk = sr + TS * HM;
  float* sw = sk + TS * HM;
  float* sv = sw + TS * HM;         // [TS][JB]
  float* sdo = sv + TS * JB;
  float* dvp = sdo + TS * JB;       // [TS][NW][JB]
  float* outs = dvp + DVP;          // [TS][3][HM]: dr, dk, dw

  const int jb = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int i = tid / NCG, cg = tid % NCG, rw = (lane >> 2) & 7;
  const int j0 = jb * JB, jc = cg * EPT;   // the block's, the thread's first
  const bool row_ok = i < h, cols_ok = j0 + jc < h;   // h % 16 == 0
  const long long rows = (long long)H * h;
  const long long base = (long long)b * Tn * rows + (long long)head * h;
  const long long n = (long long)B * Tn * rows;
  // block 0 writes dr, dk, dw, du; block jb > 0 its partials, which the
  // second pass adds in
  float* o_dr = jb == 0 ? dr : part + (jb - 1) * 3 * n;
  float* o_dk = jb == 0 ? dk : o_dr + n;
  float* o_dw = jb == 0 ? dw : o_dr + 2 * n;
  float* o_du = jb == 0 ? du : part + (gridDim.x - 1) * 3 * n +
                                   (long long)(jb - 1) * B * rows;
  const float ui = row_ok ? u[(long long)b * ub + head * h + i] : 0.f;

  // A sub-chunk's inputs (tokens t0 .. t0 + TS - 1), this thread's share:
  // rows tid and tid + THREADS of TS x HM for r, k, w, row tid of TS x JB
  // for v, do (`all`: r and do too). fetch loads them into registers, raw;
  // stage writes them to shared memory as f32, zero past T and h (w one).
  T fr[2] = {}, fk[2] = {}, fw[2] = {}, fv = {};
  float fd = 0.f;
  auto fetch = [&](int t0, bool all) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int e = tid + a * THREADS, t = t0 + e / HM, ch = e % HM;
      if (t < Tn && ch < h) {
        const long long off = base + (long long)t * rows + ch;
        fk[a] = k[off];
        fw[a] = w[off];
        if (all) fr[a] = r[off];
      }
    }
    const int t = t0 + tid / JB, j = j0 + tid % JB;
    if (t < Tn && j < h) {
      const long long off = base + (long long)t * rows + j;
      fv = v[off];
      if (all) fd = dout[off];
    }
  };
  auto stage = [&](int t0, bool all) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int e = tid + a * THREADS, t = t0 + e / HM, ch = e % HM;
      const bool ok = t < Tn && ch < h;
      sk[e] = ok ? to_f32(fk[a]) : 0.f;
      sw[e] = ok ? to_f32(fw[a]) : 1.f;
      if (all) sr[e] = ok ? to_f32(fr[a]) : 0.f;
    }
    const int t = t0 + tid / JB, j = j0 + tid % JB;
    const bool ok = t < Tn && j < h;
    sv[tid] = ok ? to_f32(fv) : 0.f;
    if (all) sdo[tid] = ok ? fd : 0.f;
  };

  float G[EPT];          // dS_t of the token being walked, row i
  float du_acc = 0.f;
#pragma unroll
  for (int x = 0; x < EPT; ++x) G[x] = 0.f;

  fetch((nc - 1) * C, false);
  for (int c = nc - 1; c >= 0; --c) {
    // ---- the state before chunk c: zero, or what the forward saved
    float S[EPT], st[NQ][EPT];
    const float* s0 = state + (((long long)b * H + head) * nc + c) * h * h +
                      (long long)i * h + j0 + jc;
#pragma unroll
    for (int x = 0; x < EPT; ++x)
      S[x] = c > 0 && row_ok && cols_ok ? s0[x] : 0.f;

    // ---- forward over the chunk: the state at each sub-chunk start; the
    // last fetch is the backward's first sub-chunk, r and do too
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
#pragma unroll
      for (int x = 0; x < EPT; ++x) st[q][x] = S[x];
      __syncthreads();   // the stage's readers are done
      stage(c * C + q * TS, false);
      __syncthreads();
      fetch(c * C + (q + 1 < NQ ? q + 1 : q) * TS, q + 1 == NQ);
      for (int tt = 0; tt < TS; ++tt) {
        const float kk = sk[tt * HM + i], ww = sw[tt * HM + i];
        float vx[EPT];
        load8(sv + tt * JB + jc, vx);
#pragma unroll
        for (int x = 0; x < EPT; ++x) S[x] = fmaf(ww, S[x], kk * vx[x]);
      }
    }

    // ---- backward over the chunk, sub-chunk by sub-chunk from the last;
    // each fetches the one before it (the first the next chunk's start)
#pragma unroll
    for (int q = NQ - 1; q >= 0; --q) {
      const int t0 = c * C + q * TS;
      __syncthreads();   // the stage, dv's partials and outs are read
      stage(t0, true);
      __syncthreads();
      if (q > 0)
        fetch(t0 - TS, true);
      else if (c > 0)
        fetch((c - 1) * C, false);
      // the sub-chunk's states S_{t-1}, recomputed from its start
#pragma unroll
      for (int x = 0; x < EPT; ++x) S[x] = st[q][x];
      for (int tt = 0; tt < TS; ++tt) {
        const float kk = sk[tt * HM + i], ww = sw[tt * HM + i];
        float vx[EPT];
        load8(sv + tt * JB + jc, vx);
#pragma unroll
        for (int x = 0; x < EPT; ++x) {
          subs[(tt * EPT + x) * THREADS + tid] = S[x];
          S[x] = fmaf(ww, S[x], kk * vx[x]);
        }
      }
      // the reverse walk: G holds dS_t on entry to token t
      for (int tt = TS - 1; tt >= 0; --tt) {
        const float rr = sr[tt * HM + i], kk = sk[tt * HM + i];
        const float ww = sw[tt * HM + i];
        const float ur = ui * rr, uk = ui * kk;
        float vx[EPT], dx[EPT];
        load8(sv + tt * JB + jc, vx);
        load8(sdo + tt * JB + jc, dx);
        float pr = 0.f, pk = 0.f, pw = 0.f, vdo = 0.f, dvv[EPT];
#pragma unroll
        for (int x = 0; x < EPT; ++x) {
          const float sp = subs[(tt * EPT + x) * THREADS + tid];
          const float e = fmaf(ur, dx[x], G[x]);   // E_t[i, j]
          pr = fmaf(dx[x], fmaf(uk, vx[x], sp), pr);
          pk = fmaf(vx[x], e, pk);
          pw = fmaf(G[x], sp, pw);
          vdo = fmaf(vx[x], dx[x], vdo);
          dvv[x] = kk * e;
          G[x] = fmaf(ww, G[x], rr * dx[x]);      // dS_{t-1}
        }
        du_acc = fmaf(rr * kk, vdo, du_acc);
        // dr, dk, dw: over the row's 4 threads (lanes 4 rw + cg)
#pragma unroll
        for (int m = 1; m < NCG; m <<= 1) {
          pr += __shfl_xor_sync(0xffffffffu, pr, m);
          pk += __shfl_xor_sync(0xffffffffu, pk, m);
          pw += __shfl_xor_sync(0xffffffffu, pw, m);
        }
        if (cg < 3) outs[(tt * 3 + cg) * HM + i] = cg == 0 ? pr
                                                   : cg == 1 ? pk : pw;
        // dv: over the warp's 8 rows (lane bits 2..4), reduce-scatter: lane
        // (rw, cg) ends with column jc + rw
        scatter_step<16, 4>(dvv, lane);
        scatter_step<8, 2>(dvv, lane);
        scatter_step<4, 1>(dvv, lane);
        dvp[(tt * NW + wp) * JB + jc + rw] = dvv[0];
      }
      __syncthreads();
      // ---- the sub-chunk's outputs: dv (the warps' partials in warp
      // order), and dr, dk, dw of this column block
      {
        const int tt = tid / JB, jl = tid % JB, t = t0 + tt, j = j0 + jl;
        float s = 0.f;
#pragma unroll
        for (int x = 0; x < NW; ++x) s += dvp[(tt * NW + x) * JB + jl];
        if (t < Tn && j < h) dv[base + (long long)t * rows + j] = s;
      }
      for (int e = tid; e < TS * 3 * HM; e += THREADS) {
        const int tt = e / (3 * HM), which = (e / HM) % 3, ch = e % HM;
        const int t = t0 + tt;
        if (t < Tn && ch < h) {
          float* o = which == 0 ? o_dr : which == 1 ? o_dk : o_dw;
          o[base + (long long)t * rows + ch] = outs[e];
        }
      }
    }
  }
  // ---- du over the row's 4 threads
#pragma unroll
  for (int m = 1; m < NCG; m <<= 1)
    du_acc += __shfl_xor_sync(0xffffffffu, du_acc, m);
  if (cg == 0 && row_ok)
    o_du[((long long)b * H + head) * h + i] = du_acc;
}

// dr, dk, dw (n elements each) and du (nu) += the other column blocks'
// partials, in block order
__global__ void wkv6_bwd_sum_kernel(float* __restrict__ dr,
                                    float* __restrict__ dk,
                                    float* __restrict__ dw,
                                    float* __restrict__ du,
                                    const float* __restrict__ part,
                                    long long n, long long nu, int np) {
  const float* pdu = part + np * 3 * n;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < 3 * n + nu; e += (long long)gridDim.x * blockDim.x) {
    if (e < 3 * n) {
      const long long a = e / n, x = e % n;
      float* o = a == 0 ? dr : a == 1 ? dk : dw;
      float s = o[x];
      for (int p = 0; p < np; ++p) s += part[(p * 3 + a) * n + x];
      o[x] = s;
    } else {
      const long long x = e - 3 * n;
      float s = du[x];
      for (int p = 0; p < np; ++p) s += pdu[p * nu + x];
      du[x] = s;
    }
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, int ub, const float* dout, const float* state,
           float* dr, float* dk, float* dv, float* dw, float* du, float* part,
           int B, int Tn, int H, int h, cudaStream_t st) {
  const int nb = (h + JB - 1) / JB, nc = (Tn + C - 1) / C;
  auto kern = wkv6_bwd_kernel<T>;
  int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err) return err;
  kern<<<dim3(nb, H, B), THREADS, SMEM, st>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, u, ub, dout, state,
      dr, dk, dv, dw, du, part, B, Tn, H, h, nc);
  err = (int)cudaGetLastError();
  if (err || nb == 1) return err;
  const long long n = (long long)B * Tn * H * h, nu = (long long)B * H * h;
  const long long blocks = (3 * n + nu + 255) / 256;
  wkv6_bwd_sum_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(
      dr, dk, dw, du, part, n, nu, nb - 1);
  return (int)cudaGetLastError();
}

}  // namespace

// Column blocks of head size h: the partials scratch holds nparts(h) - 1 of
// them, (3 (B,T,H,h) + (B,H,h)) f32 each.
extern "C" int dp_wkv6_backward_nparts(int h) { return (h + JB - 1) / JB; }

// r, k, v, w (B,T,H,h) contiguous, all f32 (bf16 == 0) or all bf16; u f32,
// (H,h) shared (ub == 0) or (B,H,h) per sample (ub == H h); dout (B,T,H,h)
// f32; state: the (B, H, ceil(T / 64), h, h) f32 scratch of the forward's
// dp_wkv6_chunked call on the same inputs (chunk c >= 1 read); dr, dk, dv,
// dw (B,T,H,h) f32 and du (B,H,h) f32 out, du per sample whatever u's
// layout; part: the partials scratch (nparts(h) > 1); h a multiple of 16 up
// to 64 (the wrapper checks).
extern "C" int dp_wkv6_backward(const void* r, const void* k, const void* v,
                                const void* w, const float* u, int ub,
                                const float* dout, const float* state,
                                float* dr, float* dk, float* dv, float* dw,
                                float* du, float* part, int B, int T, int H,
                                int h, int bf16, void* stream) {
  if (h < 16 || h > HM || h % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(r, k, v, w, u, ub, dout, state, dr, dk,
                                      dv, dw, du, part, B, T, H, h, st)
              : launch<float>(r, k, v, w, u, ub, dout, state, dr, dk, dv, dw,
                              du, part, B, T, H, h, st);
}
