// flash_attention: causal or bidirectional GQA attention with an online
// softmax, no (T,S) matrix in device memory,
//
//   o[b,t,n] = sum_s softmax_s(q[b,t,n] . k[b,s,n/G] / sqrt(h)) v[b,s,n/G]
//
// q (B,T,H,h), k/v (B,S,K,h) with H = K*G, f32 or bf16 -> o (B,T,H,h) in q's
// dtype. Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention (the serving prefill kernel). Its masking is kept: scale
// 1/sqrt(h), masked logits -1e30, causal mask qpos >= kpos with both counted
// from 0, output divided by max(l, 1e-30); the probabilities stay f32 up to
// the P.V product. The Pallas grid carries (m, l, acc) in VMEM across a
// sequential KV grid dimension; here one CTA owns one (b, head, 64-query
// tile) and loops over 64-key tiles inside the block, with (m, l, acc) in
// registers. The KV head is head / G, so K and V are never replicated. T and
// S need not be multiples of a tile: keys past S take probability 0 and rows
// past T are not written. Causal CTAs stop at the diagonal and are launched
// longest first.
//
// Bound on the H100: 4 B H T S h / 2 operations (causal) against the bytes of
// q, k, v and o — at qwen2-1.5b's prefill (B=4, T=S=4096, H=12, K=2, h=128)
// 206 GFLOP against 151 MB per layer, so it is compute-bound. This kernel
// runs both products on the f32 SIMT cores: 256 threads, each with a 4 x 4
// tile of S = QK^T and a 4 x 8 tile of the output, q^T, k^T, v and P^T
// staged in shared memory as f32. It serves f32 inputs and head sizes other
// than 64 and 128; bf16 with h = 64 or 128 (the prefill) takes
// flash_attention_wgmma.cu (tensor cores, TMA). The reduction order is
// fixed: bitwise run to run.
#include "common.cuh"

namespace {

constexpr int BQ = 64;        // queries per CTA
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 256;  // 16 x 16: rows ty*4.., keys / columns tx*4..
constexpr int HMAX = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void load8(const float* p, float x[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float x[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* p, const float x[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float x[4]) {
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(p);
  h2[0] = __floats2bfloat162_rn(x[0], x[1]);
  h2[1] = __floats2bfloat162_rn(x[2], x[3]);
}

// Rows r0 .. r0+63 of a (rows, stride) record, h columns from base, into
// dst[c * 64 + r] (transposed, times s): a thread takes 8 columns of one row,
// neighbouring threads neighbouring rows, so the stores hit 32 banks.
template <typename T>
__device__ __forceinline__ void stage_t(float* dst, const T* __restrict__ base,
                                        long long stride, int r0, int rows,
                                        int h, float s) {
  const int nc = h / 8;
  for (int e = threadIdx.x; e < 64 * nc; e += THREADS) {
    const int r = e % 64, c = (e / 64) * 8;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r0 + r < rows) load8(base + (r0 + r) * stride + c, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(c + i) * 64 + r] = x[i] * s;
  }
}

// The same rows kept row-major, dst[r * h + c]: neighbouring threads read
// neighbouring columns of a row (coalesced).
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const T* __restrict__ base,
                                           long long stride, int r0, int rows,
                                           int h) {
  const int nc = h / 8;
  for (int e = threadIdx.x; e < 64 * nc; e += THREADS) {
    const int r = e / nc, c = (e % nc) * 8;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r0 + r < rows) load8(base + (r0 + r) * stride + c, x);
    store4(dst + r * h + c, x);
    store4(dst + r * h + c + 4, x + 4);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int Tq, int S, int H, int K, int h, int causal,
                           float scale) {
  extern __shared__ float smem[];
  float* qt = smem;              // [h][BQ]  q^T * scale
  float* kt = qt + h * BQ;       // [h][BKV] k^T
  float* vs = kt + h * BKV;      // [BKV][h]
  float* pt = vs + BKV * h;      // [BKV][BQ] P^T

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nq = gridDim.x;
  const int q0 = (causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x) * BQ;
  const int head = blockIdx.y, b = blockIdx.z, kvh = head / (H / K);
  const long long qs = (long long)H * h, ks = (long long)K * h;
  const T* qb = q + (long long)b * Tq * qs + (long long)head * h;
  const T* kb = k + (long long)b * S * ks + (long long)kvh * h;
  const T* vb = v + (long long)b * S * ks + (long long)kvh * h;

  stage_t(qt, qb, qs, q0, Tq, h, scale);

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  const int kend = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kend; k0 += BKV) {
    __syncthreads();  // the previous tile's readers of kt, vs, pt are done
    stage_t(kt, kb, ks, k0, S, h, 1.f);
    stage_rows(vs, vb, ks, k0, S, h);
    __syncthreads();

    // s = (q * scale) k^T: rows ty*4+i, keys tx*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < h; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(qt + c * BQ + ty * 4);
      const float4 kk =
          *reinterpret_cast<const float4*>(kt + c * BKV + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], kv[j], s[i][j]);
    }

    // online softmax; a row's 64 keys lie in the 16 lanes of a half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        if (causal && qpos < kpos) s[i][j] = NEG_INF;
        if (kpos < S) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // keys past S take no probability at all (the ragged edge)
        s[i][j] = (k0 + tx * 4 + j < S) ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float pj[4] = {s[0][j], s[1][j], s[2][j], s[3][j]};
      store4(pt + (tx * 4 + j) * BQ + ty * 4, pj);
    }
    __syncthreads();

    // acc += P v: rows ty*4+i, columns cc*64 + tx*4 + e (cc = 0, 1)
    const int nk = min(BKV, S - k0);
#pragma unroll 2
    for (int j = 0; j < nk; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(pt + j * BQ + ty * 4);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int c = cc * 64 + tx * 4;
        if (c < h) {
          const float4 w = *reinterpret_cast<const float4*>(vs + j * h + c);
          const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][cc * 4 + e] = fmaf(pv[i], wv[e], acc[i][cc * 4 + e]);
        }
      }
    }
  }

  // o = acc / max(l, 1e-30), in q's dtype
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= Tq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + ((long long)b * Tq + t) * qs + (long long)head * h;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = cc * 64 + tx * 4;
      if (c < h) {
        const float x[4] = {acc[i][cc * 4] * inv, acc[i][cc * 4 + 1] * inv,
                            acc[i][cc * 4 + 2] * inv,
                            acc[i][cc * 4 + 3] * inv};
        store4(orow + c, x);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Tq,
           int S, int H, int K, int h, int causal, cudaStream_t st) {
  const size_t smem = (size_t)(2 * h * BQ + BKV * h + BKV * BQ) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T><<<grid, THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Tq, S, H, K, h, causal,
      1.f / sqrtf((float)h));
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,T,H,h), k/v (B,S,K,h), o (B,T,H,h), contiguous and 16-byte aligned,
// all f32 (bf16 == 0) or all bf16; H a multiple of K; h a multiple of 8, at
// most 128 (the wrapper checks).
extern "C" int dp_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int T, int S, int H, int K,
                                  int h, int causal, int bf16, void* stream) {
  if (h > HMAX || h % 8 || H % K) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(q, k, v, o, B, T, S, H, K, h, causal, st)
              : launch<float>(q, k, v, o, B, T, S, H, K, h, causal, st);
}
