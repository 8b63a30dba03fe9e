// emb_clipped_grad: the clip-weighted gradient of an embedding lookup,
//
//     G_l[v] = sum_b C_b sum_t 1[id_lbt == v] g_lbt        -> (L, V, d) f32
//
// Replaces the TPU kernel repro/kernels/emb_grad.py::emb_clipped_grad. The
// Pallas kernel contracts a (T, bv) one-hot against the cotangents for every
// vocab tile; at V=151936 and B*T=4096 that would be ~1.9 PFLOP, so it is not
// carried over.
//
// Bound on the H100: the (L, V, d) f32 output write, 933 MB per step at
// qwen2-1.5b's vocab (0.28 ms at 3.35 TB/s), against 12.6 MB of cotangents
// read: a store-bound pass, in which ~97% of the rows no id hits. So the
// zeros are written the way a fill writes them, and little is spent beyond:
//
//   a pre-pass, one CTA per layer, marks the rows some id hits in a bitmap
//     (V bits: 19 KB at qwen2-1.5b's vocab, built in shared memory and
//     written to a scratch tensor);
//   the store pass gives each (layer, row) a short CTA of 128 threads, in
//     row order, as a fill's blocks are: a row the bitmap does not mark is
//     written as 16-byte streaming stores of zeros (st.global.cs.v4); for a
//     marked row the CTA's four warps find its ids by ballots, each over a
//     quarter of the layer's ids, in k order (k = b T + t), and the CTA
//     writes the sum of C_b g_k over them in that order, by fmaf in f32
//     from 0, each thread a share of the columns.
//
// Why so, on the H100 (repro_torch.kernels.design_study times the other
// designs beside this one): a sort of the ids by one CTA, to find each
// row's run by binary search (designs/emb_grad_sorted.cu), costs a sixth
// of the bound in series before the stores, and its store pass is slower
// both with a CTA a row and with long-lived CTAs of 128 rows; one warp
// scanning all the ids of a marked row is a little slower than four. This
// pass stays ~9% above a plain fill of the output, most likely by the
// marked rows' reads of their cotangent rows amid the write stream.
//
// Ids outside [0, V) match no row and are dropped. The sum of each element
// is the same chain of fmaf as in the first version of this kernel (which
// scanned the ids by ballots for every row), so the output is bitwise what
// it was, and the same run to run. Every output element is written exactly
// once, with no float atomics.
#include "common.cuh"

namespace {

constexpr int MARK_THREADS = 1024;
constexpr int WARPS = 4;            // warps of a row's CTA
constexpr int THREADS = 32 * WARPS;
constexpr int NV = 3;               // 16-byte vectors a thread sums a pass
constexpr int PER_THREAD = 8;       // (scalar rows) columns a thread sums
constexpr int UNROLL = 8;           // id loads a lane keeps in flight
constexpr int CAP = 64;             // a warp's list of a row's ids
// shared memory: a block's 227 KB hold the bitmap of up to 1.86 M rows
constexpr int MAX_SMEM = 227 * 1024;

__host__ __device__ inline int words_of(int V) { return (V + 31) / 32; }

// The rows of layer blockIdx.x that its ids hit: bits (L, words_of(V)),
// built in shared memory.
__global__ void __launch_bounds__(MARK_THREADS)
    emb_grad_mark_kernel(const int* __restrict__ ids,
                         unsigned* __restrict__ bits, int BT, int V) {
  extern __shared__ unsigned hit[];
  const int words = words_of(V), l = blockIdx.x;
  const int* idl = ids + (long long)l * BT;
  for (int i = threadIdx.x; i < words; i += MARK_THREADS) hit[i] = 0u;
  __syncthreads();
  for (int k = threadIdx.x; k < BT; k += MARK_THREADS) {
    const int id = idl[k];
    if (id >= 0 && id < V) atomicOr(&hit[id / 32], 1u << (id % 32));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < words; i += MARK_THREADS)
    bits[(long long)l * words + i] = hit[i];
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 x = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 y = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(x.x, x.y, y.x, y.y);
}

// The sum of a marked row over k = at(0), at(1), ... at(n - 1), ascending,
// those that ``keep`` (every thread of the block takes the same k):
// thread t sums column vectors t + 128 i (VEC: 16-byte vectors of 4
// columns; else single columns), each the fmaf chain of C_b g_k, from 0.
template <typename T, bool VEC, typename At, typename Keep>
__device__ __forceinline__ void sum_row(float* __restrict__ orow,
                                        const T* __restrict__ g,
                                        const float* __restrict__ C, int Tn,
                                        int d, int n, At at, Keep keep) {
  constexpr int W = VEC ? 4 : 1;               // columns a vector
  constexpr int N = VEC ? NV : PER_THREAD;     // vectors a thread a pass
  const int dv = d / W;
  for (int c0 = 0; c0 < dv; c0 += THREADS * N) {
    float acc[N][W];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < W; ++j) acc[i][j] = 0.f;
    for (int q = 0; q < n; ++q) {
      const int k = at(q);
      if (!keep(k)) continue;
      const float cb = __ldg(C + k / Tn);
      const T* gk = g + (long long)k * d;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int c = c0 + threadIdx.x + THREADS * i;
        if (c < dv) {
          if constexpr (VEC) {
            const float4 x = load4(gk + 4 * c);
            acc[i][0] = fmaf(cb, x.x, acc[i][0]);
            acc[i][1] = fmaf(cb, x.y, acc[i][1]);
            acc[i][2] = fmaf(cb, x.z, acc[i][2]);
            acc[i][3] = fmaf(cb, x.w, acc[i][3]);
          } else {
            acc[i][0] = fmaf(cb, to_f32(gk[c]), acc[i][0]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = c0 + threadIdx.x + THREADS * i;
      if (c >= dv) continue;
      if constexpr (VEC)
        __stcs(reinterpret_cast<float4*>(orow) + c,
               make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      else
        __stcs(orow + c, acc[i][0]);
    }
  }
}

// Row blockIdx.x of layer blockIdx.y. A marked row's ids are found by the
// block's warps together, each by ballots over a quarter of the layer's
// ids (UNROLL loads a lane in flight), each quarter's in k order into a
// list of its own; past CAP a quarter, the row is summed from one ordered
// ballot scan of all the ids instead (the same k order).
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    emb_grad_kernel(const int* __restrict__ ids,
                    const unsigned* __restrict__ bits,
                    const float* __restrict__ C, const T* __restrict__ ds,
                    float* __restrict__ out, int B, int Tn, int d, int V) {
  __shared__ int list[WARPS][CAP];
  __shared__ int count[WARPS];
  const int v = blockIdx.x, l = blockIdx.y, BT = B * Tn;
  float* orow = out + ((long long)l * V + v) * d;
  const T* g = ds + (long long)l * BT * d;
  if (!(__ldg(bits + (long long)l * words_of(V) + v / 32) >> (v % 32) & 1u)) {
    if constexpr (VEC) {
      float4* o4 = reinterpret_cast<float4*>(orow);
      for (int c = threadIdx.x; c < d / 4; c += THREADS)
        __stcs(o4 + c, make_float4(0.f, 0.f, 0.f, 0.f));
    } else {
      for (int c = threadIdx.x; c < d; c += THREADS) __stcs(orow + c, 0.f);
    }
    return;
  }
  const int* idl = ids + (long long)l * BT;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int quarter = (BT + 32 * WARPS - 1) / (32 * WARPS) * 32;
  const int k1 = min(BT, (warp + 1) * quarter);
  int n = 0;
  for (int k0 = warp * quarter; k0 < k1; k0 += 32 * UNROLL) {
    unsigned m[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = k0 + 32 * u + lane;
      m[u] = __ballot_sync(0xffffffffu, k < k1 && __ldg(idl + k) == v);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int at = n + __popc(m[u] & ((1u << lane) - 1u));
      if ((m[u] >> lane & 1u) && at < CAP) list[warp][at] = k0 + 32 * u + lane;
      n += __popc(m[u]);
    }
  }
  if (lane == 0) count[warp] = n;
  __syncthreads();
  int total = 0;
  bool over = false;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    total += count[w];
    over = over || count[w] > CAP;
  }
  if (!over)   // the quarters' lists one after the other
    sum_row<T, VEC>(
        orow, g, C, Tn, d, total,
        [&](int q) {
          int w = 0;
          while (q >= count[w]) q -= count[w++];
          return list[w][q];
        },
        [](int) { return true; });
  else         // every k of the layer in order, the row's kept
    sum_row<T, VEC>(
        orow, g, C, Tn, d, BT, [](int q) { return q; },
        [&](int k) { return __ldg(idl + k) == v; });
}

template <typename T>
int launch(const int* ids, const unsigned* bits, const float* C,
           const void* ds, float* out, int L, int B, int T_, int d, int V,
           cudaStream_t st) {
  const dim3 grid(V, L);
  // 16-byte rows: d a multiple of 4 (out's rows are then 16-byte aligned)
  if (d % 4 == 0 && (uintptr_t)out % 16 == 0 &&
      (uintptr_t)ds % (4 * sizeof(T)) == 0)
    emb_grad_kernel<T, true><<<grid, THREADS, 0, st>>>(
        ids, bits, C, (const T*)ds, out, B, T_, d, V);
  else
    emb_grad_kernel<T, false><<<grid, THREADS, 0, st>>>(
        ids, bits, C, (const T*)ds, out, B, T_, d, V);
  return (int)cudaGetLastError();
}

// The pre-pass may take up to MAX_SMEM of shared memory: allowed once a
// device (a per-launch cudaFuncSetAttribute is host work the launch does
// not need).
int allow_mark_smem() {
  static unsigned done = 0u;   // a bit a device
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 32 && (done >> dev & 1u)) return 0;
  err = (int)cudaFuncSetAttribute(emb_grad_mark_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  MAX_SMEM);
  if (!err && dev < 32) done |= 1u << dev;
  return err;
}

}  // namespace

// Shared memory of the pre-pass for a vocabulary of V rows: its bitmap
// (the wrapper refuses more than a block holds).
extern "C" int dp_emb_grad_smem_bytes(int V) {
  return words_of(V) * (int)sizeof(unsigned);
}

// int32 elements of the scratch a layer: the bitmap.
extern "C" int dp_emb_grad_scratch_ints(int V) { return words_of(V); }

// ids (L,B,T) int32, C (B,) f32, ds (L,B,T,d) f32 (bf16 == 0) or bf16,
// contiguous; scratch: L * scratch_ints(V) int32 (written by the pre-pass,
// read by the store pass: one buffer may serve every call on a stream);
// out (L,V,d) f32, every element written.
extern "C" int dp_emb_grad(const int* ids, const float* C, const void* ds,
                           int* scratch, float* out, int L, int B, int T,
                           int d, int V, int bf16, void* stream) {
  const int smem = dp_emb_grad_smem_bytes(V);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int err = smem > 48 * 1024 ? allow_mark_smem() : 0;
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* bits = reinterpret_cast<unsigned*>(scratch);
  emb_grad_mark_kernel<<<L, MARK_THREADS, smem, st>>>(ids, bits, B * T, V);
  err = (int)cudaGetLastError();
  if (err) return err;
  return bf16 ? launch<__nv_bfloat16>(ids, bits, C, ds, out, L, B, T, d, V,
                                      st)
              : launch<float>(ids, bits, C, ds, out, L, B, T, d, V, st);
}
