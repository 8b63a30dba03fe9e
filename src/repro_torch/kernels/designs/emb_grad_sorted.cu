// emb_clipped_grad as a sorted pass: a design that csrc/emb_grad.cu does
// not take, kept so that the comparison can be run again
// (``python -m repro_torch.kernels.design_study --only emb``). Not part of
// the kernel library.
//
//     G_l[v] = sum_b C_b sum_t 1[id_lbt == v] g_lbt        -> (L, V, d) f32
//
//   a pre-pass, one CTA per layer, sorts the layer's keys (id << 32 | k) by
//     a bitonic network in shared memory (ids outside [0, V) sort last, as
//     INT_MAX) and writes the sorted ids and their k to a scratch tensor;
//   the store pass finds each row's run of ids by binary search and writes
//     the sum of C_b g_k over it, in k order, by fmaf in f32 from 0 (the
//     chain of emb_grad.cu, so the output is bitwise the same): a row with
//     no id is written as 16-byte streaming stores of zeros. Two shapes of
//     that pass: one CTA of 128 threads a row (``long_lived`` 0), or CTAs of
//     128 rows, each warp writing 32 of them in turn (``long_lived`` 1).
//
// Takes d a multiple of 4 with 16-byte aligned rows only.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int SORT_THREADS = 1024;
constexpr int MAX_KEYS = 16384;   // 128 KB of 64-bit keys
constexpr int THREADS = 128;
constexpr int ROWS = 128;         // rows of a long-lived CTA

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

int next_pow2(int n) {
  int m = 1;
  while (m < n) m <<= 1;
  return m;
}

// scratch of layer blockIdx.x: [0, BT) the ids sorted, [BT, 2 BT) their k.
__global__ void __launch_bounds__(SORT_THREADS)
    sort_kernel(const int* __restrict__ ids, int* __restrict__ scratch,
                int BT, int n2, int V) {
  extern __shared__ unsigned long long key[];
  const int* idl = ids + (long long)blockIdx.x * BT;
  int* sid = scratch + (long long)blockIdx.x * 2 * BT;
  for (int k = threadIdx.x; k < n2; k += SORT_THREADS) {
    const int id = k < BT ? idl[k] : -1;
    key[k] = id >= 0 && id < V
                 ? (unsigned long long)id << 32 | (unsigned)k
                 : ~0ull;
  }
  __syncthreads();
  for (int size = 2; size <= n2; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n2; i += SORT_THREADS) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long x = key[i], y = key[j];
          if ((x > y) == ((i & size) == 0)) {
            key[i] = y;
            key[j] = x;
          }
        }
      }
      __syncthreads();
    }
  for (int k = threadIdx.x; k < BT; k += SORT_THREADS) {
    const unsigned long long x = key[k];
    sid[k] = x == ~0ull ? INT_MAX : (int)(x >> 32);
    sid[BT + k] = (int)(x & 0xffffffffu);
  }
}

// the first q in [0, n) with s[q] >= v (n if none)
__device__ __forceinline__ int lower_bound(const int* __restrict__ s, int n,
                                           int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (__ldg(s + m) < v)
      lo = m + 1;
    else
      hi = m;
  }
  return lo;
}

// Row v of layer l by the threads lane0, lane0 + step, ... (16-byte
// column vectors): the run [lo, hi) of the sorted ids, in k order.
template <typename T>
__device__ __forceinline__ void write_row(const int* __restrict__ sk,
                                          int lo, int hi,
                                          const float* __restrict__ C,
                                          const T* __restrict__ g,
                                          float* __restrict__ orow, int Tn,
                                          int d, int lane0, int step) {
  float4* o4 = reinterpret_cast<float4*>(orow);
  for (int c = lane0; c < d / 4; c += step) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = lo; q < hi; ++q) {
      const int k = __ldg(sk + q);
      const float cb = __ldg(C + k / Tn);
      const float4 x = load4(g + (long long)k * d + 4 * c);
      acc.x = fmaf(cb, x.x, acc.x);
      acc.y = fmaf(cb, x.y, acc.y);
      acc.z = fmaf(cb, x.z, acc.z);
      acc.w = fmaf(cb, x.w, acc.w);
    }
    __stcs(o4 + c, acc);
  }
}

// One CTA a row: row blockIdx.x of layer blockIdx.y.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    rows_kernel(const int* __restrict__ scratch, const float* __restrict__ C,
                const T* __restrict__ ds, float* __restrict__ out, int B,
                int Tn, int d, int V) {
  const int v = blockIdx.x, l = blockIdx.y, BT = B * Tn;
  const int* sid = scratch + (long long)l * 2 * BT;
  const int lo = lower_bound(sid, BT, v);
  const int hi = lo + lower_bound(sid + lo, BT - lo, v + 1);
  write_row<T>(sid + BT, lo, hi, C, ds + (long long)l * BT * d,
               out + ((long long)l * V + v) * d, Tn, d, threadIdx.x,
               THREADS);
}

// Long-lived CTAs: ROWS rows a CTA, warp w writing rows 32 w .. 32 w + 31
// of them in turn.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    long_kernel(const int* __restrict__ scratch, const float* __restrict__ C,
                const T* __restrict__ ds, float* __restrict__ out, int B,
                int Tn, int d, int V) {
  const int l = blockIdx.y, BT = B * Tn, lane = threadIdx.x % 32;
  const int* sid = scratch + (long long)l * 2 * BT;
  const int v0 = blockIdx.x * ROWS + threadIdx.x / 32 * 32;
  for (int v = v0; v < v0 + 32 && v < V; ++v) {
    const int lo = lower_bound(sid, BT, v);
    const int hi = lo + lower_bound(sid + lo, BT - lo, v + 1);
    write_row<T>(sid + BT, lo, hi, C, ds + (long long)l * BT * d,
                 out + ((long long)l * V + v) * d, Tn, d, lane, 32);
  }
}

template <typename T>
int launch(const int* scratch, const float* C, const void* ds, float* out,
           int L, int B, int T_, int d, int V, int long_lived,
           cudaStream_t st) {
  if (long_lived)
    long_kernel<T><<<dim3((V + ROWS - 1) / ROWS, L), THREADS, 0, st>>>(
        scratch, C, (const T*)ds, out, B, T_, d, V);
  else
    rows_kernel<T><<<dim3(V, L), THREADS, 0, st>>>(scratch, C, (const T*)ds,
                                                    out, B, T_, d, V);
  return (int)cudaGetLastError();
}

}  // namespace

// int32 elements of the scratch: L * 2 B T.
extern "C" int dp_emb_sorted_scratch_ints(int L, int B, int T) {
  return L * 2 * B * T;
}

// ids (L,B,T) int32, C (B,) f32, ds (L,B,T,d) f32 (bf16 == 0) or bf16,
// contiguous, d a multiple of 4; out (L,V,d) f32, every element written.
extern "C" int dp_emb_grad_sorted(const int* ids, const float* C,
                                  const void* ds, int* scratch, float* out,
                                  int L, int B, int T, int d, int V, int bf16,
                                  int long_lived, void* stream) {
  const int n2 = next_pow2(B * T);
  if (n2 > MAX_KEYS || d % 4 || (uintptr_t)out % 16 ||
      (uintptr_t)ds % (bf16 ? 8 : 16))
    return (int)cudaErrorInvalidValue;
  const int smem = n2 * (int)sizeof(unsigned long long);
  int err = (int)cudaFuncSetAttribute(
      sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  sort_kernel<<<L, SORT_THREADS, smem, st>>>(ids, scratch, B * T, n2, V);
  err = (int)cudaGetLastError();
  if (err) return err;
  return bf16 ? launch<__nv_bfloat16>(scratch, C, ds, out, L, B, T, d, V,
                                      long_lived, st)
              : launch<float>(scratch, C, ds, out, L, B, T, d, V, long_lived,
                              st);
}
