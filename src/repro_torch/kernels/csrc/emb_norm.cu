// emb_ghost_norm: per-sample squared gradient norms of an embedding lookup,
//
//     n_b = sum_l sum_{t,t'} 1[id_lbt == id_lbt'] (g_lbt . g_lbt')
//         = sum_l sum_{runs R of (l, b)} || sum_{t in R} g_lbt ||^2
//
//     ids (L,B,T) int32, g (L,B,T,d) f32 or bf16 -> (B,) f32
//
// Replaces the TPU kernel repro/kernels/emb_norm.py::emb_ghost_norm. The
// Pallas kernel forms the (T,T) cotangent Gram tile by tile on the MXU and
// masks it by id equality. Grouping equal ids into runs (the positions of
// one (l, b) that share an id, in t order, adjacent or not) turns the masked
// Gram into the squared norms of the runs' sums, so every cotangent row is
// read once, whatever the ids.
//
// Bound on the H100: the bytes of g, 12.6 MB at qwen2-1.5b's train (B=8,
// T=512, d=1536, bf16): 3.76 us at 3.35 TB/s; the adds are 2 d a row. The
// first version (designs/emb_norm_pairs.cu) dotted every id-matching pair
// with scalar loads from 128 CTAs and ran 17x above that. Here one warp
// takes one position t (a CTA: WARPS consecutive positions of one (l, b);
// 512 CTAs at train, all resident at once) and finds whether t leads its
// run (no s < t holds its id) by ballots over the (l, b)'s ids, which the
// CTA first copies to shared memory (2 KB at T=512; past MAX_SMEM_IDS ids
// the ballots read them from device memory). A leader sums its run's rows
// in t order in f32, with 16-byte loads (rows of 16-byte multiples; else
// scalar loads), in passes of 32 NV vectors of columns (UNROLL rows in
// flight), and adds the squared norm of the sum; the other positions add
// nothing. Ids compare by value, as the plain version compares them: -1
// and ids past the vocabulary match each other like any other id. One id
// at every position is one run, summed by one warp: right, but serial.
//
// Sums: each lane's columns, a warp's xor tree, the CTA's warps in order,
// then a second pass sums each b's partials in a fixed order (no float
// atomics): bitwise equal run to run. repro_torch.kernels.design_study
// times beside it the first version, and this kernel with the partials
// summed in the same launch by the last CTA of each b (one launch, but a
// device-wide fence and an atomic count in every CTA: slower on the
// device, and no faster by events on the H100).
#include "common.cuh"

namespace {

constexpr int WARPS = 8;            // positions of a CTA: one a warp
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 1;           // rows of a run in flight
constexpr int NS = 8;               // (scalar loads) columns a lane sums
constexpr int MAX_SMEM_IDS = 8192;  // ids of an (l, b) copied to shared
                                    // memory (32 KB, under the 48 KB a
                                    // launch may ask for without opting in)

// 16 bytes of a row, widened to floats and added to acc[0 .. N); NV: the
// vectors a lane sums a pass, as many as 64 registers a thread hold
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4, NV = 4;
  static __device__ __forceinline__ void add(float* acc, uint4 v) {
    acc[0] += __uint_as_float(v.x);
    acc[1] += __uint_as_float(v.y);
    acc[2] += __uint_as_float(v.z);
    acc[3] += __uint_as_float(v.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8, NV = 3;
  static __device__ __forceinline__ void add(float* acc, uint4 v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      acc[2 * k] += f.x;
      acc[2 * k + 1] += f.y;
    }
  }
};

// Whether no s < t holds t's id (the warp's answer, in every lane).
__device__ __forceinline__ bool leads(const int* __restrict__ id, int t,
                                      int idt, int lane) {
  for (int s0 = 0; s0 < t; s0 += 32) {
    const int s = s0 + lane;
    if (__ballot_sync(0xffffffffu, s < t && id[s] == idt))
      return false;
  }
  return true;
}

// The run of t's id: bit k of the result is whether s0 + k (>= t) is in it.
__device__ __forceinline__ unsigned members(const int* __restrict__ id,
                                            int s0, int t, int Tn, int idt,
                                            int lane) {
  const int s = s0 + lane;
  return __ballot_sync(0xffffffffu, s >= t && s < Tn && id[s] == idt);
}

// sum over this lane's columns of (the run's row sum)^2: 16-byte loads
template <typename T>
__device__ __forceinline__ float run_sq_vec(const int* __restrict__ id,
                                            const T* __restrict__ g, int t,
                                            int idt, int Tn, int d,
                                            int lane) {
  constexpr int N = Vec<T>::N, NV = Vec<T>::NV, W = 32 * NV * N;
  float sq = 0.f;
  for (int c0 = 0; c0 < d; c0 += W) {
    float acc[NV * N];
#pragma unroll
    for (int k = 0; k < NV * N; ++k) acc[k] = 0.f;
    for (int s0 = t & ~31; s0 < Tn; s0 += 32) {
      unsigned hit = members(id, s0, t, Tn, idt, lane);
      while (hit) {
        int rows[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          rows[u] = hit ? s0 + __ffs((int)hit) - 1 : -1;
          hit &= hit - 1;
        }
        uint4 v[UNROLL][NV];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
#pragma unroll
          for (int k = 0; k < NV; ++k) {
            const int c = c0 + (lane + 32 * k) * N;
            v[u][k] = rows[u] >= 0 && c < d
                          ? __ldg(reinterpret_cast<const uint4*>(
                                g + (long long)rows[u] * d + c))
                          : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (rows[u] >= 0) {
#pragma unroll
            for (int k = 0; k < NV; ++k) Vec<T>::add(acc + k * N, v[u][k]);
          }
      }
    }
#pragma unroll
    for (int k = 0; k < NV * N; ++k) sq = fmaf(acc[k], acc[k], sq);
  }
  return sq;
}

// the same with scalar loads (rows not of 16-byte multiples)
template <typename T>
__device__ __forceinline__ float run_sq_scalar(const int* __restrict__ id,
                                               const T* __restrict__ g,
                                               int t, int idt, int Tn, int d,
                                               int lane) {
  float sq = 0.f;
  for (int c0 = 0; c0 < d; c0 += 32 * NS) {
    float acc[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) acc[k] = 0.f;
    for (int s0 = t & ~31; s0 < Tn; s0 += 32) {
      unsigned hit = members(id, s0, t, Tn, idt, lane);
      while (hit) {
        const T* row = g + (long long)(s0 + __ffs((int)hit) - 1) * d;
        hit &= hit - 1;
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          const int c = c0 + lane + 32 * k;
          if (c < d) acc[k] += to_f32(row[c]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NS; ++k) sq = fmaf(acc[k], acc[k], sq);
  }
  return sq;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 4)
    emb_norm_kernel(const int* __restrict__ ids, const T* __restrict__ ds,
                    float* __restrict__ partial, int L, int B, int Tn, int d,
                    int nch) {
  extern __shared__ int sid[];   // the (l, b)'s ids, where they fit
  __shared__ float warp_tot[WARPS];
  const int chunk = blockIdx.x, l = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long row0 = ((long long)l * B + b) * Tn;
  const T* g = ds + row0 * d;
  const int* id = ids + row0;
  if (Tn <= MAX_SMEM_IDS) {
    for (int s = threadIdx.x; s < Tn; s += THREADS) sid[s] = __ldg(id + s);
    __syncthreads();
    id = sid;
  }
  const int t = chunk * WARPS + w;

  float sq = 0.f;
  if (t < Tn) {
    const int idt = id[t];
    if (leads(id, t, idt, lane)) {
      if constexpr (VEC)
        sq = run_sq_vec<T>(id, g, t, idt, Tn, d, lane);
      else
        sq = run_sq_scalar<T>(id, g, t, idt, Tn, d, lane);
    }
  }
  sq = warp_sum(sq);
  if (lane == 0) warp_tot[w] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < WARPS; ++i) s += warp_tot[i];
    partial[((long long)b * L + l) * nch + chunk] = s;
  }
}

template <typename T>
int launch(const int* ids, const void* ds, float* partial, int L, int B,
           int T_, int d, int nch, cudaStream_t st) {
  const dim3 grid(nch, L, B);
  const size_t smem = T_ <= MAX_SMEM_IDS ? (size_t)T_ * sizeof(int) : 0;
  const bool vec = (long long)d * sizeof(T) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ds) % 16 == 0;
  if (vec)
    emb_norm_kernel<T, true><<<grid, THREADS, smem, st>>>(
        ids, (const T*)ds, partial, L, B, T_, d, nch);
  else
    emb_norm_kernel<T, false><<<grid, THREADS, smem, st>>>(
        ids, (const T*)ds, partial, L, B, T_, d, nch);
  return (int)cudaGetLastError();
}

}  // namespace

// Partials of one sample a layer: one a CTA.
extern "C" int dp_emb_norm_nparts(int T) { return (T + WARPS - 1) / WARPS; }

// ids (L,B,T) int32, ds (L,B,T,d) f32 (bf16 == 0) or bf16, contiguous;
// partial (B, L * nparts(T)) f32 scratch; out (B,) f32.
extern "C" int dp_emb_norm(const int* ids, const void* ds, float* partial,
                           float* out, int L, int B, int T, int d, int bf16,
                           void* stream) {
  if (L <= 0 || B <= 0 || T <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int nch = dp_emb_norm_nparts(T);
  cudaStream_t st = (cudaStream_t)stream;
  const int err =
      bf16 ? launch<__nv_bfloat16>(ids, ds, partial, L, B, T, d, nch, st)
           : launch<float>(ids, ds, partial, L, B, T, d, nch, st);
  if (err) return err;
  reduce_rows_kernel<<<B, 256, 0, st>>>(partial, out, L * nch);
  return (int)cudaGetLastError();
}
