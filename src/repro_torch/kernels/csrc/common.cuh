// Shared helpers of the book-keeping kernels (sm_90a).
//
// Every reduction here runs in a fixed order: xor-shuffle trees inside a warp
// and in-order sums across warps and partials. No float atomics anywhere, so
// a kernel gives the same bits on every run (bitwise restart is one of the
// engine's guarantees).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

static __device__ __forceinline__ float to_f32(float x) { return x; }
static __device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

static __device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block; the result is valid in thread 0 only. blockDim.x
// is a multiple of 32. Call at most once per kernel (static scratch).
static __device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_tot[32];
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) warp_tot[w] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += warp_tot[i];
  return s;
}

// out[r] = sum_i part[r * n + i], one block per row r, in a fixed order.
static __global__ void reduce_rows_kernel(const float* __restrict__ part,
                                          float* __restrict__ out, int n) {
  const float* row = part + (long long)blockIdx.x * n;
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s += row[i];
  s = block_sum(s);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

// A factor applied to row r of a record as it is loaded: c * m[r], or c
// alone when m is null (the MoE slot mask, a clip factor, or both).
struct RowScale {
  const float* m;
  float c;
  __device__ __forceinline__ float operator()(int r) const {
    return m ? c * m[r] : c;
  }
};

// ---------------------------------------------------------------- gram tile
// One 64x64 tile of the Gram X X^T of a row-major (rows, K) record, 256
// threads with 4 x 4 entries each, reduced over K in chunks of 32 staged in
// shared memory.
namespace gram {
constexpr int BT = 64;        // rows of a Gram tile
constexpr int BK = 32;        // reduction chunk over K
constexpr int THREADS = 256;  // 16 x 16 threads

// acc[m][n] += sum_k s(ri) X[ri, k] * s(rj) X[rj, k] over k < K, with
// ri = ri0 + ty + 16m and rj = rj0 + tx + 16n. Rows >= rows read as zero.
template <typename T>
__device__ __forceinline__ void tile(float acc[4][4], const T* __restrict__ x,
                                     int ri0, int rj0, int rows, int K,
                                     RowScale s, float (*si)[BT + 1],
                                     float (*sj)[BT + 1]) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  for (int k0 = 0; k0 < K; k0 += BK) {
    // a warp reads 32 consecutive k of one row: coalesced; stored k-major
    // with a stride of 65 so the transposed stores hit 32 distinct banks
#pragma unroll
    for (int e = tid; e < BT * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK, k = k0 + kk;
      const int ri = ri0 + r, rj = rj0 + r;
      si[kk][r] = (ri < rows && k < K)
                      ? s(ri) * to_f32(x[(long long)ri * K + k]) : 0.f;
      sj[kk][r] = (rj < rows && k < K)
                      ? s(rj) * to_f32(x[(long long)rj * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float u[4], v[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) u[m] = si[kk][ty + 16 * m];
#pragma unroll
      for (int n = 0; n < 4; ++n) v[n] = sj[kk][tx + 16 * n];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(u[m], v[n], acc[m][n]);
    }
    __syncthreads();
  }
}

// sum_{m,n} ga[m][n] * gg[m][n] over this thread's entries
__device__ __forceinline__ float dot(const float ga[4][4],
                                     const float gg[4][4]) {
  float s = 0.f;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) s = fmaf(ga[m][n], gg[m][n], s);
  return s;
}
}  // namespace gram

// ------------------------------------------------------------- a^T g tile
// One 128x128 tile of X^T Y for row-major X (rows, d) and Y (rows, p), 256
// threads with 8 x 8 entries each, reduced over the rows in chunks of 16
// staged in shared memory. Used for clip-weighted gradients (the tile is
// written) and for direct norms (the tile is squared and summed).
namespace atb {
constexpr int BM = 128;       // d tile
constexpr int BN = 128;       // p tile
constexpr int BK = 16;        // rows per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads

__device__ __forceinline__ void zero(float acc[8][8]) {
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = 0.f;
}

// acc[m][n] += sum_{r < rows} s(r) X[r, d0 + ty + 16m] * Y[r, p0 + tx + 16n];
// the ragged row, d and p edges read as zero.
template <typename T>
__device__ __forceinline__ void accumulate(float acc[8][8],
                                           const T* __restrict__ x,
                                           const T* __restrict__ y, int rows,
                                           int d, int p, int d0, int p0,
                                           RowScale s, float (*sx)[BM],
                                           float (*sy)[BN]) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  for (int r0 = 0; r0 < rows; r0 += BK) {
    // consecutive threads take consecutive columns: coalesced reads,
    // conflict-free shared stores
#pragma unroll
    for (int e = tid; e < BK * BM; e += THREADS) {
      const int r = e / BM, c = e % BM, t = r0 + r;
      sx[r][c] = (t < rows && d0 + c < d)
                     ? s(t) * to_f32(x[(long long)t * d + d0 + c]) : 0.f;
      sy[r][c] = (t < rows && p0 + c < p)
                     ? to_f32(y[(long long)t * p + p0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float u[8], v[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) u[m] = sx[kk][ty + 16 * m];
#pragma unroll
      for (int n = 0; n < 8; ++n) v[n] = sy[kk][tx + 16 * n];
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[m][n] = fmaf(u[m], v[n], acc[m][n]);
    }
    __syncthreads();
  }
}

// sum of the squares of this thread's entries (entries past the d / p edge
// are zero)
__device__ __forceinline__ float sq_sum(const float acc[8][8]) {
  float s = 0.f;
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) s = fmaf(acc[m][n], acc[m][n], s);
  return s;
}

// out[r, c] = acc for the tile's in-range entries of a row-major (d, p) out
__device__ __forceinline__ void store(float* __restrict__ out,
                                      const float acc[8][8], int d, int p,
                                      int d0, int p0) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int r = d0 + ty + 16 * m;
    if (r >= d) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = p0 + tx + 16 * n;
      if (c < p) out[(long long)r * p + c] = acc[m][n];
    }
  }
}

__host__ __device__ inline int ntiles(int d, int p) {
  return ((d + BM - 1) / BM) * ((p + BN - 1) / BN);
}
}  // namespace atb
