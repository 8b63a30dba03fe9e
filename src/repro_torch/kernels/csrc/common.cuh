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
