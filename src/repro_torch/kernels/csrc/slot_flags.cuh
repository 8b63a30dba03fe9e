// The pre-pass of the masked (MoE) tensor-core kernels,
// moe_clipped_grad_wgmma.cu and moe_direct_norm_wgmma.cu: the flags that
// wgmma_grad.cuh's producer loads with each stage.
#pragma once

#include "wgmma_grad.cuh"

namespace wgmma_grad {

// The pre-pass of the masked kernels: one block of 256 threads per 64-row
// block (z, kt) of the records -> flags[z nt + kt] = {bit kk: a kept slot
// (m != 0) among the block's rows 16 kk.., whether the mask is to be
// written on a: a value other than 0 and 1, or an empty slot (m = 0) whose
// row of a (d bf16) is not zero}. It reads the mask and the rows of a at
// empty slots only.
static __global__ void slot_flags_kernel(const __nv_bfloat16* __restrict__ a,
                                         const float* __restrict__ mask,
                                         uint4* __restrict__ flags, int C,
                                         int d, int nt) {
  __shared__ unsigned kbits, dirty;
  const int z = blockIdx.x / nt, kt = blockIdx.x % nt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) kbits = dirty = 0u;
  __syncthreads();
  unsigned kb = 0u, dt = 0u;
  for (int r = warp; r < BK && kt * BK + r < C; r += 8) {   // a row a warp
    const long long slot = (long long)z * C + kt * BK + r;
    const float m = mask[slot];
    if (m != 0.f) kb |= 1u << (r / 16);
    if (m != 0.f && m != 1.f) dt = 1u;
    if (m == 0.f && !dt) {
      const uint4* row = reinterpret_cast<const uint4*>(a + slot * d);
      unsigned bits = 0u;
      for (int j = lane; j < d / 8; j += 32) {
        const uint4 x = row[j];
        bits |= (x.x | x.y | x.z | x.w) & 0x7FFF7FFFu;   // -0 is zero too
      }
      if (__any_sync(0xffffffffu, bits != 0u)) dt = 1u;
    }
  }
  if (lane == 0) {
    atomicOr(&kbits, kb);
    atomicOr(&dirty, dt);
  }
  __syncthreads();
  if (threadIdx.x == 0) flags[blockIdx.x] = make_uint4(kbits, dirty, 0u, 0u);
}

// Launches the pre-pass over the Z (l, b, e) records of C slots, and maps
// its flags for the producer: (4, Z nt) u32, one 16-byte box a stage.
// -> a cudaError_t.
inline int slot_flags(CUtensorMap* map, const void* a, const float* mask,
                      void* flags, int Z, int C, int d, cudaStream_t st) {
  const int nt = (C + BK - 1) / BK;
  slot_flags_kernel<<<Z * nt, 256, 0, st>>>(
      (const __nv_bfloat16*)a, mask, (uint4*)flags, C, d, nt);
  int err = (int)cudaGetLastError();
  const cuuint64_t dims[2] = {4, (cuuint64_t)Z * nt}, str[1] = {FLAG_BYTES};
  const cuuint32_t box[2] = {4, 1};
  if (!err)
    err = hopper::make_map(map, flags, 2, dims, str, box,
                           CU_TENSOR_MAP_DATA_TYPE_UINT32,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
  return err;
}

}  // namespace wgmma_grad
