// Hopper (sm_90a) machinery shared by the tensor-core kernels: TMA tensor
// maps and loads, 1-D bulk copies, mbarrier rings, and the wgmma pieces
// (shared-memory matrix descriptors, fences, the m64nNk16 bf16 -> f32
// products).
//
// Every tile here is a TMA box whose inner dimension is 64 bf16 (128 bytes)
// loaded with CU_TENSOR_MAP_SWIZZLE_128B, so that a box of R rows is R
// 128-byte rows, 16-byte chunks XOR-ed with (row % 8), each 8-row group a
// 1024-byte swizzle atom. The wgmma descriptors below read exactly that
// layout (layout type 1, 128B swizzle), with tile buffers 1024-byte aligned:
//
//   K-major operand (K contiguous, at most 64 of it in one box): 8-row groups
//     of the M / N dimension at SBO = 1024 bytes; a k16 step moves the start
//     address by 32 bytes inside the 128-byte row; LBO is not read (16).
//   MN-major operand (M or N contiguous, "transposed"): a 64-wide M / N block
//     per box, blocks LBO bytes apart (the box size); 8-row groups of K at
//     SBO = 1024 bytes; a k16 step moves the start address by 2048 bytes.
//     Only 16-bit types have this form (the transpose immediates).
#pragma once

#include <cuda.h>  // CUtensorMap and the driver enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ------------------------------------------------------------------ host
// cuTensorMapEncodeTiled, taken from the driver through the runtime, so the
// library links against libcudart alone.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A tensor map of ``rank`` dimensions (innermost first), byte strides of
// dimensions 1..rank-1, a box of ``box`` elements (box[0]: one 128-byte
// swizzled row, 64 bf16 or 32 f32; or, unswizzled, up to 256 elements),
// out-of-bounds elements read as zero (and dropped by a store).
// -> 0, or a cudaError_t.
inline int make_map(CUtensorMap* map, const void* base, int rank,
                    const cuuint64_t* dims, const cuuint64_t* strides,
                    const cuuint32_t* box,
                    CUtensorMapDataType type =
                        CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(base),
                        dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Allows ``bytes`` of dynamic shared memory (above 48 KB) for ``kernel``.
// -> a cudaError_t.
template <typename K>
inline int allow_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

constexpr int ROW_BYTES = 128;    // one swizzled row: 64 bf16
constexpr int ATOM_BYTES = 1024;  // 8 rows: one swizzle atom

// ---------------------------------------------------------------- device
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The first 1024-byte boundary at or after p (128B-swizzled tiles sit on
// one, so that the swizzle phase is the row index).
__device__ __forceinline__ uint8_t* align_atom(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + ((ATOM_BYTES - (a & (ATOM_BYTES - 1))) & (ATOM_BYTES - 1));
}

// ---- mbarriers (shared::cta)
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes initialised barriers visible to the async proxy (TMA); call once
// after the inits, then __syncthreads().
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also announces ``bytes`` of TMA traffic for this phase.
// The count is the whole box, the zero-filled part included.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Spin until the phase of parity ``parity`` has completed (a barrier starts
// in phase 0; waiting on parity 1 before any completion returns at once).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}

// ---- warp specialisation
// The warpgroup index, read from lane 0 so that the compiler knows it is
// uniform across the warp (a branch on it then never diverges a warp).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
}

// Hands registers between warpgroups: a producer drops to N a thread, the
// consumers rise to N. Every thread of the warpgroup runs it, in a branch
// that never rejoins the others' (or the compiler ignores it).
template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// Named barriers (0 is __syncthreads'): sync waits until ``count`` threads
// have reached barrier ``id``, the caller included; arrive counts the caller
// in and goes on.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// ---- TMA loads into shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ---- 1-D bulk copies (no tensor map): ``bytes`` contiguous bytes, the
// addresses and the size multiples of 16. A load completes on ``bar`` (count
// its bytes in the phase's mbar_expect_tx); a store joins this thread's
// bulk group (bulk_commit, then bulk_wait_read before its source is written
// again).
__device__ __forceinline__ void bulk_load_1d(void* dst, const void* src,
                                             uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"((uint64_t)src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store_1d(void* dst, const void* src,
                                              uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          (uint64_t)dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

// ---- TMA stores from shared memory, one bulk group each
// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy accesses of them (a wgmma operand, a TMA store's source);
// every writing thread runs it, then the threads meet at a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"((uint64_t)map),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until at most N bulk groups still read their shared-memory source
// (the buffer may then be written again).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// Wait until at most N bulk groups are still in flight (writes included).
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
}

// ---- wgmma
// Shared-memory matrix descriptor: start address >> 4 (bits 0-13), leading
// byte offset >> 4 (16-29), stride byte offset >> 4 (32-45), base offset 0
// (tiles are atom-aligned), layout type 1 = 128B swizzle (62-63).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Before the first wgmma of a batch, and after registers it reads (the
// accumulator, a register A operand) were written by other instructions.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pins the registers of an accumulator across a wgmma issue or wait, so the
// compiler neither moves reads of it ahead of the wait nor copies it while
// the tensor cores own it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A 64 x N f32 accumulator of a warpgroup: thread (warp w, lane) holds
// d[4j + e] = D[16w + lane/4 + 8(e/2), 8j + 2(lane%4) + e%2], j < N/8. The
// same registers, rounded to bf16 in pairs, are the A operand of a
// following m64nNk16 (see flash_attention_wgmma.cu).
#define HOPPER_F8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_F32 HOPPER_F8(0), HOPPER_F8(8), HOPPER_F8(16), HOPPER_F8(24)
#define HOPPER_F64 \
  HOPPER_F32, HOPPER_F8(32), HOPPER_F8(40), HOPPER_F8(48), HOPPER_F8(56)
#define HOPPER_F96 \
  HOPPER_F64, HOPPER_F8(64), HOPPER_F8(72), HOPPER_F8(80), HOPPER_F8(88)
#define HOPPER_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define HOPPER_D64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define HOPPER_D96                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "  \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "  \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"

// D (64 x N) (+)= A (64 x 16) B (16 x N), both from shared memory; TA / TB
// = 1 for an MN-major ("transposed") operand. scale_d = 0 overwrites D.
// N = 64, 128 or 192, from the accumulator's size.
template <int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}"
      : HOPPER_F32
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t da,
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
      ", %64, %65, p, 1, 1, %67, %68;\n}"
      : HOPPER_F64
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[96], uint64_t da,
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " HOPPER_D96
      ", %96, %97, p, 1, 1, %99, %100;\n}"
      : HOPPER_F96
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// Four k16 steps of m64n128k16 (both operands MN-major, from shared
// memory) in one asm block, so that no other instruction sits between the
// wgmmas: step k runs where bit k of ``kmask`` is set (the same in every
// thread of the warpgroup: a guard predicate, not a branch), and the first
// step that runs overwrites D unless ``live`` is non-zero. All predicates
// are set before the first wgmma.
__device__ __forceinline__ void mma_ss4_if(float (&d)[64],
                                           const uint64_t (&da)[4],
                                           const uint64_t (&db)[4],
                                           uint32_t kmask, int live) {
  asm volatile(
      "{\n.reg .pred p0, p1, p2, p3, q0, q1, q2, q3;\n.reg .b32 t;\n"
      "and.b32 t, %72, 1;\nsetp.ne.b32 q0, t, 0;\n"
      "and.b32 t, %72, 2;\nsetp.ne.b32 q1, t, 0;\n"
      "and.b32 t, %72, 4;\nsetp.ne.b32 q2, t, 0;\n"
      "and.b32 t, %72, 8;\nsetp.ne.b32 q3, t, 0;\n"
      "setp.ne.b32 p0, %73, 0;\nor.pred p1, p0, q0;\n"
      "or.pred p2, p1, q1;\nor.pred p3, p2, q2;\n"
      "@q0 wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
      ", %64, %68, p0, 1, 1, 1, 1;\n"
      "@q1 wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
      ", %65, %69, p1, 1, 1, 1, 1;\n"
      "@q2 wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
      ", %66, %70, p2, 1, 1, 1, 1;\n"
      "@q3 wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
      ", %67, %71, p3, 1, 1, 1, 1;\n}"
      : HOPPER_F64
      : "l"(da[0]), "l"(da[1]), "l"(da[2]), "l"(da[3]), "l"(db[0]),
        "l"(db[1]), "l"(db[2]), "l"(db[3]), "r"(kmask), "r"(live));
}

// D (64 x N) += A (64 x 16, bf16 pairs in registers: rows lane/4 and +8,
// columns 2(lane%4) and +8, per warp) B (16 x N) from shared memory; TB and
// scale_d as above. N = 64 or 128.
template <int TB>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}"
      : HOPPER_F32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}"
      : HOPPER_F64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

// Two floats rounded to a bf16 pair (x in the low half): one b32 register
// of a wgmma A operand.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace hopper
