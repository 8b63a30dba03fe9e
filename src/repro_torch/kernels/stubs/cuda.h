// Stub of the driver API header for the syntax check (see cuda_runtime.h
// here): the tensor-map types and enums that csrc/hopper.cuh names.
#pragma once

#include <stdint.h>

typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
typedef enum cudaError_enum { CUDA_SUCCESS = 0 } CUresult;
typedef struct CUtensorMap_st {
  alignas(64) cuuint64_t opaque[16];
} CUtensorMap;
typedef enum CUtensorMapDataType_enum {
  CU_TENSOR_MAP_DATA_TYPE_UINT32 = 2,
  CU_TENSOR_MAP_DATA_TYPE_FLOAT32 = 7,
  CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9,
} CUtensorMapDataType;
typedef enum CUtensorMapInterleave_enum {
  CU_TENSOR_MAP_INTERLEAVE_NONE = 0,
} CUtensorMapInterleave;
typedef enum CUtensorMapSwizzle_enum {
  CU_TENSOR_MAP_SWIZZLE_NONE = 0,
  CU_TENSOR_MAP_SWIZZLE_32B,
  CU_TENSOR_MAP_SWIZZLE_64B,
  CU_TENSOR_MAP_SWIZZLE_128B,
} CUtensorMapSwizzle;
typedef enum CUtensorMapL2promotion_enum {
  CU_TENSOR_MAP_L2_PROMOTION_NONE = 0,
  CU_TENSOR_MAP_L2_PROMOTION_L2_64B,
  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
} CUtensorMapL2promotion;
typedef enum CUtensorMapFloatOOBfill_enum {
  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0,
  CU_TENSOR_MAP_FLOAT_OOB_FILL_NAN_REQUEST_ZERO_FMA,
} CUtensorMapFloatOOBfill;
