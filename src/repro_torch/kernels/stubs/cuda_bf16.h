// Stub of cuda_bf16.h for the syntax check (see cuda_runtime.h here).
#pragma once

#include "cuda_runtime.h"

struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
float __bfloat162float(__nv_bfloat16 x);
__nv_bfloat16 __float2bfloat16(float x);
__nv_bfloat16 __float2bfloat16_rn(float x);
unsigned short __bfloat16_as_ushort(__nv_bfloat16 x);
float2 __bfloat1622float2(__nv_bfloat162 x);
__nv_bfloat162 __floats2bfloat162_rn(float x, float y);
