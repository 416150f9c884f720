// Shared helpers for the port's hand-written sm_90a kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes passed across the plain C interface (see _build.py)
#define REPRO_F32 0
#define REPRO_BF16 1

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
