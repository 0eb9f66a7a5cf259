// Loads of a gl slab cell as float32, for either storage type of the
// slabs: float32, or bfloat16 (half the bytes of every gl stream; the JAX
// package's gl_bf16, ngsf_hmm_tpu/models/hmm_pallas.py:gl_slabs). A
// bfloat16 value is upcast exactly, so only the stored gl is quantised and
// all the arithmetic after the load stays float32.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float ld_gl(const float* p) { return __ldg(p); }

__device__ __forceinline__ float ld_gl(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
}

// The same upcast for a value already read (from shared memory).
__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
