// Asynchronous copies from global to shared memory (cp.async, sm_80 and
// later), shared by the kernels that stage tiles of their slabs in shared
// memory a few tiles deep: block_transfer_grad.cu, bw_sites.cu and
// maf_sums_grad.cu. A thread issues its copies of a tile, commits them as
// one group, and later waits until at most N of its groups are in flight;
// a __syncthreads after the wait makes every thread's copies visible.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// cp.async of V bytes (16, 8 or 4) from global to shared memory;
// src_bytes (at most V) are read and the rest of the V bytes zero-filled,
// so src_bytes 0 fills the V bytes with zeros and reads nothing.
template <int V>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (V == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                     "l"(src), "r"(src_bytes));
    else if constexpr (V == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                     "l"(src), "r"(src_bytes));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                     "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A slab element of storage type T from a float (the pad and zero fills
// of copies that cp.async cannot make: rows not 4-byte aligned).
template <class T>
__device__ __forceinline__ T elem_from_float(float v) {
    return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 elem_from_float<__nv_bfloat16>(
    float v) {
    return __float2bfloat16(v);
}
