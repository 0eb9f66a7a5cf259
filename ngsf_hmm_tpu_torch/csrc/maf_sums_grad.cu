// Kernel B of the freq M-step: one evaluation of the cross-individual
// sums and their freq-derivatives (cn, cd, dcn, dcd) at a given per-site
// freq, once per macro round after the first.
// Replaces ngsf_hmm_tpu/ops/maf_pallas.py:_run_sums_grad_slab. Two
// exports: ngsf_maf_sums_grad on float32 gl slabs, ngsf_maf_sums_grad_bf16
// on bfloat16 ones (upcast at load).
// Bound by bytes: three slabs read once (12 bytes a cell) against about
// 55 float operations a cell. One warp per site, as kernel A.
#include "maf_common.cuh"

template <int CPL, class T>
__global__ void k_maf_sums_grad(const T* __restrict__ g0,
                                const T* __restrict__ g2,
                                const float* __restrict__ p,
                                const float* __restrict__ fq,  // [sites]
                                float* __restrict__ out,       // [4, sites]
                                long long sites, int N) {
    NGSF_MAF_WARP_SITE()
    MafSite<CPL, T> s;
    s.load(g0, g2, p, site, N, lane);
    float cn, cd, dcn, dcd;
    s.template sums<true>(__ldg(fq + site), cn, cd, dcn, dcd);
    const float v = lane == 0 ? cn : lane == 1 ? cd : lane == 2 ? dcn : dcd;
    if (lane < 4) out[(long long)lane * sites + site] = v;
}

template <class T>
static int launch(const T* g0, const T* g2, const float* p, const float* fq,
                  float* out, long long sites, int N, void* stream) {
#define CALL(C)                                                            \
    k_maf_sums_grad<C, T><<<NGSF_MAF_GRID(sites), 32 * NGSF_MAF_WARPS, 0,  \
                            (cudaStream_t)stream>>>(g0, g2, p, fq, out,    \
                                                    sites, N);
    NGSF_MAF_DISPATCH(N, CALL)
#undef CALL
    return (int)cudaGetLastError();
}

extern "C" int ngsf_maf_sums_grad(const float* g0, const float* g2,
                                  const float* p, const float* fq, float* out,
                                  long long sites, int N, void* stream) {
    return launch(g0, g2, p, fq, out, sites, N, stream);
}

extern "C" int ngsf_maf_sums_grad_bf16(const __nv_bfloat16* g0,
                                       const __nv_bfloat16* g2,
                                       const float* p, const float* fq,
                                       float* out, long long sites, int N,
                                       void* stream) {
    return launch(g0, g2, p, fq, out, sites, N, stream);
}
