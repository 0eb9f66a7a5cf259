// Kernel A of the freq M-step: K0 real damped est_maf passes per site
// (each a reduction over the site's individuals), then the sums and their
// freq-derivatives at the freq reached.
// Replaces ngsf_hmm_tpu/ops/maf_pallas.py:_run_state_grad_slab. Two
// exports: ngsf_maf_state_grad on float32 gl slabs, ngsf_maf_state_grad_bf16
// on bfloat16 ones (upcast at load, 8 bytes a cell).
// Bound by bytes at the main path's widths: the three slabs are read once
// (12 bytes a cell) against about 24 + 16 K0 + 31 float operations a cell.
// One warp per site keeps the cells' planes in registers across the
// passes, so the slabs leave device memory once; a site that converges
// leaves its pass loop alone (an inactive site advances as a no-op, so
// this equals leaving only when a whole tile is inactive).
#include "maf_common.cuh"

template <int CPL, class T>
__global__ void k_maf_state_grad(const T* __restrict__ g0,
                                 const T* __restrict__ g2,
                                 const float* __restrict__ p,
                                 float* __restrict__ out,  // [8, sites]
                                 long long sites, int N, int K0) {
    NGSF_MAF_WARP_SITE()
    MafSite<CPL, T> s;
    s.load(g0, g2, p, site, N, lane);
    float freq = 0.01f, num = 0.0f, den = 0.0f, active = 1.0f;
    float cn, cd, dcn = 0.0f, dcd = 0.0f;
    for (int k = 0; k < K0 && active != 0.0f; ++k) {
        s.template sums<false>(freq, cn, cd, dcn, dcd);
        maf_advance(freq, num, den, active, cn, cd,
                    k + 1 <= NGSF_MAF_ITER_MAX);
    }
    s.template sums<true>(freq, cn, cd, dcn, dcd);
    const float row[8] = {freq, num, den, active, cn, cd, dcn, dcd};
    float v = row[0];
#pragma unroll
    for (int k = 1; k < 8; ++k) v = lane == k ? row[k] : v;
    if (lane < 8) out[(long long)lane * sites + site] = v;
}

template <class T>
static int launch(const T* g0, const T* g2, const float* p, float* out,
                  long long sites, int N, int K0, void* stream) {
#define CALL(C)                                                             \
    k_maf_state_grad<C, T><<<NGSF_MAF_GRID(sites), 32 * NGSF_MAF_WARPS, 0,  \
                             (cudaStream_t)stream>>>(g0, g2, p, out, sites, \
                                                     N, K0);
    NGSF_MAF_DISPATCH(N, CALL)
#undef CALL
    return (int)cudaGetLastError();
}

extern "C" int ngsf_maf_state_grad(const float* g0, const float* g2,
                                   const float* p, float* out,
                                   long long sites, int N, int K0,
                                   void* stream) {
    return launch(g0, g2, p, out, sites, N, K0, stream);
}

extern "C" int ngsf_maf_state_grad_bf16(const __nv_bfloat16* g0,
                                        const __nv_bfloat16* g2,
                                        const float* p, float* out,
                                        long long sites, int N, int K0,
                                        void* stream) {
    return launch(g0, g2, p, out, sites, N, K0, stream);
}
